"""The port's ROS1 bag reader/writer (fast_livo2_tpu_torch/io/rosbag.py)
against the JAX package's (fast_livo2_tpu/io/rosbag.py): every codec
round-trips as in tests/test_rosbag_end_to_end.py, the two writers give
the same bytes for Imu, Livox CustomMsg, PointCloud2 and Image messages,
each package reads the other's bag to equal messages, `bag_info` agrees,
and a bz2 chunk reads (an lz4 one raises) alike in both."""

import bz2
import struct
from types import SimpleNamespace as NS

import numpy as np
import pytest

from fast_livo2_tpu.io import rosbag as jbag
from fast_livo2_tpu_torch.io import rosbag as tbag


def _header(t, frame="base"):
    return tbag.make_header(t, frame)


def mixed_messages(seed=0, n_imu=30, n_scans=3, n_pts=200, n_img=2):
    """A small bag's messages on four topics: Imu at 200 Hz, Livox
    CustomMsg and Ouster-style PointCloud2 scans at 10 Hz, mono8 Images."""
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(n_imu):
        t = 100.0 + 0.005 * i
        g, a = rng.normal(size=3) * 0.1, rng.normal(size=3) + [0, 0, 9.81]
        msgs.append(("/livox/imu", tbag.IMU_TYPE, t, NS(
            header=_header(t, "imu"),
            angular_velocity=NS(x=float(g[0]), y=float(g[1]), z=float(g[2])),
            linear_acceleration=NS(x=float(a[0]), y=float(a[1]),
                                   z=float(a[2])))))
    for k in range(n_scans):
        t = 100.0 + 0.1 * k + 0.003
        arr = np.zeros(n_pts, tbag._LIVOX_PT)
        arr["offset_time"] = np.sort(rng.integers(0, 100_000_000, n_pts))
        for c in "xyz":
            arr[c] = rng.uniform(-20, 20, n_pts).astype(np.float32)
        arr["reflectivity"] = rng.integers(0, 255, n_pts)
        arr["tag"] = 0x10
        arr["line"] = np.arange(n_pts) % 6
        msgs.append(("/livox/lidar", tbag.LIVOX_TYPE, t, NS(
            header=_header(t, "livox"), timebase=int(t * 1e9),
            lidar_id=k % 3, points_arr=arr)))
        dt = np.dtype({"names": ["x", "y", "z", "t"],
                       "formats": ["f4", "f4", "f4", "u4"],
                       "offsets": [0, 4, 8, 12], "itemsize": 16})
        pc = np.zeros(n_pts, dt)
        for c in "xyz":
            pc[c] = rng.uniform(-20, 20, n_pts).astype(np.float32)
        pc["t"] = np.arange(n_pts) * 1000
        msgs.append(("/os_cloud_node/points", tbag.PC2_TYPE, t + 0.001, NS(
            header=_header(t + 0.001, "os"), height=1, width=n_pts,
            fields=[NS(name=nm, offset=off, datatype=7 if nm != "t" else 6,
                       count=1)
                    for nm, off in zip(dt.names, [0, 4, 8, 12])],
            is_bigendian=False, point_step=16, row_step=16 * n_pts,
            data=pc.tobytes(), is_dense=True)))
    for k in range(n_img):
        t = 100.0 + 0.1 * k + 0.05
        img = rng.integers(0, 255, (12, 16), dtype=np.uint8)
        msgs.append(("/left_camera/image", tbag.IMAGE_TYPE, t, NS(
            header=_header(t, "cam"), height=12, width=16, encoding="mono8",
            is_bigendian=False, step=16, data=img.tobytes())))
    return msgs


def _fields(obj):
    """A deserialized message as nested plain values, for equality."""
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.tobytes())
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return bytes(obj)
    if isinstance(obj, list):
        return [_fields(x) for x in obj]
    if hasattr(obj, "__dict__"):
        return {k: _fields(v) for k, v in vars(obj).items()
                if k != "points"}  # the lazy view of points_arr
    return obj


def _read(mod, path, **kw):
    return [(topic, mtype, t, _fields(m))
            for topic, mtype, t, m in mod.read_messages(str(path), **kw)]


def test_message_codecs_round_trip():
    """tests/test_rosbag_end_to_end.py::test_message_codecs_round_trip on
    the port's codecs, plus a CompressedImage decode."""
    h = tbag.make_header(12.3456789, "imu")
    imu = NS(header=h, angular_velocity=NS(x=0.1, y=-0.2, z=0.3),
             linear_acceleration=NS(x=1.0, y=2.0, z=-9.8))
    m = tbag.de_imu(tbag.ser_imu(imu))
    assert m.angular_velocity.y == -0.2
    assert m.linear_acceleration.z == -9.8
    assert m.header.stamp.sec == 12
    assert m.header.stamp.nanosec == h.stamp.nanosec
    assert m.header.frame_id == "imu"

    pts = np.zeros(7, tbag._LIVOX_PT)
    pts["x"] = np.arange(7, dtype=np.float32)
    pts["offset_time"] = np.arange(7) * 1000
    pts["tag"] = 0x10
    lv = NS(header=h, timebase=123456789, points_arr=pts)
    m = tbag.de_livox(tbag.ser_livox(lv))
    assert m.timebase == 123456789 and m.point_num == 7
    np.testing.assert_array_equal(m.points_arr["x"], pts["x"])
    assert list(m.points)[3].offset_time == 3000  # lazy object view
    # the object form of the points serializes to the same bytes
    objs = NS(header=h, timebase=123456789, points=list(m.points))
    assert tbag.ser_livox(objs) == tbag.ser_livox(lv)

    data = np.arange(6 * 4, dtype=np.uint8).tobytes()
    pc = NS(header=h, height=1, width=6,
            fields=[NS(name="x", offset=0, datatype=7, count=1)],
            is_bigendian=False, point_step=4, row_step=24, data=data,
            is_dense=True)
    m = tbag.de_pointcloud2(tbag.ser_pointcloud2(pc))
    assert m.width == 6 and m.fields[0].name == "x" and bytes(m.data) == data

    img = NS(header=h, height=2, width=3, encoding="mono8",
             is_bigendian=False, step=3, data=bytes(range(6)))
    m = tbag.de_image(tbag.ser_image(img))
    assert m.encoding == "mono8" and bytes(m.data) == bytes(range(6))

    fmt, payload = b"jpeg", b"\xff\xd8 not really a jpeg"
    buf = (tbag._ser_rosheader(h) + struct.pack("<I", len(fmt)) + fmt
           + struct.pack("<I", len(payload)) + payload)
    m = tbag.de_compressed_image(buf)
    assert m.format == "jpeg" and m.data == payload
    assert _fields(m) == _fields(jbag.de_compressed_image(buf))


@pytest.mark.parametrize("mtype", [tbag.IMU_TYPE, tbag.LIVOX_TYPE,
                                   tbag.PC2_TYPE, tbag.IMAGE_TYPE, None])
def test_write_bag_bytes_equal_jax(tmp_path, mtype):
    """The port's write_bag gives the JAX write_bag's bytes, for each
    message type alone and for all four in one bag."""
    msgs = [m for m in mixed_messages() if mtype in (None, m[1])]
    tbag.write_bag(str(tmp_path / "port.bag"), msgs)
    jbag.write_bag(str(tmp_path / "jax.bag"), msgs)
    got = (tmp_path / "port.bag").read_bytes()
    assert got.startswith(tbag.MAGIC) and got == (tmp_path / "jax.bag").read_bytes()


def test_each_reads_the_others_bag(tmp_path):
    msgs = mixed_messages(seed=1)
    tbag.write_bag(str(tmp_path / "port.bag"), msgs)
    jbag.write_bag(str(tmp_path / "jax.bag"), msgs)
    want = _read(jbag, tmp_path / "jax.bag")
    assert len(want) == len(msgs)
    assert _read(tbag, tmp_path / "jax.bag") == want
    assert _read(jbag, tmp_path / "port.bag") == want
    assert _read(tbag, tmp_path / "port.bag") == want
    # topic filter and raw mode
    sel = ["/livox/imu", "/left_camera/image"]
    assert (_read(tbag, tmp_path / "jax.bag", topics=sel)
            == _read(jbag, tmp_path / "port.bag", topics=sel))
    assert (_read(tbag, tmp_path / "jax.bag", raw=True)
            == _read(jbag, tmp_path / "port.bag", raw=True))
    # the messages read back carry what was written
    t_imu, m_imu = msgs[0][2], msgs[0][3]
    topic, mtype, t, m = next(tbag.read_messages(str(tmp_path / "jax.bag")))
    assert (topic, mtype) == ("/livox/imu", tbag.IMU_TYPE)
    assert abs(t - t_imu) < 1e-6 and m.angular_velocity.x == m_imu.angular_velocity.x


def test_bag_info_agrees(tmp_path):
    msgs = mixed_messages(seed=2)
    tbag.write_bag(str(tmp_path / "a.bag"), msgs)
    got = tbag.bag_info(str(tmp_path / "a.bag"))
    assert got == jbag.bag_info(str(tmp_path / "a.bag"))
    assert got["topics"]["/livox/lidar"] == (tbag.LIVOX_TYPE, 3)
    assert got["topics"]["/livox/imu"] == (tbag.IMU_TYPE, 30)
    assert got["start"] == pytest.approx(100.0, abs=1e-6)


def _recompress(src, dst, compression: bytes):
    """`src`'s bag with its chunk stored under `compression` (bz2-
    compressed for b"bz2"; the raw bytes under any other name)."""
    blob = src.read_bytes()
    out = [tbag.MAGIC]
    for op, header, data, end in tbag._iter_records(blob, len(tbag.MAGIC)):
        if op == tbag._OP_CHUNK:
            header = dict(header, compression=compression)
            data = bz2.compress(data) if compression == b"bz2" else data
        h = tbag._pack_header(header)
        out += [struct.pack("<I", len(h)), h, struct.pack("<I", len(data)), data]
    dst.write_bytes(b"".join(out))


@pytest.mark.parametrize("compression", [b"bz2", b"lz4"])
def test_compressed_chunks_alike(tmp_path, compression):
    msgs = mixed_messages(seed=3)
    tbag.write_bag(str(tmp_path / "plain.bag"), msgs)
    bag = tmp_path / "chunk.bag"
    _recompress(tmp_path / "plain.bag", bag, compression)
    if compression == b"bz2":
        want = _read(jbag, bag)
        assert _read(tbag, bag) == want == _read(tbag, tmp_path / "plain.bag")
        return
    with pytest.raises(ValueError) as jerr:
        _read(jbag, bag)
    with pytest.raises(ValueError) as terr:
        _read(tbag, bag)
    assert str(terr.value) == str(jerr.value) and "lz4" in str(terr.value)


def test_not_a_bag_raises(tmp_path):
    p = tmp_path / "x.bag"
    p.write_bytes(b"#ROSBAG V1.2\n" + bytes(64))
    with pytest.raises(ValueError, match="not a ROS1 v2.0 bag"):
        list(tbag.read_messages(str(p)))
    with pytest.raises(ValueError, match="no serializer"):
        tbag.write_bag(str(tmp_path / "y.bag"),
                       [("/c", tbag.CIMAGE_TYPE, 1.0, NS())])

"""Dependency-free ROS1 bag (v2.0) reader + writer (the PyTorch port's
own copy of fast_livo2_tpu/io/rosbag.py, numpy and the standard library
only).

It parses the ROS1 bag container (http://wiki.ros.org/Bags/Format/2.0)
and the message types FAST-LIVO2's launch files subscribe to:
sensor_msgs/Imu, sensor_msgs/PointCloud2, sensor_msgs/Image,
sensor_msgs/CompressedImage and livox_ros_driver/CustomMsg. ROS1
messages are packed little-endian with no alignment padding.

The writer emits standard, indexed, uncompressed bags (bag header +
chunk + connection + message + index-data + chunk-info records), byte
for byte what the JAX package's writer emits for the same messages.
`python -m fast_livo2_tpu_torch.convert_rosbag` turns a bag into the npz
sequence the run CLI reads.

Reader scope: uncompressed and bz2 chunks (stdlib); lz4 chunks raise
with a clear message (no lz4 codec is bundled).
"""

import bz2
import io
import struct
from types import SimpleNamespace
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_IDXDATA = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONN = 0x07

MAGIC = b"#ROSBAG V2.0\n"

# ---------------------------------------------------------------------------
# record container


def _pack_header(fields: Dict[str, bytes]) -> bytes:
    out = b""
    for name, val in fields.items():
        item = name.encode() + b"=" + val
        out += struct.pack("<I", len(item)) + item
    return out


def _parse_header(buf: bytes) -> Dict[str, bytes]:
    fields = {}
    i = 0
    while i < len(buf):
        (n,) = struct.unpack_from("<I", buf, i)
        i += 4
        item = buf[i:i + n]
        i += n
        k, _, v = item.partition(b"=")
        fields[k.decode()] = v
    return fields


def _write_record(f, header: Dict[str, bytes], data: bytes) -> int:
    """Append one record; returns its start offset."""
    pos = f.tell()
    h = _pack_header(header)
    f.write(struct.pack("<I", len(h)))
    f.write(h)
    f.write(struct.pack("<I", len(data)))
    f.write(data)
    return pos


def _iter_records(buf: bytes, start: int = 0):
    """Yield (op, header_fields, data, next_offset) from a byte buffer."""
    i = start
    n = len(buf)
    while i + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        header = _parse_header(buf[i:i + hlen])
        i += hlen
        (dlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        data = buf[i:i + dlen]
        i += dlen
        yield header["op"][0], header, data, i


def _time(val: bytes) -> float:
    s, ns = struct.unpack("<II", val)
    return s + ns * 1e-9


def _pack_time(t: float) -> bytes:
    s = int(t)
    return struct.pack("<II", s, int(round((t - s) * 1e9)))


# ---------------------------------------------------------------------------
# message (de)serialization — ROS1 packs fields little-endian, unpadded


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.i = 0

    def u(self, fmt):
        vals = struct.unpack_from("<" + fmt, self.buf, self.i)
        self.i += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def string(self) -> str:
        n = self.u("I")
        s = self.buf[self.i:self.i + n].decode(errors="replace")
        self.i += n
        return s

    def raw(self, n: int) -> bytes:
        b = self.buf[self.i:self.i + n]
        self.i += n
        return b

    def header(self):
        seq = self.u("I")
        sec, nsec = self.u("II")
        frame_id = self.string()
        return SimpleNamespace(
            seq=seq, frame_id=frame_id,
            stamp=SimpleNamespace(sec=sec, nanosec=nsec))


def _ser_rosheader(h) -> bytes:
    stamp = getattr(h, "stamp", None)
    sec = getattr(stamp, "sec", 0) if stamp else 0
    nsec = getattr(stamp, "nanosec", 0) if stamp else 0
    frame = getattr(h, "frame_id", "") or ""
    fb = frame.encode()
    return struct.pack("<III", getattr(h, "seq", 0), sec, nsec) + \
        struct.pack("<I", len(fb)) + fb


def make_header(t: float, frame_id: str = "base", seq: int = 0):
    sec = int(t)
    return SimpleNamespace(
        seq=seq, frame_id=frame_id,
        stamp=SimpleNamespace(sec=sec, nanosec=int(round((t - sec) * 1e9))))


# --- sensor_msgs/Imu -------------------------------------------------------

IMU_TYPE = "sensor_msgs/Imu"
IMU_MD5 = "6a62c6daae103f4ff57a132d6f95cec2"


def ser_imu(msg) -> bytes:
    def v3(v):
        return struct.pack("<3d", v.x, v.y, v.z)

    o = getattr(msg, "orientation", SimpleNamespace(x=0, y=0, z=0, w=1))
    zero9 = struct.pack("<9d", *([0.0] * 9))
    return (_ser_rosheader(msg.header)
            + struct.pack("<4d", o.x, o.y, o.z, o.w) + zero9
            + v3(msg.angular_velocity) + zero9
            + v3(msg.linear_acceleration) + zero9)


def de_imu(buf: bytes):
    r = _Reader(buf)
    h = r.header()
    ox, oy, oz, ow = r.u("4d")
    r.u("9d")
    wx, wy, wz = r.u("3d")
    r.u("9d")
    ax, ay, az = r.u("3d")
    r.u("9d")
    return SimpleNamespace(
        header=h,
        orientation=SimpleNamespace(x=ox, y=oy, z=oz, w=ow),
        angular_velocity=SimpleNamespace(x=wx, y=wy, z=wz),
        linear_acceleration=SimpleNamespace(x=ax, y=ay, z=az))


# --- sensor_msgs/PointCloud2 ----------------------------------------------

PC2_TYPE = "sensor_msgs/PointCloud2"
PC2_MD5 = "1158d486dd51d683ce2f1be655c3c181"


def ser_pointcloud2(msg) -> bytes:
    out = _ser_rosheader(msg.header)
    out += struct.pack("<II", msg.height, msg.width)
    out += struct.pack("<I", len(msg.fields))
    for f in msg.fields:
        nb = f.name.encode()
        out += struct.pack("<I", len(nb)) + nb
        out += struct.pack("<IBI", f.offset, f.datatype, f.count)
    data = bytes(msg.data)
    out += struct.pack("<B", 1 if getattr(msg, "is_bigendian", False) else 0)
    out += struct.pack("<II", msg.point_step, msg.row_step)
    out += struct.pack("<I", len(data)) + data
    out += struct.pack("<B", 1 if getattr(msg, "is_dense", True) else 0)
    return out


def de_pointcloud2(buf: bytes):
    r = _Reader(buf)
    h = r.header()
    height, width = r.u("II")
    nf = r.u("I")
    fields = []
    for _ in range(nf):
        name = r.string()
        off, dt, cnt = r.u("IBI")
        fields.append(SimpleNamespace(name=name, offset=off, datatype=dt,
                                      count=cnt))
    is_be = r.u("B")
    point_step, row_step = r.u("II")
    data = r.raw(r.u("I"))
    is_dense = r.u("B")
    return SimpleNamespace(
        header=h, height=height, width=width, fields=fields,
        is_bigendian=bool(is_be), point_step=point_step, row_step=row_step,
        data=data, is_dense=bool(is_dense))


# --- sensor_msgs/Image & CompressedImage ----------------------------------

IMAGE_TYPE = "sensor_msgs/Image"
IMAGE_MD5 = "060021388200f6f0f447d0fcd9c64743"
CIMAGE_TYPE = "sensor_msgs/CompressedImage"
CIMAGE_MD5 = "8f7a12909da2c9d3332d540a0977563f"


def ser_image(msg) -> bytes:
    enc = msg.encoding.encode()
    data = bytes(msg.data)
    return (_ser_rosheader(msg.header)
            + struct.pack("<II", msg.height, msg.width)
            + struct.pack("<I", len(enc)) + enc
            + struct.pack("<BI", 1 if getattr(msg, "is_bigendian", False)
                          else 0, msg.step)
            + struct.pack("<I", len(data)) + data)


def de_image(buf: bytes):
    r = _Reader(buf)
    h = r.header()
    height, width = r.u("II")
    encoding = r.string()
    is_be = r.u("B")
    step = r.u("I")
    data = r.raw(r.u("I"))
    return SimpleNamespace(header=h, height=height, width=width,
                           encoding=encoding, is_bigendian=bool(is_be),
                           step=step, data=data)


def de_compressed_image(buf: bytes):
    r = _Reader(buf)
    h = r.header()
    fmt = r.string()
    data = r.raw(r.u("I"))
    return SimpleNamespace(header=h, format=fmt, data=data)


# --- livox_ros_driver/CustomMsg -------------------------------------------

LIVOX_TYPE = "livox_ros_driver/CustomMsg"
LIVOX_MD5 = "e4d6829bdfe657cb6c21a746c86b21a6"  # CustomMsg.h:159
# CustomPoint wire layout (CustomPoint.h:48-66): u32 offset_time,
# f32 x/y/z, u8 reflectivity, u8 tag, u8 line — 19 bytes, unpadded.
_LIVOX_PT = np.dtype([
    ("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
    ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1")])


def ser_livox(msg) -> bytes:
    if hasattr(msg, "points_arr"):
        pts = np.asarray(msg.points_arr, dtype=_LIVOX_PT)
    else:
        pts = np.zeros(len(msg.points), _LIVOX_PT)
        for i, p in enumerate(msg.points):
            pts[i] = (p.offset_time, p.x, p.y, p.z,
                      getattr(p, "reflectivity", 0), getattr(p, "tag", 0x10),
                      getattr(p, "line", 0))
    return (_ser_rosheader(msg.header)
            + struct.pack("<QIB3B", msg.timebase, len(pts),
                          getattr(msg, "lidar_id", 0), 0, 0, 0)
            + struct.pack("<I", len(pts)) + pts.tobytes())


def de_livox(buf: bytes):
    r = _Reader(buf)
    h = r.header()
    timebase = r.u("Q")
    point_num = r.u("I")
    lidar_id = r.u("B")
    r.raw(3)
    n = r.u("I")
    arr = np.frombuffer(r.raw(n * _LIVOX_PT.itemsize), _LIVOX_PT, count=n)
    return SimpleNamespace(
        header=h, timebase=timebase, point_num=point_num,
        lidar_id=lidar_id, points_arr=arr,
        # object view kept lazy: .points materializes only if accessed
        points=_LazyPoints(arr))


class _LazyPoints:
    """Per-point object view over the structured array (compat with
    object-style consumers; the converter's fast path uses points_arr)."""

    def __init__(self, arr):
        self._arr = arr

    def __len__(self):
        return len(self._arr)

    def __iter__(self):
        for row in self._arr:
            yield SimpleNamespace(
                offset_time=int(row["offset_time"]), x=float(row["x"]),
                y=float(row["y"]), z=float(row["z"]),
                reflectivity=int(row["reflectivity"]), tag=int(row["tag"]),
                line=int(row["line"]))


_DESERIALIZERS = {
    IMU_TYPE: de_imu,
    PC2_TYPE: de_pointcloud2,
    IMAGE_TYPE: de_image,
    CIMAGE_TYPE: de_compressed_image,
    LIVOX_TYPE: de_livox,
}

_SERIALIZERS = {
    IMU_TYPE: (ser_imu, IMU_MD5),
    PC2_TYPE: (ser_pointcloud2, PC2_MD5),
    IMAGE_TYPE: (ser_image, IMAGE_MD5),
    LIVOX_TYPE: (ser_livox, LIVOX_MD5),
}


# ---------------------------------------------------------------------------
# reader


def read_messages(path, topics: Optional[List[str]] = None,
                  raw: bool = False) -> Iterator[Tuple[str, str, float, object]]:
    """Yield (topic, msgtype, receive_time, msg) in file order.

    msgtype uses slash notation ('sensor_msgs/Imu'). Unknown message
    types yield raw bytes when `raw` else are skipped. Handles plain and
    bz2-compressed chunks; both chunked and unchunked (top-level message)
    bags parse."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(MAGIC):
        raise ValueError(f"{path}: not a ROS1 v2.0 bag "
                         f"(magic {blob[:13]!r})")
    conns: Dict[int, Tuple[str, str]] = {}  # conn id -> (topic, type)
    pending: List[Tuple[int, float, bytes]] = []

    def handle(op, header, data):
        if op == _OP_CONN:
            cid = struct.unpack("<I", header["conn"])[0]
            chdr = _parse_header(data)
            topic = header.get("topic", chdr.get("topic", b"")).decode()
            mtype = chdr.get("type", b"").decode()
            conns[cid] = (topic, mtype)
        elif op == _OP_MSG:
            cid = struct.unpack("<I", header["conn"])[0]
            t = _time(header["time"])
            pending.append((cid, t, data))

    for op, header, data, _ in _iter_records(blob, len(MAGIC)):
        if op == _OP_CHUNK:
            comp = header.get("compression", b"none").decode()
            if comp == "none":
                chunk = data
            elif comp == "bz2":
                chunk = bz2.decompress(data)
            else:
                raise ValueError(
                    f"{path}: chunk compression {comp!r} unsupported "
                    "(no lz4 codec bundled; re-record with --bz2 or "
                    "decompress with `rosbag decompress`)")
            for cop, ch, cd, _ in _iter_records(chunk):
                handle(cop, ch, cd)
        elif op in (_OP_CONN, _OP_MSG):
            handle(op, header, data)
        # bag header / index / chunk-info records: not needed for a scan

        # drain in order, interleaved with parsing (bounded memory)
        for cid, t, mdata in pending:
            topic, mtype = conns.get(cid, ("?", "?"))
            if topics is not None and topic not in topics:
                continue
            de = _DESERIALIZERS.get(mtype)
            if de is None:
                if raw:
                    yield topic, mtype, t, mdata
                continue
            yield topic, mtype, t, de(mdata)
        pending.clear()


def bag_info(path) -> Dict:
    """Topic -> (msgtype, count) summary plus time range."""
    topics: Dict[str, List] = {}
    t0, t1 = np.inf, -np.inf
    for topic, mtype, t, _ in read_messages(path, raw=True):
        rec = topics.setdefault(topic, [mtype, 0])
        rec[1] += 1
        t0, t1 = min(t0, t), max(t1, t)
    return {"topics": {k: tuple(v) for k, v in topics.items()},
            "start": t0, "end": t1}


# ---------------------------------------------------------------------------
# writer


def write_bag(path, messages: List[Tuple[str, str, float, object]]):
    """Write a standard indexed ROS1 v2.0 bag (one uncompressed chunk).

    messages: list of (topic, msgtype, time_seconds, msg). msg objects
    use the same attribute shapes the deserializers produce (see
    make_header / the ser_* functions). Messages are written in time
    order as `rosbag record` would."""
    messages = sorted(messages, key=lambda m: m[2])
    topics = []
    for topic, mtype, _, _ in messages:
        if topic not in [t for t, _ in topics]:
            if mtype not in _SERIALIZERS:
                raise ValueError(f"no serializer for {mtype}")
            topics.append((topic, mtype))
    conn_ids = {topic: i for i, (topic, _) in enumerate(topics)}

    # serialize chunk body: connection records then message records
    body = io.BytesIO()
    for topic, mtype in topics:
        ser, md5 = _SERIALIZERS[mtype]
        conn_hdr = _pack_header({
            "topic": topic.encode(), "type": mtype.encode(),
            "md5sum": md5.encode(),
            "message_definition": b"",  # tools accept empty definitions
        })
        _write_record(body, {
            "op": bytes([_OP_CONN]),
            "conn": struct.pack("<I", conn_ids[topic]),
            "topic": topic.encode(),
        }, conn_hdr)
    index: Dict[int, List[Tuple[float, int]]] = {}
    for topic, mtype, t, msg in messages:
        ser, _ = _SERIALIZERS[mtype]
        off = _write_record(body, {
            "op": bytes([_OP_MSG]),
            "conn": struct.pack("<I", conn_ids[topic]),
            "time": _pack_time(t),
        }, ser(msg))
        index.setdefault(conn_ids[topic], []).append((t, off))
    chunk = body.getvalue()

    with open(path, "wb") as f:
        f.write(MAGIC)
        # bag header record, padded to 4096 bytes as rosbag does
        hdr_pos = f.tell()
        bag_hdr = _pack_header({
            "op": bytes([_OP_BAGHDR]),
            "index_pos": struct.pack("<Q", 0),  # patched below
            "conn_count": struct.pack("<I", len(topics)),
            "chunk_count": struct.pack("<I", 1),
        })
        pad = 4096 - 8 - len(bag_hdr)
        f.write(struct.pack("<I", len(bag_hdr)))
        f.write(bag_hdr)
        f.write(struct.pack("<I", pad))
        f.write(b" " * pad)

        chunk_pos = _write_record(f, {
            "op": bytes([_OP_CHUNK]),
            "compression": b"none",
            "size": struct.pack("<I", len(chunk)),
        }, chunk)
        # per-connection index-data records (version 1)
        for cid, entries in index.items():
            data = b"".join(_pack_time(t) + struct.pack("<I", off)
                            for t, off in entries)
            _write_record(f, {
                "op": bytes([_OP_IDXDATA]),
                "ver": struct.pack("<I", 1),
                "conn": struct.pack("<I", cid),
                "count": struct.pack("<I", len(entries)),
            }, data)

        index_pos = f.tell()
        # trailing connection records + chunk info (the "index" section)
        for topic, mtype in topics:
            _, md5 = _SERIALIZERS[mtype]
            conn_hdr = _pack_header({
                "topic": topic.encode(), "type": mtype.encode(),
                "md5sum": md5.encode(), "message_definition": b"",
            })
            _write_record(f, {
                "op": bytes([_OP_CONN]),
                "conn": struct.pack("<I", conn_ids[topic]),
                "topic": topic.encode(),
            }, conn_hdr)
        t_all = [m[2] for m in messages] or [0.0]
        counts = b"".join(struct.pack("<II", cid, len(entries))
                          for cid, entries in index.items())
        _write_record(f, {
            "op": bytes([_OP_CHUNKINFO]),
            "ver": struct.pack("<I", 1),
            "chunk_pos": struct.pack("<Q", chunk_pos),
            "start_time": _pack_time(min(t_all)),
            "end_time": _pack_time(max(t_all)),
            "count": struct.pack("<I", len(index)),
        }, counts)

        # patch index_pos in the bag header
        f.seek(hdr_pos)
        bag_hdr = _pack_header({
            "op": bytes([_OP_BAGHDR]),
            "index_pos": struct.pack("<Q", index_pos),
            "conn_count": struct.pack("<I", len(topics)),
            "chunk_count": struct.pack("<I", 1),
        })
        f.write(struct.pack("<I", len(bag_hdr)))
        f.write(bag_hdr)

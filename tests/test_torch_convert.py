"""The port's bag converter (python -m fast_livo2_tpu_torch.convert_rosbag)
against scripts/convert_rosbag.py: `build_sequence` array for array on
tests/test_convert.py's faked messages (livox + images, an Ouster
PointCloud2); a real bag (tests/test_rosbag_end_to_end.py's avia topics
plus raw images) converted by both in subprocesses to equal npz files;
and the port's run CLI on the converted sequence (--device cpu) held to
the JAX test's gate, ATE < 0.08 m. A CompressedImage without OpenCV stops
the port's conversion with a clear error."""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace as NS

import numpy as np
import pytest
import yaml

from fast_livo2_tpu_torch import convert_rosbag as tconv
from fast_livo2_tpu_torch import run
from fast_livo2_tpu_torch.io import dataset, synthetic
from fast_livo2_tpu_torch.io import rosbag as tbag
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import convert_rosbag as jconv  # noqa: E402
from tests.test_convert import (_img_msg, _imu_msg, _livox_msg,  # noqa: E402
                                _pc2_msg)


def _assert_seq_equal(a, b):
    np.testing.assert_array_equal(a.imu_stamps, b.imu_stamps)
    np.testing.assert_array_equal(a.imu_gyr, b.imu_gyr)
    np.testing.assert_array_equal(a.imu_acc, b.imu_acc)
    assert len(a.scans) == len(b.scans) and len(a.images) == len(b.images)
    for (ta, pa, oa), (tb, pb, ob) in zip(a.scans, b.scans):
        assert ta == tb and pa.dtype == pb.dtype and oa.dtype == ob.dtype
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(oa, ob)
    for (ta, ia), (tb, ib) in zip(a.images, b.images):
        assert ta == tb and ia.dtype == ib.dtype
        np.testing.assert_array_equal(ia, ib)


def test_build_sequence_livox_and_images_equals_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(2, 5, (300, 3)).astype(np.float32)
    offs = np.linspace(0, 0.1, 300) * 1e9
    img = rng.integers(0, 255, (8, 12), dtype=np.uint8)
    base = 1000.0
    records = [
        ("imu", "sensor_msgs/msg/Imu", base + 0.005 * i,
         _imu_msg([0.01, 0, 0], [0, 0, 9.81])) for i in range(20)
    ] + [
        ("lidar", "livox_ros_driver/msg/CustomMsg", base + 0.02,
         _livox_msg(pts, offs)),
        ("image", "sensor_msgs/msg/Image", base + 0.07, _img_msg(img)),
    ]
    got = tconv.build_sequence(records, lidar_type=1, blind=0.8, filter_num=1)
    _assert_seq_equal(got, jconv.build_sequence(records, lidar_type=1,
                                                blind=0.8, filter_num=1))
    assert got.imu_stamps[0] == 0.0 and len(got.scans[0][1]) == 300
    np.testing.assert_array_equal(got.images[0][1], img)


def test_build_sequence_pointcloud2_ouster_equals_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(2, 5, (200, 3)).astype(np.float32)
    near = np.array([[0.1, 0.1, 0.1]], np.float32)  # inside blind radius
    msg = _pc2_msg(np.concatenate([pts, near]), np.linspace(0, 0.1, 201))
    records = [("lidar", "sensor_msgs/msg/PointCloud2", 5.0, msg)]
    got = tconv.build_sequence(records, lidar_type=3, blind=0.8, filter_num=2)
    _assert_seq_equal(got, jconv.build_sequence(records, lidar_type=3,
                                                blind=0.8, filter_num=2))
    assert len(got.scans[0][1]) == 100  # blind point dropped, 1 in 2 kept


def test_compressed_image_without_cv2_fails_clearly(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    msg = NS(format="jpeg", data=b"\xff\xd8")
    with pytest.raises(RuntimeError, match="OpenCV"):
        tconv.decode_image_msg(msg)


def seq_to_messages(seq, img_topic="/left_camera/image"):
    """A sequence as avia-topic bag messages (tests/test_rosbag_end_to_end.py's
    _seq_to_messages: Livox CustomMsg with offset_time in ns, Imu), plus
    its images as raw mono8 sensor_msgs/Image."""
    msgs = []
    for t, g, a in zip(seq.imu_stamps, seq.imu_gyr, seq.imu_acc):
        msgs.append(("/livox/imu", tbag.IMU_TYPE, float(t), NS(
            header=tbag.make_header(float(t)),
            angular_velocity=NS(x=float(g[0]), y=float(g[1]), z=float(g[2])),
            linear_acceleration=NS(x=float(a[0]), y=float(a[1]),
                                   z=float(a[2])))))
    for t0, pts, offs in seq.scans:
        arr = np.zeros(len(pts), tbag._LIVOX_PT)
        arr["offset_time"] = np.round(offs * 1e9).astype(np.uint32)
        arr["x"], arr["y"], arr["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        arr["tag"] = 0x10  # valid-return tag (decode_avia keeps these)
        arr["line"] = np.arange(len(pts)) % 6
        msgs.append(("/livox/lidar", tbag.LIVOX_TYPE, float(t0), NS(
            header=tbag.make_header(float(t0)), timebase=int(t0 * 1e9),
            points_arr=arr)))
    for t, img in seq.images:
        img = np.ascontiguousarray(img, np.uint8)
        h, w = img.shape
        msgs.append((img_topic, tbag.IMAGE_TYPE, float(t), NS(
            header=tbag.make_header(float(t), "camera"), height=h, width=w,
            encoding="mono8", is_bigendian=False, step=w,
            data=img.tobytes())))
    return msgs


def _npz_arrays(path):
    out = {}
    for f in sorted(Path(path).glob("*.npz")):
        with np.load(f) as z:
            out.update({f"{f.name}:{k}": z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """test_real_bag_converts_and_runs's sequence with 10 Hz raw images,
    written to a bag by the port and converted by both converters, each
    in a subprocess."""
    root = tmp_path_factory.mktemp("bag")
    seq = synthetic.make_sequence(
        duration=2.5, lidar_hz=10.0, imu_hz=200.0, seed=5, n_lines=12,
        n_per_line=400, render=False, fov_deg=360.0)
    rng = np.random.default_rng(5)
    seq.images = [(float(t), rng.integers(0, 255, (48, 64), dtype=np.uint8))
                  for t in np.arange(0.05, 2.5, 0.1)]
    bag = root / "avia.bag"
    tbag.write_bag(str(bag), seq_to_messages(seq))
    outs = {}
    for name, cmd in (("port", ["-m", "fast_livo2_tpu_torch.convert_rosbag"]),
                      ("jax", [str(ROOT / "scripts" / "convert_rosbag.py")])):
        outs[name] = root / name
        r = subprocess.run(
            [sys.executable, *cmd, str(bag), str(outs[name]),
             "--lidar-type", "1", "--blind", "0.1", "--filter-num", "1"],
            capture_output=True, text=True, cwd=str(ROOT), timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
    return root, seq, outs


def test_converted_npz_equals_jax_script(converted):
    _, seq, outs = converted
    got, want = _npz_arrays(outs["port"]), _npz_arrays(outs["jax"])
    assert sorted(got) == sorted(want)
    assert {k.split(":")[0] for k in got} == {"imu.npz", "scans.npz",
                                              "images.npz"}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    conv = dataset.load_sequence(str(outs["port"]))
    assert len(conv.scans) == len(seq.scans)
    assert len(conv.imu_stamps) == len(seq.imu_stamps)
    assert len(conv.images) == len(seq.images)
    for (t, a), (u, b) in zip(conv.images, seq.images):
        assert abs(t - u) < 1e-6
        np.testing.assert_array_equal(a, b.astype(np.float32))
    for (t, p, o), (u, q, r) in zip(conv.scans, seq.scans):
        assert abs(t - u) < 1e-6
        np.testing.assert_array_equal(p, q.astype(np.float32))
        np.testing.assert_allclose(o, r, atol=1e-6)


def test_converted_bag_runs_on_the_port_cli(converted, one_torch_thread):
    """The port's CLI with --device cpu on the converted sequence keeps
    test_real_bag_converts_and_runs's gate (ATE < 0.08 m)."""
    root, seq, outs = converted
    cfg_yaml = root / "sensor.yaml"
    cfg_yaml.write_text(yaml.safe_dump({
        "common": {"img_en": 0, "lidar_en": 1},
        "preprocess": {"filter_size_surf": 0.15},
        "lio": {"max_layer": 1},
        "tpu": {"max_points_per_scan": 8192, "max_points_down": 4096,
                "hash_capacity_log2": 15},
    }))
    out = root / "run"
    summary = run.main(["--config", str(cfg_yaml), "--seq", str(outs["port"]),
                        "--out", str(out), "--device", "cpu"])
    assert summary["mode"] == "only_lio"
    rows = np.loadtxt(out / "trajectory.txt")
    assert rows.shape[1] == 8 and len(rows) >= 15
    est = [(float(t), np.array([x, y, z])) for t, x, y, z, *_ in rows]
    ate = synthetic.ate_rmse(est, seq.gt)
    assert ate < 0.08, f"bag->convert->run ATE {ate:.3f} m"

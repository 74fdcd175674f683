"""The port's outputs against the JAX package: the exporters (byte-
identical files), the TSDF integration and mesh extraction, the
per-point colouring and IMU-rate odometry, and a short LIVO run with
every output flag on.

Tolerances, each with its reason:
- writers, readers, mesh extraction from one volume: exact (the same
  host numpy code on the same arrays);
- tsdf.integrate: weights exact (every ray sample lands in the same
  voxel), tsdf rtol 1e-6 plus 1e-6 absolute: the ray offsets come from
  jnp.linspace, which XLA evaluates a rounding off numpy's formula (its
  middle offset comes out 2^-27 instead of 0, and its jitted and eager
  forms disagree with each other too);
- colorize_points, imu_rate_odometry: tests/test_imu.py's rtol 2e-4 /
  atol 2e-5 (float32 in another evaluation order);
- the LIVO run: the golden tolerances, 8e-3 m and 4e-3 (rotation
  entries; 0.23 degrees for the traced Euler angles), as the trajectory
  test of tests/test_torch_vio.py.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.core import imu as jimu
from fast_livo2_tpu.core import state as jstate
from fast_livo2_tpu.core import vio as jvio
from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu.io import export as jexp
from fast_livo2_tpu.io import tsdf as jtsdf
from fast_livo2_tpu.models import camera as jcam
from fast_livo2_tpu.utils.config import CameraConfig as JaxCameraConfig
from fast_livo2_tpu.utils.config import LIVOConfig as JaxConfig
from fast_livo2_tpu_torch.core import imu as timu
from fast_livo2_tpu_torch.core import state as tstate
from fast_livo2_tpu_torch.core import vio as tvio
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import export as texp
from fast_livo2_tpu_torch.io import synthetic
from fast_livo2_tpu_torch.io import tsdf as ttsdf
from fast_livo2_tpu_torch.models import camera as tcam
from fast_livo2_tpu_torch.utils.config import CameraConfig, LIVOConfig
from tests.test_torch_vio import livo_config, one_torch_thread  # noqa: F401

POS_TOL_M, ROT_TOL = 8e-3, 4e-3
RTOL, ATOL = 2e-4, 2e-5  # tests/test_imu.py


def _rot(w):
    """Rodrigues' formula in float64 numpy."""
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _writer_cases(rng):
    traj = [(0.1 * i, _rot(rng.normal(size=3) * 0.8), rng.normal(size=3))
            for i in range(12)]
    # include a rotation with a negative trace (the quaternion's pivot branch)
    traj.append((2.0, np.diag([1.0, -1.0, -1.0]), np.zeros(3)))
    pts = rng.normal(size=(500, 3)).astype(np.float32) * 5
    rgb = rng.integers(0, 256, (500, 3)).astype(np.uint8)
    inten = rng.uniform(0, 100, 500).astype(np.float32)
    gray = rng.integers(0, 256, (24, 40)).astype(np.uint8)
    cam_kw = dict(cam_model="Pinhole", cam_width=320, cam_height=256,
                  cam_fx=200.5, cam_fy=201.25, cam_cx=160.0, cam_cy=128.0)
    frames = [(i + 1, R, p, f"{i:05d}.png") for i, (_, R, p) in enumerate(traj)]
    return {
        "tum": lambda m, p: m.write_tum(p, traj),
        "pcd_binary_xyz": lambda m, p: m.write_pcd(p, pts),
        "pcd_binary_rgb": lambda m, p: m.write_pcd(p, pts, colors=rgb),
        "pcd_ascii_rgb": lambda m, p: m.write_pcd(p, pts, colors=rgb,
                                                  binary=False),
        "pcd_ascii_intensity": lambda m, p: m.write_pcd(p, pts, intensity=inten,
                                                        binary=False),
        "png_gray": lambda m, p: m.write_png(p, gray),
        "png_rgb_float": lambda m, p: m.write_png(
            p, np.repeat(gray[:, :, None] * 1.7, 3, axis=-1)),
        "colmap": lambda m, p: m.write_colmap(
            p, (jcam.make_camera(JaxCameraConfig(**cam_kw)) if m is jexp
                else tcam.make_camera(CameraConfig(**cam_kw))),
            frames, points3d=pts[:40], colors=rgb[:40]),
    }


WRITERS = ["tum", "pcd_binary_xyz", "pcd_binary_rgb", "pcd_ascii_rgb",
           "pcd_ascii_intensity", "png_gray", "png_rgb_float", "colmap"]


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("name", WRITERS)
def test_writers_byte_identical_to_jax(tmp_path, name):
    rng = np.random.default_rng(1)
    cases = _writer_cases(rng)
    written = {}
    for tag, mod in (("jax", jexp), ("port", texp)):
        root = tmp_path / tag
        root.mkdir()
        target = str(root) if name == "colmap" else str(root / "out")
        cases[name](mod, target)
        written[tag] = _files(root)
    assert written["jax"] and written["jax"] == written["port"]
    if name.startswith("pcd"):  # the readers agree on the file too
        path = str(tmp_path / "jax" / "out")
        for a, b in zip(jexp.read_pcd(path), texp.read_pcd(path)):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a, b)
    if name == "tum":
        path = str(tmp_path / "jax" / "out")
        for (t0, R0, p0), (t1, R1, p1) in zip(jexp.read_tum(path),
                                              texp.read_tum(path)):
            assert t0 == t1
            np.testing.assert_array_equal(R0, R1)
            np.testing.assert_array_equal(p0, p1)


@pytest.fixture(scope="module")
def volumes():
    """One wavy-surface cloud seen from one sensor position, fused twice
    into a 64^3 volume by each package (10 % of the points masked)."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, (3000, 3)).astype(np.float32)
    pts[:, 2] = (0.3 * np.sin(pts[:, 0]) + 0.2 * np.cos(pts[:, 1])).astype(np.float32)
    sensor = np.array([0.1, -0.2, 1.5], np.float32)
    valid = rng.random(len(pts)) > 0.1
    center = 0.5 * (pts.min(0) + pts.max(0))
    side = float((pts.max(0) - pts.min(0)).max()) * 1.1 + 1e-3
    jv = jtsdf.make_volume(center, side, grid=64)
    tv = ttsdf.make_volume(center, side, grid=64, device="cpu")
    for _ in range(2):
        jv = jtsdf.integrate(jv, jnp.asarray(pts), jnp.asarray(valid),
                             jnp.asarray(sensor))
        tv = ttsdf.integrate(tv, torch.from_numpy(pts), torch.from_numpy(valid),
                             torch.from_numpy(sensor))
    return jv, tv, pts


def test_tsdf_integrate_matches_jax(volumes):
    jv, tv, _ = volumes
    assert tv.voxel == jv.voxel and tv.trunc == jv.trunc
    np.testing.assert_array_equal(tv.origin.numpy(), np.asarray(jv.origin))
    jw = np.asarray(jv.weight)
    assert (jw > 0).sum() > 5000
    np.testing.assert_array_equal(tv.weight.numpy(), jw)
    np.testing.assert_allclose(tv.tsdf.numpy(), np.asarray(jv.tsdf),
                               rtol=1e-6, atol=1e-6)


def test_extract_mesh_identical_from_one_volume(volumes, tmp_path):
    """The port's host extraction on the JAX volume: the same vertices,
    faces, surfels, vertex colours and PLY bytes (mesh and surfels)."""
    jv, _, pts = volumes
    tv = ttsdf.TSDFVolume(tsdf=torch.from_numpy(np.array(jv.tsdf)),
                          weight=torch.from_numpy(np.array(jv.weight)),
                          origin=torch.from_numpy(np.array(jv.origin)),
                          voxel=jv.voxel, trunc=jv.trunc)
    v_j, f_j = jtsdf.extract_mesh(jv)
    v_t, f_t = ttsdf.extract_mesh(tv)
    assert len(f_j) > 1000
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(f_t, f_j)
    for a, b in zip(ttsdf.extract_surface(tv), jtsdf.extract_surface(jv)):
        np.testing.assert_array_equal(a, b)
    rgb = np.random.default_rng(2).integers(0, 256, (len(pts), 3)).astype(np.uint8)
    c_j = jtsdf.colorize_vertices(v_j, pts, rgb)
    np.testing.assert_array_equal(ttsdf.colorize_vertices(v_t, pts, rgb), c_j)
    jtsdf.write_ply_mesh(str(tmp_path / "j.ply"), v_j, f_j, c_j)
    ttsdf.write_ply_mesh(str(tmp_path / "t.ply"), v_t, f_t, c_j)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    surf, nrm = jtsdf.extract_surface(jv)
    jtsdf.write_ply(str(tmp_path / "js.ply"), surf, nrm)
    ttsdf.write_ply(str(tmp_path / "ts.ply"), surf, nrm)
    assert (tmp_path / "js.ply").read_bytes() == (tmp_path / "ts.ply").read_bytes()


def _random_state(rng):
    R = _rot(rng.normal(size=3) * 0.3).astype(np.float32)
    return dict(rot=R, pos=rng.normal(size=3).astype(np.float32),
                vel=rng.normal(size=3).astype(np.float32),
                bias_g=(rng.normal(size=3) * 0.01).astype(np.float32),
                bias_a=(rng.normal(size=3) * 0.05).astype(np.float32),
                grav=np.array([0.0, 0.0, -9.81], np.float32),
                inv_expo=np.float32(1.05))


def test_colorize_points_matches_jax():
    cfg = livo_config(LIVOConfig)
    cam_t = tcam.make_camera(cfg.camera)
    cam_j = jcam.make_camera(livo_config(JaxConfig).camera)
    rng = np.random.default_rng(3)
    img = (rng.random((256, 320)) * 255).astype(np.float32)
    st = _random_state(rng)
    st["rot"] = np.eye(3, dtype=np.float32)
    st["pos"] = np.zeros(3, np.float32)
    # points ahead of the forward-mounted camera (+x body), some behind
    pts = np.stack([rng.uniform(-2, 8, 2000), rng.uniform(-4, 4, 2000),
                    rng.uniform(-3, 3, 2000)], -1).astype(np.float32)
    valid = rng.random(2000) > 0.05
    Rci = synthetic.R_CI_FORWARD.astype(np.float32)
    Pci = np.array([0.02, -0.01, 0.03], np.float32)
    c_j, v_j = jvio.colorize_points(
        jnp.asarray(img), jnp.asarray(pts), jnp.asarray(valid),
        jstate.NavState(**{k: jnp.asarray(v) for k, v in st.items()}),
        cam_j, jnp.asarray(Rci), jnp.asarray(Pci), blind=0.5)
    c_t, v_t = tvio.colorize_points(
        torch.from_numpy(img), torch.from_numpy(pts), torch.from_numpy(valid),
        tstate.NavState(**{k: torch.as_tensor(v) for k, v in st.items()}),
        cam_t, torch.from_numpy(Rci), torch.from_numpy(Pci), blind=0.5)
    v_j = np.asarray(v_j)
    assert 200 < v_j.sum() < 2000
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=RTOL, atol=ATOL)


def test_imu_rate_odometry_matches_jax():
    rng = np.random.default_rng(4)
    st = _random_state(rng)
    stamps = 10.0 + np.arange(30) * 0.005
    gyr = rng.normal(size=(30, 3)) * 0.5
    acc = rng.normal(size=(30, 3)) + np.array([0.0, 0.0, 9.7])
    b = timu.prepare_imu_batch(stamps, gyr, acc, 10.002, 10.12, 64)
    noise_kw = dict(mean_acc_norm=9.7)
    out_j = jimu.imu_rate_odometry(
        jstate.NavState(**{k: jnp.asarray(v) for k, v in st.items()}),
        jimu.ImuBatch(*(jnp.asarray(x) for x in b)), jimu.make_noise(**noise_kw))
    out_t = timu.imu_rate_odometry(
        tstate.NavState(**{k: torch.as_tensor(v) for k, v in st.items()}),
        timu.batch_to_device(b, "cpu"), timu.make_noise(**noise_kw, device="cpu"))
    for name, a, j in zip(("offs_end", "R", "p", "v", "valid"), out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _flags(cfg):
    cfg.pcd_save.pcd_save_en = True
    cfg.publish.pub_effect_point_en = True
    cfg.evo.pose_output_en = True
    cfg.uav.imu_rate_odom = True
    return cfg


@pytest.fixture(scope="module")
def livo_runs(tmp_path_factory):
    """A 1.2 s LIVO sequence through both pipelines with every output
    flag on, and each package's files."""
    cam = tcam.make_camera(livo_config(LIVOConfig).camera)
    seq = synthetic.make_sequence(
        duration=1.2, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0, cam=cam,
        seed=0, n_lines=12, n_per_line=500, render=True, fov_deg=360.0)
    out = tmp_path_factory.mktemp("livo_outputs")
    runs = {}
    for tag, pipe in (("jax", JaxPipeline(_flags(livo_config(JaxConfig)),
                                          slam_mode="livo")),
                      ("port", LIVOPipeline(_flags(livo_config(LIVOConfig)),
                                            slam_mode="livo", device="cpu"))):
        traj = pipe.process(seq)
        d = out / tag
        d.mkdir()
        res = dict(traj=traj, pipe=pipe, dir=d,
                   pcd=pipe.save_pcd(str(d / "cloud.pcd")),
                   effect=pipe.effect_points(),
                   images=pipe.save_images(str(d / "images")))
        pipe.save_state_traces(str(d / "pre.txt"), str(d / "post.txt"))
        pipe.export_colmap(str(d / "colmap"))
        runs[tag] = res
    return seq, runs


def test_livo_outputs_match_jax(livo_runs):
    seq, runs = livo_runs
    J, T = runs["jax"], runs["port"]
    assert [t for t, _, _ in T["traj"]] == [t for t, _, _ in J["traj"]]
    assert len(T["traj"]) >= 9
    # the coloured cloud: every kept (visible) point of every VIO frame
    assert T["pcd"] > 3000
    assert abs(T["pcd"] - J["pcd"]) <= 1e-3 * J["pcd"], (T["pcd"], J["pcd"])
    pts_t, rgb_t, _ = texp.read_pcd(str(T["dir"] / "cloud.pcd"))
    assert rgb_t is not None and len(pts_t) == T["pcd"]
    # effect points: per frame, the plane-matched points
    assert [t for t, _ in T["effect"]] == [t for t, _ in J["effect"]]
    for (_, a), (_, b) in zip(T["effect"], J["effect"]):
        assert len(a) > 100
        assert abs(len(a) - len(b)) <= 0.01 * len(b)
    # state traces: one row per frame before and after the update
    for name in ("pre.txt", "post.txt"):
        a = np.loadtxt(T["dir"] / name)
        b = np.loadtxt(J["dir"] / name)
        assert a.shape == b.shape == (len(T["traj"]), 17)
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], atol=np.degrees(ROT_TOL))
        np.testing.assert_allclose(a[:, 4:7], b[:, 4:7], atol=POS_TOL_M)
    # IMU-rate poses between the updates, at IMU sample times
    ir_t, ir_j = T["pipe"].imu_rate_trajectory, J["pipe"].imu_rate_trajectory
    assert len(ir_t) > 10 * (len(T["traj"]) - 1)
    assert [t for t, _, _ in ir_t] == pytest.approx([t for t, _, _ in ir_j],
                                                    abs=1e-9)
    np.testing.assert_allclose(np.array([p for _, _, p in ir_t]),
                               np.array([p for _, _, p in ir_j]), atol=POS_TOL_M)
    np.testing.assert_allclose(np.array([R for _, R, _ in ir_t]),
                               np.array([R for _, R, _ in ir_j]), atol=ROT_TOL)
    # the ring dump and the COLMAP model: one PNG / image line per frame
    assert len(T["images"]) == len(J["images"]) > 0
    assert [os.path.basename(p) for p in T["images"]] == [
        os.path.basename(p) for p in J["images"]]
    for d in (T, J):
        lines = (d["dir"] / "colmap" / "sparse" / "0" / "images.txt").read_text()
        assert len(lines.splitlines()) == 3 + 2 * len(T["traj"])

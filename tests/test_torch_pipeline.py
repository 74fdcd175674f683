"""The port's ONLY_LIO pipeline on the CPU: the committed golden trajectory,
both points wire formats, and the modes and flags the port does not
have yet (the output flags it has).

Tolerances of the golden (tests/test_golden_trace.py): timestamps 1e-6 s,
positions 8e-3 m, rotation entries 4e-3 — cross-backend float noise over
22 frames of an iterated filter, far below what a logic change moves.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu.utils.config import LIVOConfig as JaxConfig
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import synthetic
from fast_livo2_tpu_torch.parallel.sharding import Mesh
from fast_livo2_tpu_torch.utils.config import LIVOConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "lio_traj.npz")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The pipeline runs thousands of small ops a frame; with the suite's
    parallel workers each holding a full intra-op thread pool, the pools
    oversubscribe the cores and a 3 s run takes minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_config(cls=LIVOConfig):
    """tests/test_pipeline_lio.py's small_config, for either package."""
    cfg = cls()
    cfg.tpu.max_points_per_scan = 8192
    cfg.tpu.max_points_down = 4096
    cfg.tpu.hash_capacity_log2 = 15
    cfg.lio.max_layer = 1
    cfg.preprocess.filter_size_surf = 0.15
    return cfg


def test_port_reproduces_golden_trajectory():
    """tests/test_golden_trace.py's sequence and config on the port."""
    seq = synthetic.make_sequence(
        duration=2.4, lidar_hz=10.0, imu_hz=200.0, seed=7,
        n_lines=12, n_per_line=500, render=False, fov_deg=360.0)
    pipe = LIVOPipeline(small_config(), slam_mode="only_lio", device="cpu")
    traj = pipe.process(seq)
    g = np.load(GOLDEN)
    np.testing.assert_allclose([t for t, _, _ in traj], g["ts"], atol=1e-6)
    np.testing.assert_allclose(np.array([p for _, _, p in traj]), g["ps"],
                               atol=8e-3)
    np.testing.assert_allclose(np.array([R for _, R, _ in traj]), g["Rs"],
                               atol=4e-3)
    assert all(r["n_eff"] > 0 for r in pipe.log.rows[1:])


def _pipes_with_one_scan(wire_q16):
    """The port and the JAX pipeline, each holding the same pushed scan."""
    rng = np.random.default_rng(9)
    pts = rng.uniform(-15, 15, size=(3000, 3)).astype(np.float32)
    offs = np.sort(rng.uniform(0, 0.1, size=3000)).astype(np.float32)
    out = []
    for cls, cfg_cls, kw in ((LIVOPipeline, LIVOConfig, dict(device="cpu")),
                             (JaxPipeline, JaxConfig, {})):
        cfg = small_config(cfg_cls)
        cfg.tpu.wire_q16 = wire_q16
        p = cls(cfg, slam_mode="only_lo", **kw)
        p.last_update_time = 10.0
        p.push_scan(10.0, pts, offs)
        out.append(p)
    return out, pts, offs


@pytest.mark.parametrize("wire_q16", [False, True], ids=["f32", "q16"])
def test_points_wire_round_trip(wire_q16):
    """_prepare_packet -> _unpack_pts: both packages build the same packet
    bytes and decode them to the same points; q16 stays within half a
    quantization step of the input."""
    (tp, jp), pts, offs = _pipes_with_one_scan(wire_q16)
    t_end = 10.0 + float(offs[-1])
    _, t_pack = tp._prepare_packet(t_end, None)
    _, j_pack = jp._prepare_packet(t_end, None)
    np.testing.assert_array_equal(t_pack.numpy(), np.asarray(j_pack))
    t_pts, t_offs, t_valid = tp._unpack_pts(t_pack)
    j_pts, j_offs, j_valid = jp._unpack_pts(jnp.asarray(np.asarray(j_pack)))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_pts.numpy(), np.asarray(j_pts))
    np.testing.assert_allclose(t_offs.numpy(), np.asarray(j_offs), rtol=1e-7)
    n = len(pts)
    assert t_valid.numpy()[:n].all() and not t_valid.numpy()[n:].any()
    if wire_q16:
        assert t_pack.dtype == torch.int16
        scale = np.abs(pts).max() / 32766.0
        np.testing.assert_allclose(t_pts.numpy()[:n], pts, atol=0.51 * scale)
        # half a uint16 step of the packet duration, plus one float32 ulp
        # of the absolute stamps (push_scan keeps t_begin + offs at the
        # offsets' float32 precision: 9.5e-7 s at t = 10 s)
        np.testing.assert_allclose(
            t_offs.numpy()[:n], offs,
            atol=0.51 * float(offs[-1]) / 65535 + np.spacing(np.float32(10.0)))
    else:
        np.testing.assert_array_equal(t_pts.numpy()[:n], pts)


def test_unported_modes_and_flags_raise():
    """Every flag and mode of the JAX package constructs and runs on the
    port, keyframe sharding (`mesh=`) included. An unknown mode is a
    ValueError."""
    from tests.test_torch_vio import livo_config

    seq = None
    for form in (None, "fused_frame", "stage_timing"):  # split, fused, staged
        cfg = livo_config(LIVOConfig)
        cfg.vio.raycast_en = cfg.vio.inverse_composition_en = True
        if form:
            setattr(cfg.tpu, form, True)
        pipe = LIVOPipeline(cfg, slam_mode="livo", device="cpu")
        assert pipe._ray_table is not None
        if seq is None:
            seq = synthetic.make_sequence(
                duration=1.0, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0,
                cam=pipe.cam, seed=3, n_lines=6, n_per_line=300,
                render=True, fov_deg=40.0)
        traj = pipe.process(seq, max_frames=4)
        assert len(traj) == 4 and pipe.photo_iterations > 0, form
    for section, flag in (("pcd_save", "pcd_save_en"),
                          ("publish", "pub_effect_point_en"),
                          ("uav", "imu_rate_odom"), ("evo", "pose_output_en")):
        cfg = small_config()  # the outputs are ported
        setattr(getattr(cfg, section), flag, True)
        LIVOPipeline(cfg, slam_mode="only_lio", device="cpu")
    for flag in ("stage_timing", "fused_frame"):  # ported: every mode
        for mode in LIVOPipeline.SLAM_MODES:
            cfg = small_config()
            setattr(cfg.tpu, flag, True)
            LIVOPipeline(cfg, slam_mode=mode, device="cpu")
    pipe = LIVOPipeline(small_config(), slam_mode="only_lio", device="cpu")
    pipe.enable_online_refine()  # the backend is ported
    assert pipe.online_refine and pipe.keyframe_every == 10
    mesh = Mesh(None, 0, 1, "kf", torch.device("cpu"))  # keyframe sharding
    pipe.enable_online_refine(mesh=mesh)
    assert pipe._refiner.mesh is mesh
    with pytest.raises(ValueError):
        LIVOPipeline(small_config(), slam_mode="vio", device="cpu")

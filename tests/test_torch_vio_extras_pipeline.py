"""The VIO extras through the port's LIVO pipeline on the CPU: the JAX
package's pipeline gates for raycast recovery and the inverse-
compositional update (tests/test_pipeline_livo.py:129-187) unchanged on
the port, each port run's ATE within 8e-3 m of the JAX run's on the same
sequence (ROADMAP.md item 10b's bound, the golden trajectory tolerance),
and the fused frame bit for bit the split frame with both flags on.

The sequences are made by the port's io/synthetic (a copy of the JAX
package's) and given to both pipelines.
"""

import numpy as np
import pytest

from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu.utils.config import LIVOConfig as JaxConfig
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import synthetic
from fast_livo2_tpu_torch.models import camera as tcam
from fast_livo2_tpu_torch.utils.config import LIVOConfig
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401
from tests.test_torch_vio import livo_config

ATE_VS_JAX_M = 8e-3


def _fisheye(cfg):
    cfg.camera.cam_model = "equidistant"
    cfg.camera.k1, cfg.camera.k2 = -0.04, 0.01
    cfg.camera.k3, cfg.camera.k4 = -0.002, 0.0003
    return cfg


def _config(cls, flags, fisheye=False):
    cfg = livo_config(cls)
    if fisheye:
        _fisheye(cfg)
    for f in flags:
        setattr(cfg.vio, f, True)
    return cfg


def _sequence(cfg, **kw):
    cam = tcam.make_camera(cfg.camera)
    return synthetic.make_sequence(lidar_hz=10.0, img_hz=10.0, imu_hz=200.0,
                                   cam=cam, render=True, **kw)


def _ate(traj, seq):
    return synthetic.ate_rmse([(t, p) for t, _, p in traj], seq.gt)


def _both(seq, flags, fisheye=False):
    """The port's and the JAX package's runs of one configuration:
    (port trajectory, port pipeline, JAX ATE)."""
    pipe = LIVOPipeline(_config(LIVOConfig, flags, fisheye), "livo",
                        device="cpu")
    traj = pipe.process(seq)
    jtraj = JaxPipeline(_config(JaxConfig, flags, fisheye),
                        slam_mode="livo").process(seq)
    assert [t for t, _, _ in traj] == [t for t, _, _ in jtraj]
    return traj, pipe, _ate(jtraj, seq)


@pytest.fixture(scope="module")
def raycast_seq():
    """tests/test_pipeline_livo.py:132's narrow-FOV scan + wide camera."""
    return _sequence(livo_config(LIVOConfig), duration=1.6, seed=3,
                     n_lines=10, n_per_line=400, fov_deg=40.0)


def test_livo_with_raycast_runs(raycast_seq):
    traj, _, j_ate = _both(raycast_seq, ("raycast_en",))
    assert len(traj) >= 8
    p = np.array([p for _, _, p in traj])
    assert np.isfinite(p).all() and np.abs(p).max() < 10
    assert abs(_ate(traj, raycast_seq) - j_ate) < ATE_VS_JAX_M


def test_livo_fisheye_end_to_end():
    """The equidistant fisheye (config/camera_fisheye_HILTI22.yaml's
    model) with raycast on."""
    cfg = _config(LIVOConfig, (), fisheye=True)
    seq = _sequence(cfg, duration=2.5, seed=9, n_lines=12, n_per_line=500,
                    fov_deg=360.0)
    traj, pipe, j_ate = _both(seq, ("raycast_en",), fisheye=True)
    assert len(traj) >= 15
    rmse = _ate(traj, seq)
    assert rmse < 0.06, f"fisheye LIVO ATE {rmse:.3f} m"
    tracked = [r.get("n_tracked", 0) for r in pipe.log.rows[3:]]
    assert np.mean(tracked) > 20, f"fisheye tracked {np.mean(tracked):.0f}"
    assert abs(rmse - j_ate) < ATE_VS_JAX_M, (rmse, j_ate)


def test_livo_inverse_composition_variant():
    seq = _sequence(livo_config(LIVOConfig), duration=2.0, seed=6,
                    n_lines=12, n_per_line=500, fov_deg=360.0)
    traj, pipe, j_ate = _both(seq, ("inverse_composition_en",))
    rmse = _ate(traj, seq)
    assert rmse < 0.08, f"IC ATE {rmse:.3f}"
    tracked = [r.get("n_tracked", 0) for r in pipe.log.rows[3:]]
    assert np.mean(tracked) > 20
    assert pipe.photo_iterations > 0
    assert abs(rmse - j_ate) < ATE_VS_JAX_M, (rmse, j_ate)


def test_fused_frame_equals_split_with_extras(raycast_seq):
    """With raycast and the IC update on, the fused frame (the function a
    CUDA graph captures on the card, with the device loops) gives the
    split frame's trajectory bit for bit over the first 8 frames."""
    flags = ("raycast_en", "inverse_composition_en")
    runs = []
    for fused in (False, True):
        cfg = _config(LIVOConfig, flags)
        cfg.tpu.fused_frame = fused
        pipe = LIVOPipeline(cfg, "livo", device="cpu")
        runs.append((pipe.process(raycast_seq, max_frames=8), pipe))
    (split, ps), (fused, pf) = runs
    assert len(split) == len(fused) == 8
    for (t0, R0, p0), (t1, R1, p1) in zip(split, fused):
        assert t0 == t1
        np.testing.assert_array_equal(R1, R0)
        np.testing.assert_array_equal(p1, p0)
    assert ([r["n_tracked"] for r in ps.log.rows]
            == [r["n_tracked"] for r in pf.log.rows])
    assert ps.photo_iterations == pf.photo_iterations > 0

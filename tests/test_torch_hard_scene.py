"""tests/test_hard_scene.py's two ATE gates on the port (ROADMAP item
10's done-gate), on the CPU: the hard scene (non-planar clutter,
occlusions, ~3.5 m/s motion with a 7° initial tilt, an exposure ramp)
over 3 s, LIVO and ONLY_LIO, each under the JAX test's gate (< 0.03 m)
and within 8e-3 m / 4e-3 of the JAX run on the same sequence
(tests/test_golden_trace.py's tolerances). The sequence is made once by
the port's io/synthetic and fed to both packages.
"""

import numpy as np
import pytest
import torch

from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu.utils.config import LIVOConfig as JaxConfig
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import synthetic
from fast_livo2_tpu_torch.models import camera as cam_mod
from fast_livo2_tpu_torch.utils.config import CameraConfig, LIVOConfig

POS_TOL_M, ROT_TOL = 8e-3, 4e-3
ATE_GATE_M = 0.03  # tests/test_hard_scene.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cam_cfg():
    return CameraConfig(cam_model="Pinhole", cam_width=320, cam_height=256,
                        scale=1.0, cam_fx=200.0, cam_fy=200.0, cam_cx=160.0,
                        cam_cy=128.0)


def hard_config(cls, camera=True):
    """tests/test_hard_scene.py's hard_config, for either package."""
    cfg = cls()
    if camera:
        cfg.camera = cam_cfg()
        cfg.extrin_calib.Rcl = list(synthetic.R_CI_FORWARD.reshape(-1))
        cfg.extrin_calib.Pcl = [0.0, 0.0, 0.0]
        cfg.tpu.vis_point_capacity = 8192
        cfg.tpu.frame_ring = 32
        cfg.vio.patch_pyrimid_level = 3
    cfg.tpu.max_points_per_scan = 8192
    cfg.tpu.max_points_down = 4096
    cfg.tpu.hash_capacity_log2 = 15
    cfg.lio.max_layer = 1
    cfg.preprocess.filter_size_surf = 0.15
    return cfg


@pytest.fixture(scope="module")
def hard_seq():
    return synthetic.make_sequence(
        duration=3.0, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0,
        cam=cam_mod.make_camera(cam_cfg()), seed=7, n_lines=12,
        n_per_line=500, render=True, fov_deg=360.0,
        planes=synthetic.hard_scene(), traj=synthetic.hard_trajectory(),
        exposure_fn=lambda t: 1.0 + 0.25 * np.sin(0.8 * t))


@pytest.mark.parametrize("mode", ["livo", "only_lio"])
def test_hard_scene_under_3cm_and_matches_jax(hard_seq, mode):
    camera = mode == "livo"
    traj = LIVOPipeline(hard_config(LIVOConfig, camera), slam_mode=mode,
                        device="cpu").process(hard_seq)
    assert len(traj) >= 20
    rmse = synthetic.ate_rmse([(t, p) for t, _, p in traj], hard_seq.gt)
    assert rmse < ATE_GATE_M, f"hard-scene {mode} ATE {rmse:.4f} m"
    jtraj = JaxPipeline(hard_config(JaxConfig, camera),
                        slam_mode=mode).process(hard_seq)
    assert [t for t, _, _ in traj] == [t for t, _, _ in jtraj]
    np.testing.assert_allclose(np.array([p for _, _, p in traj]),
                               np.array([p for _, _, p in jtraj]),
                               atol=POS_TOL_M)
    np.testing.assert_allclose(np.array([R for _, R, _ in traj]),
                               np.array([R for _, R, _ in jtraj]),
                               atol=ROT_TOL)

"""tests/test_configs_load.py on the port: every shipped config pair loads
through the reference YAML schema and builds a port LIVOPipeline on the
CPU, with the same asserts. Also two of the JAX package's scenario tests
(tests/test_pipeline_livo.py) on the port, each held to its JAX gates
and to the JAX run: the fisheye LIVO run with raycast off (ATE < 0.06 m,
tracked > 20; within 8e-3 m / 4e-3 of the JAX run on the same sequence)
and gravity alignment at IMU init (the JAX asserts; rotation and gravity
within 1e-5 of the JAX package's)."""

import numpy as np
import pytest

from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu.utils.config import LIVOConfig as JaxConfig
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import synthetic
from fast_livo2_tpu_torch.models import camera as cam_mod
from fast_livo2_tpu_torch.utils.config import (CameraConfig, LIVOConfig,
                                               load_config)
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

PAIRS = [
    ("configs/avia.yaml", "configs/camera_pinhole.yaml"),
    ("configs/ntu_viral.yaml", "configs/camera_ntu_viral.yaml"),
    ("configs/hilti22.yaml", "configs/camera_fisheye_hilti22.yaml"),
    ("configs/mars_lvig.yaml", "configs/camera_mars_lvig.yaml"),
]
POS_TOL_M, ROT_TOL = 8e-3, 4e-3  # tests/test_golden_trace.py


@pytest.mark.parametrize("sensor,camera", PAIRS)
def test_config_pair_builds_pipeline(sensor, camera):
    cfg = load_config(sensor, camera)
    # shrink capacities so construction is cheap on CPU
    cfg.tpu.max_points_per_scan = 1024
    cfg.tpu.max_points_down = 512
    cfg.tpu.hash_capacity_log2 = 10
    cfg.tpu.vis_point_capacity = 512
    cfg.tpu.frame_ring = 4
    pipe = LIVOPipeline(cfg, slam_mode="livo", device="cpu")
    assert pipe.cam.width > 0 and pipe.cam.height > 0
    if "hilti" in sensor:
        assert pipe.cam.model == "equidistant"
        assert cfg.preprocess.hilti_en
        # reference config/HILTI22.yaml:46: raycast off, pyramid 4
        assert not cfg.vio.raycast_en
        assert cfg.vio.patch_pyrimid_level == 4
        assert cfg.lio.voxel_size == 0.4 and cfg.lio.max_points_num == 100
    if "ntu_viral" in sensor:
        assert cfg.time_offset.lidar_time_offset == -0.1
        assert cfg.preprocess.lidar_type == 3
        assert cfg.preprocess.point_filter_num == 3
        assert cfg.camera.cam_width == 752  # the reference's left camera
    if "mars" in sensor:
        assert cfg.lio.voxel_size >= 1.0  # aerial big-voxel setup
        # reference config/MARS_LVIG.yaml: sliding off, layer depth 2,
        # quarter-res camera
        assert not cfg.local_map.map_sliding_en
        assert cfg.lio.max_layer == 2
        assert cfg.camera.scale == 0.25


def livo_config(cls):
    """tests/test_pipeline_livo.py's livo_config, for either package."""
    cfg = cls()
    cfg.camera = CameraConfig(cam_model="Pinhole", cam_width=320,
                              cam_height=256, scale=1.0, cam_fx=200.0,
                              cam_fy=200.0, cam_cx=160.0, cam_cy=128.0)
    cfg.extrin_calib.Rcl = list(synthetic.R_CI_FORWARD.reshape(-1))
    cfg.extrin_calib.Pcl = [0.0, 0.0, 0.0]
    cfg.tpu.max_points_per_scan = 8192
    cfg.tpu.max_points_down = 4096
    cfg.tpu.hash_capacity_log2 = 15
    cfg.tpu.vis_point_capacity = 8192
    cfg.tpu.frame_ring = 32
    cfg.lio.max_layer = 1
    cfg.preprocess.filter_size_surf = 0.15
    cfg.vio.patch_pyrimid_level = 3
    return cfg


def fisheye_config(cls):
    """test_livo_fisheye_end_to_end's camera, with raycast off."""
    cfg = livo_config(cls)
    cfg.camera.cam_model = "equidistant"
    cfg.camera.k1, cfg.camera.k2 = -0.04, 0.01
    cfg.camera.k3, cfg.camera.k4 = -0.002, 0.0003
    cfg.vio.raycast_en = False
    return cfg


def test_livo_fisheye_raycast_off_matches_jax():
    """The scan is 16 x 750 points: at 12 x 500 this run is chaotic at the
    tolerance, the JAX package against itself with every scan point moved
    by one float32 ulp parting by 9.8 mm (> 8 mm); at 16 x 750 by 1.9 mm,
    and the port from the JAX run by 1.2 mm."""
    cfg = fisheye_config(LIVOConfig)
    seq = synthetic.make_sequence(
        duration=2.5, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0,
        cam=cam_mod.make_camera(cfg.camera), seed=9, n_lines=16,
        n_per_line=750, render=True, fov_deg=360.0)
    pipe = LIVOPipeline(cfg, slam_mode="livo", device="cpu")
    traj = pipe.process(seq)
    assert len(traj) >= 15
    rmse = synthetic.ate_rmse([(t, p) for t, _, p in traj], seq.gt)
    assert rmse < 0.06, f"fisheye LIVO ATE {rmse:.3f} m"
    tracked = [r.get("n_tracked", 0) for r in pipe.log.rows[3:]]
    assert np.mean(tracked) > 20, f"fisheye tracked {np.mean(tracked):.0f}"
    jtraj = JaxPipeline(fisheye_config(JaxConfig), slam_mode="livo").process(seq)
    assert [t for t, _, _ in traj] == [t for t, _, _ in jtraj]
    np.testing.assert_allclose(np.array([p for _, _, p in traj]),
                               np.array([p for _, _, p in jtraj]),
                               atol=POS_TOL_M)
    np.testing.assert_allclose(np.array([R for _, R, _ in traj]),
                               np.array([R for _, R, _ in jtraj]),
                               atol=ROT_TOL)


class _TiltedImu:
    """test_gravity_alignment's IMU: the device rolled 10 degrees, still."""
    imu_stamps = np.arange(100) / 200.0
    imu_acc = np.tile([0.0, np.sin(0.17) * 9.81, np.cos(0.17) * 9.81],
                      (100, 1))
    imu_gyr = np.zeros((100, 3))


def test_gravity_alignment_matches_jax():
    out = []
    for cls, cfg_cls, kw in ((LIVOPipeline, LIVOConfig, dict(device="cpu")),
                             (JaxPipeline, JaxConfig, {})):
        cfg = livo_config(cfg_cls)
        cfg.uav.gravity_align_en = True
        pipe = cls(cfg, slam_mode="only_lio", **kw)
        assert pipe._init_imu(_TiltedImu(), 0.6)
        rot, grav = np.asarray(pipe.state.rot), np.asarray(pipe.state.grav)
        g_world = rot @ np.array([0, np.sin(0.17), np.cos(0.17)]) * 9.81
        np.testing.assert_allclose(g_world, [0, 0, 9.81], atol=1e-2)
        np.testing.assert_allclose(grav, [0, 0, -9.81], atol=1e-4)
        out.append((rot, grav))
    (rot, grav), (jrot, jgrav) = out
    np.testing.assert_allclose(rot, jrot, atol=1e-5)
    np.testing.assert_allclose(grav, jgrav, atol=1e-5)

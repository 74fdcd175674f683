"""Strided level-0 against true-pyramid sampling on the port, on the CPU:
tests/test_pyramid_ab.py's three cases with their gates unchanged.

The reference's photometric update samples the raw level-0 image with
scale-strided pointers (vio.cpp:1596-1627), and the JAX test pins that
this strided sampling does not alias away accuracy on sensor-realistic
imagery (the hard scene with high-frequency texture, photon and read
noise and optical blur), and that the anti-aliased option
(tpu.true_pyramid, ops/image.box_stack) converges as well. Here the
port's `box_stack` reproduces the halfSample pyramid and the port's LIVO
runs hold the same ATE and tracking gates.
"""

import numpy as np
import pytest
import torch

from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import synthetic
from fast_livo2_tpu_torch.models import camera as cam_mod
from fast_livo2_tpu_torch.ops import image as img_ops
from fast_livo2_tpu_torch.utils.config import CameraConfig, LIVOConfig
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_box_stack_equals_halfsample_pyramid():
    """box_stack level l at stride-aligned coordinates reproduces the
    vk::halfSample pyramid (aligned 2^l-block means)."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, size=(32, 48)).astype(np.float32)
    stack = img_ops.box_stack(torch.from_numpy(img), 3).numpy()
    pyr = img
    for lvl in (1, 2):
        # halfSample: disjoint 2x2 block means, recursively
        h, w = pyr.shape
        pyr = pyr[: h // 2 * 2, : w // 2 * 2].reshape(
            h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        s = 1 << lvl
        sampled = stack[lvl][::s, ::s][: pyr.shape[0], : pyr.shape[1]]
        # f32 integral-image accumulation: ~5e-3 DN on a [0,255] image
        np.testing.assert_allclose(sampled, pyr, atol=0.02)


def _cam_cfg():
    return CameraConfig(cam_model="Pinhole", cam_width=320, cam_height=256,
                        scale=1.0, cam_fx=200.0, cam_fy=200.0, cam_cx=160.0,
                        cam_cy=128.0)


@pytest.fixture(scope="module")
def noisy_seq():
    cam = cam_mod.make_camera(_cam_cfg())
    planes = synthetic.hard_scene()
    for p in planes:
        p.hf_amp = 1.5  # 3-20 px period content: aliasing-prone
    return synthetic.make_sequence(
        duration=3.0, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0, cam=cam,
        seed=11, n_lines=12, n_per_line=500, render=True, fov_deg=360.0,
        planes=planes, traj=synthetic.hard_trajectory(),
        img_photon_noise=1.2, img_read_noise=2.5, img_blur_px=0.6,
        exposure_fn=lambda t: 1.0 + 0.2 * np.sin(0.8 * t))


def _run(seq, true_pyramid):
    cfg = LIVOConfig()
    cfg.camera = _cam_cfg()
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
    cfg.tpu.true_pyramid = true_pyramid
    pipe = LIVOPipeline(cfg, slam_mode="livo", device="cpu")
    traj = pipe.process(seq, progress=False)
    rmse = synthetic.ate_rmse([(t, p) for t, _, p in traj], seq.gt)
    tracked = np.mean([r.get("n_tracked", 0) for r in pipe.log.rows[3:]])
    return rmse, tracked


def test_strided_sampling_survives_realistic_imaging(noisy_seq):
    """The reference-faithful strided design under noise + blur + HF
    texture (the JAX package measured 0.0065 m; gate at 3x headroom)."""
    rmse, tracked = _run(noisy_seq, true_pyramid=False)
    assert rmse < 0.02, f"strided sampling ATE {rmse:.4f} m under noise"
    assert tracked > 50, f"tracked collapsed under noise: {tracked:.0f}"


def test_true_pyramid_option_equivalent(noisy_seq):
    """The anti-aliased option converges equivalently (the JAX package
    measured 0.0069 m: no win over strided, kept as an option)."""
    rmse, tracked = _run(noisy_seq, true_pyramid=True)
    assert rmse < 0.02, f"true-pyramid ATE {rmse:.4f} m under noise"
    assert tracked > 50

"""The port's camera models, image sampling and image rendering against
the JAX package on the same seeded inputs.

Tolerances: camera and image functions to 1e-5 (relative, float32
arithmetic in two evaluation orders); sampled values on DN-scale (0-255)
images to atol 1e-3. Rendered images: rays through the two packages'
float32 cam2world may differ in the last bits, so a ray grazing a plane
edge may hit the neighbouring plane: at least 99.9 % of the pixels agree
to 1e-3 DN.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.io import synthetic as jsyn
from fast_livo2_tpu.models import camera as jcam
from fast_livo2_tpu.ops import image as jimg
from fast_livo2_tpu.utils.config import CameraConfig
from fast_livo2_tpu_torch.io import synthetic as tsyn
from fast_livo2_tpu_torch.models import camera as tcam
from fast_livo2_tpu_torch.ops import image as timg

RTOL = 1e-5
DN_ATOL = 1e-3


def _cam_cfg(model):
    cfg = CameraConfig(cam_model="Pinhole", cam_width=320, cam_height=256,
                       scale=1.0, cam_fx=200.0, cam_fy=200.0, cam_cx=160.0,
                       cam_cy=128.0)
    if model == "radtan":
        cfg.cam_d0, cfg.cam_d1, cfg.cam_d2, cfg.cam_d3 = -0.1, 0.05, 0.001, -0.002
    elif model == "equidistant":
        cfg.cam_model = "equidistant"
        cfg.k1, cfg.k2, cfg.k3, cfg.k4 = -0.04, 0.01, -0.002, 0.0003
    return cfg


@pytest.mark.parametrize("model", ["pinhole", "radtan", "equidistant"])
def test_camera_matches_jax(model):
    cfg = _cam_cfg(model)
    jc, tc = jcam.make_camera(cfg), tcam.make_camera(cfg)
    assert tuple(jc) == tuple(tc)
    assert jcam.has_distortion(jc) == tcam.has_distortion(tc)
    rng = np.random.default_rng(0)
    uv = rng.uniform(-0.7, 0.7, size=(300, 2)).astype(np.float32)
    z = rng.uniform(0.5, 10.0, size=(300, 1)).astype(np.float32)
    pts = np.concatenate([uv * z, z], axis=-1)
    pts[:3, 2] = [0.0, 1e-10, -2.0]  # the z guard and a point behind
    j_px = np.asarray(jcam.world2cam(jc, jnp.asarray(pts)))
    t_px = tcam.world2cam(tc, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(t_px, j_px, rtol=RTOL)
    px = rng.uniform([0, 0], [320, 256], size=(300, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.cam2world(tc, torch.from_numpy(px)).numpy(),
        np.asarray(jcam.cam2world(jc, jnp.asarray(px))), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        tcam.projection_jacobian(tc, torch.from_numpy(pts)).numpy(),
        np.asarray(jcam.projection_jacobian(jc, jnp.asarray(pts))), rtol=RTOL)
    np.testing.assert_array_equal(
        tcam.in_frame(tc, torch.from_numpy(t_px), 8).numpy(),
        np.asarray(jcam.in_frame(jc, jnp.asarray(t_px), 8)))


def _dn_image(h, w, seed):
    """A smooth DN-scale (0-255) image: integrated noise."""
    rng = np.random.default_rng(seed)
    a = np.cumsum(np.cumsum(rng.standard_normal((h, w)), 0), 1)
    a = (a - a.min()) / (a.max() - a.min()) * 255.0
    return a.astype(np.float32)


def test_sampling_matches_jax():
    """sample_patches, sample_patches_with_grad (single image and the
    img_idx stack form), bilinear and patch_offsets, with taps that run
    off every border (each tap clipped on its own)."""
    h, w, n, ps = 60, 80, 40, 8
    img = _dn_image(h, w, 1)
    stack = np.stack([img, _dn_image(h, w, 2), _dn_image(h, w, 3)])
    rng = np.random.default_rng(4)
    px = rng.uniform([-5, -5], [w + 5, h + 5], size=(n, 2)).astype(np.float32)
    scale = (1 << rng.integers(0, 4, n)).astype(np.int32)
    idx = rng.integers(0, 3, n).astype(np.int32)
    J = dict(img=jnp.asarray(img), stack=jnp.asarray(stack), px=jnp.asarray(px),
             scale=jnp.asarray(scale), idx=jnp.asarray(idx))
    T = dict(img=torch.from_numpy(img), stack=torch.from_numpy(stack),
             px=torch.from_numpy(px), scale=torch.from_numpy(scale),
             idx=torch.from_numpy(idx))

    for a, b in zip(timg.patch_offsets(ps), jimg.patch_offsets(ps)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(
        timg.sample_patches(T["img"], T["px"], T["scale"], ps).numpy(),
        np.asarray(jimg.sample_patches(J["img"], J["px"], J["scale"], ps)),
        atol=DN_ATOL)
    for a, b in zip(
            timg.sample_patches_with_grad(T["img"], T["px"], T["scale"], ps),
            jimg.sample_patches_with_grad(J["img"], J["px"], J["scale"], ps)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=DN_ATOL)
    for a, b in zip(
            timg.sample_patches_with_grad(T["stack"], T["px"], T["scale"], ps,
                                          img_idx=T["idx"]),
            jimg.sample_patches_with_grad(J["stack"], J["px"], J["scale"], ps,
                                          img_idx=J["idx"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=DN_ATOL)
    np.testing.assert_allclose(
        timg.bilinear(T["img"], T["px"]).numpy(),
        np.asarray(jimg.bilinear(J["img"], J["px"])), atol=DN_ATOL)


def _ulps_of_prefix_sum(a):
    """Four float32 ulps of the largest prefix sum of `a` (plus its edge
    padding): the two packages build their integral images with float32
    cumulative sums in different orders (PyTorch's CPU cumsum carries a
    double accumulator), so box sums agree to this absolute level."""
    return 4.0 * float(np.spacing(np.float32(np.abs(a).sum() * 1.2)))


def test_box_stack_and_shi_tomasi_match_jax():
    h, w = 48, 64
    img = _dn_image(h, w, 5)
    ti, ji = torch.from_numpy(img), jnp.asarray(img)
    t_stack = timg.box_stack(ti, 4).numpy()
    j_stack = np.asarray(jimg.box_stack(ji, 4))
    for l in range(4):  # level l is a box sum divided by 4^l
        np.testing.assert_allclose(t_stack[l], j_stack[l], rtol=RTOL,
                                   atol=_ulps_of_prefix_sum(img) / 4**l)
    p = np.pad(img, 1, mode="edge")
    grad2 = (0.5 * (p[1:-1, 2:] - p[1:-1, :-2])) ** 2 + (
        0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])) ** 2
    atol = _ulps_of_prefix_sum(grad2) / 64  # box sums over 8 x 8
    j_score = np.asarray(jimg.shi_tomasi_image(ji))
    np.testing.assert_allclose(timg.shi_tomasi_image(ti).numpy(), j_score,
                               rtol=RTOL, atol=atol)
    px = np.random.default_rng(6).uniform(-3, 70, size=(50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        timg.shi_tomasi(ti, torch.from_numpy(px)).numpy(),
        np.asarray(jimg.shi_tomasi(ji, jnp.asarray(px))), rtol=RTOL, atol=atol)


@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_render_image_matches_jax(model):
    cfg = _cam_cfg(model)
    cfg.cam_width, cfg.cam_height = 64, 48
    cfg.cam_fx = cfg.cam_fy = 40.0
    cfg.cam_cx, cfg.cam_cy = 32.0, 24.0
    traj = tsyn.Trajectory()
    planes = tsyn.default_room()
    a = tsyn.render_image(traj, planes, 1.3, tcam.make_camera(cfg),
                          exposure=1.1, R_ci=tsyn.R_CI_FORWARD)
    b = jsyn.render_image(jsyn.Trajectory(), jsyn.default_room(), 1.3,
                          jcam.make_camera(cfg), exposure=1.1,
                          R_ci=jsyn.R_CI_FORWARD)
    assert a.shape == b.shape == (48, 64) and a.dtype == np.float32
    close = np.abs(a - b) <= DN_ATOL
    assert close.mean() >= 0.999, f"{(~close).sum()} pixels differ"

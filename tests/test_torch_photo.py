"""K2's plain version (ops/photo_iteration.photo_iteration_plain, what the
wrapper runs on CPU tensors) against the TPU kernel it ports,
fast_livo2_tpu/ops/pallas_photo.photo_iteration in interpret mode, and
against the port's torch-op photometric chain.

Tolerances are tests/test_pallas_photo.py's: HTH and HTz rtol 2e-4, atol
2e-4 (float32 sums in another order); err rtol 1e-4; cnt exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.models import camera as jcam
from fast_livo2_tpu.ops import pallas_photo as pp
from fast_livo2_tpu.ops import so3 as jso3
from fast_livo2_tpu.utils.config import CameraConfig
from fast_livo2_tpu_torch.models import camera as tcam
from fast_livo2_tpu_torch.ops import image as timg
from fast_livo2_tpu_torch.ops import photo_iteration as tp
from fast_livo2_tpu_torch.ops import so3 as tso3


def _case(with_dist, slog_hi, seed=0, H=96, W=128, M=8):
    """tests/test_pallas_photo.py's inputs: a smooth image, M points on a
    ring about 2 m ahead, the last point masked out (none where M = 1);
    stride exponents drawn in [0, slog_hi)."""
    rng = np.random.default_rng(seed)
    img = (np.cumsum(np.cumsum(rng.standard_normal((H, W)), 0), 1)
           .astype(np.float32) / 50.0)
    cfg = CameraConfig(cam_model="Pinhole", cam_width=W, cam_height=H,
                       cam_fx=60.0, cam_fy=60.0, cam_cx=W / 2, cam_cy=H / 2)
    if with_dist:
        cfg.cam_d0, cfg.cam_d1, cfg.cam_d2, cfg.cam_d3 = 0.02, -0.01, 0.001, -0.002
    ang = np.linspace(0, 2 * np.pi, M, endpoint=False)
    pos = np.stack([0.25 * np.cos(ang), 0.2 * np.sin(ang),
                    np.full(M, 2.0)], axis=-1).astype(np.float32)
    Rcw = np.asarray(jso3.exp(jnp.asarray([0.02, -0.01, 0.03])))
    Pcw = np.array([0.01, -0.02, 0.05], np.float32)
    pos = (pos @ Rcw + (-Rcw.T @ Pcw)).astype(np.float32)
    Rci = np.asarray(jso3.exp(jnp.asarray([0.1, 0.2, -0.05])))
    Pci = np.array([0.05, -0.03, 0.02], np.float32)
    Jdp_dR = -Rci @ np.asarray(jso3.skew(jnp.asarray(-Rci.T @ Pci)))
    return dict(
        img=img, cam=cfg, pos=pos, Rcw=Rcw, Pcw=Pcw, tau=np.float32(1.1),
        ref=rng.standard_normal((M, 64)).astype(np.float32),
        slog=rng.integers(0, slog_hi, M).astype(np.int32),
        ok=np.array([True] * (M - 1) + [M == 1]),
        Jdphi_dR=Rci.astype(np.float32), Jdp_dR=Jdp_dR.astype(np.float32))


def _jax_fused(c):
    cam = jcam.make_camera(c["cam"])
    meta, refp = pp.pack_points(jnp.asarray(c["pos"]), jnp.asarray(c["ref"]),
                                jnp.asarray(c["slog"]), jnp.asarray(c["ok"]))
    par = pp.pack_params(jnp.asarray(c["Rcw"]), jnp.asarray(c["Pcw"]),
                         jnp.float32(c["tau"]), jnp.asarray(c["Jdphi_dR"]),
                         jnp.asarray(c["Jdp_dR"]), cam.fx, cam.fy, cam.cx,
                         cam.cy, jnp.asarray(cam.d), 1.0,
                         1.0 if jcam.has_distortion(cam) else 0.0)
    out = pp.photo_iteration(jnp.asarray(c["img"]), meta, refp, par,
                             interpret=True)
    return [np.asarray(x) for x in out], (np.asarray(meta), np.asarray(refp),
                                          np.asarray(par))


def _torch_inputs(c):
    cam = tcam.make_camera(c["cam"])
    T = {k: torch.from_numpy(np.array(c[k]))
         for k in ("pos", "ref", "slog", "ok", "Rcw", "Pcw", "Jdphi_dR",
                   "Jdp_dR", "tau")}
    meta, refp = tp.pack_points(T["pos"], T["ref"], T["slog"], T["ok"])
    par = tp.pack_params(T["Rcw"], T["Pcw"], T["tau"], T["Jdphi_dR"],
                         T["Jdp_dR"], cam.fx, cam.fy, cam.cx, cam.cy, cam.d,
                         1.0, 1.0 if tcam.has_distortion(cam) else 0.0)
    return torch.from_numpy(c["img"]), meta, refp, par


def _assert_outputs_close(got, want):
    HTH, HTz, err, cnt = (np.asarray(x) for x in got)
    np.testing.assert_allclose(HTH, want[0], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(HTz, want[1], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(err), float(want[2]), rtol=1e-4)
    assert float(cnt) == float(want[3])


@pytest.mark.parametrize("with_dist", [False, True], ids=["pinhole", "radtan"])
def test_plain_matches_pallas_kernel(with_dist):
    c = _case(with_dist, slog_hi=3)
    want, (j_meta, j_ref, j_par) = _jax_fused(c)
    img, meta, refp, par = _torch_inputs(c)
    # pack_points / pack_params keep the TPU kernel's layouts exactly
    np.testing.assert_array_equal(meta.numpy(), j_meta)
    np.testing.assert_array_equal(refp.numpy(), j_ref)
    np.testing.assert_array_equal(par.numpy(), j_par)
    _assert_outputs_close(
        [x.numpy() for x in tp.photo_iteration_plain(img, meta, refp, par)], want)


@pytest.mark.parametrize("M", [1, 7, 9, 17])
def test_plain_matches_pallas_kernel_at_block_edges(M):
    """Point counts around the CUDA kernel's eight points a block (one
    point, a block short of full, one over, two blocks and one over)."""
    c = _case(True, slog_hi=3, seed=M, M=M)
    want, _ = _jax_fused(c)
    _assert_outputs_close(
        [x.numpy() for x in tp.photo_iteration_plain(*_torch_inputs(c))], want)


def test_plain_with_no_points_is_zero():
    """M = 0 (an empty submap): every output is exactly zero."""
    img, meta, refp, par = _torch_inputs(_case(False, slog_hi=3))
    HTH, HTz, err, cnt = tp.photo_iteration_plain(img, meta[:0], refp[:0], par)
    assert HTH.shape == (7, 7) and HTz.shape == (7,)
    for x in (HTH, HTz, err, cnt):
        assert x.dtype == torch.float32 and not torch.any(x)


def _torch_op_iteration(c, img, scale):
    """core/vio.photometric_update's torch-op body (the port of
    tests/test_pallas_photo.py's _xla_iteration): each tap clipped on its
    own, no stride clamp."""
    cam = tcam.make_camera(c["cam"])
    T = {k: torch.from_numpy(np.array(c[k]))
         for k in ("pos", "ref", "ok", "Rcw", "Pcw", "Jdphi_dR", "Jdp_dR")}
    tau = float(c["tau"])
    pf = T["pos"] @ T["Rcw"].T + T["Pcw"]
    px = tcam.world2cam(cam, pf)
    okf = (T["ok"] & (pf[:, 2] > 1e-6)).to(torch.float32)
    val, du, dv = timg.sample_patches_with_grad(img, px, scale, 8)
    inv_scale = 1.0 / scale.to(torch.float32)
    Jimg = torch.stack([du, dv], dim=-1) * (tau * inv_scale[:, None])[..., None]
    Jca = torch.einsum("mpi,mij->mpj", Jimg, tcam.projection_jacobian(cam, pf))
    Jdphi = torch.einsum("mpi,mij->mpj", Jca, tso3.skew(pf))
    JdR = (torch.einsum("mpi,ij->mpj", Jdphi, T["Jdphi_dR"])
           + torch.einsum("mpi,ij->mpj", -Jca, T["Jdp_dR"]))
    Jdt = torch.einsum("mpi,ij->mpj", -Jca, T["Rcw"])
    res = tau * val - T["ref"]
    H = torch.cat([JdR, Jdt, val[..., None]], dim=-1)
    return (torch.einsum("mpi,mpj,m->ij", H, H, okf),
            torch.einsum("mpi,mp,m->i", H, res, okf),
            torch.sum(okf[:, None] * res * res), torch.sum(okf) * 64)


def test_stride_clamp_follows_the_tpu_kernel():
    """At W = 128 the stride exponent clamps to 3 (12 * 2^4 > 128). With
    exponents up to 5 the plain version matches the TPU kernel, which
    clamps the same way; the torch-op chain, which does not clamp, agrees
    with both only while every exponent is within the clamp."""
    assert tp.clamp_scale_log2(128) == 3
    assert tp.clamp_scale_log2(640) == 4
    assert tp.clamp_scale_log2(12) == 0
    c = _case(True, slog_hi=6, seed=1)
    assert c["slog"].max() > 3
    want, _ = _jax_fused(c)
    img, meta, refp, par = _torch_inputs(c)
    plain = [x.numpy() for x in tp.photo_iteration_plain(img, meta, refp, par)]
    _assert_outputs_close(plain, want)
    unclamped = _torch_op_iteration(c, img, torch.from_numpy(1 << c["slog"]))
    assert not np.allclose(unclamped[0].numpy(), plain[0], rtol=2e-4, atol=2e-4)
    # the same points with every exponent within the clamp: all agree
    c["slog"] = np.minimum(c["slog"], 2)
    img, meta, refp, par = _torch_inputs(c)
    plain = [x.numpy() for x in tp.photo_iteration_plain(img, meta, refp, par)]
    _assert_outputs_close(plain, _jax_fused(c)[0])
    _assert_outputs_close(
        [x.numpy() for x in _torch_op_iteration(c, img, torch.from_numpy(1 << c["slog"]))],
        plain)


def test_wrapper_routes_cpu_to_plain():
    c = _case(False, slog_hi=3)
    img, meta, refp, par = _torch_inputs(c)
    before = tp.LAUNCHES
    got = tp.photo_iteration(img, meta, refp, par)
    want = tp.photo_iteration_plain(img, meta, refp, par)
    assert tp.LAUNCHES == before  # the plain version is no launch
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError):
        tp.photo_iteration(img.to("meta"), meta, refp, par)

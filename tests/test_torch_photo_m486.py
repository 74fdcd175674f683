"""K2 above 448 tracked points: the port's photometric iteration against
the JAX package's at NTU-VIRAL's camera (configs/camera_ntu_viral.yaml:
752 x 480 with radtan distortion, grid cells of 28 px, so M = 27 x 18 =
486 slots).

The JAX package runs its TPU kernel only at M <= 448 and samples through
its XLA path above (fast_livo2_tpu/core/vio.py:546-549; on the CPU it
takes that path at every M): no stride clamp, every tap clipped on its
own. The TPU kernel instead clips each 12-tap window as one block, which
moves the window of a point whose taps reach past the left or right
edge. The port runs K2 at every M, so at M > 448 it must sample as the
XLA path does (ops/photo_iteration.clip_taps_at).

The submap is built by hand: points at search level 2 (and some at 0
and 1), spread over the frame and gathered near the left, right, top and
bottom borders, each inside retrieval's border (core/vio.border_px: 40
px at 3 pyramid levels), so every one is a point retrieval can produce.
Reference patches are sampled from the image at the true pose; the
update starts from a pose 0.3 degrees and 1.5 cm off.

Tolerances: HTH and HTz within 1e-4 of the block's largest entry (the
port forms them in closed form, the XLA path by einsum over H: float32
sums in another order); err 1e-4 relative; cnt exact. The update: the
state within 2e-6 (the old sampling moves the position by ~2e-5 m here,
the two packages' float32 arithmetic by < 1e-6), the covariance 1e-3
relative (tests/test_torch_vio.py's) or 2e-8 absolute (2e-5 of the
prior's largest entry: the posterior is the prior minus G times the
prior, and the 486 points shrink its pose block to ~1e-8, where float32
cancellation sets the error), the error 1e-4 relative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.core import state as jstate
from fast_livo2_tpu.core import vio as jvio
from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu.models import camera as jcam
from fast_livo2_tpu.ops import image as jimg
from fast_livo2_tpu.ops import so3 as jso3
from fast_livo2_tpu.utils.config import load_config as jax_load_config
from fast_livo2_tpu_torch.core import state as tstate
from fast_livo2_tpu_torch.core import vio as tvio
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.models import camera as tcam
from fast_livo2_tpu_torch.ops import image as timg
from fast_livo2_tpu_torch.ops import photo_iteration as tp
from fast_livo2_tpu_torch.ops import so3 as tso3
from fast_livo2_tpu_torch.utils.config import load_config

SENSOR, CAMERA = "configs/ntu_viral.yaml", "configs/camera_ntu_viral.yaml"
BLOCK_TOL, ERR_RTOL = 1e-4, 1e-4


def _shrink(cfg):
    """tests/test_configs_load.py's capacities: construction only."""
    cfg.tpu.max_points_per_scan = 1024
    cfg.tpu.max_points_down = 512
    cfg.tpu.hash_capacity_log2 = 10
    cfg.tpu.vis_point_capacity = 512
    cfg.tpu.frame_ring = 4
    return cfg


def _texture(H, W, seed):
    """A smooth 0-255 image with structure at every stride up to 32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.full((H, W), 128.0)
    for _ in range(24):
        f = rng.uniform(0.005, 0.12, 2)
        img += rng.uniform(4, 14) * np.sin(f[0] * xx + f[1] * yy
                                           + rng.uniform(0, 2 * np.pi))
    return np.clip(img, 0, 255).astype(np.float32)


def _pixels(rng, W, H, b, n):
    """Pixel targets: a third over the frame, the rest within 50 px of
    the left, right, top and bottom borders (inside retrieval's border b)."""
    k = n // 3
    over = rng.uniform([b, b], [W - b, H - b], (k, 2))
    side = rng.integers(0, 4, n - k)
    u = rng.uniform(b, W - b, n - k)
    v = rng.uniform(b, H - b, n - k)
    u = np.where(side == 0, rng.uniform(b, b + 50, n - k), u)
    u = np.where(side == 1, rng.uniform(W - b - 50, W - b, n - k), u)
    v = np.where(side == 2, rng.uniform(b, b + 50, n - k), v)
    v = np.where(side == 3, rng.uniform(H - b - 50, H - b, n - k), v)
    return np.concatenate([over, np.stack([u, v], -1)])


@pytest.fixture(scope="module")
def case():
    """Both packages' camera, extrinsics and VIO config from the shipped
    NTU-VIRAL pair; the hand-built submap, image and states."""
    jp = JaxPipeline(_shrink(jax_load_config(SENSOR, CAMERA)), slam_mode="livo")
    tpipe = LIVOPipeline(_shrink(load_config(SENSOR, CAMERA)), slam_mode="livo",
                         device="cpu")
    cam, cfg = tpipe.cam, tpipe.vio_cfg
    assert tuple(cfg) == tuple(jp.vio_cfg)
    M = cfg.grid_n_width * cfg.grid_n_height
    assert (cam.width, cam.height, M) == (752, 480, 486)
    assert tcam.has_distortion(cam)

    rng = np.random.default_rng(0)
    H, W = cam.height, cam.width
    img = torch.from_numpy(_texture(H, W, seed=1))
    b = tvio.border_px(cfg)
    # the true pose: the IMU at the origin; the camera from the extrinsics
    truth = tstate.init_state("cpu")
    Rcw, Pcw = tvio.camera_pose(truth, tpipe.Rci, tpipe.Pci)
    px = torch.from_numpy(_pixels(rng, W, H, b, 1200).astype(np.float32))
    bearing = tcam.cam2world(cam, px)
    depth = torch.from_numpy(rng.uniform(2.0, 9.0, len(px)).astype(np.float32))
    pc = bearing / bearing[:, 2:3] * depth[:, None]
    # keep the points retrieval could return: inside the border at the
    # true pose (the distortion inverse is approximate near the corners)
    px_true = tcam.world2cam(cam, pc)
    keep = torch.nonzero(tcam.in_frame(cam, px_true, b)).flatten()[:M]
    assert len(keep) == M
    pos = (pc[keep] - Pcw) @ Rcw  # world = Rcw^T (pc - Pcw)
    search = torch.from_numpy(rng.choice([0, 1, 2, 2, 2, 2], M).astype(np.int32))
    valid = torch.from_numpy(rng.random(M) > 0.05)
    L = cfg.pyramid_levels
    warp = torch.stack([
        timg.sample_patches(img, px_true[keep],
                            (1 << lvl) * torch.pow(2, search), cfg.patch_size)
        for lvl in range(L)], dim=1)  # (M, L, 64) at the true pose
    warp = warp + torch.from_numpy(
        rng.normal(0, 1.0, warp.shape).astype(np.float32))
    sub = tvio.Submap(
        valid=valid, point_idx=torch.arange(M, dtype=torch.int32), pos=pos,
        search_level=search, warp_patch=warp,
        ref_expo=torch.ones(M), propa_error=torch.zeros(M),
        ref_meta=torch.zeros(M, 15), point_rows=torch.zeros(M, 19),
        obs_rows=torch.zeros(M, cfg.max_obs, 20),
        patch_rows=torch.zeros(M, cfg.max_obs, cfg.patch_size ** 2))
    # the prior: 0.3 degrees and 1.5 cm off the true pose
    delta = torch.zeros(tstate.DIM_STATE)
    delta[0:3] = torch.tensor([0.003, -0.004, 0.002])
    delta[3:6] = torch.tensor([0.01, -0.008, 0.007])
    prior = tstate.boxplus(truth, delta)
    cov = tstate.init_cov("cpu") * 0.1
    packed = tstate.pack_state(prior, cov).numpy()
    jst, jcov = jstate.unpack_state(jnp.asarray(packed))
    jsub = jvio.Submap(*(jnp.asarray(np.asarray(a)) for a in sub))
    return dict(cam=cam, cfg=cfg, Rci=tpipe.Rci, Pci=tpipe.Pci, img=img,
                sub=sub, prior=prior, cov=cov, jp=jp, jst=jst, jcov=jcov,
                jsub=jsub, M=M)


def _jax_xla_normal_equations(c):
    """One iteration of the JAX package's XLA path (fast_livo2_tpu/core/
    vio.py:584-607, the branch it takes above 448 points) at the prior,
    written with that package's own functions."""
    jp, sub, cfg = c["jp"], c["jsub"], c["cfg"]
    cam, img = jp.cam, jnp.asarray(c["img"].numpy())
    st = c["jst"]
    Rcw, Pcw = jvio.camera_pose(st, jp.Rci, jp.Pci)
    Jdphi_dR = jp.Rci
    Jdp_dR = -jp.Rci @ jso3.skew(-jp.Rci.T @ jp.Pci)
    level = cfg.pyramid_levels - 1  # the first iteration's level
    scale = (1 << level) * (2 ** sub.search_level.astype(jnp.int32))
    ref = sub.ref_expo[:, None] * sub.warp_patch[:, level, :]
    tau = st.inv_expo
    pf = sub.pos @ Rcw.T + Pcw
    px = jcam.world2cam(cam, pf)
    ok = sub.valid & (pf[:, 2] > 1e-6)
    val, du, dv = jimg.sample_patches_with_grad(img, px, scale, 8)
    Jimg = (jnp.stack([du, dv], axis=-1)
            * (tau / scale.astype(jnp.float32))[:, None, None])
    Jca = jnp.einsum("mpi,mij->mpj", Jimg, jcam.projection_jacobian(cam, pf))
    Jdphi = jnp.einsum("mpi,mij->mpj", Jca, jso3.skew(pf))
    JdR = (jnp.einsum("mpi,ij->mpj", Jdphi, Jdphi_dR)
           + jnp.einsum("mpi,ij->mpj", -Jca, Jdp_dR))
    Jdt = jnp.einsum("mpi,ij->mpj", -Jca, Rcw)
    res = tau * val - ref
    H = jnp.concatenate([JdR, Jdt, val[..., None]], axis=-1)
    w = ok.astype(jnp.float32)
    return [np.asarray(x) for x in (
        jnp.einsum("mpi,mpj,m->ij", H, H, w), jnp.einsum("mpi,mp,m->i", H, res, w),
        jnp.sum(w[:, None] * res * res), jnp.sum(w) * 64)]


def _port_iteration(c, clip_taps):
    """The port's fused iteration at the prior, packed as
    core/vio.photometric_update packs it for the first level."""
    cam, cfg, sub, st = c["cam"], c["cfg"], c["sub"], c["prior"]
    Rci, Pci = c["Rci"], c["Pci"]
    Rcw, Pcw = tvio.camera_pose(st, Rci, Pci)
    Jdp_dR = -Rci @ tso3.skew(-Rci.T @ Pci)
    level = cfg.pyramid_levels - 1
    search = sub.search_level.to(torch.int32)
    ref = sub.ref_expo[:, None] * sub.warp_patch[:, level, :]
    meta, refp = tp.pack_points(sub.pos, ref, level + search, sub.valid)
    par = tp.pack_params(Rcw, Pcw, st.inv_expo, Rci, Jdp_dR, cam.fx, cam.fy,
                         cam.cx, cam.cy, cam.d, 1.0, 1.0)
    return [x.numpy() for x in tp.photo_iteration(c["img"], meta, refp, par,
                                                  clip_taps=clip_taps)]


def _close(got, want):
    for g, w in zip(got[:2], want[:2]):
        if np.abs(g - w).max() > BLOCK_TOL * np.abs(w).max():
            return False
    return (abs(float(got[2]) - float(want[2])) <= ERR_RTOL * abs(float(want[2]))
            and float(got[3]) == float(want[3]))


def test_normal_equations_match_jax_above_448(case):
    """HTH, HTz, err and cnt of one iteration at M = 486: the port's K2
    (its plain version here) with the sampling clip_taps_at(486) picks
    equals the JAX package's XLA path; the TPU kernel's block clip, which
    the port used at every M before, does not, on these points."""
    assert tp.clip_taps_at(case["M"]) and not tp.clip_taps_at(396)
    want = _jax_xla_normal_equations(case)
    got = _port_iteration(case, tp.clip_taps_at(case["M"]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_less(np.abs(g - w),
                                     BLOCK_TOL * np.abs(w).max() + 1e-30)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=ERR_RTOL)
    assert float(got[3]) == float(want[3])
    assert not _close(_port_iteration(case, False), want)


def test_photometric_update_matches_jax_above_448(case):
    """The whole coarse-to-fine update (3 levels x up to 5 iterations) of
    both packages from the same prior, submap and image at M = 486."""
    c = case
    cfg = c["cfg"]
    assert cfg.pallas_photo  # the port takes its fused path (K2)
    ts, tc, te, iters = tvio.photometric_update(
        c["prior"], c["cov"], c["sub"], c["img"], c["cam"], c["Rci"], c["Pci"],
        cfg)
    jp = c["jp"]
    js, jc, je = jax.tree.map(np.asarray, jax.jit(
        lambda st, cv, sub, img, Rci, Pci: jvio.photometric_update(
            st, cv, sub, img, jp.cam, Rci, Pci, jp.vio_cfg))(
        c["jst"], c["jcov"], c["jsub"], jnp.asarray(c["img"].numpy()),
        jp.Rci, jp.Pci))
    assert iters >= cfg.pyramid_levels
    # the update moved the pose towards the truth
    assert float(torch.linalg.norm(ts.pos)) < float(torch.linalg.norm(c["prior"].pos))
    for name, a, b in zip(tstate.NavState._fields, ts, js):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-6,
                                   err_msg=name)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-3,
                               atol=2e-5 * float(c["cov"].abs().max()))
    np.testing.assert_allclose(float(te), float(je), rtol=1e-4)

"""K2 for the equidistant camera: the fused iteration's plain version
(ops/photo_iteration.photo_iteration_plain, what the card's kernel
computes and what the CPU runs) against the torch-op `normal_equations`
branch of core/vio.photometric_update that it replaces, at HILTI'22's
camera (configs/hilti22.yaml + camera_fisheye_hilti22.yaml: 720 x 540
equidistant fisheye, a 24 x 18 grid, so M = 432 tracked slots, four
pyramid levels, the exposure column on).

Both sides run inside photometric_update itself: `_iterate_level` is
replaced by a recorder that calls the level's `normal_equations` at the
prior and moves nothing, once with tpu.pallas_photo on (K2's plain
version) and once off (the torch-op chain), so every pyramid level
(0-3, each point at its own search level 0-2) is compared from the
same state.

The submap is built by hand, as tests/test_torch_photo_m486.py builds
its own: points over the frame and gathered near the four borders, at
search levels up to 2, so that at level 3 the strided windows (stride
up to 32) reach past every border and their taps are clipped; some
points behind the camera (masked by both sides through z > 1e-6), one
on the optical axis (r = 0, under the 1e-9 guard); reference patches
sampled at the true pose plus noise; the prior 0.3 degrees and 1.5 cm
off.

Tolerances: HTH and HTz within 1e-4 of the block's largest entry (K2
forms them in closed form from ten patch sums, the torch-op chain by
einsum over the (M, 64, 7) Jacobian: the same float32 products summed
in another order); the mean error 1e-4 relative; the projection bit for
bit (the plain version writes world2cam's expression). The whole update
(fused against unfused): the state within 2e-6 and the covariance 1e-3
relative or 2e-5 of the prior's largest entry, with the reasons
tests/test_torch_photo_m486.py gives for the same bounds (float32 sums
in another order; the posterior's pose block shrinks to where float32
cancellation sets its error); the error 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from fast_livo2_tpu_torch.core import state as tstate
from fast_livo2_tpu_torch.core import vio as tvio
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.models import camera as tcam
from fast_livo2_tpu_torch.ops import image as timg
from fast_livo2_tpu_torch.ops import photo_iteration as tp
from fast_livo2_tpu_torch.utils.config import load_config

SENSOR, CAMERA = "configs/hilti22.yaml", "configs/camera_fisheye_hilti22.yaml"
BLOCK_TOL, ERR_RTOL = 1e-4, 1e-4
AXIS = 2  # the point on the optical axis
BEHIND = list(range(5, 432, 36))  # points behind the camera: 12 of the first M


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """Pixel targets: a third over the frame, the rest within 30 px of
    the left, right, top and bottom borders (inside retrieval's border b)."""
    k = n // 3
    over = rng.uniform([b, b], [W - b, H - b], (k, 2))
    side = rng.integers(0, 4, n - k)
    u = rng.uniform(b, W - b, n - k)
    v = rng.uniform(b, H - b, n - k)
    u = np.where(side == 0, rng.uniform(b, b + 30, n - k), u)
    u = np.where(side == 1, rng.uniform(W - b - 30, W - b, n - k), u)
    v = np.where(side == 2, rng.uniform(b, b + 30, n - k), v)
    v = np.where(side == 3, rng.uniform(H - b - 30, H - b, n - k), v)
    return np.concatenate([over, np.stack([u, v], -1)])


def _submap(sub, m):
    """The first m points of the submap `sub` (m may exceed its size:
    then the points repeat, as a pool's slots may hold one point twice)."""
    idx = torch.arange(m) % sub.valid.shape[0]
    return tvio.Submap(*(x[idx] for x in sub))


@pytest.fixture(scope="module")
def case():
    """HILTI'22's camera, extrinsics and VIO config from the shipped pair;
    a hand-built submap of 433 points, the image and the prior."""
    tpipe = LIVOPipeline(_shrink(load_config(SENSOR, CAMERA)), slam_mode="livo",
                         device="cpu")
    cam, cfg = tpipe.cam, tpipe.vio_cfg
    M = cfg.grid_n_width * cfg.grid_n_height
    assert (cam.model, cam.width, cam.height, M) == ("equidistant", 720, 540, 432)
    assert cfg.pallas_photo and cfg.exposure_estimate_en and cfg.patch_size == 8
    assert cfg.pyramid_levels == 4

    rng = np.random.default_rng(20)
    H, W = cam.height, cam.width
    img = torch.from_numpy(_texture(H, W, seed=3))
    b = tvio.border_px(cfg)
    truth = tstate.init_state("cpu")
    Rcw, Pcw = tvio.camera_pose(truth, tpipe.Rci, tpipe.Pci)
    n = M + 1
    px = torch.from_numpy(_pixels(rng, W, H, b, n).astype(np.float32))
    bearing = tcam.cam2world(cam, px)
    depth = torch.from_numpy(rng.uniform(2.0, 9.0, n).astype(np.float32))
    pc = bearing * depth[:, None]
    pc[AXIS] = torch.tensor([0.0, 0.0, 4.0])  # r = 0
    pc[BEHIND] = pc[BEHIND] * torch.tensor([1.0, 1.0, -1.0])
    pos = (pc - Pcw) @ Rcw  # world = Rcw^T (pc - Pcw)
    search = torch.from_numpy(rng.choice([0, 1, 2, 2], n).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) > 0.05)
    valid[AXIS] = True
    valid[BEHIND] = True  # masked by z > 1e-6 alone
    px_true = tcam.world2cam(cam, pc)
    warp = torch.stack([
        timg.sample_patches(img, px_true, (1 << lvl) * torch.pow(2, search),
                            cfg.patch_size)
        for lvl in range(cfg.pyramid_levels)], dim=1)  # (n, L, 64)
    warp = warp + torch.from_numpy(
        rng.normal(0, 1.0, warp.shape).astype(np.float32))
    sub = tvio.Submap(
        valid=valid, point_idx=torch.arange(n, dtype=torch.int32), pos=pos,
        search_level=search, warp_patch=warp,
        ref_expo=torch.from_numpy(rng.uniform(0.9, 1.1, n).astype(np.float32)),
        propa_error=torch.zeros(n), ref_meta=torch.zeros(n, 15),
        point_rows=torch.zeros(n, 19), obs_rows=torch.zeros(n, cfg.max_obs, 20),
        patch_rows=torch.zeros(n, cfg.max_obs, cfg.patch_size ** 2))
    delta = torch.zeros(tstate.DIM_STATE)
    delta[0:3] = torch.tensor([0.003, -0.004, 0.002])
    delta[3:6] = torch.tensor([0.01, -0.008, 0.007])
    prior = tstate.boxplus(truth, delta)
    cov = tstate.init_cov("cpu") * 0.1
    return dict(cam=cam, cfg=cfg, Rci=tpipe.Rci, Pci=tpipe.Pci, img=img,
                sub=sub, prior=prior, cov=cov, M=M, Rcw=Rcw, Pcw=Pcw, pc=pc)


def _level_equations(c, sub, pallas_photo, monkeypatch):
    """[(HTH, HTz, error)] of each pyramid level's first iteration at the
    prior, coarse to fine, from photometric_update's own
    `normal_equations` (K2's plain version with pallas_photo, else the
    torch-op chain)."""
    out = []

    def record(state_prop, state, G_keep, final_err, P, normal_equations,
               max_iterations, device_loop):
        out.append(tuple(x.clone() for x in normal_equations(state)))
        return state, G_keep, final_err, 0

    monkeypatch.setattr(tvio, "_iterate_level", record)
    tvio.photometric_update(c["prior"], c["cov"], sub, c["img"], c["cam"],
                            c["Rci"], c["Pci"],
                            c["cfg"]._replace(pallas_photo=pallas_photo))
    monkeypatch.undo()
    assert len(out) == c["cfg"].pyramid_levels
    return out


def _assert_equations_close(got, want):
    for level, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("HTH", "HTz"), g[:2], w[:2]):
            tol = BLOCK_TOL * float(b.abs().max())
            assert tol > 0, (level, name)
            gap = float((a - b).abs().max())
            assert gap <= tol, (level, name, gap, tol)
        torch.testing.assert_close(g[2], w[2], rtol=ERR_RTOL, atol=0.0)


@pytest.mark.parametrize("m", [432, 1, 7, 9, 433])
def test_plain_k2_matches_torch_op_branch(case, m, monkeypatch):
    """Every level's HTH, HTz and error of the equidistant K2 (its plain
    version) against the torch-op branch it replaces, at HILTI'22's M =
    432 and at point counts around the kernel's eight points a block (7
    and 9 hold the optical-axis point and one behind the camera)."""
    sub = _submap(case["sub"], m)
    got = _level_equations(case, sub, True, monkeypatch)
    want = _level_equations(case, sub, False, monkeypatch)
    _assert_equations_close(got, want)


def test_edge_points_sampled_as_the_torch_op_branch(case):
    """The hand-built points reach what the test means them to: at level 3
    windows whose taps are clipped at each of the four borders, points
    behind the camera masked out, the optical-axis point projected to the
    principal point; and K2's projection is world2cam's, bit for bit."""
    c, cam = case, case["cam"]
    sub = c["sub"]
    meta, _ = tp.pack_points(sub.pos, sub.warp_patch[:, 0], 3 + sub.search_level,
                             sub.valid)
    par = tp.pack_params(c["Rcw"], c["Pcw"], torch.tensor(1.0), c["Rci"],
                         c["Rci"], cam.fx, cam.fy, cam.cx, cam.cy, cam.d, 1.0,
                         1.0, equidistant=True)
    assert float(par[0, tp.MODEL_COL]) == 1.0
    pf, _, u, v, okf = tp._project(meta, par)
    want = tcam.world2cam(cam, torch.stack(pf, -1))
    assert torch.equal(u, want[:, 0]) and torch.equal(v, want[:, 1])
    assert float(okf[AXIS]) == 1.0
    assert abs(float(u[AXIS]) - cam.cx) < 1e-3
    assert abs(float(v[AXIS]) - cam.cy) < 1e-3
    assert torch.all(pf[2][BEHIND] < 0) and not torch.any(okf[BEHIND])
    # the unclipped tap coordinates of each point's level-3 window
    sd = 1 << (3 + sub.search_level).long()
    x0 = torch.floor(u / sd) * sd - 5 * sd
    y0 = torch.floor(v / sd) * sd - 5 * sd
    ok = okf > 0
    assert torch.any(ok & (x0 < 0)) and torch.any(ok & (y0 < 0))
    assert torch.any(ok & (x0 + 11 * sd > cam.width - 1))
    assert torch.any(ok & (y0 + 11 * sd > cam.height - 1))


def test_equidistant_routes_to_k2_with_clip_taps(case, monkeypatch):
    """photometric_update sends the equidistant camera at M = 432 through
    K2, with clip_taps True (the JAX package samples a fisheye through its
    XLA path at every M) and the equidistant instantiation, one call an
    iteration; the pinhole gate alone would pick the block clip there."""
    c = case
    assert tp.clip_taps_at(c["M"], "equidistant") and not tp.clip_taps_at(c["M"])
    calls = []
    real = tp.photo_iteration

    def spy(img, meta, ref, par, *a, **k):
        calls.append((meta.shape[0], k.get("clip_taps"), k.get("equidistant"),
                      float(par[0, tp.MODEL_COL])))
        return real(img, meta, ref, par, *a, **k)

    monkeypatch.setattr(tp, "photo_iteration", spy)
    _, _, _, iters = tvio.photometric_update(
        c["prior"], c["cov"], _submap(c["sub"], c["M"]), c["img"], c["cam"],
        c["Rci"], c["Pci"], c["cfg"])
    assert len(calls) == iters >= c["cfg"].pyramid_levels
    assert set(calls) == {(c["M"], True, True, 1.0)}


def test_fused_update_matches_unfused(case):
    """The whole coarse-to-fine update (4 levels x up to 5 iterations) at
    M = 432 through K2's plain version and through the torch-op chain
    (pallas_photo off), from the same prior, submap and image."""
    c = case
    sub = _submap(c["sub"], c["M"])
    runs = [tvio.photometric_update(c["prior"], c["cov"], sub, c["img"], c["cam"],
                                    c["Rci"], c["Pci"],
                                    c["cfg"]._replace(pallas_photo=k2))
            for k2 in (True, False)]
    (fs, fc, fe, fi), (us, uc, ue, ui) = runs
    assert fi == ui >= c["cfg"].pyramid_levels
    # the update moved the pose towards the truth
    assert float(torch.linalg.norm(fs.pos)) < float(torch.linalg.norm(c["prior"].pos))
    for name, a, b in zip(tstate.NavState._fields, fs, us):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6, msg=name)
    torch.testing.assert_close(fc, uc, rtol=1e-3,
                               atol=2e-5 * float(c["cov"].abs().max()))
    torch.testing.assert_close(fe, ue, rtol=1e-4, atol=0.0)

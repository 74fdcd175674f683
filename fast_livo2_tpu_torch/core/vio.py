"""Sparse-direct visual-inertial odometry as fixed-shape batched ops
(port of fast_livo2_tpu/core/vio.py, the frame path: retrieval, the
iterated photometric ESIKF and map maintenance).

Re-design of VIOManager (reference src/vio.cpp, include/vio.h), as in
the JAX package:
- The visual sparse map becomes a fixed-capacity pool of P point slots
  x K observation slots, packed into three tensors (`point (P+1, 19)`,
  `obs (P+1, K, 20)`, `obs_patch (P+1, K, ps²)`), plus a ring of the
  last F grayscale frames the observations reference. Row P of each pool
  tensor is the sink: PyTorch has no `mode="drop"` scatter, so writes
  that the JAX package drops land there, and no reader looks at it
  (`io/convert` strips it when a pool goes back to numpy).
- Retrieval projects every pool point, picks the nearest per image grid
  cell by scatter-min, checks depth continuity against a scatter-min
  depth raster, selects and warps the reference patch, and gates
  outliers.
- The coarse-to-fine photometric ESIKF runs per pyramid level. The JAX
  `lax.while_loop` is a Python loop here, in one of two forms over one
  body: early exit (the split frame) reads its stop flag once per
  iteration, except after the last one (at most pyramid_levels x
  (max_iterations - 1) host reads a frame, 16 at the defaults); the
  device loop (the fused and staged frames) runs every iteration with
  each carried value updated under torch.where(active, new, old) and no
  host read. Each iteration is one fused kernel launch
  (ops/photo_iteration, TPU kernel K2) where the JAX package's predicate
  holds, else the torch-op chain.
- Map maintenance: grid-scatter argmax for new points, masked
  observation appends with min-score eviction, NCC re-scoring and normal
  refinement from the LIO plane map, all written with one scatter per
  pool tensor.

In place, where JAX donated: `ring_insert` writes the ring and the
pool's valid/ref columns, and `generate_and_maintain` (and its
standalone parts `generate_points`, `update_obs`, `update_reference`,
`maintain_points`) scatters the frame's rows into the pool tensors it is
given; each returns the same tensors. Every other function leaves its
inputs untouched. The frame id is a 0-d int32 tensor on the frame's
device (a Python int is accepted and converted), as the JAX package
passes it: a captured CUDA graph (core/frame_graph.py) reads it from a
buffer instead of baking it in.

Tie-breaks follow jnp.argmin/argmax, which return the first index, as
torch.argmin/argmax document; the scatter-min/max of `_cell_argbest`
and `rasterize_depth` are order-independent. Float-to-int casts
truncate toward zero and integer `//` floors, as in the JAX package.

`colorize_points` samples the frame at each projected scan point (the
pipeline's coloured point-cloud accumulation).

The extras of the JAX package, in both loop forms where they iterate:
the inverse-compositional update (`photometric_update_ic`, 6-dof, tensor
ops, no K2), raycast recovery of LiDAR-blind grid cells (`make_ray_table`,
`raycast_recover`; a fresh 8192-slot scan table a frame, built with
ops/voxel_hash.lookup_or_insert), and the photometric factors the
sliding-window backend reads (`capture_photo_factors`, parallel/ba.py).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..models import camera as cam_mod
from ..ops import image as img_ops
from ..ops import photo_iteration as photo_mod
from ..ops import photo_tail as tail_mod
from ..ops import so3, voxel_hash
from ..utils.timing import annotate
from .state import DIM_STATE, NavState
from .voxel_map import (VoxelMap, VoxelMapConfig, _const, quad6, query_plane,
                        sym6)

# point row layout (P, 19)
_P_POS = slice(0, 3)
_P_NRM = slice(3, 6)
_P_PRV = slice(6, 9)
_P_COV = slice(9, 15)  # sym6 world covariance at creation
_P_VALID = 15
_P_CONV = 16
_P_HASREF = 17
_P_REF = 18
POINT_W = 19

# obs row layout (P, K, 20)
_O_VALID = 0
_O_PX = slice(1, 3)
_O_R = slice(3, 12)  # row-major camera-from-world rotation
_O_T = slice(12, 15)
_O_EXPO = 15
_O_SLOT = 16
_O_FID = 17
_O_MEAN = 18
_O_SCORE = 19
OBS_W = 20

_BIG = 3e38
# raycast: the per-frame scan-occupancy table's slots, and the fixed sym6
# world variance of a recovered candidate (the JAX package's vio_step)
RAY_SCAN_SLOTS = 8192
RAY_VAR6 = (1e-2, 0.0, 0.0, 1e-2, 0.0, 1e-2)


class VIOConfig(NamedTuple):
    """Static VIO configuration (the JAX package's fields and defaults)."""

    # camera grid
    grid_size: int = 30  # px per cell (derived: height / grid_n_height)
    grid_n_width: int = 22
    grid_n_height: int = 18
    # patches
    patch_size: int = 8
    pyramid_levels: int = 3  # patch_pyrimid_level
    max_obs: int = 8  # observation slots per point (reference caps 30)
    pool_capacity: int = 65536
    frame_ring: int = 64
    # filter
    max_iterations: int = 5
    img_point_cov: float = 100.0
    outlier_threshold: float = 1000.0
    exposure_estimate_en: bool = True
    normal_en: bool = True  # True = min-photometric-error ref selection
    # + plane-normal homography warp; False = closest-view ref selection
    # + fronto-parallel warp (vio.cpp:653-742)
    ncc_en: bool = False
    ncc_thre: float = 0.0
    raycast_en: bool = False
    inverse_composition_en: bool = False
    true_pyramid: bool = False  # sample box-average levels (ops/image.box_stack)
    pallas_photo: bool = False  # one fused kernel per photometric
    # iteration (ops/photo_iteration); pinhole + raw-strided sampling only
    # map maintenance
    select_obs_gap_p: float = 0.5  # delta_p threshold (:939)
    select_obs_gap_theta: float = 0.3
    select_obs_gap_px: float = 40.0


def n_cells(cfg: VIOConfig) -> int:
    return cfg.grid_n_width * cfg.grid_n_height


def derive_grid(cam: cam_mod.Camera, grid_size: int, grid_n_height: int):
    """Reference grid geometry (initializeVIO, vio.cpp:67-78)."""
    if grid_size > 10:
        gs = grid_size
    else:
        gs = cam.height // grid_n_height
    gnw = -(-cam.width // gs)
    gnh = -(-cam.height // gs)
    return gs, gnw, gnh


def border_px(cfg: VIOConfig) -> int:
    # (patch_size_half + 1) << pyramid_levels (vio.cpp:154)
    return (cfg.patch_size // 2 + 1) * (1 << cfg.pyramid_levels)


class VisualPool(NamedTuple):
    point: torch.Tensor  # (P + 1, 19) packed point rows; row P = sink
    obs: torch.Tensor  # (P + 1, K, 20) packed observation rows
    obs_patch: torch.Tensor  # (P + 1, K, ps²) level-0 patch at capture
    alloc: torch.Tensor  # () float allocation cursor (wraps)


class FrameRing(NamedTuple):
    imgs: torch.Tensor  # (F, H, W) float32 grayscale
    ids: torch.Tensor  # (F,) int32 global frame id, -1 empty


def make_pool(cfg: VIOConfig, device="cuda") -> VisualPool:
    P, K, ps2 = cfg.pool_capacity, cfg.max_obs, cfg.patch_size**2
    f = dict(dtype=torch.float32, device=device)
    return VisualPool(
        point=torch.zeros((P + 1, POINT_W), **f),
        obs=torch.zeros((P + 1, K, OBS_W), **f),
        obs_patch=torch.zeros((P + 1, K, ps2), **f),
        alloc=torch.zeros((), **f),
    )


def make_ring(cfg: VIOConfig, cam: cam_mod.Camera, device="cuda") -> FrameRing:
    return FrameRing(
        imgs=torch.zeros((cfg.frame_ring, cam.height, cam.width),
                         dtype=torch.float32, device=device),
        ids=torch.full((cfg.frame_ring,), -1, dtype=torch.int32, device=device),
    )


# ---- accessors for tests/tools (the P real slots, never the sink) ----

def pool_point_valid(pool: VisualPool):
    return pool.point[:-1, _P_VALID] > 0.5


def pool_obs_valid(pool: VisualPool):
    return pool.obs[:-1, :, _O_VALID] > 0.5


def pool_pos(pool: VisualPool):
    return pool.point[:-1, _P_POS]


def pool_converged(pool: VisualPool):
    return pool.point[:-1, _P_CONV] > 0.5


def camera_pose(state: NavState, Rci, Pci):
    """IMU state -> camera-from-world pose (updateFrameState,
    vio.cpp:1690-1697)."""
    Rcw = Rci @ state.rot.T
    Pcw = -Rcw @ state.pos + Pci
    return Rcw, Pcw


def colorize_points(img, pts_w, valid, state: NavState, cam: cam_mod.Camera,
                    Rci, Pci, blind: float = 0.0):
    """Sample per-point image intensity/color at the projected location
    (publish_frame_world's RGB rendering, LIVMapper.cpp:1133-1290, via
    getInterpolatedPixel, vio.cpp:1742-1760). img: (H, W) gray or
    (H, W, 3) float. Returns (colors (N, C), visible (N,)); colors are 0
    where not visible."""
    Rcw, Pcw = camera_pose(state, Rci, Pci)
    pc = pts_w @ Rcw.T + Pcw
    px = cam_mod.world2cam(cam, pc)
    vis = valid & (pc[:, 2] > blind) & cam_mod.in_frame(cam, px, 1)
    if img.dim() == 2:
        img = img[:, :, None]
    colors = torch.stack([img_ops.bilinear(img[:, :, c], px)
                          for c in range(img.shape[2])], dim=-1)
    return torch.where(vis[:, None], colors, 0.0), vis


def _grid_cell(px: torch.Tensor, cfg: VIOConfig) -> torch.Tensor:
    """Grid cell of each pixel: truncating cast, floor division, clip."""
    row = torch.clamp(px[:, 1].to(torch.int32) // cfg.grid_size, 0,
                      cfg.grid_n_height - 1)
    col = torch.clamp(px[:, 0].to(torch.int32) // cfg.grid_size, 0,
                      cfg.grid_n_width - 1)
    return row * cfg.grid_n_width + col


def _cell_argbest(cell: torch.Tensor, key: torch.Tensor, valid: torch.Tensor,
                  num_cells: int, mode: str):
    """Per-cell argmin/argmax via scatter + tie-break on the max lane
    index. Dropped lanes go to sink row num_cells. Returns (num_cells,)
    winning lane index or -1."""
    big = _BIG if mode == "min" else -_BIG
    k = torch.where(valid, key, big)
    tgt = torch.where(valid, cell, num_cells).long()
    best = key.new_full((num_cells + 1,), big).scatter_reduce(
        0, tgt, k, reduce="amin" if mode == "min" else "amax",
        include_self=True)[:num_cells]
    cell_best = best[cell.long()]
    is_best = valid & ((k <= cell_best) if mode == "min" else (k >= cell_best))
    lane = torch.arange(cell.shape[0], dtype=torch.int32, device=cell.device)
    idx = torch.where(is_best, lane, -1)
    out = torch.full((num_cells + 1,), -1, dtype=torch.int32, device=cell.device)
    return out.scatter_reduce(0, tgt, idx, reduce="amax",
                              include_self=True)[:num_cells]


class Submap(NamedTuple):
    """Per-frame tracked visual submap (SubSparseMap, vio.h:50-77),
    padded to the grid cell count."""

    valid: torch.Tensor  # (M,)
    point_idx: torch.Tensor  # (M,) pool index
    pos: torch.Tensor  # (M, 3)
    search_level: torch.Tensor  # (M,) int32
    warp_patch: torch.Tensor  # (M, L, patch²) warped reference patches
    ref_expo: torch.Tensor  # (M,)
    propa_error: torch.Tensor  # (M,) pre-update photometric error
    ref_meta: torch.Tensor  # (M, 15) [px(2) | R_cw(9) | t(3) | ring slot]
    # Pool rows gathered once during retrieval and threaded through to
    # the maintenance stage; point_rows carries the retrieval's ref-slot
    # cache updates.
    point_rows: torch.Tensor = None  # (M, 19)
    obs_rows: torch.Tensor = None  # (M, K, 20)
    patch_rows: torch.Tensor = None  # (M, K, ps²)


def rasterize_depth(cam: cam_mod.Camera, Rcw, Pcw, pg_w, pg_valid, border):
    """Scatter-min depth image from the current scan (the reference
    writes last-wins at vio.cpp:386-428; min is order-independent)."""
    pc = pg_w @ Rcw.T + Pcw
    px = cam_mod.world2cam(cam, pc)
    ok = pg_valid & (pc[:, 2] > 0) & cam_mod.in_frame(cam, px, border)
    col = torch.clamp(px[:, 0].to(torch.int32), 0, cam.width - 1)
    row = torch.clamp(px[:, 1].to(torch.int32), 0, cam.height - 1)
    hw = cam.height * cam.width
    flat = torch.where(ok, row * cam.width + col, hw).long()
    depth = pc.new_full((hw + 1,), _BIG).scatter_reduce(
        0, flat, torch.where(ok, pc[:, 2], _BIG), reduce="amin",
        include_self=True)[:hw]
    depth = torch.where(depth >= _BIG, 0.0, depth)
    return depth.reshape(cam.height, cam.width)


def _take_k(rows: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """rows (M, K, W) at slot k (M,) -> (M, W)."""
    idx = k.long()[:, None, None].expand(rows.shape[0], 1, rows.shape[2])
    return torch.gather(rows, 1, idx)[:, 0, :]


def _warp_homography(cam, ring, sel_obs, sel_point, Rcw, Pcw, cfg: VIOConfig):
    """Reference-patch affine warp via the plane-normal homography
    (getWarpMatrixAffineHomography + getBestSearchLevel + warpAffine,
    vio.cpp:252-331). sel_obs: (M, 20) ref-observation rows; sel_point:
    (M, 19) point rows. Returns (search_level (M,), warp (M, L, patch²),
    ok (M,))."""
    ps = cfg.patch_size
    M = sel_obs.shape[0]
    dev = sel_obs.device
    R_ref = sel_obs[:, _O_R].reshape(M, 3, 3)
    t_ref = sel_obs[:, _O_T]
    px_ref = sel_obs[:, _O_PX]
    pos = sel_point[:, _P_POS]
    normal = sel_point[:, _P_NRM]

    pf = torch.einsum("mij,mj->mi", R_ref, pos) + t_ref  # point in ref cam
    norm_ref = torch.einsum("mij,mj->mi", R_ref, normal)
    norm_ref = norm_ref / torch.clamp(
        torch.linalg.norm(norm_ref, dim=-1, keepdim=True), min=1e-9)

    # T_cur_ref = T_cur_w o T_w_ref
    R_cr = Rcw @ R_ref.transpose(-1, -2)  # (M, 3, 3)
    t_cr = Pcw - torch.einsum("mij,mj->mi", R_cr, t_ref)
    # t of T_cur_ref.inverse() = -R_cr^T t_cr (cur cam origin in ref frame)
    t_inv = -torch.einsum("mji,mj->mi", R_cr, t_cr)
    nd = torch.sum(norm_ref * pf, dim=-1)  # n.x
    eye = torch.eye(3, dtype=pf.dtype, device=dev)
    H = R_cr @ (nd[:, None, None] * eye - t_inv[:, :, None] * norm_ref[:, None, :])

    step_u = _const((4.0, 0.0), torch.float32, str(dev))
    step_v = _const((0.0, 4.0), torch.float32, str(dev))
    f_du = cam_mod.cam2world(cam, px_ref + step_u)
    f_dv = cam_mod.cam2world(cam, px_ref + step_v)
    f_c = torch.einsum("mij,mj->mi", H, cam_mod.cam2world(cam, px_ref))
    f_duc = torch.einsum("mij,mj->mi", H, f_du)
    f_dvc = torch.einsum("mij,mj->mi", H, f_dv)
    px_c = cam_mod.world2cam(cam, f_c)
    A = torch.stack(
        [(cam_mod.world2cam(cam, f_duc) - px_c) / 4.0,
         (cam_mod.world2cam(cam, f_dvc) - px_c) / 4.0],
        dim=-1)  # (M, 2, 2) columns [du, dv]

    # Best search level: quarter det while det > 3, max level 2 (:320-331)
    D = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    search = torch.zeros(M, dtype=torch.int32, device=dev)
    Dw = D
    for _ in range(2):
        step = Dw > 3.0
        search = search + step.to(torch.int32)
        Dw = torch.where(step, Dw * 0.25, Dw)

    ok = D.abs() > 1e-8
    det_safe = torch.where(ok, D, 1.0)
    Ainv = torch.stack(
        [torch.stack([A[:, 1, 1], -A[:, 0, 1]], dim=-1),
         torch.stack([-A[:, 1, 0], A[:, 0, 0]], dim=-1)],
        dim=-2) / det_safe[:, None, None]

    dx, dy = img_ops.patch_offsets(ps, dev)  # (ps²,) column/row offsets
    offs = torch.stack([dx, dy], dim=-1).to(torch.float32)  # (ps², 2)
    slot = sel_obs[:, _O_SLOT].to(torch.int32)
    fid = sel_obs[:, _O_FID].to(torch.int32)
    F = cfg.frame_ring
    slot_c = torch.clamp(slot, 0, F - 1)
    ref_ok = ok & (slot >= 0) & (ring.ids[slot_c.long()] == fid)

    h_img, w_img = ring.imgs.shape[1], ring.imgs.shape[2]
    # All pyramid levels in one gather set.
    lvl_sc = _const(tuple(float(1 << l) for l in range(cfg.pyramid_levels)),
                    torch.float32, str(dev))
    sc = (lvl_sc[None, :, None, None]
          * torch.pow(2.0, search.to(torch.float32))[:, None, None, None])
    px_patch = offs[None, None, :, :] * sc  # (M, L, ps², 2)
    samp = (torch.einsum("mij,mlpj->mlpi", Ainv, px_patch)
            + px_ref[:, None, None, :])
    u, vv = samp[..., 0], samp[..., 1]
    inb = (u >= 0) & (vv >= 0) & (u < w_img - 1) & (vv < h_img - 1)
    x0 = torch.clamp(torch.floor(u).to(torch.int32), 0, w_img - 2)
    y0 = torch.clamp(torch.floor(vv).to(torch.int32), 0, h_img - 2)
    su = u - x0
    sv = vv - y0
    # The four bilinear taps as one flat gather into the ring.
    base = (slot_c[:, None, None].long() * (h_img * w_img)
            + y0.long() * w_img + x0.long())
    taps = torch.stack([base, base + 1, base + w_img, base + w_img + 1], dim=-1)
    blk = ring.imgs.reshape(-1)[taps]  # (M, L, ps², 4) = [tl, tr, bl, br]
    val = ((1 - su) * (1 - sv) * blk[..., 0] + su * (1 - sv) * blk[..., 1]
           + (1 - su) * sv * blk[..., 2] + su * sv * blk[..., 3])
    warp = torch.where(inb, val, 0.0)  # (M, L, ps²)
    return search, warp, ref_ok


def retrieve(pool: VisualPool, ring: FrameRing, img, depth_img, state: NavState,
             cam: cam_mod.Camera, Rci, Pci, cfg: VIOConfig):
    """Build the tracked submap for this frame (retrieveFromVisualSparseMap,
    vio.cpp:352-782). Returns (submap, pool); the pool is not written."""
    ps = cfg.patch_size
    M = n_cells(cfg)
    K = cfg.max_obs
    dev = img.device
    Rcw, Pcw = camera_pose(state, Rci, Pci)
    cam_pos = -Rcw.T @ Pcw

    point = pool.point[:-1]
    pos_all = point[:, _P_POS]
    pc = pos_all @ Rcw.T + Pcw
    px = cam_mod.world2cam(cam, pc)
    # _P_VALID implies >= 1 live observation: ring_insert (run before
    # retrieval) kills points whose last observation died.
    cand = ((point[:, _P_VALID] > 0.5) & (pc[:, 2] > 0)
            & cam_mod.in_frame(cam, px, border_px(cfg)))
    cell = _grid_cell(px, cfg)
    dist = torch.linalg.norm(pos_all - cam_pos, dim=-1)
    win = _cell_argbest(cell, dist, cand, M, "min")  # (M,) pool idx or -1

    sel = win >= 0
    pidx = torch.where(sel, win, 0)
    pl = pidx.long()
    sel_point = pool.point[pl]  # (M, 19)
    sel_obs_rows = pool.obs[pl]  # (M, K, 20)
    sel_patches = pool.obs_patch[pl]  # (M, K, ps²)
    sel_pc = sel_point[:, _P_POS] @ Rcw.T + Pcw
    sel_px = cam_mod.world2cam(cam, sel_pc)

    # Depth continuity (vio.cpp:619-640).
    dxo, dyo = img_ops.patch_offsets(ps + 1, dev)  # +-half inclusive: 9x9
    cx = torch.clamp(sel_px[:, 0].to(torch.int32)[:, None] + dxo[None, :], 0,
                     cam.width - 1)
    cy = torch.clamp(sel_px[:, 1].to(torch.int32)[:, None] + dyo[None, :], 0,
                     cam.height - 1)
    dpatch = depth_img[cy.long(), cx.long()]
    bad_depth = torch.any(
        (dpatch > 0) & ((sel_pc[:, 2:3] - dpatch).abs() > 0.5), dim=1)
    sel = sel & ~bad_depth

    obs_valid = sel_obs_rows[:, :, _O_VALID] > 0.5  # (M, K)
    if cfg.normal_en:
        # Reference patch: the observation with minimum mean photometric
        # error against the others, cached per point (vio.cpp:653-693).
        n_obs_sel = torch.sum(obs_valid, dim=1)
        diff = sel_patches[:, :, None, :] - sel_patches[:, None, :, :]
        perr = torch.sum(diff * diff, dim=-1)  # (M, K, K)
        not_eye = ~torch.eye(K, dtype=torch.bool, device=dev)
        pair_ok = obs_valid[:, :, None] & obs_valid[:, None, :] & not_eye
        cnt = torch.clamp(torch.sum(pair_ok, dim=-1), min=1)
        mean_err = torch.where(
            obs_valid, torch.sum(torch.where(pair_ok, perr, 0.0), dim=-1) / cnt,
            _BIG)
        best_obs = torch.argmin(mean_err, dim=-1).to(torch.int32)
        first_obs = torch.argmax(obs_valid.to(torch.int32), dim=-1).to(torch.int32)
        had_ref = sel_point[:, _P_HASREF] > 0.5
        prev_ref = torch.clamp(sel_point[:, _P_REF].to(torch.int32), 0, K - 1)
        ref_valid_still = torch.gather(obs_valid, 1, prev_ref.long()[:, None])[:, 0]
        ref_slot = torch.where(
            had_ref & ref_valid_still, prev_ref,
            torch.where(n_obs_sel == 1, first_obs, best_obs))
        # The chosen refs ride point_rows to the maintenance scatter.
        new_point_rows = sel_point.clone()
        new_point_rows[:, _P_REF] = ref_slot.to(torch.float32)
        new_point_rows[:, _P_HASREF] = 1.0
    else:
        # Closest-view observation (VisualPoint::getCloseViewObs,
        # visual_point.cpp:57-95); drop the point past 60 degrees. No ref
        # caching (the reference re-picks every frame in this branch).
        obs_R = sel_obs_rows[:, :, _O_R].reshape(M, K, 3, 3)
        obs_t = sel_obs_rows[:, :, _O_T]  # world->cam translation
        obs_cam_pos = -torch.einsum("mkji,mkj->mki", obs_R, obs_t)
        cur_dir = cam_pos[None, :] - sel_point[:, _P_POS]
        cur_dir = cur_dir / torch.clamp(
            torch.linalg.norm(cur_dir, dim=-1, keepdim=True), min=1e-9)
        obs_dir = obs_cam_pos - sel_point[:, None, _P_POS]
        obs_dir = obs_dir / torch.clamp(
            torch.linalg.norm(obs_dir, dim=-1, keepdim=True), min=1e-9)
        cos_a = torch.where(obs_valid,
                            torch.sum(obs_dir * cur_dir[:, None, :], dim=-1), -2.0)
        ref_slot = torch.argmax(cos_a, dim=-1).to(torch.int32)
        sel = sel & (torch.amax(cos_a, dim=-1) >= 0.5)
        new_point_rows = sel_point

    sel_ref_obs = _take_k(sel_obs_rows, ref_slot)  # (M, 20)
    if cfg.normal_en:
        warp_rows = new_point_rows
    else:
        # Fronto-parallel warp (getWarpMatrixAffine, vio.cpp:276-292):
        # the homography with the normal set to the ref camera's optical
        # axis reproduces the constant-depth back-projection.
        R_ref_sel = sel_ref_obs[:, _O_R].reshape(M, 3, 3)
        warp_rows = new_point_rows.clone()
        warp_rows[:, _P_NRM] = R_ref_sel[:, 2, :]
    search, warp, warp_ok = _warp_homography(
        cam, ring, sel_ref_obs, warp_rows, Rcw, Pcw, cfg)
    sel = sel & warp_ok

    # Outlier gate on the exposure-normalized level-0 error (:744-763)
    ones = torch.ones(M, dtype=torch.int32, device=dev)
    cur_patch = img_ops.sample_patches(img, sel_px, ones, ps)
    ref_expo = sel_ref_obs[:, _O_EXPO]
    e = ref_expo[:, None] * warp[:, 0, :] - state.inv_expo * cur_patch
    err0 = torch.sum(e * e, dim=-1)
    sel = sel & (err0 <= cfg.outlier_threshold * ps * ps)
    if cfg.ncc_en:
        a = warp[:, 0, :] - torch.mean(warp[:, 0, :], dim=-1, keepdim=True)
        b = cur_patch - torch.mean(cur_patch, dim=-1, keepdim=True)
        ncc = torch.sum(a * b, dim=-1) / torch.sqrt(
            torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1) + 1e-10)
        sel = sel & (ncc >= cfg.ncc_thre)

    ref_meta = torch.cat(
        [sel_ref_obs[:, _O_PX], sel_ref_obs[:, _O_R], sel_ref_obs[:, _O_T],
         sel_ref_obs[:, _O_SLOT:_O_SLOT + 1]], dim=-1)
    submap = Submap(
        valid=sel, point_idx=pidx, pos=sel_point[:, _P_POS],
        search_level=search, warp_patch=warp, ref_expo=ref_expo,
        propa_error=err0, ref_meta=ref_meta, point_rows=new_point_rows,
        obs_rows=sel_obs_rows, patch_rows=sel_patches)
    return submap, pool


def photometric_update(state_prop: NavState, cov_prop, submap: Submap, img,
                       cam: cam_mod.Camera, Rci, Pci, cfg: VIOConfig,
                       device_loop: bool = False):
    """Coarse-to-fine iterated photometric ESIKF
    (computeJacobianAndUpdateEKF + updateState, vio.cpp:784-802,
    :1520-1688). Returns (state, cov, mean_error, iterations): the
    iterations that took effect, a host int, or with `device_loop` (all
    pyramid_levels x max_iterations iterations run, masked, with no host
    read) a 0-d int32 device tensor. One ops/photo_iteration call an
    iteration run where the fused path is taken, and one ops/photo_tail
    call an iteration run in every path."""
    f32 = cov_prop.dtype
    dev = cov_prop.device
    ps = cfg.patch_size
    expo_col = 1.0 if cfg.exposure_estimate_en else 0.0

    Pic = -Rci.T @ Pci
    Jdphi_dR = Rci
    Jdp_dR = -Rci @ so3.skew(Pic)

    cov_sym = 0.5 * (cov_prop + cov_prop.T)
    P_scaled_inv = torch.linalg.inv_ex(cov_sym / cfg.img_point_cov).inverse

    n_meas = torch.clamp(torch.sum(submap.valid) * ps * ps, min=1).to(f32)

    state = state_prop
    G_keep = torch.zeros((DIM_STATE, DIM_STATE), dtype=f32, device=dev)
    final_err = torch.zeros((), dtype=f32, device=dev)
    img_stack = (img_ops.box_stack(img, cfg.pyramid_levels + 2)
                 if cfg.true_pyramid else None)
    # The JAX package's dispatch predicate (vio.py:546-549) without its
    # two TPU-only terms, the backend test and the M <= 448 gate (both set
    # from TPU timings): the kernel on CUDA, its plain version on CPU. Above
    # the gate the kernel samples as the JAX package's XLA path does there
    # (clip_taps), decided here from the static M.
    fused = (cfg.pallas_photo and not cfg.true_pyramid
             and cam.model == "pinhole" and ps == 8)
    clip_taps = photo_mod.clip_taps_at(submap.pos.shape[0])
    has_dist = 1.0 if cam_mod.has_distortion(cam) else 0.0
    img32 = img.to(torch.float32).contiguous()
    iterations = 0

    for level in reversed(range(cfg.pyramid_levels)):
        search = submap.search_level.to(torch.int32)
        scale = (1 << level) * torch.pow(2, search)
        eff_lvl = level + search
        inv_scale = 1.0 / scale.to(f32)
        ref = submap.ref_expo[:, None] * submap.warp_patch[:, level, :]
        if fused:
            meta, ref_patch = photo_mod.pack_points(
                submap.pos, ref, eff_lvl, submap.valid, ps)

        def normal_equations(state):  # (called within this level)
            Rcw, Pcw = camera_pose(state, Rci, Pci)
            tau = state.inv_expo
            if fused:
                par = photo_mod.pack_params(
                    Rcw, Pcw, tau, Jdphi_dR, Jdp_dR, cam.fx, cam.fy, cam.cx,
                    cam.cy, cam.d, expo_col, has_dist)
                HTH7, HTz7, err_sum, _ = photo_mod.photo_iteration(
                    img32, meta, ref_patch, par, ps, clip_taps=clip_taps)
                return HTH7.to(f32), HTz7.to(f32), err_sum.to(f32) / n_meas
            pf = submap.pos @ Rcw.T + Pcw
            px = cam_mod.world2cam(cam, pf)
            ok = submap.valid & (pf[:, 2] > 1e-6)
            if cfg.true_pyramid:
                val, du, dv = img_ops.sample_patches_with_grad(
                    img_stack, px, scale, ps, img_idx=eff_lvl)
            else:
                val, du, dv = img_ops.sample_patches_with_grad(
                    img, px, scale, ps)
            Jimg = (torch.stack([du, dv], dim=-1)
                    * (tau * inv_scale[:, None])[..., None])
            Jdpi = cam_mod.projection_jacobian(cam, pf)  # (M, 2, 3)
            p_hat = so3.skew(pf)
            Jca = torch.einsum("mpi,mij->mpj", Jimg, Jdpi)  # (M, ps², 3)
            Jdphi = torch.einsum("mpi,mij->mpj", Jca, p_hat)
            JdR = (torch.einsum("mpi,ij->mpj", Jdphi, Jdphi_dR)
                   + torch.einsum("mpi,ij->mpj", -Jca, Jdp_dR))
            Jdt = torch.einsum("mpi,ij->mpj", -Jca, Rcw)  # Jdp_dt = Rcw
            res = tau * val - ref
            Hcol = (val * expo_col)[..., None]
            H = torch.cat([JdR, Jdt, Hcol], dim=-1)  # (M, ps², 7)
            okf = ok.to(f32)
            error = torch.sum(okf[:, None] * res * res) / n_meas
            return (torch.einsum("mpi,mpj,m->ij", H, H, okf),
                    torch.einsum("mpi,mp,m->i", H, res, okf), error)

        state, G_keep, final_err, n_it = _iterate_level(
            state_prop, state, G_keep, final_err, P_scaled_inv,
            normal_equations, cfg.max_iterations, device_loop)
        iterations = iterations + n_it

    cov = cov_prop - G_keep @ cov_prop
    return state, cov, final_err, iterations


def _iterate_level(state_prop: NavState, state: NavState, G_keep, final_err,
                   P_scaled_inv, normal_equations, max_iterations: int,
                   device_loop: bool):
    """One pyramid level of the iterated photometric ESIKF (updateState's
    loop, vio.cpp:1558-1688), shared by the forward and the inverse-
    compositional updates. normal_equations(state) -> (HTH (n, n), HTz
    (n,), error) over the first n state columns. Each iteration's filter
    tail (the solve, boxminus / boxplus, the accept rule) is one
    ops/photo_tail call, one kernel on the card, on the level's carried
    buffers; the state normal_equations reads is a view into them.
    Returns (state, G_keep, final_err, iterations that took effect: an
    int, or a 0-d int32 tensor in the device loop)."""
    carry, flags = tail_mod.start_level(state_prop, state, G_keep, final_err)
    state = tail_mod.nav_view(carry, tail_mod.STATE)
    iterations = 0
    for it in range(max_iterations):
        HTHn, HTzn, error = normal_equations(state)
        tail_mod.photo_tail(carry, flags, P_scaled_inv, HTHn, HTzn, error,
                            device_loop)
        if device_loop:
            continue
        iterations += 1
        # The loop condition of the JAX while_loop (~accept | converged),
        # read on the host; after the last iteration the count alone ends
        # the level.
        if it + 1 < max_iterations and bool(flags[tail_mod.DONE]):
            break
    state, G_keep, final_err = tail_mod.level_result(carry)
    return (state, G_keep, final_err,
            flags[tail_mod.ITERS] if device_loop else iterations)


def photometric_update_ic(state_prop: NavState, cov_prop, submap: Submap,
                          img, ring: FrameRing, cam: cam_mod.Camera, Rci,
                          Pci, cfg: VIOConfig, device_loop: bool = False):
    """Inverse-compositional variant of the photometric update
    (precomputeReferencePatches + updateStateInverse, vio.cpp:1327-1518):
    per-pixel Jacobians are precomputed once per pyramid level from the
    reference frame's gradients (sampled from the ring at each point's
    reference slot), so each iteration samples only current-image values
    and composes the cached 6-dof Jacobian with the current rotation
    (:1470-1474). Like the reference it is 6-dof (no exposure column)
    with plain pyramid scales (no per-point search level), and it runs
    no K2: tensor ops in both packages. Returns photometric_update's
    (state, cov, mean_error, iterations), in either loop form."""
    f32 = cov_prop.dtype
    dev = cov_prop.device
    ps = cfg.patch_size
    M = submap.valid.shape[0]

    cov_sym = 0.5 * (cov_prop + cov_prop.T)
    P_scaled_inv = torch.linalg.inv_ex(cov_sym / cfg.img_point_cov).inverse
    n_meas = torch.clamp(torch.sum(submap.valid) * ps * ps, min=1).to(f32)

    ref_px = submap.ref_meta[:, 0:2]
    R_ref_w = submap.ref_meta[:, 2:11].reshape(M, 3, 3)
    t_ref = submap.ref_meta[:, 11:14]
    slot = torch.clamp(submap.ref_meta[:, 14].to(torch.int32), 0,
                       cfg.frame_ring - 1)
    # pf in the ref camera: f_ref * depth (:1350-1352)
    f_ref = cam_mod.cam2world(cam, ref_px)
    ref_cam_center = -torch.einsum("mji,mj->mi", R_ref_w, t_ref)
    depth = torch.linalg.norm(submap.pos - ref_cam_center, dim=-1)
    pf_ref = f_ref * (depth / torch.clamp(f_ref[:, 2], min=1e-6))[:, None]
    p_w_hat = so3.skew(submap.pos)

    state = state_prop
    G_keep = torch.zeros((DIM_STATE, DIM_STATE), dtype=f32, device=dev)
    final_err = torch.zeros((), dtype=f32, device=dev)
    iterations = 0
    for level in reversed(range(cfg.pyramid_levels)):
        scale = torch.full((M,), 1 << level, dtype=torch.int32, device=dev)
        inv_scale = 1.0 / float(1 << level)
        ref = submap.warp_patch[:, level, :]
        # --- reference Jacobians (:1341-1394) ---
        _, du_r, dv_r = img_ops.sample_patches_with_grad(
            ring.imgs, ref_px, scale, ps, img_idx=slot)
        Jimg_r = torch.stack([du_r, dv_r], dim=-1) * inv_scale  # (M, ps², 2)
        Jdpi_r = cam_mod.projection_jacobian(cam, pf_ref)  # (M, 2, 3)
        JR = torch.einsum("mpi,mij,mjk->mpk", Jimg_r, Jdpi_r, R_ref_w)
        JdR0 = torch.einsum("mpi,mij->mpj", JR, p_w_hat)  # (M, ps², 3)
        Jdt0 = -JR

        def normal_equations(state):  # (called within this level)
            Rcw, Pcw = camera_pose(state, Rci, Pci)
            pf = submap.pos @ Rcw.T + Pcw
            px = cam_mod.world2cam(cam, pf)
            ok = submap.valid & (pf[:, 2] > 1e-6)
            res = img_ops.sample_patches(img, px, scale, ps) - ref
            Rwi = state.rot
            # JdR = J_dR Rwi + J_dt [Pwi]x Rwi ; Jdt = J_dt Rwi (:1472-1473)
            JdR = (torch.einsum("mpi,ij->mpj", JdR0, Rwi)
                   + torch.einsum("mpi,ij,jk->mpk", Jdt0,
                                  so3.skew(state.pos), Rwi))
            Jdt = torch.einsum("mpi,ij->mpj", Jdt0, Rwi)
            H = torch.cat([JdR, Jdt], dim=-1)  # (M, ps², 6)
            okf = ok.to(f32)
            error = torch.sum(okf[:, None] * res * res) / n_meas
            return (torch.einsum("mpi,mpj,m->ij", H, H, okf),
                    torch.einsum("mpi,mp,m->i", H, res, okf), error)

        state, G_keep, final_err, n_it = _iterate_level(
            state_prop, state, G_keep, final_err, P_scaled_inv,
            normal_equations, cfg.max_iterations, device_loop)
        iterations = iterations + n_it

    cov = cov_prop - G_keep @ cov_prop
    return state, cov, final_err, iterations


def _frame_index(x, device) -> torch.Tensor:
    """A frame id or ring slot as a 0-d int32 tensor on `device` (the
    pipeline passes tensors; a Python int is converted)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.tensor(int(x), dtype=torch.int32, device=device)


def _make_obs_row(px, Rcw, Pcw, expo, frame_slot, frame_id, mean, score, M):
    """Full (M, 20) packed observation rows; frame_slot and frame_id are
    0-d int32 tensors."""
    f = dict(dtype=torch.float32, device=px.device)
    return torch.cat([
        torch.ones((M, 1), **f), px,
        Rcw.reshape(1, 9).expand(M, 9), Pcw.reshape(1, 3).expand(M, 3),
        expo.reshape(1, 1).expand(M, 1),
        frame_slot.to(torch.float32).reshape(1, 1).expand(M, 1),
        frame_id.to(torch.float32).reshape(1, 1).expand(M, 1),
        mean[:, None], score[:, None],
    ], dim=-1)


def _generate_rows(pool_alloc, img, pg_w, pg_normal, pg_var6, pg_valid,
                   cell_occupied, state: NavState, cam: cam_mod.Camera,
                   Rci, Pci, frame_id, frame_slot, cfg: VIOConfig):
    """Row-level core of new-point generation (generateVisualMapPoints,
    vio.cpp:804-906): the best Shi-Tomasi candidate per empty grid cell.
    Returns (slot (M,) with P for dropped, point_rows, obs_rows,
    patch_rows, n_added)."""
    ps = cfg.patch_size
    M = n_cells(cfg)
    P = cfg.pool_capacity
    K = cfg.max_obs
    dev = img.device
    Rcw, Pcw = camera_pose(state, Rci, Pci)

    pc = pg_w @ Rcw.T + Pcw
    px = cam_mod.world2cam(cam, pc)
    has_normal = torch.any(pg_normal != 0.0, dim=-1)  # (:811)
    cand = (pg_valid & has_normal & (pc[:, 2] > 0)
            & cam_mod.in_frame(cam, px, border_px(cfg)))
    cell = _grid_cell(px, cfg)
    score = img_ops.shi_tomasi(img, px)
    cand = cand & ~cell_occupied[cell.long()]
    win = _cell_argbest(cell, score, cand, M, "max")  # (M,) pg idx or -1

    chosen = win >= 0
    gi = torch.where(chosen, win, 0).long()
    g12 = torch.cat([pg_w, pg_normal, pg_var6], dim=-1)[gi]  # (M, 12)
    new_pos = g12[:, 0:3]
    nrm = g12[:, 3:6]
    new_var6 = g12[:, 6:12]
    # Normal sign: point it toward the camera (:867-890).
    norm_cam = torch.einsum("ij,mj->mi", Rcw, nrm)
    dir_cam = new_pos @ Rcw.T + Pcw
    dir_cam = dir_cam / torch.clamp(
        torch.linalg.norm(dir_cam, dim=-1, keepdim=True), min=1e-9)
    flip = torch.sum(dir_cam * norm_cam, dim=-1) < 0
    new_normal = torch.where(flip[:, None], -nrm, nrm)

    chosen_i = chosen.to(torch.int32)
    offset = torch.cumsum(chosen_i, dim=0, dtype=torch.int32) - 1
    n_added = torch.sum(chosen_i)
    slot = torch.where(chosen, (pool_alloc.to(torch.int32) + offset) % P, P)

    new_px = cam_mod.world2cam(cam, new_pos @ Rcw.T + Pcw)
    ones = torch.ones(M, dtype=torch.int32, device=dev)
    patch = img_ops.sample_patches(img, new_px, ones, ps)

    one_col = torch.ones((M, 1), dtype=torch.float32, device=dev)
    zero_col = torch.zeros((M, 1), dtype=torch.float32, device=dev)
    point_rows = torch.cat(
        [new_pos, new_normal, new_normal, new_var6,
         one_col,    # valid
         zero_col,   # converged
         one_col,    # has_ref
         zero_col],  # ref_slot = 0
        dim=-1)
    obs0 = _make_obs_row(new_px, Rcw, Pcw, state.inv_expo, frame_slot,
                         frame_id, torch.mean(patch, dim=-1),
                         torch.zeros(M, dtype=torch.float32, device=dev), M)
    obs_rows = torch.zeros((M, K, OBS_W), dtype=torch.float32, device=dev)
    obs_rows[:, 0, :] = obs0
    patch_rows = torch.zeros((M, K, ps * ps), dtype=torch.float32, device=dev)
    patch_rows[:, 0, :] = patch
    return slot, point_rows, obs_rows, patch_rows, n_added


def _update_obs_rows(point_rows, obs_rows, patches, submap: Submap, img,
                     state: NavState, cam: cam_mod.Camera, Rci, Pci,
                     frame_id, frame_slot, cfg: VIOConfig):
    """Row-level core of the observation update (updateVisualMapPoints,
    vio.cpp:908-967) over pre-gathered (M, ...) pool rows. Returns new
    (point_rows, obs_rows, patches, update_flag (M,))."""
    ps = cfg.patch_size
    K = cfg.max_obs
    M = submap.valid.shape[0]
    dev = img.device
    Rcw, Pcw = camera_pose(state, Rci, Pci)
    conv = (point_rows[:, _P_CONV] > 0.5) & submap.valid
    ref_slot = point_rows[:, _P_REF].to(torch.int32)
    k_iota = torch.arange(K, dtype=torch.int32, device=dev)[None, :]

    # deleteNonRefPatchFeatures: keep only the ref slot.
    keep_only_ref = k_iota == ref_slot[:, None]
    obs_valid0 = obs_rows[:, :, _O_VALID] > 0.5
    new_valid = torch.where(conv[:, None], obs_valid0 & keep_only_ref, obs_valid0)
    obs_rows = obs_rows.clone()
    obs_rows[:, :, _O_VALID] = new_valid.to(torch.float32)

    lane_ok = submap.valid & ~conv
    px = cam_mod.world2cam(cam, point_rows[:, _P_POS] @ Rcw.T + Pcw)

    fid = torch.where(new_valid, obs_rows[:, :, _O_FID], -1.0)
    last = torch.argmax(fid, dim=-1)  # most recent obs
    last_obs = _take_k(obs_rows, last)
    R_l = last_obs[:, _O_R].reshape(M, 3, 3)
    t_l = last_obs[:, _O_T]
    px_l = last_obs[:, _O_PX]
    # delta_pose = pose_ref * pose_cur^{-1} (:935-939)
    R_d = R_l @ Rcw.T
    t_d = t_l - torch.einsum("mij,j->mi", R_d, Pcw)
    delta_p = torch.linalg.norm(t_d, dim=-1)
    tr = torch.clamp((R_d[:, 0, 0] + R_d[:, 1, 1] + R_d[:, 2, 2] - 1.0) * 0.5,
                     -1.0, 1.0)
    delta_theta = torch.arccos(tr)
    pixel_dist = torch.linalg.norm(px - px_l, dim=-1)
    add = lane_ok & ((delta_p > cfg.select_obs_gap_p)
                     | (delta_theta > cfg.select_obs_gap_theta)
                     | (pixel_dist > cfg.select_obs_gap_px))

    # Slot choice: first free, else min-score eviction (:946-953).
    free = ~new_valid
    any_free = torch.any(free, dim=-1)
    first_free = torch.argmax(free.to(torch.int32), dim=-1).to(torch.int32)
    evict = torch.argmin(torch.where(new_valid, obs_rows[:, :, _O_SCORE], _BIG),
                         dim=-1).to(torch.int32)
    wslot = torch.where(any_free, first_free, evict)
    # Evicting the ref drops the cached ref (visual_point.cpp:113-127).
    ref_killed = ~any_free & (wslot == ref_slot)
    point_rows = point_rows.clone()
    point_rows[:, _P_HASREF] = torch.where(add & ref_killed, 0.0,
                                           point_rows[:, _P_HASREF])

    ones = torch.ones(M, dtype=torch.int32, device=dev)
    patch = img_ops.sample_patches(img, px, ones, ps)
    new_obs = _make_obs_row(px, Rcw, Pcw, state.inv_expo, frame_slot, frame_id,
                            torch.mean(patch, dim=-1),
                            torch.zeros(M, dtype=torch.float32, device=dev), M)
    write_row = (k_iota == wslot[:, None]) & add[:, None]
    obs_rows = torch.where(write_row[:, :, None], new_obs[:, None, :], obs_rows)
    patches = torch.where(write_row[:, :, None], patch[:, None, :], patches)
    return point_rows, obs_rows, patches, add


def _update_reference_rows(point_rows, obs_rows, patches,
                           vmap_state: VoxelMap, map_cfg: VoxelMapConfig,
                           submap: Submap, updated: torch.Tensor,
                           cfg: VIOConfig):
    """Row-level core of the reference refinement (updateReferencePatch,
    vio.cpp:969-1100) over pre-gathered (M, ...) pool rows. Returns new
    (point_rows, obs_rows)."""
    K = cfg.max_obs
    M = submap.valid.shape[0]
    dev = patches.device
    obs_valid = obs_rows[:, :, _O_VALID] > 0.5
    n_obs = torch.sum(obs_valid, dim=-1)
    conv = point_rows[:, _P_CONV] > 0.5
    lane = submap.valid & updated & ~conv & (n_obs > 5)

    pos = point_rows[:, _P_POS]
    found, pn, pd, pcen, prad, psigma = query_plane(vmap_state, pos, map_cfg)
    dis = torch.sum(pn * pos, dim=-1) + pd
    a = pos - pcen
    dc2 = torch.sum(a * a, dim=-1)
    range_ok = torch.clamp(dc2 - dis * dis, min=0.0) <= (3.0 * prad) ** 2
    sigma_l = psigma + quad6(point_rows[:, _P_COV], pn)
    gate = dis.abs() < 3.0 * torch.sqrt(torch.clamp(sigma_l, min=1e-12))
    refine = lane & found & range_ok & gate

    prev = point_rows[:, _P_PRV]
    sign = torch.where(torch.sum(prev * pn, dim=-1) < 0, -1.0, 1.0)
    new_normal = sign[:, None] * pn
    normal_update = torch.linalg.norm(new_normal - prev, dim=-1)
    new_conv = refine & (normal_update < 1e-4) & (n_obs > 10)

    point_rows = point_rows.clone()
    point_rows[:, _P_NRM] = torch.where(refine[:, None], new_normal,
                                        point_rows[:, _P_NRM])
    point_rows[:, _P_PRV] = torch.where(refine[:, None], new_normal,
                                        point_rows[:, _P_PRV])
    point_rows[:, _P_CONV] = torch.where(new_conv, 1.0, point_rows[:, _P_CONV])

    # --- observation re-scoring (:1036-1097) ---
    means = torch.mean(patches, dim=-1)
    cen = patches - means[..., None]
    num = torch.einsum("mkp,mlp->mkl", cen, cen)
    sq = torch.einsum("mkp,mkp->mk", cen, cen)
    den = torch.sqrt(sq[:, :, None] * sq[:, None, :] + 1e-10)
    ncc = (num / den).abs()  # (M, K, K)
    not_eye = ~torch.eye(K, dtype=torch.bool, device=dev)
    pair = obs_valid[:, :, None] & obs_valid[:, None, :] & not_eye
    cnt = torch.clamp(torch.sum(pair, dim=-1), min=1)
    ncc_mean = torch.sum(torch.where(pair, ncc, 0.0), dim=-1) / cnt

    R_obs = obs_rows[:, :, _O_R].reshape(M, K, 3, 3)
    pf = torch.einsum("mkij,mj->mki", R_obs, pos) + obs_rows[:, :, _O_T]
    pf = pf / torch.clamp(torch.linalg.norm(pf, dim=-1, keepdim=True), min=1e-9)
    nrm = torch.einsum("mkij,mj->mki", R_obs, point_rows[:, _P_NRM])
    cos_angle = torch.sum(pf * nrm, dim=-1)
    score = torch.where(obs_valid, ncc_mean + cos_angle, -_BIG)
    best = torch.argmax(score, dim=-1).to(torch.float32)

    obs_rows = obs_rows.clone()
    obs_rows[:, :, _O_SCORE] = torch.where(obs_valid, score, 0.0)
    obs_rows[:, :, _O_MEAN] = means
    point_rows[:, _P_REF] = torch.where(lane, best, point_rows[:, _P_REF])
    point_rows[:, _P_HASREF] = torch.where(lane, 1.0, point_rows[:, _P_HASREF])
    return point_rows, obs_rows


def _write_rows(pool: VisualPool, idx, point_rows, obs_rows,
                patch_rows=None):
    """Scatter rows into the pool tensors in place at `idx` (P, the sink
    row, for a dropped row)."""
    idx = idx.long()
    pool.point[idx] = point_rows
    pool.obs[idx] = obs_rows
    if patch_rows is not None:
        pool.obs_patch[idx] = patch_rows


def generate_points(pool: VisualPool, img, pg_w, pg_normal, pg_var6,
                    pg_valid, cell_occupied, state: NavState,
                    cam: cam_mod.Camera, Rci, Pci, frame_id, frame_slot,
                    cfg: VIOConfig):
    """Standalone new-point generation (row core + scatter, in place);
    vio_step runs the fused generate_and_maintain instead. Allocation
    wraps the pool (the oldest slots are recycled). pg_var6: (N, 6) sym6
    point covariances; cell_occupied: (M,) grid cells already tracked.
    Returns (pool, n_added ())."""
    slot, point_rows, obs_rows, patch_rows, n_added = _generate_rows(
        pool.alloc, img, pg_w, pg_normal, pg_var6, pg_valid, cell_occupied,
        state, cam, Rci, Pci, _frame_index(frame_id, img.device),
        _frame_index(frame_slot, img.device), cfg)
    _write_rows(pool, slot, point_rows, obs_rows, patch_rows)
    return pool._replace(alloc=pool.alloc + n_added.to(torch.float32)), n_added


def update_obs(pool: VisualPool, submap: Submap, img, state: NavState,
               cam: cam_mod.Camera, Rci, Pci, frame_id, frame_slot,
               cfg: VIOConfig):
    """Standalone observation update (core + scatter of the submap's
    rows, in place); vio_step runs the fused form instead. Returns
    (pool, update_flag (M,))."""
    point_rows, obs_rows, patches, add = _update_obs_rows(
        submap.point_rows, submap.obs_rows, submap.patch_rows, submap, img,
        state, cam, Rci, Pci, _frame_index(frame_id, img.device),
        _frame_index(frame_slot, img.device), cfg)
    wp = torch.where(submap.valid, submap.point_idx, cfg.pool_capacity)
    _write_rows(pool, wp, point_rows, obs_rows, patches)
    return pool, add


def update_reference(pool: VisualPool, vmap_state: VoxelMap,
                     map_cfg: VoxelMapConfig, submap: Submap,
                     updated: torch.Tensor, cfg: VIOConfig):
    """Standalone reference refinement (core + scatter of the submap's
    point and observation rows, in place); vio_step runs the fused form
    instead. updated: (M,) the observation update's flags. Returns the
    pool."""
    point_rows, obs_rows = _update_reference_rows(
        submap.point_rows, submap.obs_rows, submap.patch_rows, vmap_state,
        map_cfg, submap, updated, cfg)
    wl = torch.where(submap.valid, submap.point_idx, cfg.pool_capacity)
    _write_rows(pool, wl, point_rows, obs_rows)
    return pool


def _maintained_rows(submap: Submap, img, state: NavState,
                     cam: cam_mod.Camera, Rci, Pci, frame_id, frame_slot,
                     vmap_state: VoxelMap, map_cfg: VoxelMapConfig,
                     cfg: VIOConfig):
    """The observation update then the reference refinement on the same
    gathered rows: (point_rows, obs_rows, patches, update_flag)."""
    point_m, obs_m, patch_m, add = _update_obs_rows(
        submap.point_rows, submap.obs_rows, submap.patch_rows, submap, img,
        state, cam, Rci, Pci, frame_id, frame_slot, cfg)
    point_m, obs_m = _update_reference_rows(
        point_m, obs_m, patch_m, vmap_state, map_cfg, submap, add, cfg)
    return point_m, obs_m, patch_m, add


def maintain_points(pool: VisualPool, vmap_state: VoxelMap,
                    map_cfg: VoxelMapConfig, submap: Submap, img,
                    state: NavState, cam: cam_mod.Camera, Rci, Pci,
                    frame_id, frame_slot, cfg: VIOConfig):
    """Observation update + reference refinement on the same pool rows
    (submap.point_idx), gathered once and scattered once, in place.
    Returns (pool, update_flag (M,))."""
    point_m, obs_m, patch_m, add = _maintained_rows(
        submap, img, state, cam, Rci, Pci,
        _frame_index(frame_id, img.device),
        _frame_index(frame_slot, img.device), vmap_state, map_cfg, cfg)
    wp = torch.where(submap.valid, submap.point_idx, cfg.pool_capacity)
    _write_rows(pool, wp, point_m, obs_m, patch_m)
    return pool, add


def generate_and_maintain(pool: VisualPool, vmap_state: VoxelMap,
                          map_cfg: VoxelMapConfig, submap: Submap, img,
                          pg_w, pg_normal, pg_var6, pg_valid,
                          state: NavState, cam: cam_mod.Camera, Rci, Pci,
                          frame_id, frame_slot, cfg: VIOConfig):
    """New-point generation + observation update + reference refinement
    with one scatter per pool tensor, in place. Maintained rows that
    collide with a freshly allocated slot (the pool wrapping onto a
    tracked point) are dropped in favor of the new point; every other
    written slot is unique, and dropped rows go to the sink row P.
    Returns (pool, update_flag (M,), n_added ())."""
    P = cfg.pool_capacity
    pidx = submap.point_idx
    frame_id = _frame_index(frame_id, img.device)
    frame_slot = _frame_index(frame_slot, img.device)
    point_m, obs_m, patch_m, add = _maintained_rows(
        submap, img, state, cam, Rci, Pci, frame_id, frame_slot, vmap_state,
        map_cfg, cfg)
    slot_g, point_g, obs_g, patch_g, n_added = _generate_rows(
        pool.alloc, img, pg_w, pg_normal, pg_var6, pg_valid, submap.valid,
        state, cam, Rci, Pci, frame_id, frame_slot, cfg)
    wp = torch.where(submap.valid, pidx, P)
    collide = torch.any(wp[:, None] == slot_g[None, :], dim=1)
    wp = torch.where(collide, P, wp)
    _write_rows(pool, torch.cat([wp, slot_g]), torch.cat([point_m, point_g]),
                torch.cat([obs_m, obs_g]), torch.cat([patch_m, patch_g]))
    pool = pool._replace(alloc=pool.alloc + n_added.to(torch.float32))
    return pool, add, n_added


def ring_insert(pool: VisualPool, ring: FrameRing, img, frame_id,
                cfg: VIOConfig):
    """Write the frame into its ring slot and invalidate observations
    that referenced the evicted frame, in place. frame_id: a 0-d int32
    tensor (or an int). Returns (pool, ring, slot), slot a 0-d int32
    tensor computed on the device."""
    K = cfg.max_obs
    frame_id = _frame_index(frame_id, img.device)
    slot = frame_id % cfg.frame_ring
    at = slot.reshape(1).long()
    ring.imgs.index_copy_(0, at, img[None].to(ring.imgs.dtype))
    ring.ids.index_copy_(0, at, frame_id.reshape(1))
    obs_valid = pool.obs[:, :, _O_VALID] > 0.5
    evicted = ((pool.obs[:, :, _O_SLOT].to(torch.int32) == slot)
               & (pool.obs[:, :, _O_FID].to(torch.int32) != frame_id))
    new_valid = obs_valid & ~evicted
    pool.obs[:, :, _O_VALID] = new_valid.to(torch.float32)
    # Points whose ref obs died lose the cached ref; 0-obs points die.
    ref_slot = pool.point[:, _P_REF].to(torch.int32)
    oh = ref_slot[:, None] == torch.arange(K, dtype=torch.int32,
                                           device=ref_slot.device)[None, :]
    ref_alive = torch.any(new_valid & oh, dim=1)
    pool.point[:, _P_HASREF] *= ref_alive.to(torch.float32)
    pool.point[:, _P_VALID] *= torch.any(new_valid, dim=-1).to(torch.float32)
    return pool, ring, slot


class VIOStepResult(NamedTuple):
    state: NavState
    cov: torch.Tensor
    pool: VisualPool
    ring: FrameRing
    n_tracked: torch.Tensor
    n_added: torch.Tensor
    mean_error: torch.Tensor
    photo_iterations: object  # photometric iterations that took effect: a
    # host int, or a 0-d int32 tensor from the device loop


def vio_step(state_prop: NavState, cov_prop, pool: VisualPool, ring: FrameRing,
             vmap_state: VoxelMap, img, pg_w, pg_normal, pg_var, pg_valid,
             frame_id, cam: cam_mod.Camera, Rci, Pci, cfg: VIOConfig,
             map_cfg: VoxelMapConfig, ray_table=None,
             device_loop: bool = False) -> VIOStepResult:
    """One VIO frame (processFrame, vio.cpp:1786-1876): ring insert ->
    depth raster -> retrieval -> iterated photometric update (forward, or
    inverse-compositional with `inverse_composition_en`) -> with
    `raycast_en` and a `ray_table` (make_ray_table), raycast candidates
    appended to the scan's rows -> new-point generation + observation
    update + reference refinement. pg_var: (N, 3, 3) or (N, 6) sym6;
    frame_id a 0-d int32 tensor. The pool and ring are updated in place.
    `device_loop`: the photometric update's host-read-free form. Its
    sub-stages run in `annotate` ranges (vio.ring_insert, vio.raster,
    vio.retrieve, vio.photometric, vio.maintain: the raycast and the
    upkeep), which tile it."""
    pg_var6 = pg_var if pg_var.dim() == 2 else sym6(pg_var)
    with annotate("vio.ring_insert"):
        pool, ring, frame_slot = ring_insert(pool, ring, img, frame_id, cfg)

    with annotate("vio.raster"):
        Rcw0, Pcw0 = camera_pose(state_prop, Rci, Pci)
        depth_img = rasterize_depth(cam, Rcw0, Pcw0, pg_w, pg_valid,
                                    border_px(cfg))

    with annotate("vio.retrieve"):
        submap, pool = retrieve(pool, ring, img, depth_img, state_prop, cam,
                                Rci, Pci, cfg)
        n_tracked = torch.sum(submap.valid.to(torch.int32))
    with annotate("vio.photometric"):
        if cfg.inverse_composition_en:
            state, cov, mean_err, iters = photometric_update_ic(
                state_prop, cov_prop, submap, img, ring, cam, Rci, Pci, cfg,
                device_loop=device_loop)
        else:
            state, cov, mean_err, iters = photometric_update(
                state_prop, cov_prop, submap, img, cam, Rci, Pci, cfg,
                device_loop=device_loop)

    with annotate("vio.maintain"):
        if cfg.raycast_en and ray_table is not None:
            ray_samples, border_cell = ray_table
            scan_tab, _ = voxel_hash.lookup_or_insert(
                voxel_hash.make_table(RAY_SCAN_SLOTS, pg_w.device),
                voxel_hash.voxel_key(pg_w, map_cfg.voxel_size), pg_valid)
            rc_pos, rc_nrm, rc_ok = raycast_recover(
                vmap_state, map_cfg, ~submap.valid, border_cell, ray_samples,
                scan_tab, state, Rci, Pci)
            rc_var6 = _const(RAY_VAR6, pg_var6.dtype, str(pg_var6.device))
            pg_w = torch.cat([pg_w, rc_pos])
            pg_normal = torch.cat([pg_normal, rc_nrm])
            pg_var6 = torch.cat([pg_var6, rc_var6.expand(rc_pos.shape[0], 6)])
            pg_valid = torch.cat([pg_valid, rc_ok])

        pool, _, n_added = generate_and_maintain(
            pool, vmap_state, map_cfg, submap, img, pg_w, pg_normal, pg_var6,
            pg_valid, state, cam, Rci, Pci, frame_id, frame_slot, cfg)
    return VIOStepResult(state=state, cov=cov, pool=pool, ring=ring,
                         n_tracked=n_tracked, n_added=n_added,
                         mean_error=mean_err, photo_iterations=iters)


def capture_photo_factors(pool: VisualPool, ring: FrameRing, img, state,
                          pg_w, pg_valid, cam: cam_mod.Camera, Rci, Pci,
                          cfg: VIOConfig):
    """Photometric factor capture for the sliding-window backend
    (parallel/ba.PhotoFactors): the frame's retrieval re-run against the
    visual map at the keyframe's posterior state, the exposure-normalized
    reference patches packed as fixed targets,

        target = tau_ref * I_ref(warped)    (vio.cpp:1621's tau_ref * I_ref)

    so that the backend's residual for the keyframe is
    r = tau_k * I_k(pi(T_k^-1 p_w)) - target with only the pose free.
    The pool is not written. Returns (pos (M, 3), target (M, ps²),
    valid (M,), scale (M,) int32)."""
    Rcw, Pcw = camera_pose(state, Rci, Pci)
    depth_img = rasterize_depth(cam, Rcw, Pcw, pg_w, pg_valid, border_px(cfg))
    submap, _ = retrieve(pool, ring, img, depth_img, state, cam, Rci, Pci, cfg)
    target = submap.ref_expo[:, None] * submap.warp_patch[:, 0, :]
    scale = torch.pow(2, submap.search_level.to(torch.int32))
    return submap.pos, target, submap.valid, scale


def make_ray_table(cam: cam_mod.Camera, cfg: VIOConfig, d_min: float = 0.1,
                   d_max: float = 3.0, step: float = 0.2, device="cuda"):
    """Per-grid-cell raycast sample table (initializeVIO, vio.cpp:91-118):
    unit-depth bearings through each cell centre times a fixed depth
    ladder. Returns (samples_cam (M, S, 3), border_cell (M,) bool)."""
    gs, gnw, gnh = cfg.grid_size, cfg.grid_n_width, cfg.grid_n_height
    rows, cols = np.meshgrid(np.arange(gnh), np.arange(gnw), indexing="ij")
    u = (gs // 2 + cols * gs).reshape(-1).astype(np.float32)
    v = (gs // 2 + rows * gs).reshape(-1).astype(np.float32)
    border = ((rows == 0) | (cols == 0) | (rows == gnh - 1)
              | (cols == gnw - 1)).reshape(-1)
    f = cam_mod.cam2world(cam, torch.from_numpy(np.stack([u, v], -1)).to(device))
    f = f / f[:, 2:3]  # unit depth
    depths = torch.from_numpy(
        np.arange(d_min, d_max + 1e-6, step, dtype=np.float32)).to(device)
    return (f[:, None, :] * depths[None, :, None],
            torch.from_numpy(border).to(device))


def raycast_recover(vmap_state: VoxelMap, map_cfg: VoxelMapConfig,
                    cell_empty: torch.Tensor, border_cell: torch.Tensor,
                    ray_samples: torch.Tensor, scan_keys_table: torch.Tensor,
                    state: NavState, Rci, Pci):
    """Raycast recovery for LiDAR-blind grid cells (vio.cpp:487-591): walk
    each empty, non-border cell's ray through the voxel grid; the first
    sample whose voxel holds an LIO plane (before any voxel the current
    scan occupies, where the reference stops, :517) gives a candidate
    visual point at the plane centre with the plane normal, consumed by
    the new-point generation like the reference's add_from_voxel_map list
    (vio.cpp:834-854). Returns (cand_pos (M, 3), cand_normal (M, 3),
    cand_valid (M,))."""
    M, S, _ = ray_samples.shape
    Rcw, Pcw = camera_pose(state, Rci, Pci)
    R_wc = Rcw.T
    cam_origin = -R_wc @ Pcw
    pts_w = ray_samples.reshape(-1, 3) @ R_wc.T + cam_origin  # (M*S, 3)

    keys0 = voxel_hash.voxel_key(pts_w, map_cfg.voxel_size)
    touched = voxel_hash.lookup(scan_keys_table, keys0) >= 0
    found, normal, _, center, _, _ = query_plane(vmap_state, pts_w, map_cfg)
    touched = touched.reshape(M, S)
    found = found.reshape(M, S)
    blocked = torch.cumsum(touched.to(torch.int32), dim=1) > 0
    usable = found & ~blocked
    first = torch.argmax(usable.to(torch.int32), dim=1)  # first True (0: none)
    has = torch.any(usable, dim=1) & cell_empty & ~border_cell
    take = first + torch.arange(M, device=first.device) * S
    return center[take], normal[take], has

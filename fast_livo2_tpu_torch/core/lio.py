"""LIO: body covariance model, voxel-grid downsample, iterated ESIKF
(port of fast_livo2_tpu/core/lio.py).

The measurement fan-in of VoxelMapManager::StateEstimation (reference
src/voxel_map.cpp:338-511) as batched tensor ops: each iteration searches
(or re-gates) plane correspondences over all points, assembles the
weighted 6-dof normal equations and solves the 19-dim gain.

Control flow. The JAX package runs the iterations as a lax.while_loop
with a lax.cond fresh/reuse branch. Here the loop is a Python loop in
one of two forms over one body:
- early exit (the split frame): the rematch/convergence logic (:477-499)
  runs on the host, reading ONE device bool (converged) after every
  iteration but a forced last one, so a frame costs at most
  max_iterations - 1 host syncs (4 at the default 5 iterations), and
  match_planes runs exactly when the JAX code would run it;
- device loop (`device_loop=True`, the fused and staged frames): all
  max_iterations iterations run with no host read, and every carried
  value (state, the kept gain G, the match, rematch, the stop flag) is
  updated under torch.where(active, new, old), as the JAX body masks
  its carry. Where `fresh` may be true the iteration computes both the
  full search and the cheap re-gate and selects each PlaneMatch field
  (JAX's lax.cond runs one branch).
Both forms give the JAX loop's state; on the same inputs they give the
same bits (the same ops in the same order for every iteration that
takes effect).

Sharding (`mesh=`, parallel/sharding.py): pts_body / valid are this
rank's slice of the measurement axis. The sums over points are
all_reduced where the JAX package's partitioner puts its psums (HᵀR⁻¹H /
HᵀR⁻¹z each iteration, the plane-cap histogram, n_effective and the
residual sum), so every rank solves the same 19-dim system and takes the
same convergence branch.
"""

import functools

from typing import NamedTuple

import torch

from ..ops import ordered_add, so3
from ..ops import voxel_hash as _vh
from ..parallel import sharding as shd
from .state import DIM_STATE, NavState, boxminus, boxplus, select
from .voxel_map import PlaneMatch, VoxelMap, VoxelMapConfig, match_planes, quad6


def _bucket_centers(ck: torch.Tensor) -> torch.Tensor:
    return _vh._bucket(ck, 1 << 16)


@functools.lru_cache(maxsize=8)
def _tan_var(degree_inc: float) -> float:
    """float32 sin^2(deg2rad(degree_inc)), evaluated on the host once per
    value (no copy to the device per call)."""
    return float(torch.sin(torch.deg2rad(
        torch.tensor(degree_inc, dtype=torch.float32))) ** 2)


def calc_body_cov(pts_b: torch.Tensor, range_inc: float, degree_inc: float):
    """Per-point covariance from range/bearing noise (reference
    calcBodyCov, voxel_map.cpp:15-34): variance range_inc^2 along the
    beam, (range * sin(degree_inc))^2 across it."""
    z = pts_b[:, 2]
    pts_b = torch.cat([pts_b[:, :2],
                       torch.where(z == 0.0, 1e-4, z)[:, None]], dim=-1)
    r2 = torch.sum(pts_b * pts_b, dim=-1)
    rang = torch.sqrt(r2)
    direction = pts_b / rang[:, None]
    range_var = range_inc * range_inc
    tan_var = _tan_var(degree_inc)
    # Orthobasis of the tangent plane (same construction as :26-31).
    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]
    b1 = torch.stack([torch.ones_like(dx), torch.ones_like(dx), -(dx + dy) / dz],
                     dim=-1)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = torch.linalg.cross(b1, direction, dim=-1)
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    N = torch.stack([b1, b2], dim=-1)  # (n, 3, 2)
    A = rang[:, None, None] * (so3.skew(direction) @ N)  # (n, 3, 2)
    return (range_var * direction[:, :, None] * direction[:, None, :]
            + tan_var * (A @ A.transpose(-1, -2)))


def voxel_downsample(pts: torch.Tensor, valid: torch.Tensor, leaf: float,
                     max_out: int):
    """Voxel-grid centroid downsample (replaces pcl::VoxelGrid,
    LIVMapper.cpp:351-352) via lexicographic stable sorts + segment mean.
    Returns (out_pts (max_out, 3), out_valid (max_out,)); voxels past
    max_out are dropped, as in the JAX package."""
    keys = torch.floor(pts / leaf).to(torch.int32)
    # Two stable sorts instead of three: y and z (each within +-2^14
    # voxels) pack into one 30-bit key.
    half = 1 << 14
    big = torch.full_like(keys[:, 0], 0x7FFFFFF)
    kx = torch.where(valid, keys[:, 0], big)
    kyz = torch.where(
        valid,
        (torch.clamp(keys[:, 1] + half, 0, 2 * half - 1) << 15)
        | torch.clamp(keys[:, 2] + half, 0, 2 * half - 1),
        big)
    perm = torch.argsort(kyz, stable=True)
    perm = perm[torch.argsort(kx[perm], stable=True)]
    skx, skyz = kx[perm], kyz[perm]
    sp = pts[perm]
    sval = valid[perm]
    new_seg = torch.ones_like(sval)
    new_seg[1:] = (skx[1:] != skx[:-1]) | (skyz[1:] != skyz[:-1])
    seg = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1
    seg = torch.where(sval & (seg < max_out), seg, max_out)  # max_out = sink
    # seg is non-decreasing: the points are sorted into their voxels
    sums = ordered_add.ordered_index_add_(pts.new_zeros((max_out + 1, 3)),
                                          seg, sp, drop=max_out,
                                          dst_sorted=True)
    # a sum of 1.0s, exact in any order below 2^24
    cnts = pts.new_zeros((max_out + 1,)).index_add_(
        0, seg, torch.ones_like(sp[:, 0]))
    sums, cnts = sums[:max_out], cnts[:max_out]
    out_valid = cnts > 0
    out = sums / torch.clamp(cnts, min=1.0)[:, None]
    return out, out_valid


class LIOResult(NamedTuple):
    state: NavState
    cov: torch.Tensor  # (19, 19) posterior
    match: PlaneMatch  # final-iteration correspondences
    pts_w: torch.Tensor  # (N, 3) posterior world points
    var_w: torch.Tensor  # (N, 3, 3) posterior world covariances
    n_effective: torch.Tensor  # () int32 matched residual count
    mean_residual: torch.Tensor  # () mean |point-to-plane|


def lio_update(
    state_prop: NavState,
    cov_prop: torch.Tensor,
    vmap_state: VoxelMap,
    pts_body: torch.Tensor,
    valid: torch.Tensor,
    ext_R: torch.Tensor,
    ext_T: torch.Tensor,
    map_cfg: VoxelMapConfig,
    dept_err: float = 0.02,
    beam_err: float = 0.05,
    max_iterations: int = 5,
    rematch_fresh: bool = True,
    fresh_every_iter: bool = False,
    plane_info_cap: int = 0,
    device_loop: bool = False,
    mesh=None,
) -> LIOResult:
    """Iterated point-to-plane ESIKF update (StateEstimation,
    voxel_map.cpp:338-511). pts_body: (N, 3) undistorted, downsampled
    LiDAR-frame points; valid masks padding.

    A full correspondence search (match_planes) runs on iteration 0 and
    on the rematch round after convergence (with rematch_fresh), or on
    every iteration (fresh_every_iter); other iterations reuse the
    carried plane fields and only re-evaluate distance and 3-sigma gate.
    `device_loop`: run every iteration masked, with no host read (see
    the module docstring). `mesh`: pts_body / valid are this rank's shard
    of the points (see the module docstring); the returned match, pts_w
    and var_w are this rank's rows, everything else is global."""
    f32 = cov_prop.dtype
    dev = cov_prop.device
    body_cov = calc_body_cov(pts_body, dept_err, beam_err)
    pts_imu = pts_body @ ext_R.T + ext_T
    crossmat = so3.skew(pts_imu)  # (N, 3, 3)
    crossmat_T = crossmat.transpose(-1, -2)

    # P^-1 of the propagated covariance — constant across iterations.
    cov_sym = 0.5 * (cov_prop + cov_prop.T)
    P_inv = torch.linalg.inv_ex(cov_sym).inverse  # no error-check sync

    R_prop_ext = state_prop.rot @ ext_R
    var_meas_rot = torch.einsum("ij,njk,lk->nil", R_prop_ext, body_cov,
                                R_prop_ext)
    pw_prop = pts_imu @ state_prop.rot.T + state_prop.pos
    rot_var = cov_prop[0:3, 0:3]
    t_var = cov_prop[3:6, 3:6]

    def search(state, pts_w):
        var_w = (torch.einsum("ij,njk,lk->nil", state.rot, body_cov,
                              state.rot)
                 + crossmat @ rot_var @ crossmat_T + t_var)
        return match_planes(vmap_state, pts_w, var_w, valid, map_cfg)

    def regate(match, pts_w):
        nrm = match.normal
        dist = torch.sum(nrm * pts_w, dim=-1) + match.d
        sigma_l = match.sigma_plane + torch.einsum(
            "ni,nij,nj->n", nrm, var_meas_rot, nrm)
        ok = match.valid & (
            dist.abs() < map_cfg.sigma_num
            * torch.sqrt(torch.clamp(sigma_l, min=1e-12)))
        return match._replace(dist=dist, valid=ok)

    state = state_prop
    match = None
    G_keep = None
    fresh = True  # a host bool in the early-exit form, else a device bool
    rematch = 0
    stop = None  # the device loop's carried stop flag
    for it in range(max_iterations):
        pts_w = pts_imu @ state.rot.T + state.pos
        if not device_loop:
            match_it = search(state, pts_w) if fresh else regate(match, pts_w)
        elif it == 0 or fresh_every_iter:
            match_it = search(state, pts_w)
        elif rematch_fresh:  # the rematch round may search afresh
            match_it = select(fresh, search(state, pts_w), regate(match, pts_w))
        else:
            match_it = regate(match, pts_w)

        n = match_it.normal
        use = match_it.valid & valid
        # H row i = [ (p_imu_i)^ R^T n_i ;  n_i ]   (:453-454)
        A = torch.einsum("nij,jk,nk->ni", crossmat, state.rot.T, n)
        H = torch.cat([A, n], dim=-1)  # (N, 6)
        z = -match_it.dist

        # Adaptive noise (:425-449) at the propagated state.
        a_prop = pw_prop - match_it.center
        sigma_l = (quad6(match_it.cov_nn, a_prop) + quad6(match_it.cov_qq, n)
                   + torch.einsum("ni,nij,nj->n", n, var_meas_rot, n))
        R_inv = torch.where(use, 1.0 / (1e-3 + sigma_l), 0.0)
        if plane_info_cap > 0:
            # Information equalization across matched planes: cap each
            # matched plane's effective point count (weight *= min(1,
            # cap / points_on_plane)), planes identified by a lossy
            # 16-bit hash of their rounded centers (collisions share a
            # cap, as in the JAX package).
            ck = torch.round(match_it.center * 8.0).to(torch.int32)
            h = _bucket_centers(ck).long()
            cnt = cov_prop.new_zeros((1 << 16) + 1).index_add_(
                0, torch.where(use, h, 1 << 16), torch.ones_like(R_inv))
            if mesh is not None:  # the global count of each plane
                cnt = shd.all_reduce(cnt, mesh)
            R_inv = R_inv * torch.clamp(
                plane_info_cap / torch.clamp(cnt[h], min=1.0), max=1.0)

        HR = H * R_inv[:, None]
        HTH6 = HR.T @ H
        HTz6 = HR.T @ z
        if mesh is not None:
            HTH6, HTz6 = shd.all_reduce_many((HTH6, HTz6), mesh)
        HTH = torch.zeros((DIM_STATE, DIM_STATE), dtype=f32, device=dev)
        HTH[0:6, 0:6] = HTH6
        K_1 = torch.linalg.inv_ex(HTH + P_inv).inverse
        G = torch.zeros((DIM_STATE, DIM_STATE), dtype=f32, device=dev)
        G[:, 0:6] = K_1[:, 0:6] @ HTH6
        vec = boxminus(state_prop, state)
        solution = K_1[:, 0:6] @ HTz6 + vec - G[:, 0:6] @ vec[0:6]
        state_it = boxplus(state, solution)

        if not device_loop:
            state, G_keep, match = state_it, G, match_it
            if it == max_iterations - 1:
                break  # forced stop: no convergence read needed
            rot_add = torch.linalg.norm(solution[0:3])
            t_add = torch.linalg.norm(solution[3:6])
            converged = bool((rot_add * 57.3 < 0.01)
                             & (t_add * 100.0 < 0.015))  # :477
            inc = converged or (rematch == 0 and it == max_iterations - 2)
            rematch += int(inc)
            if rematch >= 2:
                break
            fresh = (inc and rematch_fresh) or fresh_every_iter
            continue

        if it == 0:  # always taken: nothing to mask yet
            state, G_keep, match = state_it, G, match_it
            stop = torch.zeros((), dtype=torch.bool, device=dev)
            rematch = torch.zeros((), dtype=torch.int32, device=dev)
            active = ~stop
        else:
            active = ~stop
            state = select(active, state_it, state)
            G_keep = torch.where(active, G, G_keep)
            match = select(active, match_it, match)
        if it == max_iterations - 1:
            break  # the forced stop
        rot_add = torch.linalg.norm(solution[0:3])
        t_add = torch.linalg.norm(solution[3:6])
        converged = (rot_add * 57.3 < 0.01) & (t_add * 100.0 < 0.015)
        if it == max_iterations - 2:
            converged = converged | (rematch == 0)
        inc = active & converged
        rematch = rematch + inc.to(torch.int32)
        stop = stop | (rematch >= 2)
        fresh = inc if rematch_fresh else False

    cov_post = (torch.eye(DIM_STATE, dtype=f32, device=dev) - G_keep) @ cov_prop

    # Posterior world points + covariances for the map update
    # (LIVMapper.cpp:413-423).
    pts_w = pts_imu @ state.rot.T + state.pos
    R_ext = state.rot @ ext_R
    var_w = (torch.einsum("ij,njk,lk->nil", R_ext, body_cov, R_ext)
             + crossmat @ cov_post[0:3, 0:3] @ crossmat_T + cov_post[3:6, 3:6])
    use = match.valid & valid
    n_eff = torch.sum(use.to(torch.int32))
    res_sum = torch.sum(torch.where(use, match.dist.abs(), 0.0))
    if mesh is not None:
        n_eff, res_sum = shd.all_reduce_many((n_eff, res_sum), mesh)
    mean_res = res_sum / torch.clamp(n_eff.to(f32), min=1.0)
    return LIOResult(state=state, cov=cov_post, match=match, pts_w=pts_w,
                     var_w=var_w, n_effective=n_eff, mean_residual=mean_res)

"""Spatially sharded voxel map for the sliding-window backend (port of
fast_livo2_tpu/parallel/map_shard.py).

Keyframe sharding (ba.refine_window(mesh=)) replicates the map: its size
is capped by one device's memory, and every rebuild gathers all the
window's points. This module shards the map itself. The key space is
split by an independent spatial hash of each point's LAYER-0 voxel key,
so
  - every rank owns a map BLOCK, per-layer tables of capacity C/D;
  - a voxel's whole layer chain colocates (children of a layer-0 voxel
    hash with their ancestor), so descent gating stays rank-local;
  - points are replicated (O(N), against O(map)); each rank inserts and
    matches only the points it owns, and the per-keyframe normal
    equations combine with ONE all_reduce of (K, 6, 6) + (K, 6) + (K,)
    floats per Gauss-Newton iteration, independent of map size and point
    count.

Each rank runs the same voxel_map code on its block (capacity C/D); the
JAX package's shard_map becomes rank-local code plus that all_reduce.
"""

import math

import torch

from ..core.lio import calc_body_cov
from ..core.voxel_map import (EMPTY, REC_W, STATS_W, VoxelMap, VoxelMapConfig,
                              make_map, sym6, update_map)
from ..ops import so3
from . import sharding as shd
from .ba import _plane_terms

# Owner-routing hash: a DIFFERENT prime mix from ops.voxel_hash._bucket,
# so that block assignment is independent of in-block slot buckets (a
# shared hash would alias whole bucket ranges onto one rank's block).
_Q1, _Q2, _Q3 = -1640531535, 40503, -2048144777  # int32 views of
# 0x9e3779b1 / 0x9e37 / 0x85ebca77
_Q4 = -1640531527  # 0x9e3779b9


def owner_of(pts_w: torch.Tensor, cfg: VoxelMapConfig, n_devices: int):
    """The rank (N,) int32 owning each point's layer-0 voxel (and thereby
    its whole layer chain). int32 throughout, as in the JAX package:
    products wrap, `>>` is arithmetic, abs(INT_MIN) stays negative and
    `%` is floor-mod (torch.remainder), so the owners are the JAX
    package's bit for bit."""
    key0 = torch.floor(pts_w / cfg.voxel_size).to(torch.int32)
    h = (key0[..., 0] * _Q1) ^ (key0[..., 1] * _Q2) ^ (key0[..., 2] * _Q3)
    h = h ^ (h >> 15)
    h = h * _Q4
    h = h ^ (h >> 13)
    return torch.remainder(torch.abs(h), n_devices)


def local_cfg(cfg: VoxelMapConfig, n_devices: int) -> VoxelMapConfig:
    """A rank's block configuration: capacity C/D, same semantics."""
    shift = int(math.log2(n_devices))
    if (1 << shift) != n_devices:
        raise ValueError(f"mesh size must be a power of two, not {n_devices}")
    if cfg.capacity_log2 <= shift:
        raise ValueError(f"capacity 2^{cfg.capacity_log2} is below one slot "
                         f"per rank of {n_devices}")
    return cfg._replace(capacity_log2=cfg.capacity_log2 - shift)


def refine_window_map_sharded(window, map_cfg: VoxelMapConfig, mesh,
                              axis: str = None, outer_iters: int = 2,
                              gn_iters: int = 3, dept_err: float = 0.02,
                              beam_err: float = 0.05):
    """refine_window (plane factors only) with the MAP sharded over the
    mesh instead of the keyframes: every rank passes the whole window,
    rebuilds its block from the points it owns, and accumulates every
    keyframe's normal equations over those points; one all_reduce a
    Gauss-Newton iteration combines them, and every rank takes the same
    step. Matches ba.refine_window up to the blocks' hashing and float
    addition order (tests/test_map_shard.py).

    Returns (window, n_used (K,) int32), the same on every rank. `axis`
    is the mesh's one axis, accepted for the JAX signature."""
    del axis
    D, my = mesh.size, mesh.rank
    lcfg = local_cfg(map_cfg, D)
    K, N, _ = window.scans.shape
    dev = window.pos.device
    scans, valid = window.scans, window.valid
    body6 = sym6(calc_body_cov(scans.reshape(K * N, 3), dept_err, beam_err))
    eye6 = torch.eye(6, dtype=scans.dtype, device=dev) * 1e-6
    rot, pos = window.rot, window.pos
    n_used = torch.zeros((K,), dtype=torch.int32, device=dev)
    for _ in range(outer_iters):
        pts_w = (scans @ rot.transpose(-1, -2)
                 + pos[:, None, :]).reshape(K * N, 3)
        mine = owner_of(pts_w, map_cfg, D) == my
        m = update_map(make_map(lcfg, dev), pts_w, body6,
                       valid.reshape(K * N) & mine, lcfg)
        for _ in range(gn_iters):
            pts_w = scans @ rot.transpose(-1, -2) + pos[:, None, :]
            mine = owner_of(pts_w, map_cfg, D) == my
            HtH, Htz, use = _plane_terms(pts_w, pos, valid & mine, body6, m,
                                         lcfg)
            cnt = torch.sum(use.to(torch.int32), dim=1)
            # THE cross-rank combine: 6 x 6 + 6 + 1 per keyframe
            HtH, Htz, n_used = shd.all_reduce_many((HtH, Htz, cnt), mesh)
            sol = torch.linalg.solve_ex(HtH + eye6,
                                        Htz[..., None]).result[..., 0]
            rot = so3.exp(sol[:, 0:3]) @ rot
            pos = pos + sol[:, 3:6]
        rot = so3.normalize_rotation(rot)
    return window._replace(rot=rot, pos=pos), n_used


def sharded_map_arrays(map_cfg: VoxelMapConfig, mesh, axis: str = None):
    """This rank's block of a persistent spatially sharded map: per-layer
    tables laid out (L, C/D, ...), each rank holding only its C/D rows of
    the (L, C, ...) map, on the mesh's device. Use with blocks like
    refine_window_map_sharded's; kept apart so that callers can hold a
    long-lived sharded map between refinements."""
    del axis
    L = map_cfg.n_layers
    rows = (1 << map_cfg.capacity_log2) // mesh.size
    if rows * mesh.size != 1 << map_cfg.capacity_log2:
        raise ValueError(f"capacity 2^{map_cfg.capacity_log2} does not "
                         f"divide over {mesh.size} ranks")
    dev = mesh.device
    return VoxelMap(
        keys=torch.full((L, rows, 3), EMPTY, dtype=torch.int32, device=dev),
        stats=torch.zeros((L, rows, STATS_W), dtype=torch.float32, device=dev),
        rec=torch.zeros((L, rows, REC_W), dtype=torch.float32, device=dev))

"""The LIO geometric map: multi-layer voxel plane statistics on the device
(port of fast_livo2_tpu/core/voxel_map.py).

Re-design of VoxelMapManager + VoxelOctoTree (reference
include/voxel_map.h:129-257, src/voxel_map.cpp:55-335): the octree
becomes L stacked open-addressing hash layers (layer l has voxel size
v / 2^l). The JAX package vmaps one op set over the layers; here the
layer axis is written out — every table op takes (J, N, ...) query
batches plus a (J,) `layers` vector naming the table layer each batch
addresses, and indexes the flattened (L*C, ...) tables.

State (`VoxelMap`), as in the JAX package:
- `keys (L, C, 3)` int32, EMPTY-marked free slots (linear probing, so a
  lookup gathers one contiguous probe window);
- `stats (L, C, 16)` = [count | sum_p | sum_pp sym6 | sum_C sym6] in
  voxel-local coordinates;
- `rec (L, C, 22)` the derived plane-record cache, rebuilt from (keys,
  stats) by one full-table pass at the end of every mutation, so
  rec == derive_rec(keys, stats) at every API boundary.

An insert is a lookup, integer scatter-max claim rounds for new keys
(priority tickets (R - k) * n + lane, so the winner of a slot is the
same on any device) and one 16-wide scatter-add per layer.

PyTorch has no `mode="drop"` scatter: every scatter that drops lanes in
the JAX package writes those lanes into one extra sink row of a fresh
buffer, which is then sliced off (`_with_sink`). Gathers never see an
out-of-range index: indices that may be -1 are clamped first. The map
functions are functional: each returns a new VoxelMap and leaves its
input tensors untouched.

The plane-record legend (column 0, `_ISPL`): 1.0 solid fitted plane;
0.75 marginal plane (children pre-accumulate); 0.0 undecided; -1.0 cut
(sticky internal node, opt-in). See the JAX module for the derivation
of the closed-form plane covariance.
"""

import functools
from typing import NamedTuple, Sequence

import torch

from ..ops import eig3, voxel_hash

EMPTY = voxel_hash.EMPTY

_ISPL = 0                # plane/topology state (see the module docstring)
_PL0, _PL1 = 1, 9        # plane: normal(3), d, center(3), radius
_PC0, _PC1 = 9, 21       # plane_cov: cov_nn sym6, cov_qq sym6
_CNT = 21                # point count (mark-stripped)
REC_W = 22
STATS_W = 16  # [count | sum_p(3) | sum_pp sym6 | sum_C sym6]

CUT_MARK = 8388608.0  # 2^23: exact in f32; count + mark stays exact

_CLAIM_ROUNDS = 3  # snapshot-empty claim rounds per insert


def sym6(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 6) as (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [m[..., 0, 0], m[..., 0, 1], m[..., 0, 2],
         m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]], dim=-1)


def sym6_to_mat(s: torch.Tensor) -> torch.Tensor:
    xx, xy, xz, yy, yz, zz = (s[..., i] for i in range(6))
    return torch.stack(
        [torch.stack([xx, xy, xz], dim=-1),
         torch.stack([xy, yy, yz], dim=-1),
         torch.stack([xz, yz, zz], dim=-1)], dim=-2)


def quad6(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v^T M v for sym6 M (..., 6) and vectors v (..., 3)."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return (
        s[..., 0] * vx * vx + s[..., 3] * vy * vy + s[..., 5] * vz * vz
        + 2.0 * (s[..., 1] * vx * vy + s[..., 2] * vx * vz
                 + s[..., 4] * vy * vz)
    )


class VoxelMap(NamedTuple):
    keys: torch.Tensor  # (L, C, 3) int32, EMPTY-marked free slots
    stats: torch.Tensor  # (L, C, 16) [count | running moments]
    rec: torch.Tensor  # (L, C, 22) derived plane-record cache


class VoxelMapConfig(NamedTuple):
    """Static map configuration (the JAX package's fields and defaults;
    see fast_livo2_tpu/core/voxel_map.py for the measured rationale of
    each knob)."""

    voxel_size: float = 0.5
    n_layers: int = 3  # reference max_layer=2 -> layers 0..2
    capacity_log2: int = 18
    probes: int = 8
    insert_compact: int = 0  # >0: compact unresolved keys to this many
    # lanes before the claim rounds
    descend_compact: int = 0  # >0: layers >= 1 only for points whose
    # layer-0 voxel is not a solid plane, compacted to this many lanes
    planner_threshold: float = 0.0025  # min_eigen_value
    sigma_num: float = 3.0
    sticky_cut: bool = False  # reference octree topology (opt-in)
    pre_descend_margin: float = 0.5  # marginal-plane band (1.0 disables)
    match_finest: bool = False  # deepest gated plane wins (A/B knob)
    layer_init_num: Sequence[int] = (5, 5, 5, 5, 5)
    max_points_num: int = 50
    sibling_search: bool = False  # also gate the nearest sibling voxel


def make_map(cfg: VoxelMapConfig, device="cuda") -> VoxelMap:
    L, C = cfg.n_layers, 1 << cfg.capacity_log2
    return VoxelMap(
        keys=torch.full((L, C, 3), EMPTY, dtype=torch.int32, device=device),
        stats=torch.zeros((L, C, STATS_W), dtype=torch.float32, device=device),
        rec=torch.zeros((L, C, REC_W), dtype=torch.float32, device=device),
    )


@functools.lru_cache(maxsize=64)
def _const(values: tuple, dtype, device: str) -> torch.Tensor:
    """A small constant tensor, uploaded once per (values, device): a
    fresh torch.tensor(..., device="cuda") per call would be a blocking
    host-to-device copy, i.e. a host sync, on every map operation.
    Callers never write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


def layer_voxel_sizes(cfg: VoxelMapConfig, device) -> torch.Tensor:
    return _const(tuple(cfg.voxel_size / (1 << l) for l in range(cfg.n_layers)),
                  torch.float32, str(device))


def layer_init_nums(cfg: VoxelMapConfig, device) -> torch.Tensor:
    return _const(tuple(float(cfg.layer_init_num[min(l, len(cfg.layer_init_num) - 1)])
                        for l in range(cfg.n_layers)), torch.float32, str(device))


def layer_has_kids(cfg: VoxelMapConfig, device) -> torch.Tensor:
    return _const(tuple(1.0 if l < cfg.n_layers - 1 else 0.0
                        for l in range(cfg.n_layers)), torch.float32, str(device))


def _with_sink(t: torch.Tensor) -> torch.Tensor:
    """A fresh (M + 1, ...) copy of (M, ...) whose last row is the sink
    that dropped scatter lanes write to."""
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def _gather_lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (J, N, ...) gathered along the lane axis by idx (J, M) int64."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


def _layer_ids(n: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int64, device=device)


def _lookup_window(keys_tab, keys, probes: int, claim_rounds: int = None,
                   layers=None):
    """ONE windowed gather resolving whole probe chains.

    keys_tab: (L, C, 3) int32; keys: (J, N, 3) int32; layers: (J,) table
    layer of each query batch (default 0..J-1). Returns (slot (J, N)
    int32, -1 when absent; found (J, N); empty_rows (J, N, R) int32) —
    empty_rows are the first R EMPTY rows of the probe window (-1-padded),
    the only rows an insert of that key may claim. claim_rounds=0 skips
    them (readers)."""
    C = keys_tab.shape[1]
    dev = keys.device
    if layers is None:
        layers = _layer_ids(keys.shape[0], dev)
    h = voxel_hash._bucket(keys, C)
    offs = torch.arange(probes, dtype=torch.int32, device=dev)
    rows = (h[..., None] + offs) & (C - 1)  # (J, N, P)
    flat = layers[:, None, None] * C + rows.long()
    wkeys = keys_tab.reshape(-1, 3)[flat]  # (J, N, P, 3) — the one gather
    match = torch.all(wkeys == keys[:, :, None, :], dim=-1)
    is_empty = wkeys[..., 0] == EMPTY
    empty_before = torch.cumsum(is_empty.to(torch.int32), dim=-1) > 0
    prev_empty = torch.zeros_like(empty_before)
    prev_empty[..., 1:] = empty_before[..., :-1]
    valid_match = match & ~prev_empty
    found = torch.any(valid_match, dim=-1)
    j = torch.argmax(valid_match.to(torch.int32), dim=-1, keepdim=True)
    minus1 = torch.full_like(h, -1)
    slot = torch.where(found, torch.gather(rows, -1, j)[..., 0], minus1)
    if claim_rounds is None:
        claim_rounds = _CLAIM_ROUNDS
    empty_rows = []
    rem = is_empty
    pidx = torch.arange(probes, device=dev)
    for _ in range(min(claim_rounds, probes)):
        any_e = torch.any(rem, dim=-1)
        je = torch.argmax(rem.to(torch.int32), dim=-1, keepdim=True)
        empty_rows.append(torch.where(
            any_e, torch.gather(rows, -1, je)[..., 0], minus1))
        rem = rem & (pidx != je)
    empty_rows = (torch.stack(empty_rows, dim=-1) if empty_rows
                  else rows.new_zeros(h.shape + (0,)))
    return slot, found, empty_rows


def _compact_lanes(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Per row of mask (J, N): indices of the first `size` True lanes
    (ascending), N-filled — cumsum + one scatter."""
    J, n = mask.shape
    pos = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    dst = torch.where(mask & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((J, size + 1), n, dtype=torch.int32, device=mask.device)
    lanes = torch.arange(n, dtype=torch.int32, device=mask.device)
    out.scatter_(1, dst.long(), lanes.expand(J, n))  # duplicates only at the sink
    return out[:, :size]


def _claim_rounds(keys_tab, keys, targets, unresolved, layers):
    """Race-free claim over the lookup-snapshot empties: a persistent
    per-row claims table carries the winning ticket (R - k) * n + lane
    across rounds (an earlier round's winner always outranks a later
    bid). Per round each candidate lane scatter-max bids on its k-th
    snapshot-empty row and gathers the row's winner back; the winner's
    lane is ticket % n, so one batch-local key compare resolves winners
    and same-key twins. Keys are written once at the end. Lanes that lose
    every round stay -1 and re-insert on a later frame.

    keys_tab (L, C, 3); keys (J, n, 3); targets (J, n, R); unresolved
    (J, n); layers (J,). Returns (keys_tab (L, C, 3), slot (J, n))."""
    L, C = keys_tab.shape[:2]
    J, n, R = targets.shape
    dev = keys.device
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    slot_out = torch.full((J, n), -1, dtype=torch.int32, device=dev)
    sink = J * C
    claims = torch.full((sink + 1,), -1, dtype=torch.int32, device=dev)
    base = _layer_ids(J, dev)[:, None] * C  # each batch its own claims rows
    for k in range(R):
        target = targets[:, :, k]
        cand = unresolved & (target >= 0)
        row = base + torch.clamp(target, min=0).long()
        ticket = torch.where(cand, (R - k) * n + lane, torch.full_like(target, -1))
        claims.scatter_reduce_(0, torch.where(cand, row, sink).reshape(-1),
                               ticket.reshape(-1), reduce="amax",
                               include_self=True)
        row_ticket = claims[torch.where(cand, row, base)]
        win_lane = torch.where(row_ticket >= 0, row_ticket % n,
                               torch.zeros_like(row_ticket))
        same_key = torch.all(_gather_lanes(keys, win_lane.long()) == keys,
                             dim=-1)
        resolved = cand & (row_ticket >= 0) & same_key
        slot_out = torch.where(resolved, target, slot_out)
        unresolved = unresolved & ~resolved
    flat = _with_sink(keys_tab.reshape(-1, 3))
    dst = torch.where(slot_out >= 0, layers[:, None] * C + slot_out.long(),
                      L * C)
    flat[dst.reshape(-1)] = keys.reshape(-1, 3)  # twins write equal keys
    return flat[:-1].view(L, C, 3), slot_out


def _claim_compacted(keys_tab, keys, targets, unres, compact_to: int, layers):
    """Claim rounds with optional lane compaction (the steady-state
    insert fast path). Returns (keys_tab, slot_add (J, N), -1 unclaimed)."""
    J, N = unres.shape
    if compact_to and compact_to < N:
        lane_idx = _compact_lanes(unres, compact_to)
        li = torch.clamp(lane_idx, max=N - 1).long()
        cu = lane_idx < N
        keys_tab, cslot = _claim_rounds(keys_tab, _gather_lanes(keys, li),
                                        _gather_lanes(targets, li), cu, layers)
        slot_add = torch.full((J, N + 1), -1, dtype=torch.int32,
                              device=keys.device)
        slot_add.scatter_(1, torch.where(cu, lane_idx, N).long(), cslot)
        return keys_tab, slot_add[:, :N]
    return _claim_rounds(keys_tab, keys, targets, unres, layers)


def _insert(keys_tab, keys, valid, probes: int, compact_to: int = 0,
            claim_rounds: int = None, layers=None):
    """Find-or-claim slots: hits resolve in one windowed lookup, new keys
    claim the EMPTY rows that lookup exposed. Returns (keys_tab, slot
    (J, N), -1 = absent)."""
    if layers is None:
        layers = _layer_ids(keys.shape[0], keys.device)
    slot0, found0, empty_rows = _lookup_window(keys_tab, keys, probes,
                                               claim_rounds, layers)
    slot_out = torch.where(found0, slot0, torch.full_like(slot0, -1))
    unresolved = valid & ~found0 & (empty_rows[..., 0] >= 0)
    keys_tab, cslot = _claim_compacted(keys_tab, keys, empty_rows, unresolved,
                                       compact_to, layers)
    return keys_tab, torch.where(unresolved, cslot, slot_out)


def _derive_from_stats(st16, keys, vsize, init_num, has_kids,
                       cfg: VoxelMapConfig):
    """Plane record (..., 22) from raw moment rows st16 (..., 16) and
    their voxel keys (..., 3) (init_plane, voxel_map.cpp:55-135), fully
    unpacked: every intermediate is a plain (...,) column.
    vsize/init_num/has_kids are per-layer values broadcastable to (...)."""
    raw = st16[..., 0]
    cut = (raw >= CUT_MARK if cfg.sticky_cut
           else torch.zeros(raw.shape, dtype=torch.bool, device=raw.device))
    n = torch.where(cut, raw - CUT_MARK, raw)
    n_safe = torch.clamp(n, min=1.0)
    inv_n = 1.0 / n_safe
    mx = st16[..., 1] * inv_n
    my = st16[..., 2] * inv_n
    mz = st16[..., 3] * inv_n
    # cov = sum_pp / n - mean mean^T (+ 1e-9 I for conditioning)
    cxx = st16[..., 4] * inv_n - mx * mx + 1e-9
    cxy = st16[..., 5] * inv_n - mx * my
    cxz = st16[..., 6] * inv_n - mx * mz
    cyy = st16[..., 7] * inv_n - my * my + 1e-9
    cyz = st16[..., 8] * inv_n - my * mz
    czz = st16[..., 9] * inv_n - mz * mz + 1e-9
    lam0, lam1, lam2, v0, v1, v2 = eig3.eigh3_cols(cxx, cxy, cxz, cyy, cyz, czz)
    enough = n > init_num
    fits = lam0 < cfg.planner_threshold
    if cfg.pre_descend_margin < 1.0:
        marginal = (fits & (lam0 > cfg.planner_threshold * cfg.pre_descend_margin)
                    & (has_kids > 0.5))
    else:
        marginal = torch.zeros_like(enough)
    is_plane = torch.where(
        cut, -1.0,
        torch.where(fits & enough,
                    torch.where(marginal, 0.75, 1.0), 0.0))

    qx = (keys[..., 0].to(torch.float32) + 0.5) * vsize + mx
    qy = (keys[..., 1].to(torch.float32) + 0.5) * vsize + my
    qz = (keys[..., 2].to(torch.float32) + 0.5) * vsize + mz
    nx, ny, nz = v0
    d = -(nx * qx + ny * qy + nz * qz)
    radius = torch.sqrt(torch.clamp(lam2, min=0.0))

    # cov(n) = sigma2 * (d1 u1 u1^T + d2 u2 u2^T), sym6 components
    cb_xx = st16[..., 10] * inv_n
    cb_xy = st16[..., 11] * inv_n
    cb_xz = st16[..., 12] * inv_n
    cb_yy = st16[..., 13] * inv_n
    cb_yz = st16[..., 14] * inv_n
    cb_zz = st16[..., 15] * inv_n
    sigma2 = (cb_xx + cb_yy + cb_zz) / 3.0
    dmin = 1e-6
    d1 = (lam1 + lam0) / (n_safe * torch.clamp((lam0 - lam1) ** 2, min=dmin))
    d2 = (lam2 + lam0) / (n_safe * torch.clamp((lam0 - lam2) ** 2, min=dmin))
    u1x, u1y, u1z = v1
    u2x, u2y, u2z = v2
    s1, s2 = sigma2 * d1, sigma2 * d2
    nn_xx = s1 * u1x * u1x + s2 * u2x * u2x
    nn_xy = s1 * u1x * u1y + s2 * u2x * u2y
    nn_xz = s1 * u1x * u1z + s2 * u2x * u2z
    nn_yy = s1 * u1y * u1y + s2 * u2y * u2y
    nn_yz = s1 * u1y * u1z + s2 * u2y * u2z
    nn_zz = s1 * u1z * u1z + s2 * u2z * u2z
    return torch.stack(
        [is_plane,
         nx, ny, nz, d, qx, qy, qz, radius,
         nn_xx, nn_xy, nn_xz, nn_yy, nn_yz, nn_zz,
         cb_xx * inv_n, cb_xy * inv_n, cb_xz * inv_n,
         cb_yy * inv_n, cb_yz * inv_n, cb_zz * inv_n,
         n], dim=-1)


def derive_rec(vmap_state: VoxelMap, cfg: VoxelMapConfig) -> torch.Tensor:
    """(L, C, 22) derived plane records for the whole table. Unoccupied
    slots carry n=0 -> is_plane 0; mask by keys[..., 0] != EMPTY for
    occupancy."""
    dev = vmap_state.stats.device
    return _derive_from_stats(
        vmap_state.stats, vmap_state.keys,
        layer_voxel_sizes(cfg, dev)[:, None], layer_init_nums(cfg, dev)[:, None],
        layer_has_kids(cfg, dev)[:, None], cfg)


def _refresh(keys, stats, cfg: VoxelMapConfig) -> VoxelMap:
    """Rebuild the rec cache from (keys, stats) with ONE full-table pass.
    Every mutation path ends here."""
    m = VoxelMap(keys=keys, stats=stats, rec=stats.new_zeros(()))
    return m._replace(rec=derive_rec(m, cfg))


def _pre_meta(rec, C, layers, found, slot):
    """(count, plane column) of each looked-up voxel from the rec cache,
    0 where absent."""
    row = layers[:, None] * C + torch.where(found, slot, 0).long()
    pre = rec.reshape(-1, REC_W)[row]
    zero = rec.new_zeros(())
    return (torch.where(found, pre[..., _CNT], zero),
            torch.where(found, pre[..., _ISPL], zero))


def _accumulate(stats_flat, C, layers, keys, slots, ok, vsize, pts, var6):
    """The ONE insert write for a set of layers: a 16-wide scatter-add of
    the running moments, in place into stats_flat ((L*C + 1, 16), last
    row the sink) for lanes passing the freeze/cut/validity gates.
    keys/slots/ok (J, N, ...); vsize (J,); pts/var6 (J, N, 3)/(J, N, 6)."""
    voxel_center = (keys.to(torch.float32) + 0.5) * vsize[:, None, None]
    p_local = pts - voxel_center
    pp6 = sym6(p_local[..., :, None] * p_local[..., None, :])
    one_col = torch.ones(p_local.shape[:-1] + (1,), dtype=torch.float32,
                         device=pts.device)
    contrib = torch.cat([one_col, p_local, pp6, var6], dim=-1)
    dst = torch.where(ok, layers[:, None] * C + slots.long(),
                      stats_flat.shape[0] - 1)
    stats_flat.index_add_(0, dst.reshape(-1), contrib.reshape(-1, STATS_W))


def _mark_cut(stats_flat, C, layers, slots, should_cut, cnt_pre):
    """Sticky-cut transition (octo_state_=1): idempotent scatter-max of
    count -> cnt_pre + CUT_MARK on lanes whose voxel just became a
    permanent internal node, in place; runs after the scatter-add."""
    dst = torch.where(should_cut, layers[:, None] * C + slots.long(),
                      stats_flat.shape[0] - 1)
    col = stats_flat[:, 0].clone()
    col.scatter_reduce_(0, dst.reshape(-1), (cnt_pre + CUT_MARK).reshape(-1),
                        reduce="amax", include_self=True)
    stats_flat[:, 0] = col


def _layer_keys(pts, vsizes):
    """(N, 3) points -> (J, N, 3) int32 voxel keys at each size (J,)."""
    return torch.floor(pts[None, :, :] / vsizes[:, None, None]).to(torch.int32)


def update_map(vmap_state: VoxelMap, pts_w: torch.Tensor, var_w: torch.Tensor,
               valid: torch.Tensor, cfg: VoxelMapConfig,
               compact: bool = False) -> VoxelMap:
    """Insert a frame into every layer (the flat-layer equivalent of the
    octree's conditional subdivision). var_w: (N, 3, 3) or (N, 6) sym6
    point world covariances.

    Descent gating (cut_octo_tree, voxel_map.cpp:163-217): a point feeds
    layer l+1 only if its layer-l voxel exists, has enough points, and is
    not a solid plane, read from the PRE-insert state, so no layer's
    insert depends on another's. The JAX package's `mesh=` argument
    arrives with the sharding item (ROADMAP.md Queue 1 item 16)."""
    var_w6 = var_w if var_w.dim() == 2 else sym6(var_w)
    dev = pts_w.device
    vs = layer_voxel_sizes(cfg, dev)
    inits = layer_init_nums(cfg, dev)
    hk = layer_has_kids(cfg, dev)
    L, N = cfg.n_layers, pts_w.shape[0]
    C = vmap_state.keys.shape[1]
    compact_to = cfg.insert_compact if compact else 0
    descend = cfg.descend_compact if compact else 0
    if descend and descend < N and L > 1:
        return _update_map_descend(vmap_state, pts_w, var_w6, valid, cfg,
                                   compact_to, descend)
    layers = _layer_ids(L, dev)
    keys_L = _layer_keys(pts_w, vs)  # (L, N, 3)

    # Phase 1 — windowed lookup over all layers + pre-insert voxel meta.
    slot0, found0, empty_rows = _lookup_window(vmap_state.keys, keys_L,
                                               cfg.probes, layers=layers)
    cnt_pre, col_pre = _pre_meta(vmap_state.rec, C, layers, found0, slot0)
    cut_pre = found0 & (col_pre < -0.5)

    # Descent chain: a point feeds layer l when its layer l-1 voxel has
    # enough points and is anything but a solid plane (col < 0.9).
    valid_l = [valid]
    for li in range(1, L):
        sub = (found0[li - 1] & (cnt_pre[li - 1] > inits[li - 1])
               & (col_pre[li - 1] < 0.9))
        valid_l.append(valid_l[-1] & sub)
    valid_L = torch.stack(valid_l)  # (L, N)

    # Phase 2 — claim rounds for new keys.
    unresolved = valid_L & ~found0 & (empty_rows[..., 0] >= 0)
    keys_new, slot_add = _claim_compacted(vmap_state.keys, keys_L, empty_rows,
                                          unresolved, compact_to, layers)
    slots = torch.where(found0, slot0,
                        torch.where(unresolved, slot_add,
                                    torch.full_like(slot0, -1)))

    # Phase 3 — freeze/cut gates + ONE 16-wide scatter-add.
    frozen = cnt_pre >= cfg.max_points_num  # claimed slots have cnt_pre 0
    ok = valid_L & (slots >= 0) & ~frozen & ~cut_pre
    stats = _with_sink(vmap_state.stats.reshape(-1, STATS_W))
    _accumulate(stats, C, layers, keys_L, slots, ok, vs,
                pts_w.expand(L, N, 3), var_w6.expand(L, N, 6))
    if cfg.sticky_cut:
        should_cut = (found0 & (col_pre.abs() < 0.25)
                      & (cnt_pre > inits[:, None]) & (hk[:, None] > 0.5)
                      & ~cut_pre)
        _mark_cut(stats, C, layers, slots, should_cut, cnt_pre)
    return _refresh(keys_new, stats[:-1].view(L, C, STATS_W), cfg)


def _update_map_descend(vmap_state: VoxelMap, pts_w, var_w6, valid,
                        cfg: VoxelMapConfig, compact_to: int, D: int):
    """Steady-state insert with layer-descent compaction: layer 0 on all
    N lanes; layers >= 1 on the <= D points whose layer-0 voxel exists,
    has enough points and is not a solid plane. With D >= the true
    descending count the map equals the full path's; overflow lanes skip
    the fine layers this frame."""
    dev = pts_w.device
    vs = layer_voxel_sizes(cfg, dev)
    inits = layer_init_nums(cfg, dev)
    hk = layer_has_kids(cfg, dev)
    L, N = cfg.n_layers, pts_w.shape[0]
    C = vmap_state.keys.shape[1]
    layer0 = _layer_ids(1, dev)
    layersS = _layer_ids(L - 1, dev, start=1)

    # ---- layer 0 on all N lanes ----
    keys0 = _layer_keys(pts_w, vs[0:1])  # (1, N, 3)
    slot0, found0, empty0 = _lookup_window(vmap_state.keys, keys0, cfg.probes,
                                           layers=layer0)
    cnt0, col0 = _pre_meta(vmap_state.rec, C, layer0, found0, slot0)
    cut0 = found0 & (col0 < -0.5)
    unres0 = valid & ~found0 & (empty0[..., 0] >= 0)
    keys_tab, slot_add0 = _claim_compacted(vmap_state.keys, keys0, empty0,
                                           unres0, compact_to, layer0)
    minus1 = torch.full_like(slot0, -1)
    slots0 = torch.where(found0, slot0, torch.where(unres0, slot_add0, minus1))
    frozen0 = cnt0 >= cfg.max_points_num
    ok0 = valid & (slots0 >= 0) & ~frozen0 & ~cut0
    stats = _with_sink(vmap_state.stats.reshape(-1, STATS_W))
    _accumulate(stats, C, layer0, keys0, slots0, ok0, vs[0:1], pts_w[None],
                var_w6[None])
    if cfg.sticky_cut:
        should0 = found0 & (col0.abs() < 0.25) & (cnt0 > inits[0]) & ~cut0
        _mark_cut(stats, C, layer0, slots0, should0, cnt0)

    # ---- compact the descending lanes (everything but solid planes) ----
    sub = valid & found0 & (cnt0 > inits[0]) & (col0 < 0.9)  # (1, N)
    lane = _compact_lanes(sub, D)[0]
    li = torch.clamp(lane, max=N - 1).long()
    sub_valid = lane < N
    pts_s = pts_w[li]
    var_s = var_w6[li]

    # ---- layers 1..L-1 on D lanes ----
    keys_S = _layer_keys(pts_s, vs[1:])  # (L-1, D, 3)
    slotS, foundS, emptyS = _lookup_window(keys_tab, keys_S, cfg.probes,
                                           layers=layersS)
    cntS, colS = _pre_meta(vmap_state.rec, C, layersS, foundS, slotS)
    cutS = foundS & (colS < -0.5)

    valid_l = [sub_valid]
    for l in range(2, L):  # descent into layer l gated by layer l-1 meta
        subn = (foundS[l - 2] & (cntS[l - 2] > inits[l - 1])
                & (colS[l - 2] < 0.9))
        valid_l.append(valid_l[-1] & subn)
    valid_S = torch.stack(valid_l)  # (L-1, D)

    unresS = valid_S & ~foundS & (emptyS[..., 0] >= 0)
    keys_tab, slot_addS = _claim_compacted(
        keys_tab, keys_S, emptyS, unresS,
        compact_to if compact_to < D else 0, layersS)
    slotsS = torch.where(foundS, slotS,
                         torch.where(unresS, slot_addS, torch.full_like(slotS, -1)))
    frozenS = cntS >= cfg.max_points_num
    okS = valid_S & (slotsS >= 0) & ~frozenS & ~cutS
    _accumulate(stats, C, layersS, keys_S, slotsS, okS, vs[1:],
                pts_s.expand(L - 1, D, 3), var_s.expand(L - 1, D, 6))
    if cfg.sticky_cut:
        shouldS = (foundS & (colS.abs() < 0.25)
                   & (cntS > inits[1:, None]) & (hk[1:, None] > 0.5) & ~cutS)
        _mark_cut(stats, C, layersS, slotsS, shouldS, cntS)
    return _refresh(keys_tab, stats[:-1].view(L, C, STATS_W), cfg)


class PlaneMatch(NamedTuple):
    """Per-point plane correspondence (voxel_map.cpp:713-767); cov_nn and
    cov_qq are sym6."""

    valid: torch.Tensor  # (N,) bool
    normal: torch.Tensor  # (N, 3)
    d: torch.Tensor  # (N,)
    center: torch.Tensor  # (N, 3)
    dist: torch.Tensor  # (N,) signed point-to-plane distance
    sigma_plane: torch.Tensor  # (N,) a^T cov_nn a + n^T cov_qq n
    cov_nn: torch.Tensor  # (N, 6)
    cov_qq: torch.Tensor  # (N, 6)
    layer: torch.Tensor  # (N,) int32 winning candidate: 0..L-1 own chain
    # layer, L neighbor root voxel, > L sibling; -1 no match


def _gate(rec, found, pts_w, var_w6, cfg: VoxelMapConfig):
    """Candidate gating from derived plane records (build_single_residual,
    voxel_map.cpp:713-767). rec (J, N, 22); found (J, N); pts_w (N, 3)."""
    is_pl = (rec[..., _ISPL] > 0.5) & found
    n = rec[..., _PL0:_PL0 + 3]
    d = rec[..., _PL0 + 3]
    c = rec[..., _PL0 + 4:_PL0 + 7]
    radius = rec[..., _PL0 + 7]
    cov_nn6 = rec[..., _PC0:_PC0 + 6]
    cov_qq6 = rec[..., _PC0 + 6:_PC0 + 12]

    dist = torch.sum(n * pts_w, dim=-1) + d
    a = pts_w - c
    dc2 = torch.sum(a * a, dim=-1)
    range_dis2 = torch.clamp(dc2 - dist * dist, min=0.0)
    in_radius = range_dis2 <= (3.0 * radius) ** 2  # radius_k=3 (:719)

    sigma_plane = quad6(cov_nn6, a) + quad6(cov_qq6, n)
    sigma_l = sigma_plane + quad6(var_w6, n)
    sigma_l = torch.clamp(sigma_l, min=1e-12)
    gate = dist.abs() < cfg.sigma_num * torch.sqrt(sigma_l)
    ok = is_pl & in_radius & gate
    prob = torch.where(
        ok, torch.rsqrt(sigma_l) * torch.exp(-0.5 * dist * dist / sigma_l),
        -1.0)
    fields = torch.cat(
        [n, d[..., None], c, dist[..., None], sigma_plane[..., None],
         cov_nn6, cov_qq6], dim=-1)  # (J, N, 21)
    return is_pl, ok, prob, fields


def match_planes(vmap_state: VoxelMap, pts_w: torch.Tensor, var_w,
                 valid: torch.Tensor, cfg: VoxelMapConfig) -> PlaneMatch:
    """Point-to-plane correspondence search (BuildResidualListOMP +
    build_single_residual, voxel_map.cpp:643-786): one windowed lookup per
    candidate set — the containing voxel chain (layer l active iff its
    ancestors exist and are not planes), the nearest neighbor root voxel
    (considered only when the own chain fails, :680-691) and, with
    sibling_search, the nearest sibling per layer >= 1 — plane records
    gathered from the rec cache, gating, max-probability selection."""
    var_w6 = var_w if var_w.dim() == 2 else sym6(var_w)
    dev = pts_w.device
    n_pts = pts_w.shape[0]
    L = cfg.n_layers
    C = vmap_state.keys.shape[1]
    vsizes = layer_voxel_sizes(cfg, dev)
    keys_L = _layer_keys(pts_w, vsizes)  # (L, N, 3)

    def quarter_shift(li):
        """Nearest-neighbor shift at layer li by in-voxel offset
        (quarter-length rule)."""
        center = (keys_L[li].to(torch.float32) + 0.5) * vsizes[li]
        off = pts_w - center
        q = vsizes[li] / 4.0
        one = torch.ones_like(keys_L[li])
        return torch.where(off > q, one, torch.where(off < -q, -one, 0 * one))

    sib_layers = list(range(1, L)) if cfg.sibling_search else []
    extra = [keys_L[0] + quarter_shift(0)]
    extra += [keys_L[li] + quarter_shift(li) for li in sib_layers]
    keys_all = torch.cat([keys_L, torch.stack(extra)], dim=0)
    idx = _const(tuple(range(L)) + (0,) + tuple(sib_layers), torch.int64,
                 str(dev))

    slot, exists, _ = _lookup_window(vmap_state.keys, keys_all, cfg.probes,
                                     claim_rounds=0, layers=idx)
    row = idx[:, None] * C + torch.where(exists, slot, 0).long()
    rec = vmap_state.rec.reshape(-1, REC_W)[row]
    rec = torch.where(exists[..., None], rec, 0.0)
    is_pl, ok, prob, fields = _gate(rec, exists, pts_w, var_w6, cfg)

    any_own = torch.zeros(n_pts, dtype=torch.bool, device=dev)
    if cfg.match_finest:
        # The DEEPEST gated plane of the containing chain wins; the
        # neighbor root stays a fallback when no own-chain plane gates.
        actives = [ok[li] for li in range(L)]
        for a in actives:
            any_own = any_own | a
        actives.append(ok[L] & ~any_own)
        for si, li in enumerate(sib_layers):
            actives.append(ok[L + 1 + si] & ~any_own)
        active = torch.stack(actives, dim=0)
        ranks = _const(tuple(li + 1.0 for li in range(L))
                       + (0.0,) * (1 + len(sib_layers)), torch.float32, str(dev))
        score = torch.where(active, ranks[:, None], -1.0)
        best = torch.argmax(score, dim=0)
        any_valid = (torch.amax(score, dim=0) >= 0.0) & valid
    else:
        # Chain masks (octree descent semantics).
        ancestor_open = torch.ones(n_pts, dtype=torch.bool, device=dev)
        actives = []
        opens = []  # ancestor_open at each layer (sibling admission mask)
        for li in range(L):
            opens.append(ancestor_open)
            actives.append(ancestor_open & ok[li])
            ancestor_open = ancestor_open & exists[li] & ~is_pl[li]
        for a in actives:
            any_own = any_own | a
        actives.append(ok[L] & ~any_own)
        for si, li in enumerate(sib_layers):
            actives.append(opens[li] & ok[L + 1 + si])
        active = torch.stack(actives, dim=0)
        probs = torch.where(active, prob, -1.0)
        best = torch.argmax(probs, dim=0)
        any_valid = (torch.amax(probs, dim=0) > 0) & valid

    f = torch.gather(fields, 0, best[None, :, None].expand(1, n_pts, 21))[0]
    return PlaneMatch(
        valid=any_valid,
        normal=f[:, 0:3],
        d=f[:, 3],
        center=f[:, 4:7],
        dist=f[:, 7],
        sigma_plane=f[:, 8],
        cov_nn=f[:, 9:15],
        cov_qq=f[:, 15:21],
        layer=torch.where(any_valid, best.to(torch.int32),
                          torch.full_like(best, -1, dtype=torch.int32)),
    )


def query_plane(vmap_state: VoxelMap, pts_w: torch.Tensor, cfg: VoxelMapConfig):
    """Ungated plane lookup along the containing chain: the first layer
    whose voxel is a fitted plane wins (VoxelOctoTree::find_correspond,
    voxel_map.cpp:292-305). Used by the VIO normal refinement
    (vio.cpp:981-1034). Plane records come from the rec cache. Returns
    (found, normal, d, center, radius, sigma_l) with
    sigma_l = a^T cov_nn a + n^T cov_qq n at pts_w."""
    dev = pts_w.device
    n_pts = pts_w.shape[0]
    L = cfg.n_layers
    C = vmap_state.keys.shape[1]
    layers = _layer_ids(L, dev)
    keys_L = _layer_keys(pts_w, layer_voxel_sizes(cfg, dev))  # (L, N, 3)
    slot, exists, _ = _lookup_window(vmap_state.keys, keys_L, cfg.probes,
                                     claim_rounds=0, layers=layers)
    row = layers[:, None] * C + torch.where(exists, slot, 0).long()
    rec = vmap_state.rec.reshape(-1, REC_W)[row]
    rec = torch.where(exists[..., None], rec, 0.0)  # (L, N, 22)
    is_pl = (rec[..., _ISPL] > 0.5) & exists
    a = pts_w - rec[..., _PL0 + 4:_PL0 + 7]
    n = rec[..., _PL0:_PL0 + 3]
    sigma = (quad6(rec[..., _PC0:_PC0 + 6], a)
             + quad6(rec[..., _PC0 + 6:_PC0 + 12], n))
    pl = rec[..., _PL0:_PL1]
    found = torch.zeros(n_pts, dtype=torch.bool, device=dev)
    out_plane = pts_w.new_zeros((n_pts, 8))
    out_sigma = pts_w.new_zeros((n_pts,))
    open_chain = torch.ones(n_pts, dtype=torch.bool, device=dev)
    for li in range(L):
        hit = open_chain & is_pl[li]
        out_plane = torch.where(hit[:, None], pl[li], out_plane)
        out_sigma = torch.where(hit, sigma[li], out_sigma)
        found = found | hit
        open_chain = open_chain & exists[li] & ~is_pl[li]
    return (found, out_plane[:, 0:3], out_plane[:, 3], out_plane[:, 4:7],
            out_plane[:, 7], out_sigma)


def map_keys(vmap_state: VoxelMap, layer: int) -> torch.Tensor:
    """(C, 3) int32 keys of one layer (EMPTY-marked), for tests/tools."""
    return vmap_state.keys[layer]


def map_count(vmap_state: VoxelMap, layer: int) -> torch.Tensor:
    raw = vmap_state.stats[layer][:, 0]
    return torch.where(raw >= CUT_MARK, raw - CUT_MARK, raw).to(torch.int32)


def slide_map(vmap_state: VoxelMap, center_pos: torch.Tensor,
              half_map_size: int, cfg: VoxelMapConfig) -> VoxelMap:
    """Local-map sliding: evict voxels outside a half_map_size box around
    the current position (mapSliding/clearMemOutOfMap,
    voxel_map.cpp:924-971). Open addressing cannot delete in place, so
    each layer is rebuilt: surviving keys re-inserted into a fresh table
    (a full probe window of claim rounds) and their stats rows moved
    across. Called rarely (when the pose moved > sliding_thresh)."""
    dev = vmap_state.keys.device
    L, C = vmap_state.keys.shape[:2]
    vsizes = layer_voxel_sizes(cfg, dev)
    halves = _const(tuple(half_map_size * (1 << l) for l in range(L)),
                    torch.int32, str(dev))
    layers = _layer_ids(L, dev)
    keys_tab = vmap_state.keys
    ctr = torch.floor(center_pos[None, :] / vsizes[:, None]).to(torch.int32)
    occupied = keys_tab[..., 0] != EMPTY
    keep = occupied & torch.all(
        (keys_tab - ctr[:, None, :]).abs() <= halves[:, None, None], dim=-1)
    fresh = torch.full_like(keys_tab, EMPTY)
    fresh, new_slots = _insert(fresh, keys_tab, keep, cfg.probes, compact_to=0,
                               claim_rounds=cfg.probes, layers=layers)
    dst = torch.where(keep & (new_slots >= 0),
                      layers[:, None] * C + new_slots.long(), L * C)
    stats = vmap_state.stats.new_zeros((L * C + 1, STATS_W))
    stats[dst.reshape(-1)] = vmap_state.stats.reshape(-1, STATS_W)
    return _refresh(fresh, stats[:-1].view(L, C, STATS_W), cfg)

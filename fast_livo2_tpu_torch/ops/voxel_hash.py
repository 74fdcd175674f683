"""Fixed-capacity open-addressing spatial hash, as tensor ops (port of
fast_livo2_tpu/ops/voxel_hash.py: `_bucket`, `voxel_key`, `make_table`,
`lookup`, `lookup_or_insert`).

Keys are int32 voxel coordinates packed as one (C, 3) tensor; slots are
indices 0..C-1 into caller-owned value tensors. Linear probing with a
fixed probe length; an EMPTY slot ends a probe chain.

`_bucket` must be bit-identical to the JAX package's: the voxel map and
the LIO plane-information cap both address tables with it. Every operand
stays torch.int32, so the multiplies wrap around in two's complement and
`>>` is the arithmetic shift, as in XLA; nothing promotes to int64.

`lookup_or_insert` builds the raycast's scan-occupancy table (core/vio.py)
with the JAX package's claim protocol: per probe round each lane that
found an EMPTY slot bids its lane index into a fresh claims row by
integer scatter-max, the winners write their keys, and every bidder
re-reads its slot, so same-key twins resolve to the winner's slot in the
same round. Integer max is order-independent: the winning slot of every
key is the same on any device.
"""

import torch

EMPTY = 0x7FFFFFFF

# Large primes for the 3D spatial hash (standard Teschner-style mixing).
_P1, _P2, _P3 = 73856093, 19349669, 83492791
_MIX = -2048144789  # 0x85ebca6b as signed int32


def _bucket(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    """(..., 3) int32 keys -> (...,) int32 bucket in [0, capacity)."""
    if keys.dtype != torch.int32:
        raise TypeError(f"voxel keys must be int32, got {keys.dtype}")
    h = (keys[..., 0] * _P1) ^ (keys[..., 1] * _P2) ^ (keys[..., 2] * _P3)
    # murmur-style finalizer: the raw prime mix clusters for the small
    # coordinate ranges of room-scale maps.
    h = h ^ (h >> 13)
    h = h * _MIX
    h = h ^ (h >> 16)
    return h & (capacity - 1)


def voxel_key(points: torch.Tensor, voxel_size) -> torch.Tensor:
    """World position (N, 3) -> int32 voxel key (N, 3) by flooring
    (reference key rule, voxel_map.cpp:561-567)."""
    return torch.floor(points / voxel_size).to(torch.int32)


def make_table(capacity: int, device="cuda") -> torch.Tensor:
    """An empty (capacity, 3) int32 key table (capacity a power of 2)."""
    return torch.full((capacity, 3), EMPTY, dtype=torch.int32, device=device)


def lookup(table_keys: torch.Tensor, keys: torch.Tensor,
           probes: int = 8) -> torch.Tensor:
    """Slots (N,) int32 of keys (N, 3) in a (C, 3) key table, -1 where
    the key is absent."""
    capacity = table_keys.shape[0]
    h = _bucket(keys, capacity)
    slot_out = torch.full(h.shape, -1, dtype=torch.int32, device=keys.device)
    open_chain = torch.ones(h.shape, dtype=torch.bool, device=keys.device)
    for j in range(probes):
        s = (h + j) & (capacity - 1)
        tk = table_keys[s.long()]
        found = torch.all(tk == keys, dim=-1)
        slot_out = torch.where(open_chain & found, s, slot_out)
        open_chain = open_chain & ~found & (tk[:, 0] != EMPTY)
    return slot_out


def lookup_or_insert(table_keys: torch.Tensor, keys: torch.Tensor,
                     valid: torch.Tensor, probes: int = 8):
    """Find-or-claim slots for keys (N, 3) in a (C, 3) key table; padding
    lanes (`valid` False) never insert. Returns (new table, slots (N,)
    int32), -1 only where the probe window was exhausted. The input
    table is not written."""
    capacity = table_keys.shape[0]
    n = keys.shape[0]
    dev = keys.device
    h = _bucket(keys, capacity)
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    slot_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    unresolved = valid
    # row `capacity` is the sink the JAX package's mode="drop" drops to
    tkeys = torch.cat([table_keys, table_keys.new_full((1, 3), EMPTY)])
    for j in range(probes):
        s = (h + j) & (capacity - 1)
        sl = s.long()
        tk = tkeys[sl]
        found = torch.all(tk == keys, dim=-1)
        slot_out = torch.where(unresolved & found, s, slot_out)
        unresolved = unresolved & ~found
        # Claim empty slots: one winner per slot via a scatter-max ticket.
        cand = unresolved & (tk[:, 0] == EMPTY)
        claims = torch.full((capacity + 1,), -1, dtype=torch.int32,
                            device=dev).scatter_reduce_(
            0, torch.where(cand, sl, capacity),
            torch.where(cand, lane, -1), reduce="amax", include_self=True)
        won = cand & (claims[sl] == lane)
        tkeys[torch.where(won, sl, capacity)] = keys
        # Re-read: winners and same-key losers both resolve here.
        refound = cand & torch.all(tkeys[sl] == keys, dim=-1)
        slot_out = torch.where(refound, s, slot_out)
        unresolved = unresolved & ~refound
    return tkeys[:capacity], slot_out

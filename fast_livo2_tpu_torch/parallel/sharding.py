"""Sharding over torch.distributed (port of
fast_livo2_tpu/parallel/sharding.py).

Every heavy term of both filters is a sum over measurements (the LIO's
HᵀR⁻¹H 6 x 6 and HᵀR⁻¹z over N points, the backend's per-keyframe normal
equations), so a process group can split the measurement axis, or the
keyframe axis, and add the partial sums. The JAX package annotates
shardings and lets XLA insert the collectives. PyTorch has no
partitioner: each sharded function here takes a `Mesh` and calls the
collectives itself, where XLA puts its psums and all-gathers.

Every collective is built from two primitives, `all_reduce` (sums, and
gathers over zero-padded disjoint slices) and `broadcast`, because those
are what every backend offers for CUDA tensors: NCCL refuses two ranks on
one card, and gloo handles CUDA tensors only for broadcast, all_reduce and
barrier. So one code path runs under gloo on the CPU, under gloo with
several ranks on one card, and under NCCL across cards.

    # torchrun --nproc-per-node 4 script.py  (NCCL, one card a rank), or
    # init_process_group("gloo", ...) with every rank on cuda:0
    torch.distributed.init_process_group("nccl")
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    mesh = make_mesh()
    out = lio_update(..., pts_body=shard_points(pts, mesh),
                     valid=shard_points(valid, mesh), mesh=mesh)
"""

import contextlib
from typing import Optional

import torch
import torch.distributed as dist


class Mesh:
    """A one-axis device mesh: the process group, this process's rank and
    device, the group's size and the axis name. `collective_bytes` counts
    the bytes this rank handed to collectives (each all_reduce or
    broadcast buffer once), for the callers that report traffic."""

    def __init__(self, group, rank: int, size: int, axis: str,
                 device: torch.device):
        self.group = group
        self.rank = rank
        self.size = size
        self.axis = axis
        self.device = device
        self.collective_bytes = 0

    def __repr__(self):
        return (f"Mesh(axis={self.axis!r}, rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={dist.get_backend(self.group)})")


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              device=None) -> Mesh:
    """A mesh over the first `n_devices` ranks (all by default) of the
    initialised default process group (torchrun, or init_process_group).
    Every rank calls it. `device`: this rank's device, the current CUDA
    device by default; CPU callers pass "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torchrun, or torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the mesh of ranks 0-{n - 1}")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, rank, n, axis, torch.device(device))


def _tree(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(fn, x) for x in tree)
    return tree


def shard_rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous slice of a leading axis of length n, which
    must divide by the mesh size (as the JAX package's sharding needs)."""
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not divide over "
                         f"{mesh.size} ranks of mesh axis {mesh.axis!r}")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_points(tree, mesh: Mesh):
    """This rank's contiguous slice of the leading axis of every tensor in
    `tree` (a tensor or a (named) tuple of them), on the mesh's device."""
    return _tree(lambda x: x[shard_rows(x.shape[0], mesh)].to(mesh.device),
                 tree)


def all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of x over the mesh (a new tensor; x is untouched). Booleans
    add as integers."""
    out = x.to(torch.int32) if x.dtype == torch.bool else x.contiguous().clone()
    mesh.collective_bytes += out.numel() * out.element_size()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def all_reduce_many(xs, mesh: Mesh):
    """all_reduce of several float32 tensors in ONE collective: flattened
    into one buffer, summed, split back to their shapes."""
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in xs])
    flat = all_reduce(flat, mesh)
    out, i = [], 0
    for x in xs:
        out.append(flat[i:i + x.numel()].reshape(x.shape).to(x.dtype))
        i += x.numel()
    return out


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's slice of the leading axis, concatenated in rank order
    (each rank passes the same shape): one all_reduce over a zero-filled
    full buffer in which each rank writes its own rows. Exact, since each
    entry sums one value and zeros."""
    dtype = x.dtype
    if dtype == torch.bool:
        x = x.to(torch.uint8)
    n = x.shape[0]
    full = x.new_zeros((n * mesh.size,) + tuple(x.shape[1:]))
    full[mesh.rank * n:(mesh.rank + 1) * n] = x
    mesh.collective_bytes += full.numel() * full.element_size()
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=mesh.group)
    return full.to(dtype) if dtype == torch.bool else full


def replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's x on every rank's device (a broadcast; a new tensor)."""
    out = x.to(mesh.device).contiguous().clone()
    mesh.collective_bytes += out.numel() * out.element_size()
    dist.broadcast(out, src=dist.get_global_rank(mesh.group, 0),
                   group=mesh.group)
    return out


def put_replicated(tree, mesh: Mesh):
    """`replicated` of every tensor in `tree`."""
    return _tree(lambda x: replicated(x, mesh), tree)


def put_sharded(tree, mesh: Mesh):
    """Every tensor of `tree` placed on the mesh: a tensor with a leading
    axis is split over the ranks along it (`shard_points`; the axis must
    divide by the mesh size), a 0-d tensor is rank 0's value on every rank
    (`put_replicated`). The counterpart of the JAX package's
    put_sharded(tree, shard_points(mesh))."""
    return _tree(lambda x: (put_replicated(x, mesh) if x.dim() == 0
                            else shard_points(x, mesh)), tree)


def agree(flag: bool, mesh: Optional[Mesh]) -> bool:
    """Rank 0's host decision on every rank (one broadcast), for a branch
    that enters collectives: a branch read from a rank's own float state
    could go one way on one rank and the other way on another."""
    if mesh is None:
        return flag
    return bool(replicated(torch.tensor([int(flag)], dtype=torch.int32),
                           mesh).item())


@contextlib.contextmanager
def deterministic(device: torch.device):
    """torch's deterministic algorithms on a CUDA device for the block
    (every write with duplicate targets then takes one order, so replicas
    that apply the same update hold the same bits, sink rows included;
    the float scatter-adds are ordered in either mode, ops/ordered_add);
    nothing on the CPU, whose writes are already ordered. warn_only: an
    op with no deterministic form warns instead of raising."""
    if torch.device(device).type != "cuda":
        yield
        return
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)

"""Ordered segment add: `base.index_add_(0, dst, src)` as the CPU sums it,
on the card.

It replaces no TPU kernel. It was added because CUDA's float
`index_add_` sums with atomics in no fixed order, so two runs of the
same frames on the card parted by centimetres, while the JAX package's
`.at[].add` scatters (XLA) sum in update order on the CPU and
deterministically on the TPU. Every float scatter-add of the port goes
through it: the downsample's centroid sums (core/lio.py), the map's
running moments (core/voxel_map.py `_accumulate`) and the TSDF's
weighted SDF sums (io/tsdf.py).

`ordered_index_add_(base, dst, src, drop=None, dst_sorted=False)` updates
the (R, W) float32 `base` in place and returns it: each row r becomes
(((base[r] + src[i1]) + src[i2]) + ...), with i1 < i2 < ... the lanes
whose `dst` is r. `drop` names a sink row that no caller reads: the
kernel leaves it unsummed (the sink's run holds every invalid lane, and
walking it would set the kernel's time), the plain version sums it.
`dst_sorted=True` says that `dst` is already non-decreasing (not
checked: a check is a device sync), and the sort is skipped.

On CUDA tensors it sorts `dst` stably (torch.sort, deterministic and
capturable) and launches the hand-written kernel `csrc/ordered_add.cu`
(one thread per sorted lane and column; the thread that starts a run
walks it in order; the source says what bounds it), or raises: there is
no fallback; the call takes the shared launch path of ops/_launch.py.
On CPU tensors it runs `ordered_index_add_plain`, which is
`base.index_add_(0, dst, src)`: the CPU sums lane by lane in index
order. `LAUNCHES` counts calls that launched the kernel, never
plain-version calls.

Keys must lie in [0, R). The kernel does not check them; the plain
version's `index_add_` raises on the CPU.
"""

import ctypes
from typing import Optional

import torch

from . import _launch

LAUNCHES = 0
_F32, _I64 = torch.float32, torch.int64

_fn = None


def ordered_index_add_plain(base: torch.Tensor, dst: torch.Tensor,
                            src: torch.Tensor) -> torch.Tensor:
    """base (R, W), dst (n,) integer, src (n, W): base.index_add_(0, dst,
    src), in place."""
    return base.index_add_(0, dst, src)


def _kernel():
    global _fn
    if _fn is None:
        # base, keys, perm, src, n, W, drop, device, stream
        _fn = _launch.load("ordered_add", "ordered_add_launch",
                           [ctypes.c_void_p] * 4
                           + [ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_void_p])
    return _fn


def _diagnose(base, dst, src):
    """The wrapper's device, dtype, shape and contiguity checks one by one
    (its slow path): raises for the first that fails."""
    n = dst.shape[0]
    _launch.diagnose("ordered_index_add_", "base", base, (
        ("base", base, tuple(base.shape), _F32),
        ("dst", dst, (n,), _I64),
        ("src", src, (n, base.shape[1]), _F32)))


def ordered_index_add_(base: torch.Tensor, dst: torch.Tensor,
                       src: torch.Tensor, drop: Optional[int] = None,
                       dst_sorted: bool = False) -> torch.Tensor:
    """base (R, W) float32, dst (n,) int64, src (n, W) float32 -> base,
    each row summed in ascending lane order, in place. CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    dev = base.get_device()
    if not (dev >= 0 and base.is_cuda and dst.get_device() == dev
            and src.get_device() == dev and base.dtype == _F32
            and dst.dtype == _I64 and src.dtype == _F32
            and base.dim() == 2 and dst.dim() == 1 and src.dim() == 2
            and src.shape[0] == dst.shape[0] and src.shape[1] == base.shape[1]
            and base.is_contiguous() and dst.is_contiguous()
            and src.is_contiguous()):
        if base.dim() != 2 or dst.dim() != 1 or src.dim() != 2:
            raise ValueError(f"ordered_index_add_: base must be (R, W), dst "
                             f"(n,) and src (n, W), got {tuple(base.shape)}, "
                             f"{tuple(dst.shape)} and {tuple(src.shape)}")
        if _launch.on_cpu("ordered_index_add_", base):
            return ordered_index_add_plain(base, dst, src)
        _diagnose(base, dst, src)
    n = dst.shape[0]
    if n == 0:
        return base
    if dst_sorted:
        keys, perm = dst, None
    else:
        keys, perm = torch.sort(dst, stable=True)
    err = (_fn or _kernel())(base.data_ptr(), keys.data_ptr(),
                             None if perm is None else perm.data_ptr(),
                             src.data_ptr(), n, base.shape[1],
                             -1 if drop is None else drop, dev,
                             _launch.raw_stream(dev))
    if err:
        _launch.fail("ordered_index_add_", err)
    global LAUNCHES
    LAUNCHES += 1
    return base

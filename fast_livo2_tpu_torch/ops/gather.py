"""Row gather table[idx] (port of TPU kernel K3,
fast_livo2_tpu/ops/pallas_gather.py:gather_rows).

The JAX package runs this kernel on no path: its map and pool gathers
are XLA gathers, and only its own test calls it (the kernel was an
experiment measuring random-row access on a TPU). The port keeps it the
same way: a kernel, its plain version and the wrapper below, which no
module of the port calls.

`gather_rows(table, idx, group)` has the TPU wrapper's signature and
contract: a (C, W) float32 table, (N,) int32 indices with N % group == 0
(ValueError otherwise, where the TPU wrapper asserts), and (N, W) out,
exact. On CUDA tensors it launches the hand-written kernel
`csrc/gather_rows.cu` (one warp a row, 16-byte loads where the pointers
allow; the source says what bounds it) or raises: there is no fallback;
the call takes the shared launch path of ops/_launch.py. On CPU tensors
it runs `gather_rows_plain`. `LAUNCHES` counts calls that launched the
kernel, never plain-version calls.

Indices must lie in [0, C). Neither kernel checks them: the TPU kernel
leaves such a row undefined and the CUDA kernel reads outside the table
(a range check on the host would be a device sync). The plain version's
indexing raises IndexError on the CPU.
"""

import ctypes

import torch

from . import _launch

LAUNCHES = 0
_F32, _I32 = torch.float32, torch.int32

_fn = None


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (C, W), idx (N,) integer -> table[idx] (N, W)."""
    return table[idx.long()]


def _kernel():
    global _fn
    if _fn is None:
        # table, idx, out, N, W, device, stream
        _fn = _launch.load("gather_rows", "gather_rows_launch",
                           [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
    return _fn


def _diagnose(table, idx):
    """The wrapper's device, dtype and contiguity checks one by one (its
    slow path): raises for the first that fails."""
    _launch.diagnose("gather_rows", "table", table, (
        ("table", table, tuple(table.shape), _F32),
        ("idx", idx, tuple(idx.shape), _I32)))


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                group: int = 128) -> torch.Tensor:
    """table (C, W) float32, idx (N,) int32 with N % group == 0 -> (N, W)
    = table[idx]. CPU tensors run the plain version; CUDA tensors launch
    the kernel."""
    dev = table.get_device()
    if not (dev >= 0 and table.is_cuda and idx.get_device() == dev
            and table.dtype == _F32 and idx.dtype == _I32
            and table.dim() == 2 and idx.dim() == 1
            and idx.shape[0] % group == 0 and table.is_contiguous()
            and idx.is_contiguous()):
        if table.dim() != 2 or idx.dim() != 1:
            raise ValueError(f"gather_rows: table must be (C, W) and idx (N,), "
                             f"got {tuple(table.shape)} and {tuple(idx.shape)}")
        n = idx.shape[0]
        if n % group != 0:
            raise ValueError(f"gather_rows: N = {n} is not a multiple of "
                             f"group = {group}")
        if _launch.on_cpu("gather_rows", table):
            return gather_rows_plain(table, idx)
        _diagnose(table, idx)
    n = idx.shape[0]
    out = table.new_empty((n, table.shape[1]))
    if n == 0:
        return out
    err = (_fn or _kernel())(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                             n, table.shape[1], dev, _launch.raw_stream(dev))
    if err:
        _launch.fail("gather_rows", err)
    global LAUNCHES
    LAUNCHES += 1
    return out

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
allow; the source says what bounds it) or raises: there is no fallback.
On CPU tensors it runs `gather_rows_plain`. `LAUNCHES` counts calls that
launched the kernel, never plain-version calls.

Indices must lie in [0, C). Neither kernel checks them: the TPU kernel
leaves such a row undefined and the CUDA kernel reads outside the table
(a range check on the host would be a device sync). The plain version's
indexing raises IndexError on the CPU.
"""

import ctypes

import torch

LAUNCHES = 0

_fn = None


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (C, W), idx (N,) integer -> table[idx] (N, W)."""
    return table[idx.long()]


def _kernel():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("gather_rows").gather_rows_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                group: int = 128) -> torch.Tensor:
    """table (C, W) float32, idx (N,) int32 with N % group == 0 -> (N, W)
    = table[idx]. CPU tensors run the plain version; CUDA tensors launch
    the kernel."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows: table must be (C, W) and idx (N,), "
                         f"got {tuple(table.shape)} and {tuple(idx.shape)}")
    n, w = idx.shape[0], table.shape[1]
    if n % group != 0:
        raise ValueError(f"gather_rows: N = {n} is not a multiple of "
                         f"group = {group}")
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    if idx.device != table.device:
        raise ValueError(f"gather_rows: idx on {idx.device}, table on "
                         f"{table.device}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"gather_rows: table must be float32 and idx int32, "
                        f"got {table.dtype} and {idx.dtype}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows: table and idx must be contiguous")
    out = torch.empty((n, w), dtype=torch.float32, device=table.device)
    if n == 0:
        return out
    # The 16-byte path needs whole float4 rows at 16-byte aligned bases:
    # decided from the real pointers (a view may start at any element).
    vec = int(w % 4 == 0 and table.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                        n, w, vec, stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out

"""The launch path shared by the port's kernel wrappers (ops/cov_scan,
ops/photo_iteration, ops/gather).

At the main path's sizes a wrapper's host time is several times its
kernel's device time, so a call on CUDA tensors does only what the
launch needs:
- the device index comes from `Tensor.get_device()` (an int, -1 off the
  card), never from `torch.device` objects;
- the stream is the device's current one as a raw `cudaStream_t`
  (`raw_stream`), never a `torch.cuda.Stream` object;
- there is no device guard in Python: each C entry point takes the
  device index and switches the current device only when it differs
  (csrc/launch_on.cuh);
- the wrapper tests dtypes, shapes, contiguity and devices in one boolean
  expression; only when that is false does the slow path (`on_cpu`, the
  wrapper's own checks, `diagnose`) route a CPU call to the plain
  version or work out which check failed and raise;
- outputs come from `new_empty` on an input tensor.
Nothing checks index ranges and nothing waits for the device.
"""

import ctypes
from typing import Iterable, Sequence, Tuple

import torch

Spec = Tuple[str, torch.Tensor, Sequence[int], torch.dtype]


def raw_stream(device: int) -> int:
    """The current CUDA stream of `device` as a raw `cudaStream_t` (an
    int), as `torch.cuda.current_stream(device).cuda_stream` gives it,
    without building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(device)


def load(name: str, symbol: str, argtypes):
    """Entry point `symbol` of `csrc/<name>.cu`, built at first use, with
    its ctypes argument types and an int (cudaError_t) result."""
    from . import _build

    fn = getattr(_build.load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def fail(op: str, err: int):
    raise RuntimeError(f"{op} kernel launch failed: cudaError {err}")


def on_cpu(op: str, ref: torch.Tensor) -> bool:
    """True where `ref` lies on the CPU (the wrapper runs its plain
    version), False on a CUDA device; raises ValueError on any other."""
    if ref.is_cpu:
        return True
    if not ref.is_cuda:
        raise ValueError(f"{op}: unsupported device {ref.device}")
    return False


def diagnose(op: str, ref_name: str, ref: torch.Tensor, specs: Iterable[Spec]):
    """Raise for the first check that fails, tensor by tensor in the order
    given: device (that of `ref`), dtype, shape, contiguity. Each spec is
    (name, tensor, expected shape, expected dtype). Returns if all pass."""
    for name, t, shape, dtype in specs:
        if t.device != ref.device:
            raise ValueError(f"{op}: {name} on {t.device}, {ref_name} on "
                             f"{ref.device}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} must be "
                            f"{str(dtype).removeprefix('torch.')}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")

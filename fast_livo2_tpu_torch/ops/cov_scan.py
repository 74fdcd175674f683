"""Covariance propagation P <- F_i P F_i^T + Q_i over K IMU intervals
(port of TPU kernel K1, fast_livo2_tpu/ops/cov_scan.py:propagate_cov).

`propagate_cov` is the wrapper the IMU propagation calls once per
frame. On CUDA tensors it launches the hand-written kernel
`csrc/cov_scan.cu` (one thread block, P in shared memory, K sequential
FP32 steps; the source says what bounds it) or raises: there is no
fallback; the call takes the shared launch path of ops/_launch.py. On
CPU tensors it runs `propagate_cov_plain`, the same sequential
recursion in PyTorch ops and in the same order. The kernel is built by
nvcc at first use (ops/_build.py); nothing is built or loaded at
import.

`LAUNCHES` counts kernel launches (never plain-version calls), so a run
can show that its main path went through the kernel.
"""

import ctypes

import torch

from . import _launch

LAUNCHES = 0
MAX_D = 32  # the kernel keeps three D x D matrices in shared memory
_F32 = torch.float32

_fn = None


def propagate_cov_plain(F: torch.Tensor, Q: torch.Tensor,
                        P0: torch.Tensor) -> torch.Tensor:
    """Final covariance of P <- F_i P F_i^T + Q_i, i = 0..K-1, in order.
    F, Q: (K, D, D); P0: (D, D); returns (D, D)."""
    P = P0
    for i in range(F.shape[0]):
        P = (F[i] @ P) @ F[i].T + Q[i]
    return P


def _kernel():
    global _fn
    if _fn is None:
        # F, Q, P0, out, K, D, device, stream
        _fn = _launch.load("cov_scan", "cov_scan_launch",
                           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
    return _fn


def _diagnose(F, Q, P0):
    """The wrapper's checks one by one (its slow path): raises for the
    first that fails."""
    K, D = F.shape[0], P0.shape[0]
    _launch.diagnose("propagate_cov", "P0", P0, (
        ("F", F, (K, D, D), _F32), ("Q", Q, (K, D, D), _F32),
        ("P0", P0, (D, D), _F32)))
    if D > MAX_D:
        raise ValueError(f"propagate_cov: D={D} exceeds the kernel's {MAX_D}")


def propagate_cov(F: torch.Tensor, Q: torch.Tensor,
                  P0: torch.Tensor) -> torch.Tensor:
    """Final covariance of the recursion over the leading axis of F, Q
    (K, D, D) from P0 (D, D). CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    dev = P0.get_device()
    if not (dev >= 0 and P0.is_cuda and F.get_device() == dev
            and Q.get_device() == dev and F.dtype == _F32
            and Q.dtype == _F32 and P0.dtype == _F32 and F.dim() == 3
            and P0.dim() == 2 and F.shape == Q.shape
            and F.shape[1:] == P0.shape and P0.shape[0] == P0.shape[1] <= MAX_D
            and F.is_contiguous() and Q.is_contiguous()
            and P0.is_contiguous()):
        if _launch.on_cpu("propagate_cov", P0):
            return propagate_cov_plain(F, Q, P0)
        _diagnose(F, Q, P0)
    D = P0.shape[0]
    out = P0.new_empty((D, D))
    err = (_fn or _kernel())(F.data_ptr(), Q.data_ptr(), P0.data_ptr(),
                             out.data_ptr(), F.shape[0], D, dev,
                             _launch.raw_stream(dev))
    if err:
        _launch.fail("cov_scan", err)
    global LAUNCHES
    LAUNCHES += 1
    return out

"""The filter tail of one photometric ESIKF iteration, fused: what
core/vio._iterate_level computes once normal_equations(state) has
returned (HTH (n, n), HTz (n,), error), for n = 7 (the forward update
with its exposure column) or n = 6 (the inverse-compositional update).

The level's carried values live in two device buffers that the tail
rewrites in place, so that they pass from iteration to iteration with no
copy: `carry` (float32, CARRY_W) holds state_prop, state and old_state
packed as core/state.pack_state packs a NavState (NAV_LEN floats each),
then G_keep (19 x 19), final_err and last_error; `flags` (int32,
FLAGS_W) holds the device loop's stop flag and iteration count and the
split form's `done` (~accept | converged, which the host reads).
`start_level` makes them from a level's inputs (one cat and one fill);
`nav_view` and `level_result` give NavState / G_keep / final_err views
into `carry`, which normal_equations and the next level read.

`photo_tail` is the wrapper `_iterate_level` calls once per iteration.
On CUDA tensors it launches the hand-written kernel `csrc/photo_tail.cu`
(one block: the 19 x 19 solve by Gauss-Jordan with partial pivoting in
one warp, csrc/warp_solve.cuh; boxminus, G, the solution, boxplus and
the accept selects; the source says what bounds it) or raises: there is
no fallback. The call takes the shared launch path of ops/_launch.py,
allocates nothing and never waits for the device. On CPU tensors it runs
`photo_tail_plain`, the tail in PyTorch ops exactly as core/vio ran it
inline (the inverse by torch.linalg.inv_ex, boxminus / boxplus / select
of core/state), so CPU results are those of that code bit for bit.
`LAUNCHES` counts calls that launched the kernel, never plain-version
calls. It replaces no TPU kernel: the JAX package's tail is XLA ops.
"""

import ctypes

import torch

from ..core import state as state_mod
from ..core.state import (DIM_STATE, NAV_LEN, NavState, boxminus, boxplus,
                          nav_parts, select)
from . import _launch

D = DIM_STATE
MAX_N = 7  # the widest HTH the kernel takes
# carry layout (csrc/photo_tail.cu)
PROP, STATE, OLD = 0, NAV_LEN, 2 * NAV_LEN
G_KEEP = 3 * NAV_LEN
FINAL_ERR = G_KEEP + D * D
LAST_ERR = FINAL_ERR + 1
CARRY_W = LAST_ERR + 1
# flags layout
STOP, ITERS, DONE = 0, 1, 2
FLAGS_W = 3

_BIG = 3e38  # last_error before a level's first iteration (core/vio._BIG)
_F32 = torch.float32

LAUNCHES = 0

_fn = None


def nav_view(carry: torch.Tensor, at: int) -> NavState:
    """The NavState packed at carry[at:at + NAV_LEN], as views."""
    return state_mod.nav_view(carry[at:at + NAV_LEN])


def start_level(state_prop: NavState, state: NavState, G_keep, final_err):
    """(carry, flags) at the start of a pyramid level: old_state = state,
    last_error = _BIG, stop = 0, no iteration counted."""
    carry = torch.cat([*nav_parts(state_prop), *nav_parts(state),
                       *nav_parts(state), G_keep.reshape(D * D),
                       final_err.reshape(1),
                       final_err.new_full((1,), _BIG)])
    return carry, carry.new_zeros((FLAGS_W,), dtype=torch.int32)


def level_result(carry: torch.Tensor):
    """(state, G_keep, final_err) held in `carry`, as views."""
    return (nav_view(carry, STATE), carry[G_KEEP:FINAL_ERR].view(D, D),
            carry[FINAL_ERR])


def photo_tail_plain(carry, flags, P_scaled_inv, HTHn, HTzn, error,
                     device_loop: bool):
    """The tail in PyTorch ops, as core/vio._iterate_level ran it inline,
    on the values held in `carry` / `flags`; writes the results back into
    them."""
    state_prop, state, old_state = (nav_view(carry, a)
                                    for a in (PROP, STATE, OLD))
    G_keep = carry[G_KEEP:FINAL_ERR].view(D, D)
    final_err, last_error = carry[FINAL_ERR], carry[LAST_ERR]
    stop = flags[STOP] != 0

    f32, dev = P_scaled_inv.dtype, P_scaled_inv.device
    n = HTHn.shape[0]
    HTH = torch.zeros((D, D), dtype=f32, device=dev)
    HTH[0:n, 0:n] = HTHn
    K_1 = torch.linalg.inv_ex(HTH + P_scaled_inv).inverse
    G = torch.zeros((D, D), dtype=f32, device=dev)
    G[:, 0:n] = K_1[:, 0:n] @ HTHn
    vec = boxminus(state_prop, state)
    sol = -K_1[:, 0:n] @ HTzn + vec - G[:, 0:n] @ vec[0:n]

    # Accept/rollback (vio.cpp:1648-1681): on improvement keep the
    # pre-update state and apply the solution; otherwise revert to the
    # saved state and stop. In the device loop an iteration after the
    # stop changes nothing.
    accept = error <= last_error
    new_state = boxplus(state, sol)
    if device_loop:
        active = ~stop
        back = select(active, old_state, state)
        accept = active & accept
    else:
        back = old_state
    old_state, state = (select(accept, state, old_state),
                        select(accept, new_state, back))
    rot_add = torch.linalg.norm(sol[0:3])
    t_add = torch.linalg.norm(sol[3:6])
    converged = (rot_add * 57.3 < 0.001) & (t_add * 100.0 < 0.001)
    G_keep = torch.where(accept, G, G_keep)
    final_err = torch.where(accept, error, final_err)
    last_error = torch.where(accept, error, last_error)

    carry[STATE:OLD] = torch.cat(nav_parts(state))
    carry[OLD:G_KEEP] = torch.cat(nav_parts(old_state))
    carry[G_KEEP:FINAL_ERR] = G_keep.reshape(D * D)
    carry[FINAL_ERR] = final_err
    carry[LAST_ERR] = last_error
    if device_loop:
        flags[ITERS] += active.to(torch.int32)
        flags[STOP] = stop | ~accept | converged
    else:
        flags[DONE] = ~accept | converged


def _kernel():
    global _fn
    if _fn is None:
        # carry, flags, P, p_s0, p_s1, hth, h_s0, h_s1, htz, z_s, err, n,
        # device_loop, device, stream
        _fn = _launch.load(
            "photo_tail", "photo_tail_launch",
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return _fn


def _diagnose(carry, flags, P_scaled_inv, HTHn, HTzn, error):
    """The wrapper's checks one by one (its slow path): raises for the
    first that fails."""
    n = HTHn.shape[0] if HTHn.dim() == 2 else -1
    if not 1 <= n <= MAX_N:
        raise ValueError(f"photo_tail: HTHn must be (n, n) with 1 <= n <= "
                         f"{MAX_N}, got {tuple(HTHn.shape)}")
    _launch.diagnose("photo_tail", "carry", carry, (
        ("carry", carry, (CARRY_W,), _F32),
        ("flags", flags, (FLAGS_W,), torch.int32)))
    # the matrices may have any strides (the kernel takes them)
    for name, t, shape in (("P_scaled_inv", P_scaled_inv, (D, D)),
                           ("HTHn", HTHn, (n, n)), ("HTzn", HTzn, (n,)),
                           ("error", error, ())):
        if t.device != carry.device:
            raise ValueError(f"photo_tail: {name} on {t.device}, carry on "
                             f"{carry.device}")
        if t.dtype != _F32:
            raise TypeError(f"photo_tail: {name} must be float32, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"photo_tail: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def photo_tail(carry, flags, P_scaled_inv, HTHn, HTzn, error,
               device_loop: bool):
    """One iteration's filter tail on the level's `carry` and `flags`
    (module docstring), in place. P_scaled_inv: (19, 19); HTHn: (n, n)
    with 1 <= n <= 7; HTzn: (n,); error: (). CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    dev = carry.get_device()
    if not (dev >= 0 and carry.is_cuda and flags.get_device() == dev
            and P_scaled_inv.get_device() == dev and HTHn.get_device() == dev
            and HTzn.get_device() == dev and error.get_device() == dev
            and carry.dtype == _F32 and flags.dtype == torch.int32
            and P_scaled_inv.dtype == _F32 and HTHn.dtype == _F32
            and HTzn.dtype == _F32 and error.dtype == _F32
            and carry.shape == (CARRY_W,) and flags.shape == (FLAGS_W,)
            and carry.is_contiguous() and flags.is_contiguous()
            and P_scaled_inv.shape == (D, D) and HTHn.dim() == 2
            and 1 <= HTHn.shape[0] <= MAX_N
            and HTHn.shape[1] == HTHn.shape[0]
            and HTzn.shape == (HTHn.shape[0],) and error.dim() == 0):
        # the same contract on both devices: a call the kernel would
        # refuse raises on the CPU too
        _diagnose(carry, flags, P_scaled_inv, HTHn, HTzn, error)
        if _launch.on_cpu("photo_tail", carry):
            return photo_tail_plain(carry, flags, P_scaled_inv, HTHn, HTzn,
                                    error, device_loop)
    ps, hs = P_scaled_inv.stride(), HTHn.stride()
    err = (_fn or _kernel())(carry.data_ptr(), flags.data_ptr(),
                             P_scaled_inv.data_ptr(), ps[0], ps[1],
                             HTHn.data_ptr(), hs[0], hs[1], HTzn.data_ptr(),
                             HTzn.stride(0), error.data_ptr(), HTHn.shape[0],
                             int(device_loop), dev, _launch.raw_stream(dev))
    if err:
        _launch.fail("photo_tail", err)
    global LAUNCHES
    LAUNCHES += 1

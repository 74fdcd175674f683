"""The photometric filter tail (ops/photo_tail.py) on the CPU.

- photo_tail_plain, and core/vio._iterate_level built on it, equal the
  tail as _iterate_level ran it inline before the tail had a wrapper
  (`_inline_iterate_level` below, that code as it was) bit for bit, in
  both loop forms and at n = 7 (the forward update) and n = 6 (the
  inverse-compositional one), through accepted, rejected, stopped and
  converged iterations;
- the wrapper's contract: a call the kernel would refuse raises on the
  CPU too, a CPU call runs the plain version and counts no launch.
The kernel itself is held to the plain version by the card tests
(tests/test_torch_cuda.py, marker `cuda`).
"""

import math

import numpy as np
import pytest
import torch

from fast_livo2_tpu_torch.core import vio
from fast_livo2_tpu_torch.core.state import (DIM_STATE, NavState, boxminus,
                                             boxplus, select)
from fast_livo2_tpu_torch.ops import photo_tail, so3

D = DIM_STATE
_BIG = 3e38


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inline_iterate_level(state_prop, state, G_keep, final_err, P_scaled_inv,
                          normal_equations, max_iterations, device_loop):
    """core/vio._iterate_level with its tail inline, as it was."""
    f32, dev = P_scaled_inv.dtype, P_scaled_inv.device
    old_state = state
    last_error = torch.full((), _BIG, dtype=f32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    iterations = 0
    for it in range(max_iterations):
        HTHn, HTzn, error = normal_equations(state)
        n = HTHn.shape[0]
        HTH = torch.zeros((D, D), dtype=f32, device=dev)
        HTH[0:n, 0:n] = HTHn
        K_1 = torch.linalg.inv_ex(HTH + P_scaled_inv).inverse
        G = torch.zeros((D, D), dtype=f32, device=dev)
        G[:, 0:n] = K_1[:, 0:n] @ HTHn
        vec = boxminus(state_prop, state)
        sol = -K_1[:, 0:n] @ HTzn + vec - G[:, 0:n] @ vec[0:n]
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
        if device_loop:
            iterations = iterations + active.to(torch.int32)
            stop = stop | ~accept | converged
            continue
        iterations += 1
        if it + 1 < max_iterations and bool(~accept | converged):
            break
    return state, G_keep, final_err, iterations


def _rot(axis, angle):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a) * angle
    return so3.exp(torch.tensor(a, dtype=torch.float32))


def _state(rng, rot):
    f = lambda k: torch.tensor(rng.normal(size=k) * 0.3, dtype=torch.float32)
    return NavState(rot=rot, pos=f(3), vel=f(3), bias_g=f(3) * 0.01,
                    bias_a=f(3) * 0.1, grav=f(3) + torch.tensor([0, 0, -9.81]),
                    inv_expo=torch.tensor(1.0 + rng.normal() * 0.05,
                                          dtype=torch.float32))


def _P_scaled_inv(rng, cond):
    """inv(cov / img_point_cov) of an SPD covariance whose eigenvalues
    spread over `cond`, taken as core/vio takes it."""
    Q, _ = np.linalg.qr(rng.normal(size=(D, D)))
    ev = np.geomspace(1e-2, 1e-2 / cond, D)
    cov = torch.tensor((Q * ev) @ Q.T, dtype=torch.float32)
    cov = 0.5 * (cov + cov.T)
    return torch.linalg.inv_ex(cov / 100.0).inverse


# (name, n, rotation of state_prop against the start state, errors each
# iteration in turn: the accept rule sees these, so they script accepted,
# rejected and later stopped iterations; HTz scale: 0 makes sol ~ 0 and
# the first iteration converged)
CASES = [
    ("accept_all", 7, ([0.3, -0.5, 0.8], 0.02), [9.0, 8.0, 7.0, 6.5, 6.0], 1.0),
    ("reject_then_stopped", 7, ([1, 2, 3], 0.1), [9.0, 8.0, 8.5, 7.0, 6.0], 1.0),
    ("converged", 7, ([1, 0, 0], 0.0), [9.0, 8.0, 7.0, 6.0, 5.0], 0.0),
    ("near_identity", 6, ([0.2, 0.1, -1.0], 3e-5), [4.0, 3.0, 3.0, 2.0, 2.5], 1.0),
    ("near_pi", 6, ([0.6, -0.3, 0.74], math.pi - 2e-4), [4.0, 5.0, 3.0, 2.0, 1.0], 1.0),
    ("ill_conditioned", 7, ([0, 1, 1], 0.5), [3.0, 2.0, 2.5, 1.0, 1.0], 1.0),
]


def _problem(case, seed=0):
    name, n, (axis, angle), errors, hz = case
    rng = np.random.default_rng(seed)
    state = _state(rng, _rot(rng.normal(size=3), 0.7))
    state_prop = state._replace(rot=state.rot @ _rot(axis, angle)) \
        if angle else state
    P = _P_scaled_inv(rng, 1e6 if name == "ill_conditioned" else 1e2)
    J = torch.tensor(rng.normal(size=(64, n)) * 30.0, dtype=torch.float32)
    HTH = J.T @ J
    z = torch.tensor(rng.normal(size=n) * hz, dtype=torch.float32)
    calls = []

    def normal_equations(s):
        # HTz depends on the state it is handed (the state the tail wrote)
        e = boxminus(state_prop, s)[0:n]
        calls.append(len(calls))
        error = torch.tensor(errors[(len(calls) - 1) % len(errors)],
                             dtype=torch.float32)
        return HTH, (HTH @ e) * hz + z, error

    G_keep = torch.zeros((D, D))
    final_err = torch.zeros(())
    return state_prop, state, G_keep, final_err, P, normal_equations


def _assert_bitwise(a, b):
    (sa, Ga, ea, ia), (sb, Gb, eb, ib) = a, b
    for x, y in zip(sa, sb):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert torch.equal(Ga.view(torch.int32), Gb.view(torch.int32))
    assert torch.equal(ea.view(torch.int32), eb.view(torch.int32))
    assert int(ia) == int(ib)


@pytest.mark.parametrize("device_loop", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_iterate_level_equals_inline_tail_bitwise(case, device_loop):
    """The level through ops/photo_tail's plain version against the
    inline tail, bit for bit, over max_iterations = 5."""
    args = _problem(case)
    want = _inline_iterate_level(*args, 5, device_loop)
    got = vio._iterate_level(*_problem(case), 5, device_loop)
    _assert_bitwise(got, want)
    if device_loop:
        assert got[3].dtype == torch.int32 and got[3].dim() == 0


@pytest.mark.parametrize("device_loop", [False, True])
def test_levels_chain_bitwise(device_loop):
    """Four levels in turn, each starting from the last one's state,
    G_keep and final_err (as photometric_update chains them), against
    the inline tail: the carry's level start (old_state, last_error,
    stop reset) matches."""
    cases = [CASES[1], CASES[0], CASES[4], CASES[3]]
    sp, st, G, fe, P, _ = _problem(cases[0])
    got = want = (st, G, fe, 0)
    for k, c in enumerate(cases):
        ne = _problem(c, seed=k)[5]
        r_w = _inline_iterate_level(sp, want[0], want[1], want[2], P, ne, 5,
                                    device_loop)
        ne = _problem(c, seed=k)[5]
        r_g = vio._iterate_level(sp, got[0], got[1], got[2], P, ne, 5,
                                 device_loop)
        want = (*r_w[:3], want[3] + r_w[3])
        got = (*r_g[:3], got[3] + r_g[3])
        _assert_bitwise(got, want)


def test_wrapper_runs_plain_on_cpu_without_a_launch():
    sp, st, G, fe, P, ne = _problem(CASES[1])
    carry, flags = photo_tail.start_level(sp, st, G, fe)
    c2, f2 = carry.clone(), flags.clone()
    HTHn, HTzn, error = ne(st)
    before = photo_tail.LAUNCHES
    photo_tail.photo_tail(carry, flags, P, HTHn, HTzn, error, True)
    photo_tail.photo_tail_plain(c2, f2, P, HTHn, HTzn, error, True)
    assert photo_tail.LAUNCHES == before
    assert torch.equal(carry.view(torch.int32), c2.view(torch.int32))
    assert torch.equal(flags, f2)
    assert int(flags[photo_tail.ITERS]) == 1
    assert not torch.equal(carry[photo_tail.STATE:photo_tail.OLD],
                           carry[photo_tail.OLD:photo_tail.G_KEEP])


def test_layout_views():
    sp, st, G, fe, P, _ = _problem(CASES[0])
    carry, flags = photo_tail.start_level(sp, st, G, fe)
    assert carry.shape == (photo_tail.CARRY_W,) == (438,)
    assert flags.dtype == torch.int32 and not flags.any()
    for a, want in ((photo_tail.PROP, sp), (photo_tail.STATE, st),
                    (photo_tail.OLD, st)):
        v = photo_tail.nav_view(carry, a)
        assert all(torch.equal(x, y) for x, y in zip(v, want))
        assert v.rot.data_ptr() == carry[a:].data_ptr()  # a view
    assert float(carry[photo_tail.LAST_ERR]) == np.float32(_BIG)
    s, Gk, f = photo_tail.level_result(carry)
    assert torch.equal(Gk, G) and torch.equal(f, fe)


def _call(**over):
    sp, st, G, fe, P, ne = _problem(CASES[0])
    carry, flags = photo_tail.start_level(sp, st, G, fe)
    HTHn, HTzn, error = ne(st)
    args = dict(carry=carry, flags=flags, P_scaled_inv=P, HTHn=HTHn,
                HTzn=HTzn, error=error)
    args.update(over)
    photo_tail.photo_tail(**args, device_loop=True)


@pytest.mark.parametrize("over,exc", [
    (dict(HTHn=torch.zeros(8, 8), HTzn=torch.zeros(8)), ValueError),
    (dict(HTHn=torch.zeros(7, 6)), ValueError),
    (dict(HTzn=torch.zeros(6)), ValueError),
    (dict(error=torch.zeros(1)), ValueError),
    (dict(carry=torch.zeros(437)), ValueError),
    (dict(flags=torch.zeros(3)), TypeError),
    (dict(P_scaled_inv=torch.zeros(19, 19, dtype=torch.float64)), TypeError),
    (dict(HTzn=torch.zeros(7, dtype=torch.float16)), TypeError),
    (dict(carry=torch.zeros(876)[::2]), ValueError),
])
def test_wrapper_rejects_bad_input(over, exc):
    before = photo_tail.LAUNCHES
    with pytest.raises(exc):
        _call(**over)
    assert photo_tail.LAUNCHES == before

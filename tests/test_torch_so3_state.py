"""Parity of the PyTorch port's SO(3) ops and 19-dim state against the
JAX package on the same numpy-seeded inputs.

Tolerance: 2e-6 absolute on O(1) quantities. Both sides evaluate the
same float32 formulas; the residue is ulp-level rounding from different
transcendental implementations and operation fusion (XLA vs ATen).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.core import state as jstate
from fast_livo2_tpu.ops import so3 as jso3
from fast_livo2_tpu_torch.core import state as tstate
from fast_livo2_tpu_torch.ops import so3 as tso3

ATOL = 2e-6


def _both(fn_j, fn_t, *arrays):
    """Run the JAX and the port function on the same float32 arrays."""
    a32 = [np.array(a, np.float32) for a in arrays]  # writable copies
    got_j = np.asarray(fn_j(*[jnp.asarray(a) for a in a32]))
    got_t = fn_t(*[torch.from_numpy(a) for a in a32]).numpy()
    return got_j, got_t


def _rotations(n, seed, scale=1.0):
    w = np.random.default_rng(seed).normal(size=(n, 3)) * scale
    return np.asarray(jso3.exp(jnp.asarray(w, jnp.float32)))


@pytest.mark.parametrize("scale", [1e-6, 1e-4, 1e-2, 0.5, 3.0])
def test_exp_and_skew(scale):
    w = np.random.default_rng(1).normal(size=(64, 3)) * scale
    j, t = _both(jso3.exp, tso3.exp, w)
    np.testing.assert_allclose(t, j, atol=ATOL)
    j, t = _both(jso3.skew, tso3.skew, w)
    np.testing.assert_array_equal(t, j)
    dt = np.float32(0.005)
    j, t = _both(lambda x: jso3.exp(x, dt), lambda x: tso3.exp(x, dt), w)
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("angle", [1e-7, 1e-5, 0.3, 2.0, np.pi - 2e-3,
                                   np.pi - 5e-4, np.pi - 1e-5])
def test_log_including_near_pi(angle):
    """Generic branch, the small-angle series and the near-pi branch
    (theta > pi - 1e-3: axis from the symmetric part, so3.py:86-107)."""
    rng = np.random.default_rng(2)
    axis = rng.normal(size=(48, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    R = np.asarray(jso3.exp(jnp.asarray(axis * angle, jnp.float32)))
    j, t = _both(jso3.log, tso3.log, R)
    np.testing.assert_allclose(t, j, atol=ATOL)
    if angle > np.pi - 1e-3:
        np.testing.assert_allclose(np.linalg.norm(t, axis=-1), angle,
                                   atol=2e-3)


def test_normalize_euler_quat():
    R = _rotations(64, seed=5)
    R_noisy = R + np.random.default_rng(6).normal(size=R.shape) * 1e-4
    j, t = _both(jso3.normalize_rotation, tso3.normalize_rotation, R_noisy)
    np.testing.assert_allclose(t, j, atol=ATOL)
    j, t = _both(jso3.euler_zyx, tso3.euler_zyx, R)
    np.testing.assert_allclose(t, j, atol=4 * ATOL)
    j, t = _both(jso3.quat_wxyz, tso3.quat_wxyz, R)
    np.testing.assert_allclose(t, j, atol=ATOL)
    # the singular branch of euler_zyx (pitch = +-90 deg)
    Rs = np.asarray(jso3.exp(jnp.asarray([[0.0, np.pi / 2, 0.0]], jnp.float32)))
    j, t = _both(jso3.euler_zyx, tso3.euler_zyx, Rs)
    np.testing.assert_allclose(t, j, atol=4 * ATOL)


def _random_state(rng):
    s = jstate.boxplus(jstate.init_state(),
                       jnp.asarray(rng.normal(size=19) * 0.5, jnp.float32))
    cov = rng.normal(size=(19, 19)) * 0.1
    cov = (cov @ cov.T + np.eye(19) * 0.01).astype(np.float32)
    return s, cov


def test_state_init_and_pack_layout():
    np.testing.assert_array_equal(tstate.init_cov(device="cpu").numpy(),
                                  np.asarray(jstate.init_cov()))
    np.testing.assert_array_equal(
        tstate.pack_state(tstate.init_state(device="cpu"),
                          tstate.init_cov(device="cpu")).numpy(),
        np.asarray(jstate.pack_state(jstate.init_state(), jstate.init_cov())))
    rng = np.random.default_rng(3)
    s, cov = _random_state(rng)
    packed = np.array(jstate.pack_state(s, jnp.asarray(cov)))
    assert packed.shape == (tstate.PACKED_LEN,)
    ts, tcov = tstate.unpack_state(torch.from_numpy(packed))
    for name in tstate.NavState._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(s, name)))
    np.testing.assert_array_equal(tcov.numpy(), cov)
    np.testing.assert_array_equal(tstate.pack_state(ts, tcov).numpy(), packed)


def test_boxplus_boxminus():
    rng = np.random.default_rng(4)
    s, cov = _random_state(rng)
    packed = np.array(jstate.pack_state(s, jnp.asarray(cov)))
    ts, _ = tstate.unpack_state(torch.from_numpy(packed))
    delta = (rng.normal(size=19) * 0.3).astype(np.float32)
    s2 = jstate.boxplus(s, jnp.asarray(delta))
    t2 = tstate.boxplus(ts, torch.from_numpy(delta))
    for name in tstate.NavState._fields:
        np.testing.assert_allclose(getattr(t2, name).numpy(),
                                   np.asarray(getattr(s2, name)), atol=ATOL)
    np.testing.assert_allclose(tstate.boxminus(t2, ts).numpy(),
                               np.asarray(jstate.boxminus(s2, s)), atol=5e-6)
    np.testing.assert_allclose(tstate.boxminus(t2, ts).numpy(), delta,
                               atol=1e-5)

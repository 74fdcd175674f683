"""Parity of the port's covariance scan (kernel K1's plain version and its
wrapper) and IMU propagation / undistortion against the JAX package.

Tolerances:
- covariance: rtol 2e-4, atol 2e-5 — tests/test_imu.py:176-177's bound
  for two float32 evaluation orders of the same recursion (the JAX CPU
  path composes affine maps by an associative scan; the port steps
  P <- F P F^T + Q in order);
- state and poses: 1e-5 absolute — the rotation prefix is associated
  differently (log-step doubling vs lax.associative_scan), which moves
  float32 rounding by a few ulp per product;
- undistorted points (|p| <= ~20 m): 2e-5 absolute, the same rounding
  scaled by the point range.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.core import imu as jimu
from fast_livo2_tpu.core import state as jstate
from fast_livo2_tpu.ops import cov_scan as jcov
from fast_livo2_tpu_torch.core import imu as timu
from fast_livo2_tpu_torch.core import state as tstate
from fast_livo2_tpu_torch.ops import cov_scan as tcov

RTOL_COV, ATOL_COV = 2e-4, 2e-5


def _cov_inputs(K, D=19, seed=3):
    """tests/test_imu.py:156-163's construction."""
    rng = np.random.default_rng(seed)
    F = (np.eye(D)[None] + rng.normal(size=(K, D, D)) * 0.02).astype(np.float32)
    Q = rng.normal(size=(K, D, D)) * 0.01
    Q = np.einsum("kij,klj->kil", Q, Q).astype(np.float32)
    P0 = rng.normal(size=(D, D)) * 0.1
    P0 = (P0 @ P0.T + np.eye(D) * 0.01).astype(np.float32)
    return F, Q, P0


@pytest.mark.parametrize("K", [16, 64])
def test_cov_scan_plain_matches_pallas_interpret(K):
    F, Q, P0 = _cov_inputs(K)
    want = np.asarray(jcov.propagate_cov(jnp.asarray(F), jnp.asarray(Q),
                                         jnp.asarray(P0), interpret=True))
    got = tcov.propagate_cov_plain(torch.from_numpy(F), torch.from_numpy(Q),
                                   torch.from_numpy(P0)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_COV, atol=ATOL_COV)


def test_cov_scan_wrapper_routes_cpu_to_plain():
    F, Q, P0 = _cov_inputs(8)
    before = tcov.LAUNCHES
    args = [torch.from_numpy(a) for a in (F, Q, P0)]
    out = tcov.propagate_cov(*args)
    assert tcov.LAUNCHES == before  # a CPU tensor never launches the kernel
    np.testing.assert_array_equal(out.numpy(),
                                  tcov.propagate_cov_plain(*args).numpy())
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent path
        tcov.propagate_cov(*[a.to("meta") for a in args])


def _imu_case(seed, n_imu=24, hz=200.0, max_k=32):
    rng = np.random.default_rng(seed)
    stamps = np.arange(n_imu) / hz + 0.0025
    gyr = rng.normal(size=(n_imu, 3)) * 0.3
    acc = (np.array([0.05, -0.02, 9.7]) + rng.normal(size=(n_imu, 3)) * 0.3)
    prop_beg, prop_end = 0.01, float(stamps[-1]) + 0.002
    jb = jimu.prepare_imu_batch(stamps, gyr, acc, prop_beg, prop_end, max_k)
    tb = timu.prepare_imu_batch(stamps, gyr, acc, prop_beg, prop_end, max_k)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a, b)
    # a non-trivial prior: rotated, moving, biased, with gravity
    delta = (rng.normal(size=19) * 0.1).astype(np.float32)
    s = jstate.boxplus(jstate.init_state(), jnp.asarray(delta))
    s = s._replace(grav=jnp.asarray([0.1, -0.05, -9.81], jnp.float32))
    P = rng.normal(size=(19, 19)) * 0.03
    P = (P @ P.T + np.eye(19) * 1e-3).astype(np.float32)
    packed = np.array(jstate.pack_state(s, jnp.asarray(P)))
    return jb, tb, s, P, packed


def _noise_pair(**kw):
    return jimu.make_noise(**kw), timu.make_noise(**kw, device="cpu")


@pytest.mark.parametrize("est", [True, False])
def test_propagate_and_undistort_match_jax(est):
    jb, tb, s, P, packed = _imu_case(seed=11)
    jn, tn = _noise_pair(mean_acc_norm=9.79, est_bias=est, est_gravity=est,
                         est_exposure=est)
    js, jP, jposes = jimu.propagate(s, jnp.asarray(P), jb, jn)
    ts0, tP0 = tstate.unpack_state(torch.from_numpy(packed))
    ts, tP, tposes = timu.propagate(ts0, tP0,
                                    timu.batch_to_device(tb, "cpu"), tn)
    for name in ("rot", "pos", "vel"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=1e-5)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP),
                               rtol=RTOL_COV, atol=ATOL_COV)
    for name in timu.ImuPoses._fields:
        np.testing.assert_allclose(getattr(tposes, name).numpy(),
                                   np.asarray(getattr(jposes, name)),
                                   atol=1e-5, err_msg=name)

    rng = np.random.default_rng(12)
    pts = (rng.normal(size=(500, 3)) * 8).astype(np.float32)
    t_offs = rng.uniform(-0.002, 0.13, size=500).astype(np.float32)
    ext_R = np.array(jimu.so3.exp(jnp.asarray([0.01, -0.02, 0.03],
                                                jnp.float32)))
    ext_T = np.array([0.04, -0.02, 0.01], np.float32)
    want = np.asarray(jimu.undistort(jnp.asarray(pts), jnp.asarray(t_offs),
                                     jposes, js, jnp.asarray(ext_R),
                                     jnp.asarray(ext_T)))
    got = timu.undistort(torch.from_numpy(pts), torch.from_numpy(t_offs),
                         tposes, ts, torch.from_numpy(ext_R),
                         torch.from_numpy(ext_T)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_propagate_padding_is_noop():
    """Padding intervals (dt = 0) leave state and covariance unchanged:
    the same span at K = 32 and K = 64 agrees."""
    rng = np.random.default_rng(5)
    stamps = np.arange(10) / 200.0
    gyr, acc = rng.normal(size=(10, 3)), rng.normal(size=(10, 3)) + 9.8
    _, tn = _noise_pair()
    outs = []
    for k in (32, 64):
        b = timu.prepare_imu_batch(stamps, gyr, acc, 0.0, stamps[-1], k)
        outs.append(timu.propagate(tstate.init_state(device="cpu"),
                                   tstate.init_cov(device="cpu"),
                                   timu.batch_to_device(b, "cpu"), tn))
    np.testing.assert_allclose(outs[0][0].pos.numpy(), outs[1][0].pos.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(outs[0][1].numpy(), outs[1][1].numpy(),
                               atol=1e-6)


def test_static_init_and_no_imu_mode_match_jax():
    rng = np.random.default_rng(6)
    acc = np.array([0.1, -0.2, 9.8]) + rng.normal(size=(40, 3)) * 0.02
    gyr = rng.normal(size=(40, 3)) * 1e-3
    jg, jn_ = jimu.static_init(acc, gyr)
    tg, tn_ = timu.static_init(acc, gyr)
    np.testing.assert_array_equal(tg, jg)
    assert tn_ == jn_

    jb, tb, s, P, packed = _imu_case(seed=13)
    s = s._replace(bias_g=jnp.asarray([0.2, -0.1, 0.3], jnp.float32))
    packed = np.array(jstate.pack_state(s, jnp.asarray(P)))
    jn, tn = _noise_pair(acc_cov=0.4, gyr_cov=0.2)
    dt = np.float32(0.1)
    js, jP = jimu.propagate_without_imu(s, jnp.asarray(P), dt, jn)
    ts0, tP0 = tstate.unpack_state(torch.from_numpy(packed))
    ts, tP = timu.propagate_without_imu(ts0, tP0, torch.tensor(dt), tn)
    np.testing.assert_allclose(ts.rot.numpy(), np.asarray(js.rot), atol=1e-6)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), atol=1e-6)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=RTOL_COV,
                               atol=ATOL_COV)
    pts = (rng.normal(size=(300, 3)) * 6).astype(np.float32)
    t_offs = rng.uniform(0, 0.1, size=300).astype(np.float32)
    want = np.asarray(jimu.undistort_without_imu(
        jnp.asarray(pts), jnp.asarray(t_offs), dt, js))
    got = timu.undistort_without_imu(torch.from_numpy(pts),
                                     torch.from_numpy(t_offs),
                                     torch.tensor(dt), ts).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)

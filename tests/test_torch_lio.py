"""Parity of the port's LIO step against the JAX package on the CPU.

- `voxel_downsample` is held EXACT on identical inputs: both sort the
  same integer keys stably and sum the same points in the same order on
  the CPU.
- `calc_body_cov`: 1e-7 absolute (covariances of ~1e-3; float32 formulas
  evaluated by XLA and ATen).
- `lio_update`, from a JAX-built map and a packed state carried over
  with io/convert.py: `n_effective` EQUAL, the state to 1e-5 and the
  posterior covariance to rtol 1e-3 / atol 1e-7. The iterated solve
  (two 19x19 inverses per iteration over thousands of residuals) lets
  float32 summation-order differences grow a little; a logic difference
  (a different match, iteration count or gain) moves these by orders of
  magnitude more.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.core import lio as jlio
from fast_livo2_tpu.core import state as jstate
from fast_livo2_tpu.core import voxel_map as jvm
from fast_livo2_tpu_torch.core import lio as tlio
from fast_livo2_tpu_torch.core import voxel_map as tvm
from fast_livo2_tpu_torch.core.state import NavState, unpack_state
from fast_livo2_tpu_torch.io import convert


@pytest.mark.parametrize("leaf,max_out", [(0.5, 2048), (0.15, 4096), (0.5, 100)])
def test_voxel_downsample_exact(leaf, max_out):
    rng = np.random.default_rng(5)
    pts = rng.uniform(-6, 6, size=(5000, 3)).astype(np.float32)
    pts[:50] = pts[0]  # one crowded voxel
    valid = rng.uniform(size=5000) > 0.1
    jo, jv = jlio.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid), leaf,
                                   max_out)
    to, tv = tlio.voxel_downsample(torch.from_numpy(pts),
                                   torch.from_numpy(valid), leaf, max_out)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_calc_body_cov_and_bucket_centers():
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(400, 3)).astype(np.float32) * 6
    pts[0, 2] = 0.0  # the z == 0 guard
    want = np.asarray(jlio.calc_body_cov(jnp.asarray(pts), 0.02, 0.05))
    got = tlio.calc_body_cov(torch.from_numpy(pts), 0.02, 0.05).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7)
    ck = rng.integers(-4000, 4000, size=(1000, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tlio._bucket_centers(torch.from_numpy(ck)).numpy(),
        np.asarray(jlio._bucket_centers(jnp.asarray(ck))))


def _plane_points(rng, n, normal, d, extent=4.0, noise=0.005):
    """tests/test_voxel_map.py's sampler of the plane n.p + d = 0."""
    normal = np.asarray(normal, np.float64)
    normal = normal / np.linalg.norm(normal)
    a = np.array([1.0, 0, 0]) if abs(normal[0]) < 0.9 else np.array([0, 1.0, 0])
    b1 = np.cross(normal, a)
    b1 /= np.linalg.norm(b1)
    b2 = np.cross(normal, b1)
    uv = rng.uniform(-extent, extent, size=(n, 2))
    pts = -d * normal + uv[:, :1] * b1 + uv[:, 1:] * b2
    pts += rng.normal(size=(n, 3)) * noise
    return pts.astype(np.float32)


def _scene(rng, n_per):
    return np.concatenate([_plane_points(rng, n_per, [0, 0, 1], 1.0),
                           _plane_points(rng, n_per, [1, 0, 0], -5.0),
                           _plane_points(rng, n_per, [0, 1, 0], -5.0)])


MAP_KW = dict(voxel_size=0.5, n_layers=2, capacity_log2=14,
              planner_threshold=0.0025, layer_init_num=(5, 5))


@pytest.fixture(scope="module")
def carried():
    """A JAX map of three planes, a perturbed prior state, scan points of
    the true pose, and the port's copies of map and state."""
    cfg = jvm.VoxelMapConfig(**MAP_KW)
    rng = np.random.default_rng(3)
    pts_w = _scene(rng, 3000)
    n = len(pts_w)
    jm = jvm.update_map(jvm.make_map(cfg), jnp.asarray(pts_w),
                        jnp.tile(jnp.eye(3) * 1e-4, (n, 1, 1)),
                        jnp.ones(n, bool), cfg)
    true_delta = np.zeros(19, np.float32)
    true_delta[0:3] = [0.02, -0.015, 0.03]
    true_delta[3:6] = [0.05, -0.04, 0.03]
    s_true = jstate.boxplus(jstate.init_state(), jnp.asarray(true_delta))
    sample_w = jnp.asarray(_scene(np.random.default_rng(4), 1200))
    pts_body = np.array((sample_w - s_true.pos) @ s_true.rot)
    valid = np.ones(len(pts_body), bool)
    valid[-100:] = False
    prior = jstate.boxplus(jstate.init_state(), jnp.asarray(
        np.random.default_rng(8).normal(size=19).astype(np.float32) * 1e-3))
    cov = np.asarray(jstate.init_cov()) * 0.5
    packed = np.asarray(jstate.pack_state(prior, jnp.asarray(cov)))
    t_packed, tm = convert.state_from_numpy(
        packed, *(np.asarray(a) for a in jm), device="cpu")
    return dict(jm=jm, tm=tm, prior=prior, cov=cov, t_packed=t_packed,
                pts_body=pts_body, valid=valid)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(plane_info_cap=40),
    dict(fresh_every_iter=True),
    dict(rematch_fresh=False, max_iterations=3),
], ids=["default", "info_cap", "fresh_every_iter", "no_rematch"])
def test_lio_update_matches_jax_on_carried_map(carried, opts):
    c = carried
    ext_R = np.array(jstate.so3.exp(jnp.asarray([0.01, -0.02, 0.015],
                                                  jnp.float32)))
    ext_T = np.array([0.04, -0.02, 0.01], np.float32)
    jres = jlio.lio_update(
        c["prior"], jnp.asarray(c["cov"]), c["jm"], jnp.asarray(c["pts_body"]),
        jnp.asarray(c["valid"]), jnp.asarray(ext_R), jnp.asarray(ext_T),
        jvm.VoxelMapConfig(**MAP_KW), **opts)
    t_state, t_cov = unpack_state(c["t_packed"])
    tres = tlio.lio_update(
        t_state, t_cov, c["tm"], torch.from_numpy(c["pts_body"]),
        torch.from_numpy(c["valid"]), torch.from_numpy(ext_R),
        torch.from_numpy(ext_T), tvm.VoxelMapConfig(**MAP_KW), **opts)
    assert int(tres.n_effective) == int(jres.n_effective)
    assert int(tres.n_effective) > 2000
    for name in NavState._fields:
        np.testing.assert_allclose(getattr(tres.state, name).numpy(),
                                   np.asarray(getattr(jres.state, name)),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(tres.cov.numpy(), np.asarray(jres.cov),
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_array_equal(tres.match.valid.numpy(),
                                  np.asarray(jres.match.valid))
    np.testing.assert_allclose(tres.pts_w.numpy(), np.asarray(jres.pts_w),
                               atol=1e-4)
    np.testing.assert_allclose(float(tres.mean_residual),
                               float(jres.mean_residual), rtol=1e-3)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(plane_info_cap=40),
    dict(fresh_every_iter=True),
    dict(rematch_fresh=False, max_iterations=3),
], ids=["default", "info_cap", "fresh_every_iter", "no_rematch"])
def test_lio_device_loop_equals_early_exit(carried, opts):
    """The device-loop form (every iteration run, each carried value
    masked, no host read; the fused and staged frames) gives the
    early-exit form's result bit for bit on the same inputs."""
    c = carried
    t_state, t_cov = unpack_state(c["t_packed"])
    args = (t_state, t_cov, c["tm"], torch.from_numpy(c["pts_body"]),
            torch.from_numpy(c["valid"]),
            torch.from_numpy(np.array(jstate.so3.exp(
                jnp.asarray([0.01, -0.02, 0.015], jnp.float32)))),
            torch.from_numpy(np.array([0.04, -0.02, 0.01], np.float32)),
            tvm.VoxelMapConfig(**MAP_KW))
    early = tlio.lio_update(*args, **opts)
    loop = tlio.lio_update(*args, **opts, device_loop=True)
    for name, a, b in zip(NavState._fields, early.state, loop.state):
        assert torch.equal(a, b), name
    for name in ("cov", "pts_w", "var_w", "n_effective", "mean_residual"):
        assert torch.equal(getattr(early, name), getattr(loop, name)), name
    for name, a, b in zip(early.match._fields, early.match, loop.match):
        assert torch.equal(a, b), name

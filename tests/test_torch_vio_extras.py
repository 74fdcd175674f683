"""The port's VIO extras (core/vio.py: the inverse-compositional update,
raycast recovery and its scan table, photometric factor capture; ops/
voxel_hash.lookup_or_insert) against the JAX package.

The function tests start from tests/test_torch_vio.py's capture: the JAX
LIVO run's own inputs of its VIO half at one mid-sequence frame, carried
across as numpy arrays (io/convert), and the JAX outputs of that frame's
stages (the ring-inserted pool and ring, the submap, the posterior
state), so each function runs on the same inputs in both packages.

Tolerances, each with its reason:
- hash slots and tables, `has`, valid and scale: exact (integer logic,
  the same scatter-max tickets);
- the ray table: rtol 1e-6 (the same float32 arithmetic, other order);
- raycast candidates: 1e-5 m (plane centres and normals read from the
  same map records);
- photometric_update_ic: state 1e-5 and covariance rtol 1e-3, the
  forward update's tolerances (tests/test_torch_vio.py); its device loop
  bit for bit its early-exit loop;
- photo factors: the retrieval tolerances of tests/test_torch_vio.py
  (positions rtol 1e-5; the warped targets 0.25 DN, scaled by the
  reference exposure).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.core import vio as jvio
from fast_livo2_tpu.ops import voxel_hash as jhash
from fast_livo2_tpu_torch.core import state as tstate
from fast_livo2_tpu_torch.core import vio as tvio
from fast_livo2_tpu_torch.io import convert
from fast_livo2_tpu_torch.ops import voxel_hash as thash
from tests.test_torch_vio import (_submap_to_torch, jax_frame,  # noqa: F401
                                  jax_run, one_torch_thread)


def _hash_case(case):
    rng = np.random.default_rng(4)
    if case == "collisions":
        # 400 lanes over ~150 distinct keys in 512 slots: duplicate keys in
        # one batch, shared buckets, padding lanes, and a table that
        # already holds some of the keys
        keys = rng.integers(-4, 2, size=(400, 3)).astype(np.int32)
        valid = rng.uniform(size=400) > 0.1
        capacity, pre = 512, keys[:60]
    else:
        # 200 distinct keys into 64 slots: probe windows run full and
        # lanes come back -1
        keys = np.stack([np.arange(200), 3 * np.arange(200),
                         -np.arange(200)], -1).astype(np.int32)
        valid = np.ones(200, bool)
        capacity, pre = 64, keys[:0]
    return keys, valid, capacity, pre


@pytest.mark.parametrize("case", ["collisions", "full_probe_window"])
def test_lookup_or_insert_matches_jax(case):
    keys, valid, capacity, pre = _hash_case(case)
    jt = jhash.make_table(capacity)
    jt, _ = jhash.lookup_or_insert(jt, jnp.asarray(pre),
                                   jnp.ones(len(pre), bool))
    jt, jslots = jhash.lookup_or_insert(jt, jnp.asarray(keys),
                                        jnp.asarray(valid))
    tt = thash.make_table(capacity, "cpu")
    tt, _ = thash.lookup_or_insert(tt, torch.from_numpy(pre),
                                   torch.ones(len(pre), dtype=torch.bool))
    t_in, t_copy = tt, tt.clone()
    tt, tslots = thash.lookup_or_insert(t_in, torch.from_numpy(keys),
                                        torch.from_numpy(valid))
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt.keys))
    assert torch.equal(t_in, t_copy)  # the input table is not written
    s = tslots.numpy()
    if case == "collisions":
        assert (s[valid] >= 0).all() and (s[~valid] == -1).all()
        # every lane of one key resolved to one slot
        for k in np.unique(keys[valid], axis=0)[:20]:
            lanes = valid & np.all(keys == k, axis=1)
            assert len(set(s[lanes])) == 1
    else:
        assert (s == -1).sum() > 0 and (s >= 0).sum() == capacity
    # the table found by lookup
    np.testing.assert_array_equal(
        thash.lookup(tt, torch.from_numpy(keys)).numpy()[s >= 0], s[s >= 0])


def test_make_ray_table_matches_jax(jax_frame):
    T, _, _, Jin = jax_frame
    j_samples, j_border = jvio.make_ray_table(Jin["cam"], Jin["cfg"])
    t_samples, t_border = tvio.make_ray_table(T["cam"], T["cfg"],
                                              device="cpu")
    np.testing.assert_allclose(t_samples.numpy(), np.asarray(j_samples),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t_border.numpy(), np.asarray(j_border))
    assert t_samples.shape[0] == tvio.n_cells(T["cfg"])


def test_raycast_recover_matches_jax(jax_frame):
    """From the JAX run's mid-sequence map and posterior state. The
    submap's empty cells and the frame's scan table as vio_step builds
    them, and, so that more rays reach a plane before the current scan,
    a second scan table from every fourth scan point."""
    T, _, J, Jin = jax_frame
    samples, border = jvio.make_ray_table(Jin["cam"], Jin["cfg"])
    jstate = jax.tree.map(jnp.asarray, J["post"][0])
    tstate_ = tstate.NavState(*(torch.from_numpy(np.array(a))
                                for a in J["post"][0]))
    vsize = Jin["map_cfg"].voxel_size
    empty = ~np.asarray(J["sub"].valid)
    pg_w, pg_ok = np.array(Jin["pg_w"]), np.array(Jin["pg_ok"])
    sparse = pg_ok & (np.arange(len(pg_ok)) % 4 == 0)
    n_has = 0
    for ok in (pg_ok, sparse):
        jtab, _ = jhash.lookup_or_insert(
            jhash.make_table(tvio.RAY_SCAN_SLOTS),
            jhash.voxel_key(jnp.asarray(pg_w), vsize), jnp.asarray(ok))
        jpos, jnrm, jhas = jax.tree.map(np.asarray, jax.jit(
            lambda vmap, st, tab: jvio.raycast_recover(
                vmap, Jin["map_cfg"], jnp.asarray(empty), border, samples,
                tab, st, Jin["Rci"], Jin["Pci"]))(Jin["vmap"], jstate, jtab))
        ttab, _ = thash.lookup_or_insert(
            thash.make_table(tvio.RAY_SCAN_SLOTS, "cpu"),
            thash.voxel_key(torch.from_numpy(pg_w), vsize),
            torch.from_numpy(ok))
        np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab.keys))
        tpos, tnrm, thas = tvio.raycast_recover(
            T["vmap"], T["map_cfg"], torch.from_numpy(empty),
            torch.from_numpy(np.array(border)),
            torch.from_numpy(np.array(samples)), ttab, tstate_, T["Rci"],
            T["Pci"])
        np.testing.assert_array_equal(thas.numpy(), jhas)
        np.testing.assert_allclose(tpos.numpy()[jhas], jpos[jhas], atol=1e-5)
        np.testing.assert_allclose(tnrm.numpy()[jhas], jnrm[jhas], atol=1e-5)
        n_has += int(jhas.sum())
    assert n_has > 0, "no ray reached a plane: the case tests nothing"


@pytest.fixture(scope="module")
def ic_case(jax_frame):
    """The JAX inverse-compositional update from the JAX frame's submap,
    ring and image, and the port's inputs for it."""
    T, _, J, Jin = jax_frame
    cam, cfg = Jin["cam"], Jin["cfg"]
    jsub = jvio.Submap(*(jnp.asarray(a) for a in J["sub"]))
    jring = jvio.FrameRing(*(jnp.asarray(a) for a in J["ring"]))
    out = jax.tree.map(np.asarray, jax.jit(
        lambda st, cv, img, Rci, Pci: jvio.photometric_update_ic(
            st, cv, jsub, img, jring, cam, Rci, Pci, cfg))(
        Jin["state"], Jin["cov"], Jin["img"], Jin["Rci"], Jin["Pci"]))
    args = (T["state"], T["cov"], _submap_to_torch(J["sub"]), T["img"],
            convert.ring_from_numpy(*J["ring"], device="cpu"), T["cam"],
            T["Rci"], T["Pci"], T["cfg"])
    return args, out


def test_photometric_update_ic_matches_jax(ic_case):
    args, (js, jc, je) = ic_case
    ts, tc, te, iters = tvio.photometric_update_ic(*args)
    assert 3 <= iters <= 3 * args[-1].max_iterations
    for name, a, b in zip(tstate.NavState._fields, ts, js):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-4)
    # the update moved the state (a case that tests something)
    assert not torch.equal(ts.pos, args[0].pos)


def test_photometric_ic_device_loop_equals_early_exit(ic_case):
    """The IC update's device loop (the fused and staged frames) gives its
    early-exit loop's state, covariance and error bit for bit and counts
    the same iterations."""
    args, _ = ic_case
    es, ec, ee, e_it = tvio.photometric_update_ic(*args)
    ls, lc, le, l_it = tvio.photometric_update_ic(*args, device_loop=True)
    for name, a, b in zip(tstate.NavState._fields, es, ls):
        assert torch.equal(a, b), name
    assert torch.equal(ec, lc) and torch.equal(ee, le)
    assert isinstance(l_it, torch.Tensor) and int(l_it) == e_it


def test_capture_photo_factors_matches_jax(jax_frame):
    """From the maintained pool and ring of the JAX frame, at its
    posterior state."""
    T, _, J, Jin = jax_frame
    pool, ring = J["maintained"][0], J["ring"]
    cam, cfg = Jin["cam"], Jin["cfg"]
    jpos, jtgt, jval, jscale = jax.tree.map(np.asarray, jax.jit(
        lambda pool, ring, img, st, pg_w, pg_ok, Rci, Pci:
        jvio.capture_photo_factors(pool, ring, img, st, pg_w, pg_ok, cam,
                                   Rci, Pci, cfg))(
        jvio.VisualPool(*(jnp.asarray(a) for a in pool)),
        jvio.FrameRing(*(jnp.asarray(a) for a in ring)), Jin["img"],
        jax.tree.map(jnp.asarray, J["post"][0]), Jin["pg_w"], Jin["pg_ok"],
        Jin["Rci"], Jin["Pci"]))
    tpos, ttgt, tval, tscale = tvio.capture_photo_factors(
        convert.pool_from_numpy(*pool, device="cpu"),
        convert.ring_from_numpy(*ring, device="cpu"), T["img"],
        tstate.NavState(*(torch.from_numpy(np.array(a)) for a in J["post"][0])),
        T["pg_w"], T["pg_ok"], T["cam"], T["Rci"], T["Pci"], T["cfg"])
    assert jval.sum() > 50
    np.testing.assert_array_equal(tval.numpy(), jval)
    np.testing.assert_array_equal(tscale.numpy(), jscale)
    np.testing.assert_allclose(tpos.numpy(), jpos, rtol=1e-5, atol=1e-6)
    # target = ref_expo * warp: the warp's 0.25 DN times the largest
    # exposure an observation of the pool carries
    expo = float(np.abs(pool[1][..., tvio._O_EXPO]).max())
    np.testing.assert_allclose(ttgt.numpy()[jval], jtgt[jval],
                               atol=0.25 * expo)

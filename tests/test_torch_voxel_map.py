"""Parity of the port's voxel plane map against the JAX package on the CPU.

Both packages insert the same seeded frames in turn, through the full,
the compacted (insert_compact / descend_compact) and the sticky-cut
insert paths. Tolerances:
- `keys` are held EQUAL slot for slot: the claim protocol is integer
  (priority tickets in a scatter-max) and `_bucket` is bit-identical, so
  any difference is a logic fault;
- `stats` (sums of up to a few hundred float32 moments): rtol 1e-5,
  atol 1e-5 — XLA and ATen may add a slot's contributions in a
  different order;
- `rec`, the derived plane cache: the port's rec equals its own
  derive_rec after every mutation at 1e-6 (the coherence test of
  tests/test_voxel_map.py). Against the JAX rec, the plane state and
  count columns are equal, and on voxels with enough points for a fit
  every column agrees to 2e-4 after scaling by its largest magnitude
  (the 3x3 eigensolver amplifies ulp-level differences; voxels of 1-3
  points have arbitrary null-space eigenvectors and are not compared).

Then a JAX-built map is carried over with io/convert.py and the port's
`match_planes` and `slide_map` are held against JAX's on it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.core import voxel_map as jvm
from fast_livo2_tpu_torch.core import voxel_map as tvm
from fast_livo2_tpu_torch.core.state import PACKED_LEN
from fast_livo2_tpu_torch.io import convert

RTOL_STATS, ATOL_STATS = 1e-5, 1e-5
ATOL_REC_SCALED = 2e-4


def _frames(seed, n=600, n_frames=3):
    """Seeded frames over a floor, a wall and a noisy blob: planes at the
    coarse layer, a blob that fails the fit and descends, and new keys
    every frame (the scene shifts)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    base[: n // 2, 2] = -1.3 + 0.01 * rng.standard_normal(n // 2)  # floor
    base[n // 2: 3 * n // 4, 0] = 2.3 + 0.01 * rng.standard_normal(n // 4)  # wall
    base[3 * n // 4:] = rng.uniform(-1, 1, (n - 3 * n // 4, 3))  # blob
    out = []
    for f in range(n_frames):
        shift = np.array([0.3 * f, -0.2 * f, 0.0], np.float32)
        pts = base + shift + rng.normal(size=base.shape).astype(np.float32) * 0.005
        a = rng.normal(size=(n, 3, 3)) * 1e-2
        var = (np.einsum("nij,nkj->nik", a, a) + np.eye(3) * 1e-4).astype(np.float32)
        valid = np.ones(n, bool)
        valid[-37:] = False  # padding lanes, as the pipeline pads
        out.append((pts.astype(np.float32), var, valid))
    return out


def _cfgs(name):
    base = dict(voxel_size=1.0, n_layers=3, capacity_log2=11,
                layer_init_num=(4, 4, 4), planner_threshold=0.0025,
                max_points_num=60)
    extra = {"full": {},
             "compact": dict(insert_compact=128, descend_compact=256),
             "sticky": dict(sticky_cut=True, pre_descend_margin=0.5)}[name]
    return jvm.VoxelMapConfig(**base, **extra), tvm.VoxelMapConfig(**base, **extra)


def _assert_maps_match(tm, jm, tcfg):
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
    np.testing.assert_allclose(tm.stats.numpy(), np.asarray(jm.stats),
                               rtol=RTOL_STATS, atol=ATOL_STATS)
    t_rec, j_rec = tm.rec.numpy(), np.asarray(jm.rec)
    np.testing.assert_allclose(t_rec, tvm.derive_rec(tm, tcfg).numpy(),
                               rtol=1e-6, atol=1e-6)
    for col in (tvm._ISPL, tvm._CNT):
        np.testing.assert_array_equal(t_rec[..., col], j_rec[..., col])
    # Plane fields where a fit is defined: a voxel of fewer points has a
    # rank-deficient scatter whose null-space eigenvectors are arbitrary.
    fit = t_rec[..., tvm._CNT] > min(tcfg.layer_init_num)
    scale = np.maximum(np.abs(j_rec[fit]).max(axis=0), 1.0)
    np.testing.assert_allclose(t_rec[fit] / scale, j_rec[fit] / scale,
                               atol=ATOL_REC_SCALED)


@pytest.mark.parametrize("name", ["full", "compact", "sticky"])
def test_update_map_sequence_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    jm, tm = jvm.make_map(jcfg), tvm.make_map(tcfg, device="cpu")
    for i, (pts, var, valid) in enumerate(_frames(seed=21)):
        compact = name == "compact" and i > 0  # the steady-state insert
        jm = jvm.update_map(jm, jnp.asarray(pts), jnp.asarray(var),
                            jnp.asarray(valid), jcfg, compact=compact)
        tm = tvm.update_map(tm, torch.from_numpy(pts), torch.from_numpy(var),
                            torch.from_numpy(valid), tcfg, compact=compact)
        _assert_maps_match(tm, jm, tcfg)
    for layer in range(tcfg.n_layers):
        np.testing.assert_array_equal(tvm.map_count(tm, layer).numpy(),
                                      np.asarray(jvm.map_count(jm, layer)))
    assert (tm.keys.numpy()[1:, :, 0] != tvm.EMPTY).any()  # descent happened
    if name == "sticky":
        assert (tm.rec.numpy()[..., tvm._ISPL] == -1.0).any()  # a voxel cut


def test_insert_overflow_and_sym6_helpers():
    """Compacted claims with more new keys than lanes: both packages keep
    the same subset; sym6 / sym6_to_mat / quad6 agree."""
    cfg_kw = dict(voxel_size=0.5, n_layers=1, capacity_log2=10,
                  layer_init_num=(3,), insert_compact=16)
    jcfg, tcfg = jvm.VoxelMapConfig(**cfg_kw), tvm.VoxelMapConfig(**cfg_kw)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-20, 20, (400, 3)).astype(np.float32)
    var = np.tile(np.eye(3, dtype=np.float32) * 1e-4, (400, 1, 1))
    valid = np.ones(400, bool)
    jm = jvm.update_map(jvm.make_map(jcfg), jnp.asarray(pts), jnp.asarray(var),
                        jnp.asarray(valid), jcfg, compact=True)
    tm = tvm.update_map(tvm.make_map(tcfg, device="cpu"), torch.from_numpy(pts),
                        torch.from_numpy(var), torch.from_numpy(valid), tcfg,
                        compact=True)
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
    assert 0 < (tm.keys.numpy()[0, :, 0] != tvm.EMPTY).sum() <= 16

    s6 = tvm.sym6(torch.from_numpy(var[:5]))
    np.testing.assert_array_equal(s6.numpy(), np.asarray(jvm.sym6(jnp.asarray(var[:5]))))
    np.testing.assert_array_equal(tvm.sym6_to_mat(s6).numpy(), var[:5])
    v = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tvm.quad6(s6, torch.from_numpy(v)).numpy(),
        np.asarray(jvm.quad6(jnp.asarray(s6.numpy()), jnp.asarray(v))),
        rtol=1e-6)


@pytest.fixture(scope="module")
def carried():
    """A JAX-built map (two layers, several frames) and its port copy."""
    jcfg, tcfg = _cfgs("full")
    jm = jvm.make_map(jcfg)
    for pts, var, valid in _frames(seed=33, n=800, n_frames=3):
        jm = jvm.update_map(jm, jnp.asarray(pts), jnp.asarray(var),
                            jnp.asarray(valid), jcfg)
    packed = np.random.default_rng(0).normal(size=PACKED_LEN).astype(np.float32)
    _, tm = convert.state_from_numpy(packed, *(np.asarray(a) for a in jm), "cpu")
    back = convert.state_to_numpy(torch.from_numpy(packed), tm)
    for a, b in zip(back[1:], jm):
        np.testing.assert_array_equal(a, np.asarray(b))
    return jcfg, tcfg, jm, tm


@pytest.mark.parametrize("variant", ["chain", "finest", "sibling"])
def test_match_planes_on_carried_map(carried, variant):
    jcfg, tcfg, jm, tm = carried
    kw = {"chain": {}, "finest": dict(match_finest=True),
          "sibling": dict(sibling_search=True)}[variant]
    jcfg, tcfg = jcfg._replace(**kw), tcfg._replace(**kw)
    rng = np.random.default_rng(44)
    pts, var, valid = _frames(seed=33, n=800, n_frames=1)[0]
    q = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.02
    jmt = jvm.match_planes(jm, jnp.asarray(q), jnp.asarray(var),
                           jnp.asarray(valid), jcfg)
    tmt = tvm.match_planes(tm, torch.from_numpy(q), torch.from_numpy(var),
                           torch.from_numpy(valid), tcfg)
    np.testing.assert_array_equal(tmt.valid.numpy(), np.asarray(jmt.valid))
    np.testing.assert_array_equal(tmt.layer.numpy(), np.asarray(jmt.layer))
    assert tmt.valid.numpy().mean() > 0.3
    for name in ("normal", "d", "center", "dist"):
        np.testing.assert_allclose(getattr(tmt, name).numpy(),
                                   np.asarray(getattr(jmt, name)),
                                   atol=2e-5, err_msg=name)
    for name in ("sigma_plane", "cov_nn", "cov_qq"):
        np.testing.assert_allclose(getattr(tmt, name).numpy(),
                                   np.asarray(getattr(jmt, name)),
                                   rtol=1e-4, atol=1e-9, err_msg=name)


def test_slide_map_on_carried_map(carried):
    jcfg, tcfg, jm, tm = carried
    center = np.array([1.3, -0.4, 0.2], np.float32)
    js = jvm.slide_map(jm, jnp.asarray(center), 3, jcfg)
    ts = tvm.slide_map(tm, torch.from_numpy(center), 3, tcfg)
    np.testing.assert_array_equal(ts.keys.numpy(), np.asarray(js.keys))
    np.testing.assert_array_equal(ts.stats.numpy(), np.asarray(js.stats))
    np.testing.assert_allclose(ts.rec.numpy(), tvm.derive_rec(ts, tcfg).numpy(),
                               rtol=1e-6, atol=1e-6)
    kept = (ts.keys.numpy()[..., 0] != tvm.EMPTY).sum()
    assert 0 < kept < (tm.keys.numpy()[..., 0] != tvm.EMPTY).sum()

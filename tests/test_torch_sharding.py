"""The port's sharding over torch.distributed against the JAX package, on
the CPU, along the measurement axis: 2 and then 4 gloo ranks
(tests/test_torch_dist_worker.py, one torch thread each, every rank with
a timeout) run every case in one launch a world size, and each case is
compared here with the JAX package's single-device result and the port's
single-process one. The backend's sharded cases are
tests/test_torch_sharding_ba.py.

The cases mirror tests/test_sharding.py (the LIO update with the points
sharded, also in the device loop and with the plane-information cap; a
map write from sharded points, then ten in a row) and
tests/test_distributed.py (LIO and a window refine across processes),
plus owner_of, local_cfg and the sharding helpers' collectives. Tolerances are the JAX
tests': LIO boxminus < 1e-4, covariance atol 1e-5 / rtol 1e-3,
n_effective equal. On the CPU the sharded map writes are bit for bit the
single process's, and every rank returns the same bits.
"""

import contextlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_livo2_tpu.core import lio as jlio
from fast_livo2_tpu.core import voxel_map as jvm
from fast_livo2_tpu.core.state import boxminus as jboxminus
from fast_livo2_tpu.core.state import init_cov as jinit_cov
from fast_livo2_tpu.core.state import init_state as jinit_state
from fast_livo2_tpu.core.state import unpack_state as junpack_state
from fast_livo2_tpu.parallel import map_shard as jmap_shard
from fast_livo2_tpu_torch.core import voxel_map as tvm
from fast_livo2_tpu_torch.parallel import map_shard
from fast_livo2_tpu_torch.parallel import sharding as shd
from tests import test_torch_dist_worker as W

ROOT = Path(__file__).resolve().parent.parent


def _plane_pts(rng, n, normal, d, extent=4.0):
    """tests/test_sharding.py's plane sampler."""
    normal = np.asarray(normal, np.float64)
    a = np.array([1.0, 0, 0]) if abs(normal[0]) < 0.9 else np.array([0, 1.0, 0])
    b1 = np.cross(normal, a)
    b1 /= np.linalg.norm(b1)
    b2 = np.cross(normal, b1)
    uv = rng.uniform(-extent, extent, size=(n, 2))
    return (-d * normal + uv[:, :1] * b1 + uv[:, 1:] * b2
            + rng.normal(size=(n, 3)) * 0.004).astype(np.float32)


def _lio_inputs():
    """tests/test_sharding.py::_setup: a 3-plane scene in a JAX-built map
    and 1024 body points of two planes."""
    rng = np.random.default_rng(0)
    scene = np.concatenate([_plane_pts(rng, 4000, [0, 0, 1], 1.0),
                            _plane_pts(rng, 4000, [1, 0, 0], -5.0),
                            _plane_pts(rng, 4000, [0, 1, 0], -5.0)])
    cfg = jvm.VoxelMapConfig(**W.MAP_LIO)
    n = len(scene)
    m = jvm.update_map(jvm.make_map(cfg), jnp.asarray(scene),
                       jnp.tile(jnp.eye(3) * 1e-4, (n, 1, 1)),
                       jnp.ones(n, bool), cfg)
    body = np.concatenate([_plane_pts(rng, 512, [0, 0, 1], 1.0),
                           _plane_pts(rng, 512, [1, 0, 0], -5.0)])
    return cfg, m, body


def _jax_refs(data, m):
    """The JAX package's single-device results of the LIO and map cases."""
    refs = {}
    cfg = jvm.VoxelMapConfig(**W.MAP_LIO)
    body = jnp.asarray(data["lio/body"])
    valid = jnp.ones(body.shape[0], bool)
    for name, kw in (("split", {}), ("cap", dict(plane_info_cap=40))):
        refs[f"lio/{name}"] = jax.jit(lambda mm, b, v, kw=kw: jlio.lio_update(
            jinit_state(), jinit_cov(), mm, b, v, jnp.eye(3), jnp.zeros(3), cfg,
            max_iterations=3, **kw))(m, body, valid)
    n = len(data["map/pts"])
    refs["map/one"] = jvm.update_map(
        m, jnp.asarray(data["map/pts"]), jnp.tile(jnp.eye(3) * 1e-4, (n, 1, 1)),
        jnp.ones(n, bool), cfg)
    return refs


def _dist_inputs(data):
    """tests/dist_worker.py's inputs: __graft_entry__._build_lio_example
    (1024 points, a 2^12 map) and its 8 x 512 window; and the JAX
    single-device LIO result."""
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as ge

    step, (state, cov, m, body, valid), _ = ge._build_lio_example(
        n_pts=1024, cap_log2=12)
    res = jax.jit(step)(state, cov, m, body, valid)
    for k, v in zip(("keys", "stats", "rec"), m):
        data[f"dist/{k}"] = np.asarray(v)
    data["dist/body"] = np.asarray(body)
    K, N = 8, 512
    rng = np.random.default_rng(0)
    data["dist/w0"] = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    data["dist/w1"] = rng.normal(size=(K, 3)).astype(np.float32) * 0.05
    data["dist/w2"] = (np.asarray(body)[None, :N, :].repeat(K, 0)
                       + rng.normal(size=(K, N, 3)).astype(np.float32) * 0.002)
    data["dist/w3"] = np.ones((K, N), bool)
    return np.asarray(res.state.pos), np.asarray(res.cov)


CASES = ("lio", "map_update", "dist", "collectives")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs (written to inputs.npz for the workers), the JAX
    package's results and the port's single-process results."""
    root = tmp_path_factory.mktemp("shard")
    with one_thread():
        cfg, m, body = _lio_inputs()
        data = {"lio/body": body}
        for k, v in zip(("keys", "stats", "rec"), m):
            data[f"lio/{k}"] = np.asarray(v)
        rng = np.random.default_rng(3)
        data["map/pts"] = rng.uniform(-4, 4, (1024, 3)).astype(np.float32)
        frames = np.stack([np.concatenate([
            _plane_pts(rng, 512, [0, 0, 1], 1.0),
            _plane_pts(rng, 512, [1, 0, 0], -5.0)]) for _ in range(W.MAP_FRAMES)])
        data["map/frames"] = frames
        data["map/frames_valid"] = rng.uniform(size=frames.shape[:2]) > 0.1
        var6 = np.zeros(frames.shape[:2] + (6,), np.float32)
        var6[..., [0, 3, 5]] = rng.uniform(1e-5, 1e-3, frames.shape[:2] + (3,))
        data["map/frames_var6"] = var6
        jax_refs = _jax_refs(data, m)
        jax_refs["dist"] = _dist_inputs(data)
        np.savez(root / "inputs.npz", **data)
        port = {name: W.CASES[name](data, None, "cpu") for name in CASES}
    return root, data, jax_refs, port


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, case):
    root, _, _, _ = case
    return W.launch(root, request.param, root / "inputs.npz", cases=CASES)


def _same_on_every_rank(ranks, prefix):
    for k in ranks[0]:
        if k.startswith(prefix):
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_sharded_lio_matches_jax_and_single(case, ranks):
    _, _, jax_refs, port = case
    _same_on_every_rank(ranks, "lio/")
    got = {k[4:]: v for k, v in ranks[0].items() if k.startswith("lio/")}
    for name in ("split", "cap"):
        ref = jax_refs[f"lio/{name}"]
        state, _ = junpack_state(jnp.asarray(got[f"{name}_packed"]))
        delta = np.asarray(jboxminus(state, ref.state))
        assert np.abs(delta).max() < 1e-4, (name, delta)
        np.testing.assert_allclose(got[f"{name}_cov"], np.asarray(ref.cov),
                                   atol=1e-5, rtol=1e-3)
        assert int(got[f"{name}_n_eff"]) == int(ref.n_effective)
        np.testing.assert_allclose(got[f"{name}_pts_w"], np.asarray(ref.pts_w),
                                   atol=1e-4)
    for name in ("split", "loop", "cap"):  # against the single process
        np.testing.assert_allclose(got[f"{name}_packed"],
                                   port["lio"][f"{name}_packed"], atol=1e-5)
        np.testing.assert_allclose(got[f"{name}_cov"],
                                   port["lio"][f"{name}_cov"],
                                   atol=1e-6, rtol=1e-4)
        assert got[f"{name}_n_eff"] == port["lio"][f"{name}_n_eff"]
        np.testing.assert_allclose(got[f"{name}_mean_res"],
                                   port["lio"][f"{name}_mean_res"], rtol=1e-5)
    # the device loop is the split loop's result on every rank
    for f in ("packed", "cov", "n_eff", "pts_w", "dist"):
        np.testing.assert_array_equal(got[f"loop_{f}"], got[f"split_{f}"])


def test_sharded_map_update_consistent(case, ranks):
    """The gathered write is the single process's, bit for bit (the same
    points in the same order), on every rank; against the JAX package the
    voxels resolve alike with equal counts (tests/test_sharding.py)."""
    _, data, jax_refs, port = case
    _same_on_every_rank(ranks, "map_update/")
    for k, want in port["map_update"].items():
        np.testing.assert_array_equal(ranks[0][f"map_update/{k}"], want,
                                      err_msg=k)
    out = tvm.VoxelMap(*(torch.from_numpy(ranks[0][f"map_update/one_{k}"])
                         for k in ("keys", "stats", "rec")))
    ref = jax_refs["map/one"]
    pts = data["map/pts"]
    keys = jvm.voxel_hash.voxel_key(jnp.asarray(pts), W.MAP_LIO["voxel_size"])
    s_ref = np.asarray(jvm.voxel_hash.lookup(
        jvm.voxel_hash.HashTable(keys=jvm.map_keys(ref, 0)), keys))
    s_out = np.asarray(jvm.voxel_hash.lookup(
        jvm.voxel_hash.HashTable(keys=jnp.asarray(tvm.map_keys(out, 0).numpy())),
        keys))
    assert (s_ref >= 0).mean() > 0.99
    found = (s_ref >= 0) & (s_out >= 0)
    assert found.mean() > 0.99
    np.testing.assert_array_equal(
        np.asarray(jvm.map_count(ref, 0))[s_ref[found]],
        tvm.map_count(out, 0).numpy()[s_out[found]])


def test_two_process_spmd_lio_and_ba(case, ranks):
    """tests/test_distributed.py's checks: the sharded LIO step within
    1e-4 (position) and 1e-3 (covariance) of the JAX single-device step;
    the keyframe-sharded refine finite and near the origin, and the
    single process's within 5e-4."""
    _, _, jax_refs, port = case
    _same_on_every_rank(ranks, "dist/")
    pos_ref, cov_ref = jax_refs["dist"]
    np.testing.assert_allclose(ranks[0]["dist/pos"], pos_ref, atol=1e-4)
    np.testing.assert_allclose(ranks[0]["dist/cov"], cov_ref, atol=1e-3)
    ba_pos = ranks[0]["dist/ba_pos"]
    assert np.isfinite(ba_pos).all() and np.abs(ba_pos).max() < 1.0
    np.testing.assert_allclose(ba_pos, port["dist"]["ba_pos"], atol=5e-4)


def test_collectives_replicate_gather_and_agree(ranks):
    """put_replicated hands every rank rank 0's (named) tree, agree rank
    0's decision; all_gather_rows concatenates float, int and bool rows
    in rank order, exactly; all_reduce counts booleans."""
    D = len(ranks)
    _same_on_every_rank(ranks, "collectives/")
    got = {k[12:]: v for k, v in ranks[0].items() if k.startswith("collectives/")}
    np.testing.assert_array_equal(got["replicated"], np.ones((4, 2)))
    assert got["replicated_type"] == "Window"
    np.testing.assert_array_equal(got["agree"], [True, False])
    want = np.concatenate([np.arange(3) + 10 * r for r in range(D)])
    np.testing.assert_array_equal(got["gather_f"][:, 0], want / 4)
    assert got["gather_i"].dtype == np.int32 and got["gather_b"].dtype == bool
    np.testing.assert_array_equal(got["gather_i"], want)
    np.testing.assert_array_equal(got["gather_b"], want % 2 == 0)
    assert int(got["count"]) == (D + 1) // 2


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_owner_of_matches_jax(n_devices):
    """owner_of's int32 arithmetic (wrapping products, arithmetic >>,
    abs(INT_MIN), floor-mod) is the JAX package's, bit for bit, over 10^5
    points up to +-10^6 m."""
    rng = np.random.default_rng(n_devices)
    pts = np.concatenate([
        rng.uniform(-20, 20, (40000, 3)),
        rng.uniform(-1e6, 1e6, (40000, 3)),
        rng.choice([-1e6, 1e6, -0.25, 0.0, 0.25], (20000, 3))]).astype(np.float32)
    cfg = W.MAP_SHARD
    want = np.asarray(jmap_shard.owner_of(jnp.asarray(pts),
                                          jvm.VoxelMapConfig(**cfg), n_devices))
    got = map_shard.owner_of(torch.from_numpy(pts), tvm.VoxelMapConfig(**cfg),
                             n_devices)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < n_devices


def test_owner_routing_balanced_and_chain_colocated():
    """tests/test_map_shard.py::test_owner_routing_balanced_and_chain_colocated
    on the port."""
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-20, 20, (20000, 3)).astype(np.float32))
    own = map_shard.owner_of(pts, tvm.VoxelMapConfig(**W.MAP_SHARD), 8).numpy()
    counts = np.bincount(own, minlength=8)
    assert counts.min() > 0.7 * counts.mean(), counts
    key0 = np.floor(pts.numpy() / W.MAP_SHARD["voxel_size"]).astype(np.int64)
    flat = key0 @ np.array([1, 1 << 20, 1 << 40])
    for k in np.unique(flat)[:50]:
        assert len(np.unique(own[flat == k])) == 1


def test_local_cfg_refuses_like_jax():
    """local_cfg: capacity C/D for a power-of-two mesh; a mesh that is not
    one, or capacity below a slot a rank, refused as in the JAX package
    (its asserts)."""
    cfg, jcfg = tvm.VoxelMapConfig(**W.MAP_SHARD), jvm.VoxelMapConfig(**W.MAP_SHARD)
    for d in (1, 2, 4, 8):
        assert (map_shard.local_cfg(cfg, d).capacity_log2
                == jmap_shard.local_cfg(jcfg, d).capacity_log2 == 16 - d.bit_length() + 1)
    for d, c in ((3, 16), (6, 16), (4, 2), (2, 1)):
        with pytest.raises(AssertionError):
            jmap_shard.local_cfg(jcfg._replace(capacity_log2=c), d)
        with pytest.raises(ValueError):
            map_shard.local_cfg(cfg._replace(capacity_log2=c), d)


def test_shard_rows_and_make_mesh_refuse():
    """A leading axis that does not divide over the mesh is refused (the
    JAX sharding's constraint); make_mesh needs a process group."""
    for rank, want in ((0, slice(0, 3)), (2, slice(6, 9))):
        mesh = shd.Mesh(None, rank, 4, "dp", torch.device("cpu"))
        assert shd.shard_rows(12, mesh) == want
        assert torch.equal(shd.shard_points(torch.arange(12), mesh),
                           torch.arange(12)[want])
        with pytest.raises(ValueError, match="does not divide over 4 ranks"):
            shd.shard_points(torch.zeros(10, 3), mesh)
    with pytest.raises(RuntimeError, match="initialised process group"):
        shd.make_mesh(device="cpu")

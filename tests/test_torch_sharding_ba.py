"""The port's backend sharded over torch.distributed against the JAX
package, on the CPU: 2 and then 4 gloo ranks (tests/test_torch_dist_worker.py)
run tests/test_ba.py's three keyframe-sharded cases (plus links + photo)
on an 8-keyframe window, its OnlineRefiner contract with a mesh,
tests/test_map_shard.py's map-sharded refine and its per-rank blocks, and
a pipeline with the online backend and refine_trajectory sharded.

Tolerances: keyframe sharding 5e-4 (photometric 2e-5) against the single
process, as tests/test_ba.py holds the sharded JAX run against the single
one, and 1e-4 against the JAX package (tests/test_torch_ba.py); the
map-sharded refine within 1e-2 of the replicated one with
tests/test_map_shard.py's gates; the pipeline's trajectory and refined
keyframes within 1e-4 m of the single process's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_livo2_tpu.core import voxel_map as jvm
from fast_livo2_tpu.models import camera as jcam
from fast_livo2_tpu.ops import so3 as jso3
from fast_livo2_tpu.parallel import ba as jba
from fast_livo2_tpu.utils.config import CameraConfig as JaxCameraConfig
from fast_livo2_tpu_torch.core import voxel_map as tvm
from fast_livo2_tpu_torch.io import dataset, synthetic
from tests import test_torch_dist_worker as W
from tests.test_ba import _make_window
from tests.test_torch_ba import _links, _photo, _window
from tests.test_torch_sharding import _same_on_every_rank, one_thread

CASES = ("ba", "online", "map_shard", "pipeline")


def _map_shard_window():
    """tests/test_map_shard.py's window: 6 keyframes x 1200 points, the
    first corrupted; and the true positions."""
    window, _, gt_pos = _make_window(K=6, N=1200, pose_noise=0.0)
    rot, pos = np.array(window.rot), np.array(window.pos)
    rot[0] = np.asarray(jso3.exp(jnp.asarray([0.02, -0.01, 0.015]))) @ rot[0]
    pos[0] = pos[0] + np.array([0.03, -0.02, 0.04])
    return (rot, pos, np.asarray(window.scans), np.asarray(window.valid)), gt_pos


def _jax_refs(data):
    """The JAX package's single-device refinements: the four window
    variants, and the replicated refine of the map-sharded case."""
    refs = {}
    bcfg = jvm.VoxelMapConfig(**W.MAP_BA)
    jw = jba.Window(*(jnp.asarray(data[f"ba/w{i}"]) for i in range(4)))
    jl = jba.ImuLinks(*(jnp.asarray(data[f"ba/l{i}"], jnp.float32)
                        for i in range(5)), valid=jnp.asarray(data["ba/l5"]))
    jp = jba.PhotoFactors(*(jnp.asarray(data[f"ba/p{i}"], jnp.float32)
                            for i in range(4)),
                          valid=jnp.asarray(data["ba/p4"]),
                          scale=jnp.asarray(data["ba/p5"]))
    cam = jcam.make_camera(JaxCameraConfig(**W.CAM))
    for name in W.BA_VARIANTS:
        fn = jax.jit(lambda w, l, p, name=name: jba.refine_window(
            w, bcfg, outer_iters=1, gn_iters=2, link_sweeps=2,
            imu_links=l if "links" in name else None,
            photo=p if "photo" in name else None, cam=cam,
            Rci=jnp.asarray(data["ba/Rci"]), Pci=jnp.zeros(3)))
        refined, _ = fn(jw, jl, jp)
        refs[name] = (np.asarray(refined.rot), np.asarray(refined.pos))
    mw = jba.Window(*(jnp.asarray(data[f"ms/w{i}"]) for i in range(4)))
    refined, _ = jax.jit(lambda w: jba.refine_window(
        w, jvm.VoxelMapConfig(**W.MAP_SHARD), outer_iters=2, gn_iters=3))(mw)
    refs["ms_pos"] = np.asarray(refined.pos)
    return refs


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs (written to inputs.npz for the workers), the JAX
    package's results, the port's single-process results and the map-
    sharded case's true positions."""
    root = tmp_path_factory.mktemp("shard_ba")
    with one_thread():
        w, gt_rot, gt_pos = _window(K=8)
        data = {f"ba/w{i}": a for i, a in enumerate(w)}
        data.update({f"ba/l{i}": np.asarray(a)
                     for i, a in enumerate(_links(gt_rot, gt_pos))})
        photo, data["ba/Rci"] = _photo(gt_rot, gt_pos)
        data.update({f"ba/p{i}": np.asarray(a) for i, a in enumerate(photo)})
        ms_w, ms_gt = _map_shard_window()
        data.update({f"ms/w{i}": a for i, a in enumerate(ms_w)})
        seq = synthetic.make_sequence(
            duration=2.0, lidar_hz=10.0, imu_hz=200.0, seed=5, n_lines=12,
            n_per_line=400, render=False, fov_deg=360.0)
        dataset.save_sequence(str(root / "seq"), seq)
        data["pipe/seq"] = np.array(str(root / "seq"))
        jax_refs = _jax_refs(data)
        np.savez(root / "inputs.npz", **data)
        port = {name: W.CASES[name](data, None, "cpu") for name in CASES}
    return root, data, jax_refs, port, ms_gt


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, case):
    root = case[0]
    return W.launch(root, request.param, root / "inputs.npz", cases=CASES)


@pytest.mark.parametrize("variant", W.BA_VARIANTS)
def test_window_refinement_sharded_matches(case, ranks, variant):
    """tests/test_ba.py's sharded cases: against the single process at
    5e-4 (photometric 2e-5) and the JAX package at 1e-4."""
    _, _, jax_refs, port, _ = case
    _same_on_every_rank(ranks, f"ba/{variant}_")
    rot, pos = (ranks[0][f"ba/{variant}_{f}"] for f in ("rot", "pos"))
    tol = 2e-5 if variant == "photo" else 5e-4
    np.testing.assert_allclose(pos, port["ba"][f"{variant}_pos"], atol=tol)
    np.testing.assert_allclose(rot, port["ba"][f"{variant}_rot"], atol=tol)
    np.testing.assert_array_equal(ranks[0][f"ba/{variant}_n_used"],
                                  port["ba"][f"{variant}_n_used"])
    j_rot, j_pos = jax_refs[variant]
    np.testing.assert_allclose(pos, j_pos, atol=1e-4)
    np.testing.assert_allclose(rot, j_rot, atol=1e-4)


def test_online_refiner_with_mesh(case, ranks):
    """The OnlineRefiner contract with a mesh, on every rank; its refined
    windows are the single process's (outer 1 x gn 1)."""
    port = case[3]
    _same_on_every_rank(ranks, "online/")
    assert ranks[0]["online/contract"].all(), ranks[0]["online/contract"]
    for f in ("rot", "pos", "links_rot", "links_pos"):
        np.testing.assert_allclose(ranks[0][f"online/{f}"],
                                   port["online"][f], atol=5e-4)


def test_map_sharded_refine_matches_replicated(case, ranks):
    """tests/test_map_shard.py: the corrupted keyframe is pulled back,
    the clean ones stay, and the map-sharded poses are the replicated
    refine's within 1e-2 (the port's and the JAX package's); every rank
    holds (L, C/D, ...) blocks of a 2^18-slot map on its device."""
    _, data, jax_refs, port, gt_pos = case
    _same_on_every_rank(ranks, "map_shard/")
    pos = ranks[0]["map_shard/pos"]
    err_before = np.linalg.norm(data["ms/w1"][0] - gt_pos[0])
    err_after = np.linalg.norm(pos[0] - gt_pos[0])
    assert err_after < 0.4 * err_before, (err_before, err_after)
    assert np.linalg.norm(pos[1:] - gt_pos[1:], axis=-1).max() < 0.015
    np.testing.assert_allclose(pos, port["map_shard"]["pos"], atol=1e-2)
    np.testing.assert_allclose(pos, jax_refs["ms_pos"], atol=1e-2)
    assert int(ranks[0]["map_shard/n_used"].min()) > 300
    rows = (1 << 18) // len(ranks)
    for r in ranks:
        np.testing.assert_array_equal(
            r["map_shard/block_shapes"],
            [[2, rows, 3], [2, rows, tvm.STATS_W], [2, rows, tvm.REC_W]])
        assert r["map_shard/block_device"].all()


def test_pipeline_online_refine_and_refine_trajectory_with_mesh(case, ranks):
    """Every rank runs the same frames; the sharded online backend submits
    at the same keyframes on every rank (rank 0's gate decision) and
    refines the windows the single process refines; refine_trajectory
    (mesh=) likewise."""
    port = case[3]
    _same_on_every_rank(ranks, "pipeline/")
    got = {k[9:]: v for k, v in ranks[0].items() if k.startswith("pipeline/")}
    want = port["pipeline"]
    np.testing.assert_array_equal(got["submits"], want["submits"])
    assert got["submits"][0] > 0
    np.testing.assert_array_equal(got["refined_t"], want["refined_t"])
    for k in ("traj_pos", "traj_rot", "refined_pos", "post_pos", "post_rot"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)

"""The port's standalone VIO maintenance functions, its put_sharded and
its profiler hooks, against the JAX package where it has them.

The VIO functions start from the JAX LIVO run's own mid-sequence state
(tests/test_torch_vio.py's module fixtures, imported: one JAX run for
this file): the ring-inserted pool, the submap, the posterior state and
the scan of CAPTURE_FRAME, carried across as numpy arrays. Each is held
against its JAX counterpart (core/vio.py: generate_points,
update_obs, update_reference, maintain_points) with test_torch_vio.py's
tolerances for maintained rows: the integer columns exact, the float
columns rtol 1e-5 (points atol 1e-5; observation rows and DN-scale
patches atol 1e-3). `generate_and_maintain` is pinned bit for bit to
maintain_points followed by generate_points (the fused scatter writes
the generated rows last, as the sequence does).

put_sharded runs on a one-rank gloo mesh in this process; device_trace
on the CPU must write a Chrome trace naming the pipeline's six stages
(utils/timing.STAGES), which run inside `annotate` ranges.
"""

import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fast_livo2_tpu.core import vio as jvio
from fast_livo2_tpu_torch.core import state as tstate
from fast_livo2_tpu_torch.core import vio as tvio
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import convert
from fast_livo2_tpu_torch.parallel import sharding as shd
from fast_livo2_tpu_torch.utils import timing
from fast_livo2_tpu_torch.utils.config import LIVOConfig
from tests.test_torch_vio import (_INT_OBS_COLS, _INT_POINT_COLS,  # noqa: F401
                                  _submap_to_torch, jax_frame, jax_run,
                                  livo_config, one_torch_thread)


def _jax_pool(J):
    return jvio.VisualPool(*(jnp.asarray(a) for a in J["pool"]))


# The posterior as the frame left it (the camera barely moved since the
# last observations: no point takes a new one), and moved 0.3 m along x,
# past select_obs_gap_p, so that observations are appended and evicted.
SHIFTS = pytest.mark.parametrize("shift", [0.0, 0.3], ids=["posterior", "moved"])


def _post(J, shift):
    st = J["post"][0]
    return st._replace(pos=np.asarray(st.pos) + np.float32([shift, 0, 0]))


def _port_args(jax_frame, shift=0.0):
    """(T, fid, J, Jin, the port's pool from JAX's ring-inserted pool,
    the posterior state moved by `shift` m along x, the submap)."""
    T, fid, J, Jin = jax_frame
    pool = convert.pool_from_numpy(*J["pool"], device="cpu")
    post = tstate.NavState(*(torch.from_numpy(np.array(a))
                             for a in _post(J, shift)))
    return T, fid, J, Jin, pool, post, _submap_to_torch(J["sub"])


def _jax_post(J, shift=0.0):
    return type(J["post"][0])(*(jnp.asarray(a) for a in _post(J, shift)))


def _assert_pool_matches(tpool, jpool):
    t_point, t_obs, t_patch, t_alloc = convert.pool_to_numpy(tpool)
    j_point, j_obs, j_patch, j_alloc = (np.asarray(a) for a in jpool)
    assert float(t_alloc) == float(j_alloc)
    np.testing.assert_array_equal(t_point[:, _INT_POINT_COLS],
                                  j_point[:, _INT_POINT_COLS])
    np.testing.assert_array_equal(t_obs[..., _INT_OBS_COLS],
                                  j_obs[..., _INT_OBS_COLS])
    np.testing.assert_allclose(t_point, j_point, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_obs, j_obs, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(t_patch, j_patch, rtol=1e-5, atol=1e-3)


@SHIFTS
def test_maintain_points_matches_jax(jax_frame, shift):
    T, fid, J, Jin, tpool, post, tsub = _port_args(jax_frame, shift)
    slot = int(J["slot"])
    tpool, tadd = tvio.maintain_points(
        tpool, T["vmap"], T["map_cfg"], tsub, T["img"], post, T["cam"],
        T["Rci"], T["Pci"], fid, slot, T["cfg"])
    cam, cfg, map_cfg = Jin["cam"], Jin["cfg"], Jin["map_cfg"]
    jsub = jvio.Submap(*(jnp.asarray(a) for a in J["sub"]))
    jpool, jadd = jax.jit(lambda pool, vmap, img, st, Rci, Pci: jvio.maintain_points(
        pool, vmap, map_cfg, jsub, img, st, cam, Rci, Pci, jnp.int32(fid),
        jnp.int32(slot), cfg))(
        _jax_pool(J), Jin["vmap"], Jin["img"], _jax_post(J, shift),
        Jin["Rci"], Jin["Pci"])
    assert (int(np.asarray(jadd).sum()) > 0) == (shift > 0)
    np.testing.assert_array_equal(tadd.numpy(), np.asarray(jadd))
    _assert_pool_matches(tpool, jpool)


@SHIFTS
def test_update_obs_then_reference_match_jax(jax_frame, shift):
    """The two maintenance stages standalone, each scattering its rows:
    the observation update's flags feed the reference refinement."""
    T, fid, J, Jin, tpool, post, tsub = _port_args(jax_frame, shift)
    slot = int(J["slot"])
    tpool, tadd = tvio.update_obs(tpool, tsub, T["img"], post, T["cam"],
                                  T["Rci"], T["Pci"], fid, slot, T["cfg"])
    tpool = tvio.update_reference(tpool, T["vmap"], T["map_cfg"], tsub,
                                  tadd, T["cfg"])
    cam, cfg, map_cfg = Jin["cam"], Jin["cfg"], Jin["map_cfg"]
    jsub = jvio.Submap(*(jnp.asarray(a) for a in J["sub"]))

    @jax.jit
    def both(pool, vmap, img, st, Rci, Pci):
        pool, add = jvio.update_obs(pool, jsub, img, st, cam, Rci, Pci,
                                    jnp.int32(fid), jnp.int32(slot), cfg)
        return jvio.update_reference(pool, vmap, map_cfg, jsub, add, cfg), add

    jpool, jadd = both(_jax_pool(J), Jin["vmap"], Jin["img"],
                       _jax_post(J, shift), Jin["Rci"], Jin["Pci"])
    assert (int(np.asarray(jadd).sum()) > 0) == (shift > 0)
    np.testing.assert_array_equal(tadd.numpy(), np.asarray(jadd))
    _assert_pool_matches(tpool, jpool)


def test_generate_points_matches_jax(jax_frame):
    """New points in the grid cells the submap leaves empty, written at
    the allocation cursor."""
    T, fid, J, Jin, tpool, post, tsub = _port_args(jax_frame)
    slot = int(J["slot"])
    tpool, tn = tvio.generate_points(
        tpool, T["img"], T["pg_w"], T["pg_n"], T["pg_v6"], T["pg_ok"],
        tsub.valid, post, T["cam"], T["Rci"], T["Pci"], fid, slot, T["cfg"])
    cam, cfg = Jin["cam"], Jin["cfg"]
    jpool, jn = jax.jit(lambda pool, img, pg_w, pg_n, pg_v6, pg_ok, occ, st,
                        Rci, Pci: jvio.generate_points(
        pool, img, pg_w, pg_n, pg_v6, pg_ok, occ, st, cam, Rci, Pci,
        jnp.int32(fid), jnp.int32(slot), cfg))(
        _jax_pool(J), Jin["img"], Jin["pg_w"], Jin["pg_n"], Jin["pg_v6"],
        Jin["pg_ok"], jnp.asarray(J["sub"].valid), _jax_post(J), Jin["Rci"],
        Jin["Pci"])
    assert int(tn) == int(jn) > 0
    _assert_pool_matches(tpool, jpool)


@SHIFTS
def test_generate_and_maintain_is_maintain_then_generate(jax_frame, shift):
    """The fused form, bit for bit the two standalone scatters in order
    (a generated slot that collides with a maintained row keeps the new
    point), the update flags and n_added equal."""
    T, fid, J, _, tpool, post, tsub = _port_args(jax_frame, shift)
    slot = int(J["slot"])
    fused, f_add, f_n = tvio.generate_and_maintain(
        tpool, T["vmap"], T["map_cfg"], tsub, T["img"], T["pg_w"], T["pg_n"],
        T["pg_v6"], T["pg_ok"], post, T["cam"], T["Rci"], T["Pci"], fid,
        slot, T["cfg"])
    seq_pool = convert.pool_from_numpy(*J["pool"], device="cpu")
    seq_pool, s_add = tvio.maintain_points(
        seq_pool, T["vmap"], T["map_cfg"], tsub, T["img"], post, T["cam"],
        T["Rci"], T["Pci"], fid, slot, T["cfg"])
    seq_pool, s_n = tvio.generate_points(
        seq_pool, T["img"], T["pg_w"], T["pg_n"], T["pg_v6"], T["pg_ok"],
        tsub.valid, post, T["cam"], T["Rci"], T["Pci"], fid, slot, T["cfg"])
    assert torch.equal(f_add, s_add) and int(f_n) == int(s_n) > 0
    for a, b in zip(convert.pool_to_numpy(fused),
                    convert.pool_to_numpy(seq_pool)):
        np.testing.assert_array_equal(a, b)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_put_sharded_on_one_rank_gloo_mesh():
    """Leaves with a leading axis go through shard_points (on one rank:
    the whole axis), 0-d leaves through put_replicated (rank 0's value,
    one broadcast each); the tree's structure is kept."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = shd.make_mesh(device="cpu")
        pts = torch.arange(24, dtype=torch.float32).reshape(8, 3)
        valid = torch.arange(8) % 3 != 0
        tree = tstate.NavState(*(torch.full(s, float(i)) for i, s in enumerate(
            ((3, 3), (3,), (3,), (3,), (3,), (3,), ()))))
        out = shd.put_sharded((pts, valid, tree), mesh)
        assert torch.equal(out[0], pts) and torch.equal(out[1], valid)
        assert type(out[2]) is tstate.NavState
        for a, b in zip(out[2], tree):
            assert torch.equal(a, b) and a is not b
        # the one 0-d leaf went through a broadcast
        assert mesh.collective_bytes == 4
        with pytest.raises(ValueError, match="does not divide"):
            shd.shard_rows(7, shd.Mesh(mesh.group, 0, 2, "dp", mesh.device))
    finally:
        dist.destroy_process_group()


def test_device_trace_names_the_annotated_stages(jax_run, tmp_path):
    """A short LIVO run on the CPU inside device_trace: the trace file
    holds a range for each of the six stages (a split frame enters each
    through `annotate`), and a caller's own annotate range."""
    seq = jax_run[0]
    pipe = LIVOPipeline(livo_config(LIVOConfig), slam_mode="livo",
                        device="cpu")
    with timing.device_trace(str(tmp_path)) as prof:
        with timing.annotate("caller_range"):
            pipe.process(seq, max_frames=4)
    assert prof is not None
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for name in timing.STAGES + ("caller_range",):
        assert name in names, name

"""The capacity-cycling soak (fast_livo2_tpu_torch/soak.py) against the
JAX package's, on the CPU: tests/test_soak.py's case (6 s, 12 x 500
points, 320 x 256 frames, a 2,048-point pool with 4 observations a
point, an 8-frame ring, map sliding at 1 m) through the port.

- The port's split run passes the JAX test's gates unchanged (finite,
  ATE < 0.15 m, a span > 2 m, > 20 tracked points over the second
  half), cycles what the soak is for (at least one map slide and one
  ring wrap; the pool's 2,048 slots take ~1,000 points in 6 s, so it
  does not wrap here), and stays within 8e-3 m / 4e-3 of the JAX run
  on the same sequence (tests/test_golden_trace.py's tolerances).
- The fused frame (tpu.fused_frame, eager on the CPU) over the first 30
  frames, which hold a slide and three ring wraps, is bit for bit the
  split run: trajectory, packed state, map, pool (its allocation cursor
  included) and ring ids.
"""

import numpy as np
import pytest
import torch

from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu_torch import soak
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from tests.test_soak import _soak_cfg

POS_TOL_M, ROT_TOL = 8e-3, 4e-3
POOL = 2048  # tests/test_soak.py's pool
PREFIX = 30  # frames of the fused-vs-split comparison


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return soak.soak_sequence(6.0, "livo", soak.soak_config(POOL))


def _state(pipe):
    """Every tensor of a pipeline's device state, cloned."""
    return [t.clone() for t in (pipe.packed, *pipe.vmap_state, *pipe.pool,
                                *pipe.ring)]


@pytest.fixture(scope="module")
def split_run(seq):
    """The port's split run, with its state after PREFIX frames."""
    pipe = LIVOPipeline(soak.soak_config(POOL), slam_mode="livo", device="cpu")
    pipe.push_sequence(seq)
    assert pipe.poll(max_frames=PREFIX, flush=True) == PREFIX
    at_prefix = (_state(pipe), [r[1].clone() for r in pipe.trajectory],
                 pipe.map_slides, pipe.frame_id)
    pipe.poll(flush=True)
    pipe._finalize_host_views()
    return pipe, at_prefix


def test_soak_gates_and_cycles_match_jax(seq, split_run):
    pipe, _ = split_run
    traj = pipe.trajectory
    out = {**soak.gates(traj, seq, pipe), **soak.cycle_counts(pipe)}
    assert out["failed"] == [], out
    assert out["map_slides"] >= 1 and out["ring_wraps"] >= 1, out
    assert out["pool_alloc"] > 0
    jpipe = JaxPipeline(_soak_cfg(), slam_mode="livo")
    jtraj = jpipe.process(seq)
    assert [t for t, _, _ in traj] == [t for t, _, _ in jtraj]
    np.testing.assert_allclose(np.array([p for _, _, p in traj]),
                               np.array([p for _, _, p in jtraj]),
                               atol=POS_TOL_M)
    np.testing.assert_allclose(np.array([R for _, R, _ in traj]),
                               np.array([R for _, R, _ in jtraj]),
                               atol=ROT_TOL)
    np.testing.assert_allclose(jpipe._last_slide_pos, pipe._last_slide_pos,
                               atol=POS_TOL_M)


def test_fused_soak_is_split_bit_for_bit(seq, split_run):
    _, (state, traj, slides, frames) = split_run
    pipe = LIVOPipeline(soak.soak_config(POOL, fused=True), slam_mode="livo",
                        device="cpu")
    pipe.push_sequence(seq)
    assert pipe.poll(max_frames=PREFIX, flush=True) == PREFIX
    assert pipe.map_slides == slides >= 1
    assert pipe.frame_id == frames and frames // pipe.vio_cfg.frame_ring >= 3
    assert len(pipe.trajectory) == len(traj)
    for (_, a), b in zip(pipe.trajectory, traj):
        assert torch.equal(a, b)
    for a, b in zip(_state(pipe), state):
        assert torch.equal(a, b)

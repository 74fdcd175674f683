"""The avia rig (configs/avia.yaml + camera_pinhole.yaml: Livox CustomMsg,
24 x 1,000 points over 70 degrees, DEGRADE noise, the 1280 x 1024
radtan camera at scale 0.5 (M = 396: the port's torch-op path samples as
the JAX package does on the CPU), images 0.1 s late) on the CPU at
tests/test_torch_rigs.py's size, through its bag and the converter: the
port's LIVO run against the JAX package's within 8e-3 m / 4e-3; the
port's frame held to the JAX run one step at a time
(tests/test_torch_rigs.OneStep: its packets, LIO half, VIO half and
deferred insert on the JAX run's own inputs at every frame), each block
of the packed state under its floor but at the frames TIES lists; its
fused frames bit for bit its split frames.

TIES are the frames where the port's LIO half decides on a float tie
the other way from the JAX package, each pinned by test_rig_tie_pinned
(the one package's one-ulp twin lands on the other's result):
- frames 7 and 10: a scan point undistorts onto a downsample voxel
  boundary to within float32 resolution, and the downsampled scans
  differ by one voxel (4.3e-5 / 1.7e-5 m; at frame 7 the JAX package's
  own one-ulp twin moves it, at frame 10 the port's);
- frame 11: a point is matched to another plane in the JAX package's run
  than in the port's (6.6e-5 m), and the JAX package's own one-ulp twin
  matches it as the port does."""

import pytest

from tests.test_torch_rigs import (assert_crossover, assert_traj_close,
                                   assert_traj_equal, one_step_faults,
                                   one_torch_thread,  # noqa: F401
                                   parity_runs, vio_half_faults)

RIG = "avia"
TIES = {7: ("lio", "test_rig_tie_pinned[7]"),
        10: ("lio", "test_rig_tie_pinned[10]"),
        11: ("lio", "test_rig_tie_pinned[11]")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return parity_runs(RIG, str(tmp_path_factory.mktemp(RIG)), keep=TIES)


def test_rig_matches_jax(runs):
    assert len(runs["split"]) >= 15
    assert_traj_close(runs["split"], runs["jax"])


def test_rig_one_step_matches_jax(runs):
    assert len(runs["step"].frames) >= 15
    faults = one_step_faults(runs["step"], TIES)
    assert not faults, faults


def test_rig_vio_half_matches_jax(runs):
    faults = vio_half_faults(runs["step"], TIES)
    assert not faults, faults


@pytest.mark.parametrize("fid", sorted(TIES))
def test_rig_tie_pinned(runs, fid):
    assert_crossover(runs["step"], fid, TIES[fid][0])


def test_rig_fused_equals_split(runs):
    assert_traj_equal(runs["fused"], runs["split"])

"""The ntu_viral rig (configs/ntu_viral.yaml + camera_ntu_viral.yaml:
Ouster PointCloud2, point_filter_num 3, scans 0.1 s early, the 752 x
480 radtan camera at M = 486: K2 in the sampling above the 448-point
gate, 3 pyramid levels) on the CPU at tests/test_torch_rigs.py's size,
through its bag and the converter: the port's LIVO run against the JAX
package's within 8e-3 m / 4e-3; the port's frame held to the JAX run one
step at a time (tests/test_torch_rigs.OneStep: its packets, LIO half,
VIO half and deferred insert on the JAX run's own inputs at every
frame), each block of the packed state under its floor but at the
frames TIES lists; its fused frames bit for bit its split frames.

TIES are the frames where the port decides on a float tie the other way
from the JAX package, each pinned by test_rig_tie_pinned:
- frame 4, VIO: at pyramid level 2 the port's K2 path (clip_taps) gives
  iteration 3 the error of iteration 2 bit for bit, and the accept rule
  `error <= last_error` takes a 10th iteration that the JAX package and
  the port's torch-op path reject (each by a few float32 ulps of the
  error sum): 3.5e-5 m, 3.4e-4 m/s.
- frame 15, LIO: a scan point undistorts to within float32 resolution of
  a downsample voxel boundary (y ~ 1e-11 m, the boundary 0), each
  package floors it to another voxel, and the downsampled scan has one
  voxel more: cov 2.5e-4 of its largest entry."""

import pytest

from tests.test_torch_rigs import (assert_crossover, assert_downsample_tie,
                                   assert_traj_close, assert_traj_equal,
                                   one_step_faults,
                                   one_torch_thread,  # noqa: F401
                                   parity_runs, photo_traces, vio_half_faults)

RIG = "ntu_viral"
TIES = {4: ("vio", "test_rig_tie_pinned[4]"),
        15: ("lio", "test_rig_tie_pinned[15]")}


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
    step = runs["step"]
    if TIES[fid][0] == "lio":
        assert assert_downsample_tie(step, fid) == 1
        return
    port, jax = photo_traces(step, fid)  # K2's plain version (clip_taps)
    torch_op, _ = photo_traces(step, fid, pallas_photo=False)
    assert port[0][3] == port[0][2]  # level 2, iterations 2 and 3: a tie
    assert len(port[0]) == 5  # ... accepted: one more iteration
    assert jax[0][3] > jax[0][2] and len(jax[0]) == 4
    assert torch_op[0][3] > torch_op[0][2] and len(torch_op[0]) == 4
    assert_crossover(step, fid, "vio")  # the port's twin takes JAX's way


def test_rig_fused_equals_split(runs):
    assert_traj_equal(runs["fused"], runs["split"])

"""The hilti22 rig (configs/hilti22.yaml + camera_fisheye_hilti22.yaml:
Hesai XT32 PointCloud2 in a flipped LiDAR frame, 32 x 1,000 points, 0.4
m voxels, the 720 x 540 equidistant camera at 40 Hz decimated to 10 Hz;
its photometric update runs through K2's plain version, sampling each
tap as the JAX package's XLA path does) on the CPU at tests/test_torch_rigs.py's size, through its bag
and the converter: the port's LIVO run against the JAX package's within
8e-3 m / 4e-3; the port's frame held to the JAX run one step at a time
(tests/test_torch_rigs.OneStep: its packets, LIO half, VIO half and
deferred insert on the JAX run's own inputs at every frame), each block
of the packed state under its floor but at the frames TIES lists; its
fused frames bit for bit its split frames.

TIES, each pinned by test_rig_tie_pinned:
- frame 12, VIO: the reference patch retrieve warps for one point is
  ill-posed in both packages (a plane seen nearly edge-on: the affine
  warp stretches the patch ~120x, its far samples move by grey levels
  when the pose moves by one ulp), and the two packages' patches part by
  tens of grey levels; the port's photometric update on the JAX
  package's submap starts every level at the JAX package's error, so
  the gap (2.9e-5 m, 2.2e-4 m/s, inv_expo 2.1e-4) is that patch's."""

import pytest

from tests.test_torch_rigs import (assert_traj_close, assert_traj_equal,
                                   assert_warp_tie, one_step_faults,
                                   one_torch_thread,  # noqa: F401
                                   parity_runs, vio_half_faults)

RIG = "hilti22"
TIES = {12: ("vio", "test_rig_tie_pinned[12]")}


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
    jax, port, moved = assert_warp_tie(runs["step"], fid)
    print(f"frame {fid}: the patch entry JAX {jax}, port {port}, "
          f"port with the pose one ulp away {moved}")


def test_rig_fused_equals_split(runs):
    assert_traj_equal(runs["fused"], runs["split"])

"""The ntu_viral rig (configs/ntu_viral.yaml + camera_ntu_viral.yaml:
Ouster PointCloud2, point_filter_num 3, scans 0.1 s early, the 752 x
480 radtan camera at M = 486: K2 in the sampling above the 448-point
gate, 3 pyramid levels) on the CPU at tests/test_torch_rigs.py's size,
through its bag and the converter: the port's LIVO run against the JAX
package's within 8e-3 m / 4e-3; the port's VIO half on the JAX run's
own inputs at every VIO frame, its posterior state within 1e-4 of the
JAX package's (float32 in another order: a photometric iteration's
accept or rollback, decided on float32 errors that can tie, falls the
other way on a few frames and moves the state by a few 1e-5); its fused
frames bit for bit its split frames."""

import numpy as np
import pytest

from tests.test_torch_rigs import (assert_traj_close, assert_traj_equal,
                                   one_torch_thread, parity_runs,  # noqa: F401
                                   vio_half_diffs)

RIG = "ntu_viral"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return parity_runs(RIG, str(tmp_path_factory.mktemp(RIG)))


def test_rig_matches_jax(runs):
    assert len(runs["split"]) >= 15
    assert_traj_close(runs["split"], runs["jax"])


def test_rig_vio_half_matches_jax(runs):
    assert len(runs["captures"]) >= 14
    d = vio_half_diffs(runs["cfg"], runs["captures"])
    print("VIO half: max rotation, position diff", d.max(axis=0))
    np.testing.assert_array_less(d, 1e-4)


def test_rig_fused_equals_split(runs):
    assert_traj_equal(runs["fused"], runs["split"])

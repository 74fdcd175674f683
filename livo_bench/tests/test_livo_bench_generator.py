"""The recording generator: the same seed gives the same recording and
another seed another; noiseless, its scene, motion, IMU and scans are
the port's io/synthetic ones, number for number."""

import copy

import numpy as np
import torch

from fast_livo2_tpu_torch.io import synthetic
from livo_bench.lib import deployment, generator


def small():
    d = copy.deepcopy(deployment._json("configs", "avia"))
    d["rig"].update(lines=2, per_line=64)
    d["camera"].update(cam_width=64, cam_height=48, cam_fx=40.0, cam_fy=40.0,
                       cam_cx=32.0, cam_cy=24.0, scale=1.0)
    return d


def test_same_seed_same_recording():
    d = small()
    a, b, c = (generator.make_recording(d, 1.2, s, "cpu")
               for s in (2 ** 31 + 5, 2 ** 31 + 5, 7))
    assert np.array_equal(a.imu_acc, b.imu_acc)
    assert all(np.array_equal(x[1], y[1]) and np.array_equal(x[2], y[2])
               for x, y in zip(a.scans, b.scans))
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a.images, b.images))
    assert not np.array_equal(a.imu_acc, c.imu_acc)
    assert not all(np.array_equal(x[1], y[1]) for x, y in zip(a.images, c.images))
    # the same sizes and arrivals on every seed
    assert np.array_equal(a.imu_t, c.imu_t)
    assert [x[0] for x in a.images] == [x[0] for x in c.images]


def test_noiseless_matches_io_synthetic():
    seq = synthetic.make_sequence(duration=2.0, n_lines=3, n_per_line=40, render=False,
                                  gyr_noise=0.0, acc_noise=0.0, range_noise=0.0,
                                  seed=0, fov_deg=70.0)
    t = torch.tensor(seq.imu_stamps, dtype=torch.float64)
    gy, ac = generator.imu_stream(t, torch.Generator().manual_seed(0), 0.0, 0.0)
    assert np.abs(gy.numpy() - seq.imu_gyr).max() < 1e-9
    assert np.abs(ac.numpy() - seq.imu_acc).max() < 1e-6
    rig = dict(lines=3, per_line=40, fov_deg=70.0, dropout=0.0, range_noise=0.0,
               outlier_frac=0.0)
    tb = torch.tensor([s[0] for s in seq.scans], dtype=torch.float64)
    mine = generator.scans(generator.Scene("cpu"), tb, rig, torch.Generator(),
                           np.eye(3), np.zeros(3), 0.0, False)
    for (t0, p, o), (t1, q, r) in zip(seq.scans, mine):
        # the same points, in firing (time) order
        order = np.argsort(o, kind="stable")
        assert t0 == t1 and p.shape == q.shape
        assert np.abs(p[order] - q).max() < 1e-5 and np.array_equal(o[order], r)

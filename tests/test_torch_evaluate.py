"""The port's trajectory evaluation (fast_livo2_tpu_torch/utils/evaluate.py,
the run CLI's summary ATE) on the CPU: tests/test_evaluate_goldens.py's
RPE case with its gates unchanged, and the port's `ape`, `rpe` and
`umeyama` held against scripts/evaluate.py's on the same trajectories
(the port keeps its own copy of them; the two must give the same
numbers). The published-table case of that file reads the reference's
own result files, which this repository does not ship, and is not
repeated here.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from fast_livo2_tpu_torch.utils import evaluate as tev

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import evaluate as jev  # noqa: E402


def test_rpe_known_error_scale():
    """A constant-velocity trajectory with positions scaled by (1+eps) has
    relative translation error exactly eps*v*delta, and a perfect
    estimate has RPE 0 (evo_rpe convention, translational, + drift %)."""
    v, eps, dur = 2.0, 0.03, 10.0
    ts = np.arange(0.0, dur, 0.1)
    I = np.eye(3)
    ref = [(t, I, np.array([v * t, 0.0, 0.0])) for t in ts]
    est_perfect = [(t, I, np.array([v * t, 0.0, 0.0])) for t in ts]
    est_scaled = [(t, I, np.array([(1 + eps) * v * t, 0.0, 0.0]))
                  for t in ts]

    s0 = tev.rpe(ref, est_perfect, delta=1.0)
    assert s0["rpe_rmse"] < 1e-12
    np.testing.assert_allclose(s0["path_m"], v * (dur - 0.1), rtol=1e-6)

    s1 = tev.rpe(ref, est_scaled, delta=1.0)
    # segment length snaps to the stamp grid (1.0-1.1 s), so the error
    # is eps*v*delta_actual in [0.060, 0.066]
    assert eps * v * 1.0 - 1e-9 <= s1["rpe_rmse"] <= eps * v * 1.1 + 1e-9
    assert s1["drift_pct"] > 0


def _rot(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _trajectories(case):
    """(ground truth, estimate) over a curved 20 s path: the estimate
    rotated, shifted and noisy; `jitter` also moves its stamps by up to
    15 ms and drops some (association drops and duplicates); `sparse`
    keeps one estimate in three."""
    rng = np.random.default_rng(len(case))
    ts = np.arange(0.0, 20.0, 0.05)
    p = np.stack([3 * np.sin(0.3 * ts), 2 * np.cos(0.2 * ts), 0.1 * ts], -1)
    Rs = [_rot(np.array([0.01, 0.02, 0.3]) * t + 1e-3) for t in ts]
    gt = [(t, R, x) for t, R, x in zip(ts, Rs, p)]
    G = _rot(np.array([0.1, -0.2, 0.4]))
    est = [(t, G @ R, G @ x + np.array([1.0, -2.0, 0.5])
            + rng.normal(0, 0.02, 3)) for t, R, x in gt]
    if case == "jitter":
        est = [(t + rng.uniform(-0.015, 0.015), R, x) for t, R, x in est
               if rng.random() > 0.1]
        est.sort(key=lambda e: e[0])
    elif case == "sparse":
        est = est[::3]
    return gt, est


@pytest.mark.parametrize("case", ["dense", "jitter", "sparse"])
def test_ape_rpe_umeyama_equal_scripts_evaluate(case):
    gt, est = _trajectories(case)
    for align in (True, False):
        assert tev.ape(gt, est, align=align) == jev.ape(gt, est, align=align)
    off = [0.1, 0.0, -0.05]
    assert (tev.ape(gt, est, prism_offset=off)
            == jev.ape(gt, est, prism_offset=off))
    for delta in (0.5, 1.0, 5.0):
        assert tev.rpe(gt, est, delta=delta) == jev.rpe(gt, est, delta=delta)
    src = np.array([x for _, _, x in est[:50]])
    dst = np.array([x for _, _, x in gt[:50]])
    for with_scale in (False, True):
        got = tev.umeyama(src, dst, with_scale)
        want = jev.umeyama(src, dst, with_scale)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    assert tev.associate([g[0] for g in gt], [e[0] for e in est]) == \
        jev.associate([g[0] for g in gt], [e[0] for e in est])

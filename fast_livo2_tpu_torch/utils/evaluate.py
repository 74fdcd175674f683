"""Trajectory evaluation: ATE RMSE with the exact evo_ape convention, and
translational RPE with drift (the PyTorch port's own copy of
`associate`, `umeyama`, `ape` and `rpe` from scripts/evaluate.py, for the
run CLI's summary; the port imports nothing of scripts/).

  - association: for each REFERENCE (ground-truth) timestamp, the
    nearest estimate timestamp within max_diff (evo default 0.01 s);
    duplicates allowed, exactly like evo.core.sync.matching_time_indices.
  - alignment: Umeyama closed form on the matched positions, est -> ref
    (`-a`, SE(3), no scale).
  - APE: rmse/mean/median/max of per-pair position error norms.
"""

import numpy as np


def associate(ref_t, est_t, max_dt=0.01):
    """evo-convention association: for each reference stamp, the nearest
    estimate stamp if within max_dt. Returns (ref_idx, est_idx) pairs.

    Mirrors evo.core.sync.matching_time_indices: iterate over the
    *first* trajectory's stamps, argmin over the second, duplicates
    allowed. est_t must be sorted (TUM files are)."""
    ref_t = np.asarray(ref_t)
    est_t = np.asarray(est_t)
    j = np.searchsorted(est_t, ref_t)
    j_lo = np.clip(j - 1, 0, len(est_t) - 1)
    j_hi = np.clip(j, 0, len(est_t) - 1)
    pick_hi = np.abs(est_t[j_hi] - ref_t) < np.abs(est_t[j_lo] - ref_t)
    best = np.where(pick_hi, j_hi, j_lo)
    ok = np.abs(est_t[best] - ref_t) <= max_dt
    return list(zip(np.nonzero(ok)[0].tolist(), best[ok].tolist()))


def umeyama(src, dst, with_scale=False):
    """Closed-form alignment dst ≈ s R src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (D * S.diagonal()).sum() / xs.var(0).sum() if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ape(ref, est, align=True, prism_offset=None, max_dt=0.01):
    """ref/est: lists [(t, R, p)], ref = ground truth. Returns APE stats
    (meters) under the evo_ape convention (see module docstring)."""
    if prism_offset is not None:
        off = np.asarray(prism_offset)
        est = [(t, R, p + R @ off) for t, R, p in est]
    ref_t = np.array([g[0] for g in ref])
    est_t = np.array([e[0] for e in est])
    pairs = associate(ref_t, est_t, max_dt)
    if len(pairs) < 3:
        raise ValueError(f"only {len(pairs)} associations")
    P_ref = np.array([ref[i][2] for i, _ in pairs])
    P_est = np.array([est[j][2] for _, j in pairs])
    if align:
        s, R, t = umeyama(P_est, P_ref)
        P_est = (s * (R @ P_est.T)).T + t
    err = np.linalg.norm(P_est - P_ref, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "n": len(err),
    }


def rpe(ref, est, delta: float = 1.0, max_dt=0.01, ape_rmse=None):
    """Translational Relative Pose Error at time-delta `delta` seconds
    (the evo_rpe convention, translation part): for each associated pair
    (i, i+Δ), error = || (T_ref_i^-1 T_ref_{i+Δ}) ⊖ (T_est_i^-1
    T_est_{i+Δ}) ||_trans. Alignment-free — measures local drift, the
    complement of the APE the reference's harness reports. Also returns
    drift as %% of the ground-truth path length."""
    ref_t = np.array([g[0] for g in ref])
    est_t = np.array([e[0] for e in est])
    pairs = associate(ref_t, est_t, max_dt)
    if len(pairs) < 3:
        raise ValueError(f"only {len(pairs)} associations")
    ts = np.array([ref_t[i] for i, _ in pairs])
    errs = []
    for a in range(len(pairs)):
        b = int(np.searchsorted(ts, ts[a] + delta))
        if b >= len(pairs):
            break
        ia, ja = pairs[a]
        ib, jb = pairs[b]
        # relative translation expressed in the segment-start frame
        d_ref = ref[ia][1].T @ (ref[ib][2] - ref[ia][2])
        d_est = est[ja][1].T @ (est[jb][2] - est[ja][2])
        errs.append(np.linalg.norm(d_ref - d_est))
    errs = np.asarray(errs)
    P_ref = np.array([ref[i][2] for i, _ in pairs])
    path = float(np.sum(np.linalg.norm(np.diff(P_ref, axis=0), axis=1)))
    if ape_rmse is None:  # pass a precomputed APE to avoid recomputing
        ape_rmse = ape(ref, est, align=True, max_dt=max_dt)["rmse"]
    return {
        "rpe_rmse": float(np.sqrt(np.mean(errs**2))) if len(errs) else 0.0,
        "rpe_mean": float(errs.mean()) if len(errs) else 0.0,
        "rpe_max": float(errs.max()) if len(errs) else 0.0,
        "delta_s": float(delta),
        "path_m": path,
        "drift_pct": (100.0 * ape_rmse / path) if path > 0 else 0.0,
        "n": int(len(errs)),
    }

"""Voxel-map topology and match-quality diagnostics (port of
scripts/diag_map.py).

Runs the outdoor clip (the MARS_LVIG 2 m-voxel operating point: the
long outdoor scene, 24 x 1000 points a scan, 80 m range, map sliding)
and reports what the 2 m-voxel investigation needed:

  - ATE and drift of the run;
  - a per-layer map census: occupied voxels, solid planes (ISPL = 1),
    marginal planes (0.75), CUT internal nodes (-1), undecided voxels,
    frozen voxels, i.e. how far the layered descent subdivided;
  - a per-match layer histogram: ground-truth-posed points of held-out
    scans matched against a map built from ground-truth-posed scans
    (match_planes), counted by winning candidate (own-chain layer or
    neighbour), with |point-to-plane| residual statistics per layer:
    plane-fit quality against voxel size, with no filter drift.

    python -m fast_livo2_tpu_torch.diag_map [--voxel 2.0] [--layers 3]
        [--no-sticky] [--margin 1.0] [--seed 32] [--duration 20]
        [--device cuda|cpu]
"""

import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch


def outdoor_seq(seed: int, duration: float):
    """The outdoor clip: the 44 s waypoint flight over the long outdoor
    scene, cut to `duration`, with the IMU noise and biases and 0.03 m
    range noise of tests/test_long_run.py's clip."""
    from .io import synthetic

    wp = synthetic.long_outdoor_waypoints()
    traj = synthetic.WaypointTrajectory(wp, duration=44.0)
    return synthetic.make_sequence(
        duration=duration, lidar_hz=10.0, imu_hz=200.0, seed=seed,
        n_lines=24, n_per_line=1000, render=False, fov_deg=360.0,
        planes=synthetic.long_outdoor_scene(), traj=traj, max_range=80.0,
        gyr_noise=2e-3, acc_noise=2e-2, range_noise=0.03,
        bias_g=np.array([0.002, -0.0015, 0.001]),
        bias_a=np.array([0.05, -0.03, 0.08]))


def _census_rows(rec: np.ndarray, keys: np.ndarray, max_points_num: int):
    from .core import voxel_map as vm

    rows = []
    for layer in range(rec.shape[0]):
        occ = keys[layer, :, 0] != vm.EMPTY
        col = rec[layer, :, vm._ISPL]
        cnt = rec[layer, :, vm._CNT]
        rows.append(dict(
            layer=layer,
            occupied=int(occ.sum()),
            solid=int(((col > 0.9) & occ).sum()),
            marginal=int((np.isclose(col, 0.75) & occ).sum()),
            cut=int(((col < -0.5) & occ).sum()),
            undecided=int(((np.abs(col) < 0.1) & occ).sum()),
            frozen=int(((cnt >= max_points_num) & occ).sum()),
        ))
    return rows


def census(pipe):
    """Per-layer topology counts of a pipeline's live map (anything with
    `vmap_state` and `map_cfg`): one derive_rec on the map's device and
    one copy of the records and keys to the host."""
    from .core import voxel_map as vm

    rec = vm.derive_rec(pipe.vmap_state, pipe.map_cfg).cpu().numpy()
    return _census_rows(rec, pipe.vmap_state.keys.cpu().numpy(),
                        pipe.map_cfg.max_points_num)


def _gt_world_points(seq, fi, max_pts=4096):
    """Body points of scan fi (every k-th, at most max_pts) and their
    world positions under per-point ground-truth poses (the ground truth
    interpolated at each point's own stamp; no filter involved)."""
    gt_t = np.array([g[0] for g in seq.gt])
    gt_R = np.array([g[1] for g in seq.gt])
    gt_p = np.array([g[2] for g in seq.gt])
    t0, pts, offs = seq.scans[fi]
    step = max(1, len(pts) // max_pts)
    sub, so = pts[::step][:max_pts], offs[::step][:max_pts]
    ts = t0 + so
    gi = np.clip(np.searchsorted(gt_t, ts), 1, len(gt_t) - 1)
    w = np.clip((ts - gt_t[gi - 1])
                / np.maximum(gt_t[gi] - gt_t[gi - 1], 1e-9), 0, 1)
    p = gt_p[gi - 1] * (1 - w[:, None]) + gt_p[gi] * w[:, None]
    R = gt_R[gi]  # nearest rotation: its smear is far below range noise
    pts_w = np.einsum("nij,nj->ni", R, sub) + p
    return sub, pts_w


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def match_histogram(vmap_state, map_cfg, frames, label):
    """Winning-layer histogram and |residual| statistics of (body, world)
    point sets matched against a map. Prints and returns the rows."""
    from .core import voxel_map as vm
    from .core.lio import calc_body_cov

    dev = vmap_state.keys.device
    L = map_cfg.n_layers
    hist = np.zeros(L + 2, np.int64)  # layers, neighbour, unmatched
    res = [[] for _ in range(L + 1)]
    for sub, pts_w in frames:
        var6 = vm.sym6(calc_body_cov(_f32(sub, dev), 0.02, 0.05))
        m = vm.match_planes(vmap_state, _f32(pts_w, dev), var6,
                            torch.ones(len(sub), dtype=torch.bool,
                                       device=dev), map_cfg)
        lay = m.layer.cpu().numpy()
        dist = np.abs(m.dist.cpu().numpy())
        ok = m.valid.cpu().numpy()
        for layer in range(L + 1):
            sel = ok & (lay == layer)
            hist[layer] += int(sel.sum())
            if sel.any():
                res[layer].append(dist[sel])
        hist[L + 1] += int((~ok).sum())
    out = []
    for layer in range(L + 1):
        r = np.concatenate(res[layer]) if res[layer] else np.array([0.0])
        name = f"layer{layer}" if layer < L else "neighbor"
        out.append(dict(cand=name, matches=int(hist[layer]),
                        res_mean_cm=round(float(r.mean()) * 100, 2),
                        res_p90_cm=round(float(np.percentile(r, 90)) * 100, 2)))
    out.append(dict(cand="unmatched", matches=int(hist[L + 1]),
                    res_mean_cm=0.0, res_p90_cm=0.0))
    print(f"== {label}")
    for row in out:
        print("  ", row)
    return out


def gt_map_quality(seq, map_cfg, n_build=60, n_probe=8, device="cuda"):
    """A fresh map built on `device` from ground-truth-posed scans, and
    ground-truth-posed points of held-out (odd) scans to match against
    it: per-layer match share and residuals measure what the topology
    and the plane fit give at this voxel size, with zero filter drift.
    Returns (map, probe frames)."""
    from .core import voxel_map as vm
    from .core.lio import calc_body_cov

    m = vm.make_map(map_cfg, device)
    build_idx = np.linspace(0, len(seq.scans) - 1, n_build).astype(int)
    for fi in build_idx:
        sub, pts_w = _gt_world_points(seq, fi)
        var6 = vm.sym6(calc_body_cov(_f32(sub, device), 0.02, 0.05))
        m = vm.update_map(m, _f32(pts_w, device), var6,
                          torch.ones(len(sub), dtype=torch.bool,
                                     device=device), map_cfg)
    probe_idx = (np.linspace(0, len(seq.scans) - 2, n_probe).astype(int)
                 | 1)  # odd frames: held out of the build set
    return m, [_gt_world_points(seq, fi) for fi in probe_idx]


def outdoor_config(voxel=2.0, layers=3, sticky=True, margin=None):
    """scripts/diag_map.py's configuration of the run."""
    from .utils.config import LIVOConfig

    cfg = LIVOConfig()
    cfg.tpu.max_points_per_scan = 16384
    cfg.tpu.max_points_down = 8192
    cfg.tpu.hash_capacity_log2 = 16
    cfg.lio.voxel_size = voxel
    cfg.lio.max_layer = layers - 1
    cfg.preprocess.filter_size_surf = 0.5
    cfg.local_map.map_sliding_en = True
    cfg.local_map.half_map_size = 50
    cfg.local_map.sliding_thresh = 8.0
    cfg.tpu.sticky_cut = sticky
    if margin is not None:
        cfg.tpu.pre_descend_margin = margin
    return cfg


def main(argv=None):
    from .core.pipeline import LIVOPipeline
    from .io import synthetic

    ap = argparse.ArgumentParser(prog="python -m fast_livo2_tpu_torch.diag_map")
    ap.add_argument("--voxel", type=float, default=2.0)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--no-sticky", action="store_true")
    ap.add_argument("--margin", type=float, default=None)
    ap.add_argument("--seed", type=int, default=32)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    seq = outdoor_seq(args.seed, args.duration)
    cfg = outdoor_config(args.voxel, args.layers, not args.no_sticky,
                         args.margin)
    t0 = time.time()
    pipe = LIVOPipeline(cfg, slam_mode="only_lio", device=args.device)
    tr = pipe.process(seq, progress=False)
    wall = time.time() - t0
    rmse = synthetic.ate_rmse([(t, p) for t, _, p in tr], seq.gt)
    gt_p = np.array([g[2] for g in seq.gt])
    path = float(np.sum(np.linalg.norm(np.diff(gt_p, axis=0), axis=1)))

    print(f"== run: voxel={args.voxel} layers={args.layers} "
          f"sticky={cfg.tpu.sticky_cut} margin={cfg.tpu.pre_descend_margin} "
          f"seed={args.seed} device={pipe.device}")
    print(f"   frames={len(tr)} wall={wall:.0f}s ATE={rmse:.3f} m "
          f"drift={100 * rmse / path:.2f}% of {path:.0f} m "
          f"slides={pipe.map_slides}")
    print("== map census (final, from the run)")
    for row in census(pipe):
        print("  ", row)
    gt_map, probes = gt_map_quality(seq, pipe.map_cfg, device=args.device)
    match_histogram(gt_map, pipe.map_cfg, probes,
                    "GT-built map vs held-out GT probes")
    print("== GT-built map census")
    for row in census(SimpleNamespace(vmap_state=gt_map,
                                      map_cfg=pipe.map_cfg)):
        print(f"   layer {row['layer']}: occ={row['occupied']} "
              f"solid={row['solid']} marginal={row['marginal']} "
              f"cut={row['cut']} undecided={row['undecided']}")


if __name__ == "__main__":
    main()

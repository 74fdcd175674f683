"""Long-run soak: force every finite-capacity mechanism to cycle (port
of scripts/soak.py).

Runs a long synthetic LIVO sequence with deliberately tight capacities so
that, within one run, the engine must (a) slide the local map several
times (mapSliding semantics, voxel_map.cpp:924-948), (b) wrap the visual
reference-frame ring and evict observations, and (c) churn the visual
point pool, then checks that the estimate stays bounded and finite. On a
card with `--fused`, every frame after the first two is one replay of a
captured CUDA graph, so the slides, ring wraps and pool wraps happen
between and inside replays.

    python -m fast_livo2_tpu_torch.soak [--duration 20] [--mode livo]
        [--fused] [--device cuda|cpu]

Prints the run's numbers, with the map slides, ring wraps (frames ÷
frame_ring) and pool wraps (the pool's allocation cursor ÷ its
capacity), then PASS; exits 1 when a gate fails.
"""

import argparse
import json
import sys
import time

import numpy as np

POOL_CAPACITY = 4096  # visual points (scripts/soak.py)
ATE_GATE_M = 0.15  # looser than the steady-capacity gates: sliding throws
# map away behind the sensor
SPAN_GATE_M = 2.0  # the trajectory must cross the sliding threshold
TAIL_TRACKED_GATE = 20  # the VIO leg alive through ring wraps and eviction


def soak_config(pool_capacity: int = POOL_CAPACITY, fused: bool = False):
    """scripts/soak.py's tight capacities on LIVOConfig(): a 320 x 256
    pinhole, 8192 / 4096 points a scan before / after downsampling, 2^15
    voxel slots a layer, 2 layers, a visual pool of `pool_capacity` with 4
    observations a point, an 8-frame ring (a wrap every 0.8 s), map
    sliding at 1 m with a 30-voxel half map."""
    from .io import synthetic
    from .utils.config import CameraConfig, LIVOConfig

    cfg = LIVOConfig()
    cfg.camera = CameraConfig(cam_model="Pinhole", cam_width=320,
                              cam_height=256, scale=1.0, cam_fx=200.0,
                              cam_fy=200.0, cam_cx=160.0, cam_cy=128.0)
    cfg.extrin_calib.Rcl = list(synthetic.R_CI_FORWARD.reshape(-1))
    cfg.extrin_calib.Pcl = [0.0, 0.0, 0.0]
    cfg.tpu.max_points_per_scan = 8192
    cfg.tpu.max_points_down = 4096
    cfg.tpu.hash_capacity_log2 = 15
    cfg.tpu.vis_point_capacity = pool_capacity
    cfg.tpu.vis_obs_per_point = 4
    cfg.tpu.frame_ring = 8
    cfg.tpu.fused_frame = fused
    cfg.lio.max_layer = 1
    cfg.preprocess.filter_size_surf = 0.15
    cfg.local_map.map_sliding_en = True
    cfg.local_map.sliding_thresh = 1.0
    cfg.local_map.half_map_size = 30
    return cfg


def soak_sequence(duration: float, mode: str, cfg, seed: int = 7):
    """scripts/soak.py's sequence: 12 x 500 points a scan, 360°, the
    room traversed by a 3 x 2.2 x 0.4 m trajectory; in LIVO the frames
    rendered through the config's camera on the forward mount."""
    from .io import synthetic
    from .models import camera as cam_mod

    livo = mode == "livo"
    return synthetic.make_sequence(
        duration=duration, lidar_hz=10.0, imu_hz=200.0, seed=seed,
        n_lines=12, n_per_line=500, fov_deg=360.0,
        cam=cam_mod.make_camera(cfg.camera) if livo else None, render=livo,
        traj=synthetic.Trajectory(pos_amp=np.array([3.0, 2.2, 0.4])),
        R_ci=synthetic.R_CI_FORWARD)


def cycle_counts(pipe) -> dict:
    """What a run cycled: map slides, ring wraps (frames ÷ frame_ring)
    and pool wraps (the allocation cursor ÷ the capacity; the cursor is
    float32, exact to 2^24 points). Reads the cursor from the device."""
    out = {"map_slides": pipe.map_slides, "ring_wraps": 0, "pool_wraps": 0,
           "pool_alloc": 0}
    if pipe.pool is not None:
        alloc = int(pipe.pool.alloc.item())
        if alloc >= 2 ** 24:
            raise ValueError(f"pool cursor {alloc} is past float32's exact "
                             "integers")
        out.update(ring_wraps=pipe.frame_id // pipe.vio_cfg.frame_ring,
                   pool_wraps=alloc // pipe.vio_cfg.pool_capacity,
                   pool_alloc=alloc)
    return out


def gates(traj, seq, pipe) -> dict:
    """The soak's numbers and its gates (scripts/soak.py): every pose
    finite, ATE < 0.15 m, a span > 2 m, and in LIVO a mean of > 20
    tracked points over the second half. Returns the numbers, with
    `failed` listing the gates that failed."""
    from .io import synthetic

    P = np.array([p for _, _, p in traj])
    out = {"frames": len(traj), "finite": bool(np.isfinite(P).all())}
    out["ate_rmse_m"] = (synthetic.ate_rmse([(t, p) for t, _, p in traj],
                                            seq.gt) if out["finite"]
                         else float("nan"))
    out["span_m"] = np.ptp(P, axis=0).tolist()
    n_eff = [r["n_eff"] for r in pipe.log.rows if r["n_eff"] > 0]
    out["mean_effective_points"] = float(np.mean(n_eff)) if n_eff else 0.0
    failed = []
    if not out["finite"]:
        failed.append("non-finite pose in trajectory")
    if not out["ate_rmse_m"] < ATE_GATE_M:
        failed.append(f"soak ATE {out['ate_rmse_m']:.3f} m out of bounds")
    if not max(out["span_m"]) > SPAN_GATE_M:
        failed.append("trajectory did not traverse the room")
    if pipe.slam_mode == "livo":
        trk = [r["n_tracked"] for r in pipe.log.rows]
        out["tail_tracked_mean"] = float(np.mean(trk[len(trk) // 2:]))
        if not out["tail_tracked_mean"] > TAIL_TRACKED_GATE:
            failed.append(f"VIO died mid-run (tail tracked "
                          f"{out['tail_tracked_mean']:.0f})")
    out["failed"] = failed
    return out


def run(duration: float = 20.0, mode: str = "livo", fused: bool = False,
        device: str = "cuda"):
    """One soak run. Returns (numbers with the gates and the cycle
    counts, pipeline, trajectory, sequence)."""
    from .core.pipeline import LIVOPipeline

    cfg = soak_config(fused=fused)
    t0 = time.perf_counter()
    seq = soak_sequence(duration, mode, cfg)
    seq_s = time.perf_counter() - t0
    pipe = LIVOPipeline(cfg, slam_mode=mode, device=device)
    t0 = time.perf_counter()
    traj = pipe.process(seq)
    wall = time.perf_counter() - t0
    out = {"mode": mode, "fused": fused, "device": str(pipe.device),
           "sequence_s": seq_s, "wall_s": wall,
           **gates(traj, seq, pipe), **cycle_counts(pipe)}
    return out, pipe, traj, seq


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m fast_livo2_tpu_torch.soak")
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--mode", default="livo", choices=["livo", "only_lio"])
    ap.add_argument("--fused", action="store_true",
                    help="tpu.fused_frame: one CUDA graph replay a frame")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    out, _, _, _ = run(args.duration, args.mode, args.fused, args.device)
    print(f"[soak] {out['frames']} frames in {out['wall_s']:.1f}s on "
          f"{out['device']} ({out['wall_s'] / max(out['frames'], 1) * 1e3:.0f}"
          " ms/frame incl. capture)")
    print(json.dumps(out))
    for msg in out["failed"]:
        print(f"[soak] FAIL: {msg}", file=sys.stderr)
    if out["failed"]:
        return 1
    print("[soak] PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())

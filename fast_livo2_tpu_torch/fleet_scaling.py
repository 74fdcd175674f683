"""Fleet-axis scaling: aggregate frames/s of B independent streams
stacked on one card, and placed one a card where the machine has more
than one (port of scripts/fleet_scaling.py, over
parallel/batch.MultiStreamReplay).

    python -m fast_livo2_tpu_torch.fleet_scaling [B ...] [--device cuda|cpu]

B defaults to 1 2 4. Every stream replays its own 3 s ONLY_LIO sequence
(12 x 500 points a scan, seeds 30 + b) at the script's reduced map
(8192 / 4096 points, 2^15 slots, 2 layers). The "placed" column is
measured only when torch.cuda.device_count() > 1 (stream b on
cuda:b); otherwise the table says it was not measured.
"""

import argparse
import time

import torch


def config():
    """scripts/fleet_scaling.py's configuration."""
    from .utils.config import LIVOConfig

    cfg = LIVOConfig()
    cfg.tpu.max_points_per_scan = 8192
    cfg.tpu.max_points_down = 4096
    cfg.tpu.hash_capacity_log2 = 15
    cfg.lio.max_layer = 1
    cfg.preprocess.filter_size_surf = 0.15
    return cfg


def sequences(B: int, duration: float = 3.0):
    """One sequence a stream: 12 x 500 points a scan, seeds 30 + b."""
    from .io import synthetic

    return [synthetic.make_sequence(duration=duration, lidar_hz=10.0,
                                    imu_hz=200.0, seed=30 + b, n_lines=12,
                                    n_per_line=500, render=False,
                                    fov_deg=360.0)
            for b in range(B)]


def run(B: int, devices, seqs=None, duration: float = 3.0):
    """B streams through MultiStreamReplay on `devices` (a list; one
    entry stacks every stream on that device). Returns (aggregate
    steady frames/s, the replay)."""
    from .parallel.batch import MultiStreamReplay

    seqs = seqs if seqs is not None else sequences(B, duration)
    mp = MultiStreamReplay(config(), batch=B, slam_mode="only_lio",
                           devices=devices)
    t0 = time.time()
    mp.process(seqs)
    fps = mp.n_frames / mp.wall_s if mp.wall_s > 0 else 0.0
    placed = len({str(d) for d in mp.devices}) > 1
    print(f"B={B} devices={'placed' if placed else 'single'} "
          f"({', '.join(str(d) for d in mp.devices)}): {mp.n_frames} frames "
          f"steady in {mp.wall_s:.1f}s -> {fps:.1f} frames/s aggregate "
          f"(total {time.time() - t0:.0f}s)")
    return fps, mp


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fast_livo2_tpu_torch.fleet_scaling")
    ap.add_argument("sizes", nargs="*", type=int, default=[1, 2, 4],
                    help="stream counts B (default 1 2 4)")
    ap.add_argument("--device", default="cuda",
                    help="device of the stacked streams (default cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    rows = []
    for B in args.sizes:
        seqs = sequences(B)
        single, _ = run(B, [dev], seqs)
        placed = None
        if n_cards > 1 and B > 1:
            placed, _ = run(B, [torch.device("cuda", b % n_cards)
                                for b in range(B)], seqs)
        rows.append((B, single, placed))
    if n_cards > 1:
        print("\n| B | single-device agg fps | placed agg fps | placed/single |")
        print("|---|---|---|---|")
        for B, f1, fp in rows:
            fp = f1 if fp is None else fp
            print(f"| {B} | {f1:.1f} | {fp:.1f} | {fp / max(f1, 1e-9):.2f}x |")
    else:
        print(f"\nplaced: not measured ({n_cards} CUDA device(s); placing "
              "streams one a card needs more than one)")
        print(f"\n| B | single-device agg fps ({dev}) |")
        print("|---|---|")
        for B, f1, _ in rows:
            print(f"| {B} | {f1:.1f} |")
    return rows


if __name__ == "__main__":
    main()

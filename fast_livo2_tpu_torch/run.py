"""Run the PyTorch port of the LIVO engine on a sequence directory: the
user's entry point, option for option that of scripts/run_livo.py, on
one NVIDIA GPU by default.

    python -m fast_livo2_tpu_torch.run --config configs/avia.yaml \\
        --camera configs/camera_pinhole.yaml --seq /data/seq01 \\
        --out /tmp/run01 [--mode livo] [--pcd] [--mesh] [--colmap] \\
        [--images] [--traces] [--checkpoint ck.npz] [--resume ck.npz] \\
        [--online-refine] [--max-frames N] [--device cuda|cpu]

The sequence directory uses the npz layout of io/dataset.py. The slam
mode defaults from the config's enable flags like the reference
(LIVMapper.cpp:162: imu_en off -> only_lo; img_en off -> only_lio).
Outputs: <out>/trajectory.txt (TUM) always; optionally the world cloud
(cloud.pcd), a TSDF mesh (mesh.ply), a COLMAP model, PNG dumps of the
frame ring and the mat_pre / mat_out state traces; one JSON summary line
on stdout (ATE, drift and RPE when gt.npz is present). A checkpoint
written with --checkpoint holds the rest of the stream, so --resume with
a sequence directory of only what came after it (or none of it: an empty
sequence, plus the images in LIVO mode) continues the run.

`--stage-table` sets tpu.stage_timing and prints the per-frame stage
table (propagate / undistort / downsample / lio / map / vio, device time
on the card) before the summary line. `--online-refine` turns on the
sliding-window backend at its defaults (LIVOPipeline.enable_online_refine:
a keyframe every 10 frames, a 16-keyframe window refined every 8 on its
own CUDA stream, its pose delta fed back) and writes the refined keyframe
trajectory to <out>/trajectory_refined.txt, with `refined_keyframes` in
the summary.
"""

import argparse
import json
import os
import time


def derive_mode(cfg) -> str:
    if not cfg.imu.imu_en:
        return "only_lo"
    if not cfg.common.img_en:
        return "only_lio"
    return "livo"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m fast_livo2_tpu_torch.run")
    ap.add_argument("--config", required=True, help="sensor yaml")
    ap.add_argument("--camera", default=None, help="camera yaml")
    ap.add_argument("--seq", required=True, help="npz sequence directory")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--mode", default=None,
                    choices=["livo", "only_lio", "only_lo"],
                    help="override the config-derived slam mode")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--pcd", action="store_true",
                    help="accumulate + write the colored world cloud")
    ap.add_argument("--mesh", action="store_true",
                    help="TSDF -> colored PLY mesh (implies --pcd)")
    ap.add_argument("--colmap", action="store_true")
    ap.add_argument("--images", action="store_true",
                    help="dump tracked-point overlay PNGs")
    ap.add_argument("--traces", action="store_true",
                    help="write mat_pre/mat_out state traces")
    ap.add_argument("--stage-table", action="store_true",
                    help="per-stage device timing (tpu.stage_timing): "
                         "print the per-frame stage table at the end")
    ap.add_argument("--online-refine", action="store_true",
                    help="run the sliding-window backend behind the filter "
                         "and write trajectory_refined.txt")
    ap.add_argument("--checkpoint", default=None,
                    help="write an engine snapshot at the end")
    ap.add_argument("--resume", default=None,
                    help="resume from a snapshot before processing")
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    from .core.pipeline import LIVOPipeline
    from .io import checkpoint as ck_mod
    from .io import dataset, export
    from .utils.config import load_config
    from .utils.evaluate import ape, rpe

    cfg = load_config(args.config, args.camera)
    mode = args.mode or derive_mode(cfg)
    if args.pcd or args.mesh:
        cfg.pcd_save.pcd_save_en = True
    if args.traces:
        cfg.evo.pose_output_en = True
    if args.stage_table:
        cfg.tpu.stage_timing = True

    seq = dataset.load_sequence(args.seq, cfg=cfg)
    pipe = LIVOPipeline(cfg, slam_mode=mode, device=args.device)
    if args.resume:
        ck_mod.load(args.resume, pipe)
    if args.online_refine:
        pipe.enable_online_refine()

    t0 = time.time()
    traj = pipe.process(seq, max_frames=args.max_frames,
                        progress=args.progress)
    wall = time.time() - t0
    if args.stage_table:
        pipe.print_stage_table(last_n=20)

    os.makedirs(args.out, exist_ok=True)
    export.write_tum(os.path.join(args.out, "trajectory.txt"), traj)
    summary = {
        "frames": len(traj),
        "mode": mode,
        "device": str(pipe.device),
        "wall_s": round(wall, 1),
        "fps": round(len(traj) / wall, 2) if wall > 0 else 0.0,
        "dropped_inputs": pipe.dropped_inputs,
    }
    if args.online_refine and pipe.refined_keyframes:
        export.write_tum(os.path.join(args.out, "trajectory_refined.txt"),
                         pipe.refined_keyframe_trajectory())
        summary["refined_keyframes"] = len(pipe.refined_keyframes)
    if args.pcd or args.mesh:
        summary["pcd_points"] = pipe.save_pcd(
            os.path.join(args.out, "cloud.pcd"))
    if args.mesh:
        summary["mesh_faces"] = pipe.save_mesh(
            os.path.join(args.out, "mesh.ply"))
        if pipe.mesh_seconds is not None:
            summary.update({f"mesh_{k}": round(v, 3)
                            for k, v in pipe.mesh_seconds.items()})
    if args.colmap:
        pipe.export_colmap(os.path.join(args.out, "colmap"))
    if args.images:
        summary["images"] = len(pipe.save_images(
            os.path.join(args.out, "images")))
    if args.traces:
        pipe.save_state_traces(os.path.join(args.out, "mat_pre.txt"),
                               os.path.join(args.out, "mat_out.txt"))
    if args.checkpoint:
        ck_mod.save(args.checkpoint, pipe)
    if seq.gt:
        est = [(t, R, p) for t, R, p in traj]
        stats = ape(seq.gt, est, align=True, max_dt=0.05)
        summary["ate_rmse_m"] = round(stats["rmse"], 4)
        r = rpe(seq.gt, est, delta=1.0, max_dt=0.05, ape_rmse=stats["rmse"])
        summary["drift_pct"] = round(r["drift_pct"], 4)
        summary["rpe_1s_m"] = round(r["rpe_rmse"], 4)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

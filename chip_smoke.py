#!/usr/bin/env python3
"""Drive the PyTorch port's main paths (ONLY_LIO and full LIVO) on one
NVIDIA GPU and hold every hand-written kernel of those paths against its
plain PyTorch version.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and the CUDA
toolkit (nvcc). The kernels are compiled from `fast_livo2_tpu_torch/csrc/`
into `build/kernels/` at first use. Phases, each printing one JSON line:

  1. device         the card, torch/CUDA versions, the float32 precision
                    policy;
  2. build          nvcc builds of every kernel source, started together;
  3. kernel         K1 (cov_scan) against its plain version on the card at
                    the main path's shapes (K = 64, D = 19), both timed;
  4. kernel_photo   K2 (photo_iteration) against its plain version on a
                    rendered 640 x 512 frame with M = 396 points, stride
                    exponents 0-5 (the clamp to 4 bites), some points
                    masked, with and without distortion; both timed;
  5. pipeline       the full-width ONLY_LIO sequence on "cuda": frames,
                    ATE against ground truth, per-frame wall time, host
                    syncs per frame, K1 launches;
  6. parity         its first frames again on "cpu" (plain versions), held
                    to the golden-trace tolerances against the card's run;
  7. profile        steady ONLY_LIO frames under torch.profiler: kernel
                    time, idle share and launches per frame, the costliest
                    kernels;
  8-10. pipeline_livo, parity_livo, profile_livo: the same three for the
                    full-width LIVO sequence (the ONLY_LIO scans plus
                    bench.py's rendered images), with the tracked-point
                    gate, K2 launches against the photometric iterations
                    the pipeline counted, and K2's share of device time.

Then the `kernels` line, the card's name and power limit, and as the last
line {"ok": true, "device": {...}}. Any failed phase exits non-zero before
that line; there is no CPU fallback. Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

# The port runs without JAX: make any import of it fail loudly here.
sys.modules["jax"] = None
sys.modules["fast_livo2_tpu"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet), at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

K_MAIN, D_STATE = 64, 19  # cov_scan shapes on the main path
RTOL_K1, ATOL_K1 = 2e-4, 2e-5  # tests/test_imu.py:176-177
M_MAIN = 396  # tracked-point slots: the 22 x 18 grid of a 640 x 512 frame
# K2: each HTH / HTz entry within 1e-4 of the plain block's largest
# absolute entry plus rtol 2e-4 (the card sums in another order); err
# rtol 1e-4; cnt exact.
RTOL_K2, BLOCK_ATOL_K2, RTOL_ERR_K2 = 2e-4, 1e-4, 1e-4
# K2 operations: per pixel 5 bilinear evaluations (35), du/dv (4), the
# residual (2), ten products and their sums (20); per point about 600
# (projection, Jacobian coefficients, the 64-float row); then one add
# per row entry in the sum over points.
FLOP_PER_PIXEL, FLOP_PER_POINT = 61, 600
ATE_GATE_M = 0.05  # tests/test_pipeline_lio.py ONLY_LIO gate
TRACKED_GATE = 20  # tests/test_pipeline_livo.py:87
POS_TOL_M, ROT_TOL = 8e-3, 4e-3  # tests/test_golden_trace.py tolerances
PARITY_FRAMES = 10
PARITY_FRAMES_LIVO = 8


class PhaseError(RuntimeError):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def time_cuda(fn, reps=7, calls=100, warmup=20):
    """Milliseconds per call of fn(): CUDA events around `calls`
    back-to-back calls, the median of `reps` such runs after `warmup`
    calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def device_ms(fn, names, calls=50):
    """Device time per call of fn(), summed over the kernels whose names
    contain one of `names`, from torch.profiler over `calls` calls. Where
    the host cannot enqueue calls faster than the card runs them, this is
    below time_cuda's per-call time, which then measures the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(n in e.name for n in names))
    return us / 1e3 / calls


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the two least times."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_device():
    from fast_livo2_tpu_torch.ops import precision

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    check(precision.policy_ok(), f"float32 precision policy off: {precision.policy()}")
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "precision": precision.policy()})
    return smi


def phase_build():
    from fast_livo2_tpu_torch.ops import _build

    names = _build.sources()
    t0 = time.perf_counter()
    libs = _build.build(names)
    emit({"phase": "build", "kernels": names,
          "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(p) for p in libs.values()]})


def k1_inputs(K, D, seed=3):
    """tests/test_imu.py:156-163's construction."""
    rng = np.random.default_rng(seed)
    F = (np.eye(D)[None] + rng.normal(size=(K, D, D)) * 0.02).astype(np.float32)
    Q = rng.normal(size=(K, D, D)) * 0.01
    Q = np.einsum("kij,klj->kil", Q, Q).astype(np.float32)
    P0 = rng.normal(size=(D, D)) * 0.1
    P0 = (P0 @ P0.T + np.eye(D) * 0.01).astype(np.float32)
    return F, Q, P0


def phase_kernel():
    from fast_livo2_tpu_torch.ops import cov_scan

    F, Q, P0 = (torch.from_numpy(a).cuda() for a in k1_inputs(K_MAIN, D_STATE))
    got = cov_scan.propagate_cov(F, Q, P0)
    torch.cuda.synchronize()
    want = cov_scan.propagate_cov_plain(F, Q, P0)
    err = (got - want).abs()
    max_abs_err = float(err.max())
    ok = bool(torch.all(err <= ATOL_K1 + RTOL_K1 * want.abs()))
    check(torch.isfinite(got).all().item(), "cov_scan kernel: non-finite output")
    check(ok, f"cov_scan kernel disagrees with its plain version: "
              f"max_abs_err {max_abs_err}")
    ms = time_cuda(lambda: cov_scan.propagate_cov(F, Q, P0))
    dev_ms = device_ms(lambda: cov_scan.propagate_cov(F, Q, P0),
                       ["cov_scan_kernel"])
    plain_ms = time_cuda(lambda: cov_scan.propagate_cov_plain(F, Q, P0))
    # Least time for the same work: each input read once, the output
    # written once; two D x D x D products per step, 2 FLOP per FMA.
    nbytes = (2 * K_MAIN * D_STATE * D_STATE + 2 * D_STATE * D_STATE) * 4
    flops = K_MAIN * 4 * D_STATE ** 3
    bound_ms, bound_by = bound(nbytes, flops)
    row = {"name": "cov_scan.propagate_cov", "route": "cuda",
           "source": "fast_livo2_tpu_torch/csrc/cov_scan.cu",
           "replaces": "fast_livo2_tpu/ops/cov_scan.py:69",
           "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           # No single PyTorch call computes this K-step recursion.
           "library_ms": None}
    emit({"phase": "kernel", "K": K_MAIN, "D": D_STATE, "rtol": RTOL_K1,
          "atol": ATOL_K1, "bytes": nbytes, "flops": flops,
          "device_ms": dev_ms, **row})
    return row


def k2_inputs(img, with_dist, seed=7, M=M_MAIN):
    """M points spread over the frame 1.5-8 m ahead of the camera, stride
    exponents 0-5, about 10 % masked out, the camera pose at the origin
    and the forward mount's Jacobian blocks."""
    from fast_livo2_tpu_torch.io import synthetic
    from fast_livo2_tpu_torch.models import camera
    from fast_livo2_tpu_torch.ops import photo_iteration as photo

    cam = camera.make_camera(camera_config())
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.5, 8.0, M)
    uv = rng.uniform([-0.75, -0.6], [0.75, 0.6], size=(M, 2))
    pos = np.concatenate([uv * z[:, None], z[:, None]], -1).astype(np.float32)
    ref = rng.uniform(0.0, 255.0, size=(M, 64)).astype(np.float32)
    slog = rng.integers(0, 6, M).astype(np.int32)
    ok = rng.random(M) > 0.1
    dev = img.device
    meta, refp = photo.pack_points(*(torch.from_numpy(a).to(dev)
                                     for a in (pos, ref, slog, ok)))
    Rci = torch.from_numpy(synthetic.R_CI_FORWARD.astype(np.float32)).to(dev)
    dist = [0.02, -0.01, 0.001, -0.002] if with_dist else [0.0] * 4
    par = photo.pack_params(torch.eye(3, device=dev), torch.zeros(3, device=dev),
                            torch.tensor(1.05, device=dev), Rci, 0.0 * Rci,
                            cam.fx, cam.fy, cam.cx, cam.cy, dist, 1.0,
                            1.0 if with_dist else 0.0)
    return img, meta, refp, par


def phase_kernel_photo(seq):
    from fast_livo2_tpu_torch.ops import photo_iteration as photo

    frame = seq.images[len(seq.images) // 2][1]  # a rendered 512 x 640 frame
    img = torch.from_numpy(np.ascontiguousarray(frame, np.float32)).cuda()
    max_abs_err = max_rel_err = 0.0
    for with_dist in (False, True):
        args = k2_inputs(img, with_dist)
        got = photo.photo_iteration(*args)
        torch.cuda.synchronize()
        want = photo.photo_iteration_plain(*args)
        for name, g, w in zip(("HTH", "HTz"), got[:2], want[:2]):
            check(torch.isfinite(g).all().item(), f"K2 kernel: non-finite {name}")
            tol = BLOCK_ATOL_K2 * float(w.abs().max()) + RTOL_K2 * w.abs()
            d = (g - w).abs()
            max_abs_err = max(max_abs_err, float(d.max()))
            max_rel_err = max(max_rel_err, float(d.max() / w.abs().max()))
            check(bool(torch.all(d <= tol)),
                  f"K2 kernel {name} disagrees with its plain version "
                  f"(dist={with_dist}): max_abs_err {float(d.max())}")
        d_err = abs(float(got[2]) - float(want[2]))
        max_abs_err = max(max_abs_err, d_err)
        check(d_err <= RTOL_ERR_K2 * abs(float(want[2])),
              f"K2 kernel err {float(got[2])} vs plain {float(want[2])}")
        check(float(got[3]) == float(want[3]),
              f"K2 kernel cnt {float(got[3])} vs plain {float(want[3])}")
    args = k2_inputs(img, False)
    ms = time_cuda(lambda: photo.photo_iteration(*args))
    dev_ms = device_ms(lambda: photo.photo_iteration(*args),
                       ["photo_rows_kernel", "photo_sum_kernel"])
    plain_ms = time_cuda(lambda: photo.photo_iteration_plain(*args), calls=20)
    # Least time: the distinct image taps the windows read, the point
    # inputs and the parameter row read once, the 64-float output written
    # once; FP32 operations as counted at FLOP_PER_*.
    M = args[1].shape[0]
    taps = int(torch.unique(photo.window_taps(img.shape, args[1], args[3])).numel())
    nbytes = (taps + M * (photo.META_W + 64) + photo.PAR_W + photo.OUT_W) * 4
    flops = M * (64 * FLOP_PER_PIXEL + FLOP_PER_POINT) + M * photo.OUT_W
    bound_ms, bound_by = bound(nbytes, flops)
    row = {"name": "photo_iteration.photo_iteration", "route": "cuda",
           "source": "fast_livo2_tpu_torch/csrc/photo_iteration.cu",
           "replaces": "fast_livo2_tpu/ops/pallas_photo.py:204",
           "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           # No single PyTorch call computes the fused projection, strided
           # bilinear sampling, Jacobian chain and 7 x 7 reduction.
           "library_ms": None}
    emit({"phase": "kernel_photo", "M": M, "H": int(img.shape[0]),
          "W": int(img.shape[1]), "slog_max": 5,
          "max_scale_log2": photo.clamp_scale_log2(int(img.shape[1])),
          "rtol": RTOL_K2, "block_atol": BLOCK_ATOL_K2,
          "max_err_over_block_max": max_rel_err, "distinct_taps": taps,
          "bytes": nbytes, "flops": flops, "device_ms": dev_ms, **row})
    return row


def camera_config():
    """bench.py:130-133's camera: 640 x 512 pinhole, f = 400 px."""
    from fast_livo2_tpu_torch.utils.config import CameraConfig

    return CameraConfig(cam_model="Pinhole", cam_width=640, cam_height=512,
                        scale=1.0, cam_fx=400.0, cam_fy=400.0, cam_cx=320.0,
                        cam_cy=256.0)


def full_width_sequence():
    """bench.py's core sequence (bench.py:128-151) at 6 s: ~24k points a
    scan, 10 Hz scans, 200 Hz IMU, 10 Hz 640 x 512 images through the
    forward camera mount, with bench.py's DEGRADE image and LiDAR noise.
    The images are drawn after the scans, so the scans are the same draws
    as a run without images."""
    from fast_livo2_tpu_torch.io import synthetic
    from fast_livo2_tpu_torch.models import camera

    return synthetic.make_sequence(
        duration=6.0, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0,
        cam=camera.make_camera(camera_config()), seed=0, n_lines=24,
        n_per_line=1000, render=True, fov_deg=360.0, img_photon_noise=1.2,
        img_read_noise=2.5, img_blur_px=0.6, range_noise=0.02,
        lidar_dropout=0.05, lidar_outlier_frac=0.005)


def full_width_config():
    """LIVOConfig() defaults with bench.py:155-158's camera, Rcl and
    filter_size_surf = 0.15: 32768 points a scan, 8192 after
    downsampling, 3 map layers of 2^18 slots, 5 LIO iterations; a 65536-
    point visual pool, 4 pyramid levels x 5 photometric iterations."""
    from fast_livo2_tpu_torch.io import synthetic
    from fast_livo2_tpu_torch.utils.config import LIVOConfig

    cfg = LIVOConfig()
    cfg.camera = camera_config()
    cfg.extrin_calib.Rcl = list(synthetic.R_CI_FORWARD.reshape(-1))
    cfg.extrin_calib.Pcl = [0.0, 0.0, 0.0]
    cfg.preprocess.filter_size_surf = 0.15
    return cfg


def _events(pipe):
    """The pipeline's queued event times (camera frames in LIVO mode)."""
    if pipe._use_images:
        return [t for t, _ in pipe._img_queue]
    return list(pipe._scan_events)


def drive(pipe):
    """poll(max_frames=1) until the queue is empty, each frame timed on
    its own with its synchronizing CUDA calls counted. Returns (frame_ms,
    syncs per frame)."""
    frame_ms, syncs = [], []
    while _events(pipe):
        t0 = time.perf_counter()
        # Every synchronizing CUDA call inside the frame (a device-to-host
        # read, a blocking copy) raises one warning in this mode.
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                n = pipe.poll(max_frames=1, flush=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if n:
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            syncs.append(sum("synchronizing CUDA operation" in str(w.message)
                             for w in caught))
    return frame_ms, syncs


def phase_pipeline(seq, mode):
    """The full-width sequence on "cuda" in `mode` (only_lio or livo):
    process(seq) unrolled so that each frame is timed on its own. The
    kernels' launch counts are set to 0 just before the run and read just
    after it."""
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
    from fast_livo2_tpu_torch.io import synthetic
    from fast_livo2_tpu_torch.ops import cov_scan
    from fast_livo2_tpu_torch.ops import photo_iteration as photo

    cfg = full_width_config()
    pipe = LIVOPipeline(cfg, mode, device="cuda")
    pipe.push_sequence(seq)
    events = _events(pipe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cov_scan.LAUNCHES = 0
    photo.LAUNCHES = 0
    frame_ms, syncs = drive(pipe)
    launches = {"cov_scan": cov_scan.LAUNCHES, "photo_iteration": photo.LAUNCHES}
    pipe._finalize_host_views()
    traj = pipe.trajectory
    frames = len(traj)
    check(frames == len(frame_ms), f"{frames} trajectory rows for "
                                   f"{len(frame_ms)} frames run")
    # Every event after the one that completes the IMU static init
    # (imu_int_frame samples) must have run as a frame.
    need = max(cfg.imu.imu_int_frame, 5)
    n_imu = np.searchsorted(seq.imu_stamps, events, side="right")
    i_init = int(np.argmax(n_imu >= need))
    check([t for t, _, _ in traj] == events[i_init + 1:],
          f"ran {frames} frames for {len(events) - i_init - 1} events")
    ps = np.array([p for _, _, p in traj])
    Rs = np.array([R for _, R, _ in traj])
    check(np.isfinite(ps).all() and np.isfinite(Rs).all(),
          "non-finite trajectory")
    ate = synthetic.ate_rmse([(t, p) for t, _, p in traj], seq.gt)
    check(ate < ATE_GATE_M, f"{mode}: ATE {ate} m >= {ATE_GATE_M} m")
    # Every frame (the map-building first one included) propagates
    # through the IMU batch once.
    check(launches["cov_scan"] == frames,
          f"cov_scan launched {launches['cov_scan']} times in {frames} frames")
    steady = frame_ms[1:]  # frame 0 builds the map and warms the caches
    out = {"phase": "pipeline" if mode == "only_lio" else "pipeline_livo",
           "mode": mode, "frames": frames, "ate_rmse_m": ate,
           "first_frame_ms": frame_ms[0],
           "median_frame_ms": statistics.median(steady),
           "p90_frame_ms": float(np.percentile(steady, 90)),
           "host_syncs_per_frame_median": statistics.median(syncs[1:]),
           "host_syncs_per_frame_max": max(syncs[1:]),
           "cov_scan_launches": launches["cov_scan"],
           "mean_n_eff": float(np.mean([r["n_eff"] for r in pipe.log.rows[1:]])),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "points_per_scan": int(np.median([len(p) for _, p, _ in seq.scans]))}
    if mode == "livo":
        vio_frames = frames - 1  # the map-building first frame runs no VIO
        tracked = [r["n_tracked"] for r in pipe.log.rows[3:]]
        check(np.mean(tracked) > TRACKED_GATE,
              f"mean n_tracked {np.mean(tracked)} <= {TRACKED_GATE}")
        check(launches["photo_iteration"] == pipe.photo_iterations > 0,
              f"photo_iteration launched {launches['photo_iteration']} times "
              f"for {pipe.photo_iterations} photometric iterations")
        max_iters = cfg.vio.patch_pyrimid_level * cfg.vio.max_iterations
        check(pipe.photo_iterations <= max_iters * vio_frames,
              f"{pipe.photo_iterations} photometric iterations in "
              f"{vio_frames} VIO frames")
        out.update({
            "mean_n_tracked": float(np.mean(tracked)),
            "mean_n_added": float(np.mean([r["n_added"] for r in pipe.log.rows[1:]])),
            "photo_iterations": pipe.photo_iterations,
            "photo_iterations_per_vio_frame": pipe.photo_iterations / vio_frames,
            "photo_iteration_launches": launches["photo_iteration"]})
    else:
        check(launches["photo_iteration"] == 0,
              "photo_iteration launched on the ONLY_LIO path")
    emit(out)
    return traj, launches


def phase_parity(seq, traj_cuda, mode, frames):
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    pipe = LIVOPipeline(full_width_config(), mode, device="cpu")
    t0 = time.perf_counter()
    traj_cpu = pipe.process(seq, max_frames=frames)
    secs = time.perf_counter() - t0
    check(len(traj_cpu) == frames, f"cpu run gave {len(traj_cpu)} frames")
    ts_c = np.array([t for t, _, _ in traj_cpu])
    ts_g = np.array([t for t, _, _ in traj_cuda[:frames]])
    dp = max(float(np.abs(a[2] - b[2]).max())
             for a, b in zip(traj_cpu, traj_cuda))
    dR = max(float(np.abs(a[1] - b[1]).max())
             for a, b in zip(traj_cpu, traj_cuda))
    check(np.array_equal(ts_c, ts_g), "cpu and cuda runs cut different frames")
    check(dp <= POS_TOL_M and dR <= ROT_TOL,
          f"{mode} cpu vs cuda: position {dp} m (tol {POS_TOL_M}), "
          f"rotation {dR} (tol {ROT_TOL})")
    emit({"phase": "parity" if mode == "only_lio" else "parity_livo",
          "frames": frames, "max_pos_diff_m": dp, "max_rot_diff": dR,
          "pos_tol_m": POS_TOL_M, "rot_tol": ROT_TOL, "cpu_seconds": secs})


def phase_profile(seq, mode, warm=12, frames=10, top=8):
    """Where a steady frame's time goes: `frames` frames after `warm`
    unprofiled ones, under torch.profiler. Reports wall and summed kernel
    time per frame, the device's idle share of the wall time, the kernel
    launches per frame, the kernels that take the most time and K2's
    share of the kernel time."""
    from torch.profiler import ProfilerActivity, profile

    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    pipe = LIVOPipeline(full_width_config(), mode, device="cuda")
    pipe.push_sequence(seq)
    pipe.poll(max_frames=warm, flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = pipe.poll(max_frames=frames, flush=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(n == frames, f"profiled {n} frames, wanted {frames}")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3  # us -> ms
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    k2_ms = sum(v for k, v in by_name.items()
                if "photo_rows_kernel" in k or "photo_sum_kernel" in k)
    emit({"phase": "profile" if mode == "only_lio" else "profile_livo",
          "frames": frames,
          "wall_ms_per_frame": wall_ms / frames,
          "kernel_ms_per_frame": busy_ms / frames,
          "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
          "kernel_launches_per_frame": len(kernels) / frames,
          "photo_iteration_ms_per_frame": k2_ms / frames,
          "photo_iteration_share_of_kernel_time": (k2_ms / busy_ms) if busy_ms else None,
          "top_kernels_ms_per_frame": [[k[:90], v / frames] for k, v in ranked]})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import fast_livo2_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        smi = phase_device()
        phase_build()
        k1 = phase_kernel()
        t0 = time.perf_counter()
        seq = full_width_sequence()
        emit({"phase": "sequence", "scans": len(seq.scans),
              "images": len(seq.images), "seconds": time.perf_counter() - t0})
        k2 = phase_kernel_photo(seq)
        traj, _ = phase_pipeline(seq, "only_lio")
        phase_parity(seq, traj, "only_lio", PARITY_FRAMES)
        phase_profile(seq, "only_lio")
        traj, launches = phase_pipeline(seq, "livo")
        phase_parity(seq, traj, "livo", PARITY_FRAMES_LIVO)
        phase_profile(seq, "livo")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches: the LIVO main path's run, which goes through both kernels
    k1["launches"] = launches["cov_scan"]
    k2["launches"] = launches["photo_iteration"]
    emit({"kernels": [k1, k2]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's main paths (ONLY_LIO, full LIVO and the user's
run through the CLI, with its outputs and checkpoint/resume) on one
NVIDIA GPU and hold every hand-written kernel against its plain PyTorch
version.

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
                    rendered 640 x 512 frame with M in {0, 1, 7, 9, 396,
                    4096} points (396 on the main path), stride exponents
                    0-5 (the clamp to 4 bites), some points masked, with
                    and without distortion; bitwise the same over 20
                    calls and across calls at another M (the last-block
                    ticket is reset); one device kernel a call; timed;
  4b. side_stream   the three wrappers once on a side stream
                    (torch.cuda.stream(s)) against their plain versions,
                    and the raw stream the launch path reads equal to
                    s.cuda_stream;
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
                    the pipeline counted, and K2's share of device time;
  11. kernel_gather K3 (gather_rows) against table[idx], bit for bit, at
                    the LIO map's shape (262,144 x 128 table, 8,192 rows),
                    the JAX test's, an odd width and an unaligned view;
                    event times of K3 and torch.index_select in turns
                    (library, kernel, kernel, library), device, plain and
                    host times, and the wrapper's host time step by step.
                    No path runs K3 (as in the JAX package): its main-path
                    launches are 0, its phase's count beside them;
  12. run_cli       the user's run: the LIVO sequence saved as an npz
                    sequence under build/, a sensor yaml of the same
                    config, and `python -m fast_livo2_tpu_torch.run` with
                    every output and a checkpoint, in process on "cuda":
                    frames, ATE, the cloud, the TSDF mesh (integration on
                    the card, extraction on the host, each timed), COLMAP,
                    PNGs and traces;
  13. resume        LIVO to half the frames and saved; the saving pipeline
                    then runs on uninterrupted, while a fresh pipeline
                    loads the checkpoint (every tensor bit for bit), runs
                    the rest and is held to the golden tolerances against
                    it; IMU-rate poses read before its last frame.

Then the `kernels` line, the card's name and power limit, and as the last
line {"ok": true, "device": {...}}. Any failed phase exits non-zero before
that line; there is no CPU fallback. Imports nothing of JAX. Every
kernel phase reports `ms` (CUDA events around 100 back-to-back calls),
`host_us` (time.perf_counter around 1,000 calls), `device_ms` and the
device kernels a call (torch.profiler).

    python3 chip_smoke.py --turns OTHER_ROOT

times the three wrappers and torch.index_select and profiles steady
LIVO frames (`kernel_times`) in four processes in turns, OTHER_ROOT's
package, this one's, this one's, OTHER_ROOT's (e.g. the parent commit
unpacked with `git archive` under build/), each building its own
kernels, and prints one `turns` line. `--kernel-times ROOT` is one such
process.
"""

import contextlib
import io
import itertools
import json
import os
import shutil
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
# K3: (C, W, N, group) — the LIO map's gather (2^18 slots of 128 floats,
# 8,192 downsampled points), tests/test_eig3.py's shape, an odd width.
GATHER_SHAPES = ((262144, 128, 8192, 128), (2048, 128, 512, 64),
                 (2048, 13, 512, 64))
GATHER_INDEX_SETS = 16  # 16 x 4 MiB of distinct rows > the 50 MB L2
K2_SWEEP = (0, 1, 7, 9, M_MAIN, 4096)  # a block holds 8 points
K2_REPEATS = 20
REPO = os.path.dirname(os.path.abspath(__file__))


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


def host_us(fn, calls=1000, batch=100, warmup=20):
    """Host microseconds per call of fn(): time.perf_counter around
    `calls` calls after `warmup`, `batch` at a time with an untimed
    synchronize between batches, so that the launch queue never fills
    and blocks the host on the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // batch):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / calls * 1e6


def device_profile(fn, calls=50):
    """(device kernels a call, {kernel name: device ms a call}) of fn(),
    from torch.profiler over `calls` calls, recorded in the second of two
    cycles (the first warms the tracer up: events right after it starts
    can be missed). Where the host cannot enqueue calls faster than the
    card runs them, the device time is below time_cuda's per-call time,
    which then measures the host."""
    from torch.profiler import ProfilerActivity, profile, schedule

    recorded = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: recorded.append(
                     [(e.name, e.device_time) for e in p.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA])) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    by_name = {}
    for name, us in recorded[-1]:
        by_name[name] = by_name.get(name, 0.0) + us / 1e3 / calls
    return len(recorded[-1]) / calls, by_name


def timings(fn, event=True):
    """A wrapper's times: event ms (unless `event` is false), host us and
    device ms a call, the device kernels a call and their device ms by
    kernel name."""
    per_call, by_name = device_profile(fn)
    return {**({"ms": time_cuda(fn)} if event else {}), "host_us": host_us(fn),
            "device_ms": sum(by_name.values()),
            "device_kernels_per_call": per_call,
            "device_ms_by_kernel": {k[:90]: v for k, v in by_name.items()}}


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the two least times."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def phase_device():
    from fast_livo2_tpu_torch.ops import precision

    smi = nvidia_smi()
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
    t = timings(lambda: cov_scan.propagate_cov(F, Q, P0))
    check(t["device_kernels_per_call"] == 1,
          f"cov_scan: {t['device_kernels_per_call']} device kernels a call")
    plain_ms = time_cuda(lambda: cov_scan.propagate_cov_plain(F, Q, P0))
    # Least time for the same work: each input read once, the output
    # written once; two D x D x D products per step, 2 FLOP per FMA.
    nbytes = (2 * K_MAIN * D_STATE * D_STATE + 2 * D_STATE * D_STATE) * 4
    flops = K_MAIN * 4 * D_STATE ** 3
    bound_ms, bound_by = bound(nbytes, flops)
    row = {"name": "cov_scan.propagate_cov", "route": "cuda",
           "source": "fast_livo2_tpu_torch/csrc/cov_scan.cu",
           "replaces": "fast_livo2_tpu/ops/cov_scan.py:69",
           "max_abs_err": max_abs_err, "ms": t["ms"], "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           # No single PyTorch call computes this K-step recursion.
           "library_ms": None, "device_ms": t["device_ms"],
           "host_us": t["host_us"]}
    emit({"phase": "kernel", "K": K_MAIN, "D": D_STATE, "rtol": RTOL_K1,
          "atol": ATOL_K1, "bytes": nbytes, "flops": flops, **t, **row})
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


def check_k2(got, want, what):
    """Hold one K2 result to its plain version at the stated tolerances.
    Returns (max_abs_err, max_err_over_block_max)."""
    max_abs = max_rel = 0.0
    for name, g, w in zip(("HTH", "HTz"), got[:2], want[:2]):
        check(torch.isfinite(g).all().item(), f"K2 {what}: non-finite {name}")
        w_max = float(w.abs().max())
        d = (g - w).abs()
        max_abs = max(max_abs, float(d.max()))
        if w_max:
            max_rel = max(max_rel, float(d.max()) / w_max)
        check(bool(torch.all(d <= BLOCK_ATOL_K2 * w_max + RTOL_K2 * w.abs())),
              f"K2 {what}: {name} disagrees with its plain version: "
              f"max_abs_err {float(d.max())}")
    d_err = abs(float(got[2]) - float(want[2]))
    check(d_err <= RTOL_ERR_K2 * abs(float(want[2])),
          f"K2 {what}: err {float(got[2])} vs plain {float(want[2])}")
    check(float(got[3]) == float(want[3]),
          f"K2 {what}: cnt {float(got[3])} vs plain {float(want[3])}")
    return max(max_abs, d_err), max_rel


def k2_flat(out):
    """The four outputs of one K2 call as one (58,) tensor."""
    return torch.cat([out[0].reshape(-1), out[1], out[2].reshape(1),
                      out[3].reshape(1)])


def phase_kernel_photo(seq):
    from fast_livo2_tpu_torch.ops import photo_iteration as photo

    frame = seq.images[len(seq.images) // 2][1]  # a rendered 512 x 640 frame
    img = torch.from_numpy(np.ascontiguousarray(frame, np.float32)).cuda()
    max_abs_err = max_rel_err = 0.0  # at the main path's M
    sweep_err = 0.0
    for M in K2_SWEEP:
        for with_dist in (False, True):
            args = k2_inputs(img, with_dist, M=M)
            before = photo.LAUNCHES
            got = photo.photo_iteration(*args)
            torch.cuda.synchronize()
            check(photo.LAUNCHES == before + 1, "K2: no launch counted")
            a, r = check_k2(got, photo.photo_iteration_plain(*args),
                            f"M={M} dist={with_dist}")
            sweep_err = max(sweep_err, r)
            if M == M_MAIN:
                max_abs_err, max_rel_err = max(max_abs_err, a), max(max_rel_err, r)
    # The same bits from run to run, with calls at other M (other grids,
    # so another block draws the last ticket) in between.
    args = k2_inputs(img, False)
    others = [k2_inputs(img, False, M=M) for M in (7, 4096)]
    first = k2_flat(photo.photo_iteration(*args))
    for k in range(K2_REPEATS):
        check(torch.equal(k2_flat(photo.photo_iteration(*args)), first),
              f"K2 not bitwise repeatable at call {k + 1}")
        photo.photo_iteration(*others[k % 2])
    t = timings(lambda: photo.photo_iteration(*args))
    check(t["device_kernels_per_call"] == 1
          and all("photo_iteration_kernel" in k for k in t["device_ms_by_kernel"]),
          f"K2: device kernels a call {t['device_kernels_per_call']}: "
          f"{list(t['device_ms_by_kernel'])}")
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
           "max_abs_err": max_abs_err, "ms": t["ms"], "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           # No single PyTorch call computes the fused projection, strided
           # bilinear sampling, Jacobian chain and 7 x 7 reduction.
           "library_ms": None, "device_ms": t["device_ms"],
           "host_us": t["host_us"]}
    emit({"phase": "kernel_photo", "M": M, "H": int(img.shape[0]),
          "W": int(img.shape[1]), "slog_max": 5,
          "max_scale_log2": photo.clamp_scale_log2(int(img.shape[1])),
          "rtol": RTOL_K2, "block_atol": BLOCK_ATOL_K2,
          "max_err_over_block_max": max_rel_err, "M_sweep": list(K2_SWEEP),
          "sweep_max_err_over_block_max": sweep_err,
          "bitwise_repeats": K2_REPEATS, "distinct_taps": taps,
          "bytes": nbytes, "flops": flops, **t, **row})
    return row, img


def phase_side_stream(img):
    """Each wrapper launched once inside torch.cuda.stream(side), held
    against its plain version; the raw stream the launch path reads
    there is the side stream's."""
    from fast_livo2_tpu_torch.ops import _launch, cov_scan, gather
    from fast_livo2_tpu_torch.ops import photo_iteration as photo

    F, Q, P0 = (torch.from_numpy(a).cuda() for a in k1_inputs(K_MAIN, D_STATE))
    k2 = k2_inputs(img, True)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(4096, 128)).astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.integers(0, 4096, 1024).astype(np.int32)).cuda()
    counts = (cov_scan.LAUNCHES, photo.LAUNCHES, gather.LAUNCHES)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        raw = _launch.raw_stream(torch.cuda.current_device())
        cov = cov_scan.propagate_cov(F, Q, P0)
        pho = photo.photo_iteration(*k2)
        gat = gather.gather_rows(table, idx)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    check(raw == side.cuda_stream != torch.cuda.current_stream().cuda_stream,
          f"raw stream {raw}, side stream {side.cuda_stream}")
    check((cov_scan.LAUNCHES, photo.LAUNCHES, gather.LAUNCHES)
          == tuple(c + 1 for c in counts), "side stream: launches not counted")
    want = cov_scan.propagate_cov_plain(F, Q, P0)
    check(bool(torch.all((cov - want).abs() <= ATOL_K1 + RTOL_K1 * want.abs())),
          "K1 on a side stream disagrees with its plain version")
    check_k2(pho, photo.photo_iteration_plain(*k2), "side stream")
    check(torch.equal(gat, gather.gather_rows_plain(table, idx)),
          "K3 on a side stream differs from table[idx]")
    emit({"phase": "side_stream", "stream": side.cuda_stream,
          "raw_stream_equal": True, "kernels": ["cov_scan", "photo_iteration",
                                                "gather_rows"]})


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
    from fast_livo2_tpu_torch.ops import cov_scan, gather
    from fast_livo2_tpu_torch.ops import photo_iteration as photo

    cfg = full_width_config()
    pipe = LIVOPipeline(cfg, mode, device="cuda")
    pipe.push_sequence(seq)
    events = _events(pipe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cov_scan.LAUNCHES = 0
    photo.LAUNCHES = 0
    gather.LAUNCHES = 0
    frame_ms, syncs = drive(pipe)
    launches = {"cov_scan": cov_scan.LAUNCHES, "photo_iteration": photo.LAUNCHES,
                "gather_rows": gather.LAUNCHES}
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
           "gather_rows_launches": launches["gather_rows"],
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


def is_k2_kernel(name):
    """A device kernel of K2: this tree's one kernel, or either stage of
    the two-launch design it replaced (photo_rows_kernel, then
    photo_sum_kernel), so that `--kernel-times` counts an older tree's."""
    return any(k in name for k in ("photo_iteration_kernel",
                                   "photo_rows_kernel", "photo_sum_kernel"))


def phase_profile(seq, mode, warm=12, frames=10, top=8):
    emit({"phase": "profile" if mode == "only_lio" else "profile_livo",
          **profile_frames(seq, mode, warm, frames, top)})


def profile_frames(seq, mode, warm=12, frames=10, top=8):
    """Where a steady frame's time goes: `frames` frames after `warm`
    unprofiled ones, under torch.profiler. Reports wall and summed kernel
    time per frame, the device's idle share of the wall time, the kernel
    launches per frame, the kernels that take the most time, K2's share
    of the kernel time, its device kernels and the photometric iterations
    the frames ran (the launches a frame move with them)."""
    from torch.profiler import ProfilerActivity, profile

    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    pipe = LIVOPipeline(full_width_config(), mode, device="cuda")
    pipe.push_sequence(seq)
    pipe.poll(max_frames=warm, flush=True)
    torch.cuda.synchronize()
    iterations = pipe.photo_iterations
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = pipe.poll(max_frames=frames, flush=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    iterations = pipe.photo_iterations - iterations
    check(n == frames, f"profiled {n} frames, wanted {frames}")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3  # us -> ms
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    k2_ms = sum(v for k, v in by_name.items() if is_k2_kernel(k))
    k2_kernels = sum(is_k2_kernel(e.name) for e in kernels)
    return {"frames": frames,
            "wall_ms_per_frame": wall_ms / frames,
            "kernel_ms_per_frame": busy_ms / frames,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
            "kernel_launches_per_frame": len(kernels) / frames,
            "photo_iteration_ms_per_frame": k2_ms / frames,
            "photo_iteration_kernels_per_frame": k2_kernels / frames,
            "photo_iterations_per_frame": iterations / frames,
            "photo_iteration_share_of_kernel_time": (k2_ms / busy_ms) if busy_ms else None,
            "top_kernels_ms_per_frame": [[k[:90], v / frames] for k, v in ranked]}


def gather_timing_inputs(rng):
    """The LIO map's gather: a (262,144, 128) table and GATHER_INDEX_SETS
    index vectors of 8,192 rows, handed out in turn so that the rows come
    from HBM as a real caller's would. Returns (table, next index, group)."""
    C, W, N, group = GATHER_SHAPES[0]
    table = torch.from_numpy(rng.normal(size=(C, W)).astype(np.float32)).cuda()
    sets = [torch.from_numpy(rng.integers(0, C, N).astype(np.int32)).cuda()
            for _ in range(GATHER_INDEX_SETS)]
    return table, itertools.cycle(sets).__next__, group


def gather_host_steps(table, idx, repeats=5):
    """The K3 wrapper's host microseconds a call, step by step: the whole
    call, `new_empty`, the raw stream, the ctypes call with N = 0 (argument
    conversion and the C entry, which launches nothing) and with N (the
    launch added). Each step is timed `repeats` times in turn over 200
    calls, the median kept; steps timed alone need not add up to the
    call. Beside them, the profiler's CPU-side view of the call and of
    torch.index_select (`cpu_view`)."""
    from fast_livo2_tpu_torch.ops import _launch, gather

    dev = table.get_device()
    n, w = idx.shape[0], table.shape[1]
    ptrs = (table.data_ptr(), idx.data_ptr(), table.new_empty((n, w)).data_ptr())
    fn = gather._kernel()
    stream = _launch.raw_stream(dev)
    fns = {"call": lambda: gather.gather_rows(table, idx),
           "new_empty": lambda: table.new_empty((n, w)),
           "raw_stream": lambda: _launch.raw_stream(dev),
           "ctypes_entry": lambda: fn(*ptrs, 0, w, dev, stream),
           "ctypes_entry_and_launch": lambda: fn(*ptrs, n, w, dev, stream)}
    runs = {k: [] for k in fns}
    for _ in range(repeats):
        for k, f in fns.items():
            runs[k].append(host_us(f, calls=200))
    steps = {k: statistics.median(v) for k, v in runs.items()}
    steps["c_launch"] = steps["ctypes_entry_and_launch"] - steps["ctypes_entry"]
    steps["profiler_cpu_us"] = {
        "gather_rows": cpu_view(fns["call"]),
        "index_select": cpu_view(lambda: torch.index_select(table, 0, idx))}
    return steps


def cpu_view(fn, calls=200, top=6):
    """The host's microseconds a call by event, from torch.profiler's
    CPU-side view (self time: ATen ops, CUDA runtime calls such as
    cudaLaunchKernel) over `calls` calls; the profiler's own cost is in
    them, so they compare only with each other."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_cpu_time_total / calls)
                   for e in prof.key_averages()
                   if e.self_cpu_time_total > 0 and "Synchronize" not in e.key),
                  key=lambda kv: -kv[1])
    return dict(rows[:top])


def phase_kernel_gather():
    """K3 against its plain version, bit for bit, at GATHER_SHAPES and on
    a table view whose base is not 16-byte aligned (the scalar path);
    then timed at the main shape, the kernel and torch.index_select in
    turns (library, kernel, kernel, library), each reading
    GATHER_INDEX_SETS index vectors in turn; the plain version beside
    them, and the wrapper's host time step by step."""
    from fast_livo2_tpu_torch.ops import gather

    rng = np.random.default_rng(11)
    gather.LAUNCHES = 0
    shapes = []
    for C, W, N, group in GATHER_SHAPES:
        table = torch.from_numpy(rng.normal(size=(C, W)).astype(np.float32)).cuda()
        idx = torch.from_numpy(rng.integers(0, C, N).astype(np.int32)).cuda()
        got = gather.gather_rows(table, idx, group=group)
        torch.cuda.synchronize()
        check(torch.equal(got, gather.gather_rows_plain(table, idx)),
              f"K3 kernel differs from table[idx] at C={C} W={W} N={N}")
        shapes.append([C, W, N, group])
    flat = torch.from_numpy(rng.normal(size=2048 * 128 + 1).astype(np.float32)).cuda()
    view = flat[1:].view(2048, 128)
    check(view.data_ptr() % 16 != 0, "the unaligned case is aligned")
    idx = torch.from_numpy(rng.integers(0, 2048, 512).astype(np.int32)).cuda()
    got = gather.gather_rows(view, idx, group=64)
    torch.cuda.synchronize()
    check(torch.equal(got, view[idx.long()]), "K3 kernel differs on an "
                                               "unaligned view")
    table, nxt, group = gather_timing_inputs(rng)
    t = gather_timings(table, nxt, group)
    plain_ms = time_cuda(lambda: gather.gather_rows_plain(table, nxt()))
    # device time of every kernel each call launches (the plain version
    # casts the indices, then indexes)
    plain_dev_ms = sum(device_profile(
        lambda: gather.gather_rows_plain(table, nxt()))[1].values())
    steps = gather_host_steps(table, nxt())
    # Least time: the N rows read once, written once, the indices read
    # once; a copy does no arithmetic.
    C, W, N, _ = GATHER_SHAPES[0]
    nbytes = 2 * N * W * 4 + N * 4
    bound_ms, bound_by = bound(nbytes, 0)
    row = {"name": "gather.gather_rows", "route": "cuda",
           "source": "fast_livo2_tpu_torch/csrc/gather_rows.cu",
           "replaces": "fast_livo2_tpu/ops/pallas_gather.py:53",
           "max_abs_err": 0.0, "ms": t["gather_rows"]["ms"],
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": t["index_select"]["ms"],
           "device_ms": t["gather_rows"]["device_ms"],
           "host_us": t["gather_rows"]["host_us"],
           "library_host_us": t["index_select"]["host_us"]}
    emit({"phase": "kernel_gather", "shapes_bitwise_equal": shapes,
          "unaligned_view_bitwise_equal": True, "C": C, "W": W, "N": N,
          "index_sets": GATHER_INDEX_SETS, "bytes": nbytes,
          "plain_device_ms": plain_dev_ms, "timings": t,
          "host_us_steps": steps, "phase_launches": gather.LAUNCHES, **row})
    return row, gather.LAUNCHES


def gather_timings(table, nxt, group):
    """K3 and torch.index_select on the same index vectors: event ms in
    turns (library, kernel, kernel, library; `ms` the mean of a pair),
    then host us and device ms of each."""
    from fast_livo2_tpu_torch.ops import gather

    fns = {"gather_rows": lambda: gather.gather_rows(table, nxt(), group=group),
           "index_select": lambda: torch.index_select(table, 0, nxt())}
    order = ("index_select", "gather_rows", "gather_rows", "index_select")
    out = {k: {"ms_turns": []} for k in fns}
    for k in order:
        out[k]["ms_turns"].append(time_cuda(fns[k]))
    for k, fn in fns.items():
        out[k]["ms"] = statistics.mean(out[k]["ms_turns"])
        out[k].update(timings(fn, event=False))
    return out


def sensor_yaml(path):
    """A sensor yaml that load_config reads back as full_width_config()."""
    import dataclasses

    import yaml

    from fast_livo2_tpu_torch.utils.config import load_config

    cfg = full_width_config()
    with open(path, "w") as f:
        yaml.safe_dump({
            "camera": dataclasses.asdict(cfg.camera),
            "extrin_calib": {"Rcl": [float(x) for x in cfg.extrin_calib.Rcl],
                             "Pcl": [float(x) for x in cfg.extrin_calib.Pcl]},
            "preprocess": {"filter_size_surf": cfg.preprocess.filter_size_surf},
        }, f)
    check(load_config(path) == cfg, "the sensor yaml does not give "
                                    "full_width_config()")


def phase_run_cli(seq, frames):
    """The user's run: `python -m fast_livo2_tpu_torch.run` in process on
    "cuda" over the LIVO sequence saved as an npz sequence, every output
    on and a checkpoint at the end."""
    from fast_livo2_tpu_torch import run
    from fast_livo2_tpu_torch.io import dataset, synthetic

    root = os.path.join(REPO, "build", "smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    dataset.save_sequence(os.path.join(root, "seq"), seq)
    save_s = time.perf_counter() - t0
    sensor_yaml(os.path.join(root, "sensor.yaml"))
    out = os.path.join(root, "out")
    ck = os.path.join(root, "ck.npz")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        summary = run.main([
            "--config", os.path.join(root, "sensor.yaml"),
            "--seq", os.path.join(root, "seq"), "--out", out, "--pcd",
            "--mesh", "--colmap", "--images", "--traces", "--checkpoint", ck,
            "--device", "cuda"])
    wall_s = time.perf_counter() - t0
    check(json.loads(printed.getvalue().strip().splitlines()[-1]) == summary,
          "the CLI's summary line differs from its return value")
    check(summary["mode"] == "livo" and summary["frames"] == frames,
          f"CLI ran {summary['frames']} {summary['mode']} frames, the "
          f"sequence has {frames}")
    check(summary["ate_rmse_m"] < ATE_GATE_M,
          f"CLI ATE {summary['ate_rmse_m']} m >= {ATE_GATE_M} m")
    # The CLI reports scripts/run_livo.py's evo convention: each 50 Hz
    # ground-truth stamp paired with the nearest estimate within 50 ms,
    # so motion over up to 40 ms enters the error. The pipeline phases'
    # ATE interpolates the ground truth at each estimate instead.
    rows = np.loadtxt(os.path.join(out, "trajectory.txt"))
    ate_interp = synthetic.ate_rmse([(r[0], r[1:4]) for r in rows], seq.gt)
    check(ate_interp < ATE_GATE_M, f"CLI trajectory ATE {ate_interp} m")
    check(summary["pcd_points"] > 0 and summary["mesh_faces"] > 0
          and summary["images"] > 0, f"empty CLI outputs: {summary}")
    files = ["trajectory.txt", "cloud.pcd", "mesh.ply", "mat_pre.txt",
             "mat_out.txt"] + [os.path.join("colmap", "sparse", "0", n)
                               for n in ("cameras.txt", "images.txt",
                                         "points3D.txt")]
    missing = [f for f in files if not os.path.getsize(os.path.join(out, f))]
    check(not missing and os.path.getsize(ck) > 0, f"empty outputs {missing}")
    pngs = [f for f in os.listdir(os.path.join(out, "images"))
            if f.endswith(".png")]
    check(len(pngs) == summary["images"], f"{len(pngs)} PNGs written")
    emit({"phase": "run_cli", "ate_interp_m": ate_interp,
          "cli_wall_s": wall_s, "sequence_save_s": save_s,
          "checkpoint_mib": os.path.getsize(ck) / 2 ** 20,
          "mesh_grid": 256, **summary})


def phase_resume(seq, frames):
    """LIVO to half the frames, saved, and run on uninterrupted; the
    checkpoint loaded into a fresh pipeline, the camera frames after the
    cut pushed, the rest run and held against the uninterrupted run (both
    from the same state: only the card's unordered float scatter-adds
    part them); IMU-rate poses read before its last frame."""
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
    from fast_livo2_tpu_torch.io import checkpoint, convert

    cfg = full_width_config()
    half = frames // 2
    a = LIVOPipeline(cfg, "livo", device="cuda")
    a.push_sequence(seq)
    check(a.poll(max_frames=half, flush=True) == half, "first half")
    ck = os.path.join(REPO, "build", "smoke_resume.npz")
    t0 = time.perf_counter()
    checkpoint.save(ck, a)
    save_s = time.perf_counter() - t0
    a.poll(flush=True)
    a._finalize_host_views()
    check(len(a.trajectory) == frames, f"uninterrupted run: "
                                       f"{len(a.trajectory)} frames")
    b = LIVOPipeline(cfg, "livo", device="cuda")
    t0 = time.perf_counter()
    checkpoint.load(ck, b)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    _, saved = checkpoint.read(ck)
    loaded = dict(zip(("packed", "vmap_keys", "vmap_stats", "vmap_rec"),
                      convert.state_to_numpy(b.packed, b.vmap_state)))
    loaded.update(zip(("pool_point", "pool_obs", "pool_obs_patch",
                       "pool_alloc"), convert.pool_to_numpy(b.pool)))
    loaded.update(zip(("ring_imgs", "ring_ids"), convert.ring_to_numpy(b.ring)))
    loaded.update({f"noise_{n}": t.cpu().numpy()
                   for n, t in zip(type(b.noise)._fields, b.noise)})
    loaded["prefetch_imu"] = b._prefetch[1][0].cpu().numpy()
    loaded["prefetch_pts"] = b._prefetch[1][1].cpu().numpy()
    differ = [k for k, v in loaded.items() if not np.array_equal(v, saved[k])]
    check(not differ, f"loaded tensors differ from the saved ones: {differ}")
    exposure = cfg.time_offset.exposure_time_init
    for t, img in seq.images:
        if t + exposure > b.last_update_time:
            b.push_image(t, img)
    tail = a.trajectory[half:]
    check(b.poll(max_frames=len(tail) - 1, flush=True) == len(tail) - 1,
          "resumed run stopped early")
    # IMU-rate poses past the newest update, read before the last frame:
    # the IMU stream ends before the last camera frame's capture time.
    poses = b.imu_rate_poses()
    b.poll(flush=True)
    b._finalize_host_views()
    check([t for t, _, _ in b.trajectory] == [t for t, _, _ in tail],
          f"resumed run cut {len(b.trajectory)} frames, {len(tail)} expected")
    dp = max(float(np.abs(x[2] - y[2]).max()) for x, y in zip(b.trajectory, tail))
    dR = max(float(np.abs(x[1] - y[1]).max()) for x, y in zip(b.trajectory, tail))
    check(dp <= POS_TOL_M and dR <= ROT_TOL,
          f"resumed tail vs uninterrupted run: {dp} m, {dR}")
    check(len(poses) > 0 and all(np.isfinite(p).all() for _, _, p, _ in poses),
          "no IMU-rate poses past the newest update")
    emit({"phase": "resume", "frames_before": half,
          "frames_after": len(b.trajectory), "tensors_bitwise_equal": len(loaded),
          "checkpoint_mib": os.path.getsize(ck) / 2 ** 20, "save_s": save_s,
          "load_s": load_s, "max_pos_diff_m": dp, "max_rot_diff": dR,
          "pos_tol_m": POS_TOL_M, "rot_tol": ROT_TOL,
          "imu_rate_poses": len(poses)})


def smooth_image(H, W, seed=0):
    """A smooth DN-scale (H, W) float32 image (a doubly integrated noise
    field scaled to 0-255)."""
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.standard_normal((H, W)), 0), 1)
    return ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.float32)


def kernel_times():
    """The three wrappers' and torch.index_select's times at the main
    path's shapes, then steady full-width LIVO frames under the profiler,
    through the package's public API alone (the wrappers and
    LIVOPipeline, unchanged since it was written), so that
    `--kernel-times ROOT` measures the package of another tree: K1 at
    K = 64, D = 19; K2 at M = 396 on a smooth 512 x 640 image; K3 and
    index_select on the LIO map's gather, in turns; the LIVO frames'
    launches, K2 kernels and photometric iterations (profile_frames)."""
    from fast_livo2_tpu_torch.ops import _build, cov_scan, gather
    from fast_livo2_tpu_torch.ops import photo_iteration as photo

    _build.build(_build.sources())
    F, Q, P0 = (torch.from_numpy(a).cuda() for a in k1_inputs(K_MAIN, D_STATE))
    img = torch.from_numpy(smooth_image(512, 640)).cuda()
    args = k2_inputs(img, False)
    table, nxt, group = gather_timing_inputs(np.random.default_rng(11))
    out = {"cov_scan": timings(lambda: cov_scan.propagate_cov(F, Q, P0)),
           "photo_iteration": timings(lambda: photo.photo_iteration(*args)),
           **gather_timings(table, nxt, group)}
    out["profile_livo"] = profile_frames(full_width_sequence(), "livo")
    return out


def run_turns(other):
    """kernel_times of `other`'s package and this one's in four processes,
    other, this, this, other; one `turns` line."""
    runs = []
    for root in (other, REPO, REPO, other):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--kernel-times", root],
                           capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            print(f"chip_smoke: --kernel-times {root} failed:\n"
                  f"{p.stderr[-4000:]}", file=sys.stderr)
            return 1
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    emit({"phase": "turns", "roots": [other, REPO, REPO, other], "runs": runs})
    print(nvidia_smi(), flush=True)
    return 0


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 2
    mode = argv[0] if argv else None
    root = os.path.abspath(argv[1]) if mode == "--kernel-times" else REPO
    sys.path.insert(0, root)
    try:
        import fast_livo2_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port package is not in {root}: {e}",
              file=sys.stderr)
        return 2
    if mode == "--kernel-times":
        emit({"package": os.path.dirname(fast_livo2_tpu_torch.__file__),
              "nvidia_smi": nvidia_smi(), **kernel_times()})
        return 0
    if mode == "--turns":
        return run_turns(os.path.abspath(argv[1]))
    if mode is not None:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
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
        k2, frame = phase_kernel_photo(seq)
        phase_side_stream(frame)
        traj, _ = phase_pipeline(seq, "only_lio")
        phase_parity(seq, traj, "only_lio", PARITY_FRAMES)
        phase_profile(seq, "only_lio")
        traj, launches = phase_pipeline(seq, "livo")
        phase_parity(seq, traj, "livo", PARITY_FRAMES_LIVO)
        phase_profile(seq, "livo")
        k3, k3_phase_launches = phase_kernel_gather()
        phase_run_cli(seq, len(traj))
        phase_resume(seq, len(traj))
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches: the LIVO main path's run, which goes through K1 and K2;
    # no path runs K3 (0), its own phase's count beside it
    k1["launches"] = launches["cov_scan"]
    k2["launches"] = launches["photo_iteration"]
    k3["launches"] = launches["gather_rows"]
    k3["phase_launches"] = k3_phase_launches
    emit({"kernels": [k1, k2, k3]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

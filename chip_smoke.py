#!/usr/bin/env python3
"""Drive the PyTorch port's main paths (ONLY_LIO, full LIVO and the user's
run through the CLI, with its outputs and checkpoint/resume, in split,
fused and staged frames; the VIO extras; the sliding-window backend and
multi-stream replay; a ROS bag converted and run; sharding over
torch.distributed; the hard scene, the capacity-cycling soak, the outdoor
map-sliding flight and the dense scan; the tools; the four shipped sensor
rigs from their recordings) on one NVIDIA GPU and hold every hand-written
kernel against its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and the CUDA
toolkit (nvcc). The kernels are compiled from `fast_livo2_tpu_torch/csrc/`
into `build/kernels/` at first use. Phases, each printing one JSON line:

  1. device         the card, torch/CUDA versions, the float32 precision
                    policy;
  2. build          nvcc builds of every kernel source, started together;
  3. kernel         K1 (cov_scan) against its plain version on the card at
                    the main path's shapes (K = 64, D = 19), at two inputs:
                    dense (every step live) and main-path-shaped (21 live
                    steps, then 43 padding steps with F = I and Q = 0 by
                    value, some entries -0.0, which the kernel skips);
                    one device kernel a call; each timed;
  4. kernel_photo   K2 (photo_iteration) against its plain version on a
                    rendered 640 x 512 frame with M in {0, 1, 7, 9, 396,
                    4096} points (396 on the main path), stride exponents
                    0-5 (the clamp to 4 bites), some points masked, with
                    and without distortion; bitwise the same over 20
                    calls and across calls at another M (the last-block
                    ticket is reset); one device kernel a call; timed;
                    then at each rig's processed camera and tracked
                    slots (640 x 512 M 396, 752 x 480 M 486 in the
                    above-448 sampling, hilti22's 720 x 540 equidistant
                    fisheye M 432 in the equidistant instantiation and
                    the per-tap sampling, 612 x 512 M 378), each timed
                    and bounded;
  4a. kernel_tail   the photometric filter tail (ops/photo_tail, which
                    ports no TPU kernel) against its plain version at
                    avia's and hilti22's shapes (n = 7) and at n = 6, in
                    both loop forms, each held to a float64 evaluation
                    no worse than four times the plain float32 tail;
                    bitwise the same over 20 calls; one device kernel a
                    call; timed beside the plain tail;
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
                    kernels, K1's device ms and kernels a frame;
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
  11b. kernel_ordered_add  ordered_add (no TPU kernel's port: the float
                    scatter-adds in lane order) against the CPU's
                    index_add_, bit for bit on every row but the sink, at
                    the map insert's, the downsample's and the TSDF's
                    shapes (ORDERED_ADD_SHAPES), twice each; timed in
                    turns beside CUDA's index_add_ (float atomics) and
                    the same under deterministic algorithms;
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
  14-19. pipeline_fused, parity_fused, profile_fused and the same three
                    for LIVO: tpu.fused_frame, each frame after the first
                    two one replay of a captured CUDA graph. Four runs in
                    turns in one process (split, fused, fused, split; the
                    two runs of each form bit for bit the same, fused vs
                    split within the golden tolerances, ordered_add once
                    a site a frame):
                    frames, ATE, tracked points, frame times, capture
                    seconds, graphs and their memory, bytes copied back a
                    frame, 0 host syncs in a replayed frame, K1 once and
                    K2 pyramid levels x iterations (20) a VIO frame
                    beside the iterations that took effect; parity_fused*:
                    the first fused run against the first split run,
                    held to the golden tolerances (expected 0.0);
                    steady replays under
                    torch.profiler with K1 and K2 found in them by kernel
                    name (a profile whose counts fall short, as the
                    profiler drops events on a busy host, is taken again,
                    up to 3);
  20. stage_timing  LIVO with tpu.stage_timing: every stage's device ms
                    on every staged frame, the table printed, and the
                    trajectory against the split run with
                    deferred_map_insert = False;
  21. resume_fused  a fused run saved half-way, loaded into a fused
                    pipeline that has already captured its graph, and run
                    on from its static buffers: held to the golden
                    tolerances against the uninterrupted fused run.
  22. vio_extras    the LIVO sequence with vio.raycast_en, then with
                    vio.inverse_composition_en, each split then fused:
                    ATE, tracked points, raycast candidates a frame,
                    frame times; fused vs split at the golden
                    tolerances, 0 syncs in a replay, K1 once a frame, K2
                    20 a fused VIO frame with raycast and 0 with IC;
  23. backend_photo the online backend with photometric factors on the
                    fused LIVO sequence (a keyframe every 2 frames,
                    8-keyframe windows every 4): factors captured,
                    windows refined, ATE, K2 as in the fused LIVO phase;
  24. batch         MultiStreamReplay, fused LIVO, 1 then 4 streams of
                    the sequence on the card: each stream against the
                    single one at the golden tolerances, aggregate
                    frames/s beside the single stream's, placement on a
                    missing card raising;
  25. resume_backend an ONLY_LIO fused run with the backend saved half-
                    way (its window drained) and loaded: keyframes and
                    refined poses bit for bit, the tail at the golden
                    tolerances;
  26. backend       the first 30 s of bench.py's long-indoor sequence
                    (generated in a child process from the start of the
                    run, cached under build/), ONLY_LIO fused, without
                    and with the online backend in turns (plain,
                    backend, backend, plain), then with the submit gate
                    at 0.05: the refiner's submits, completed windows,
                    submit host ms, window device ms on its stream,
                    graph capture s and pool MB; refined keyframes' ATE
                    beside the filter's; frame ms with and without; the
                    feedback run's ATE within max(1.3 x, + 0.02 m) of the
                    run without (tests/test_long_run.py:120); 0 syncs in
                    replayed frames but the refiner's captures;
  27. rosbag        the LIVO sequence written to a ROS1 bag by the port's
                    write_bag (Imu, Livox CustomMsg, raw mono8 Image),
                    converted by `python -m fast_livo2_tpu_torch.convert_rosbag
                    --blind 0` in a subprocess (points bit for bit, images
                    and IMU equal, stamps within 1 us of the source), and
                    the CLI on "cuda" under deterministic algorithms over
                    it and over the source saved as npz with ROS-time
                    stamps: ATE gates, trajectories bit for bit the same,
                    K1 and K2 launches equal; bag bytes, write and
                    convert s and MB/s, CLI wall s;
  28. sharded       2 gloo ranks on cuda:0 (processes of this script,
                    `--shard-rank`) at the full-width configuration
                    (8,192 points, 3 layers of 2^18 slots, a 16-keyframe
                    window from a LIVO run): lio_update over the points,
                    10 update_map(mesh=) calls (replicas bit for bit
                    equal), refine_window(mesh=) with IMU links and
                    photometric factors, refine_window_map_sharded; each
                    held against this process's single-process call at
                    the golden tolerances; then the same calls under NCCL
                    with world size 1, and whether the keyframe-sharded
                    refine captures as a CUDA graph under NCCL; each
                    call's ms and collective bytes.

  29. hard        bench.py's hard scene (3 s, 24 x 1000 points, 640 x
                    512 frames with DEGRADE and an exposure ramp, the core
                    configuration), LIVO split then fused: ATE < 0.03 m
                    in both (tests/test_hard_scene.py);
  30. soak        scripts/soak.py's 20 s flight at its capacities (320 x
                    256, 2^15 slots, an 8-frame ring, sliding at 1 m)
                    with a 2,048-point pool, LIVO split then fused: the
                    script's gates in both forms, >= 3 slides, >= 20 ring
                    wraps, >= 1 pool wrap, one capture, 0 syncs in a
                    replay, fused vs split 0.0 m;
  31. outdoor     bench.py's 45 s outdoor flight (2 m voxels, map
                    sliding, 80 m range), ONLY_LIO fused with the plane-
                    information cap (deterministic, against its
                    deterministic split run: 0.0 m), without it and at
                    1 m voxels: drift <= 0.5 / 2.0 / 0.5 %
                    (tests/test_long_run.py), slides; the capped map's
                    census (outdoor_census);
  32. dense       bench.py's dense scan (4 s, 48 x 2000 points, 32,768
                    after downsampling), LIVO split then fused: ATE <
                    0.05 m, K2 20 a fused VIO frame, capture s and pool
                    bytes, K1 / K2 device ms a frame from one profile;
  33. tools       `fast_livo2_tpu_torch.mesh` on run_cli's cloud (its
                    volume against the CPU's, and integrated twice on the
                    card: bit for bit), `export_planes` (the CLI
                    on run_cli's checkpoint; a fused run's map: planes =
                    _ISPL rows), `fleet_scaling` B = 1, 2, 4.
  34. rig_avia, rig_ntu_viral, rig_hilti22, rig_mars_lvig: the four
                    shipped config pairs (configs/), each from its own
                    recording at its published width (RIGS: the camera
                    at the camera yaml's full resolution, the LiDAR's
                    points a scan in its own frame, the yaml's time
                    offsets; a ROS bag on the yaml's topics but for
                    mars_lvig) through `convert_rosbag` and the CLI with
                    the yamls as shipped: split and fused in turns
                    (split, fused, fused, split; mars_lvig, whose start
                    is chaotic, then the same pair under deterministic
                    algorithms, which its drift gate reads); ATE or drift
                    gates and tracked points, fused vs split and the two
                    runs of each form 0.0 m apart, 0 syncs in a replay,
                    K1 once a frame,
                    ordered_add once a site, K2 20 / 15 / 20 / 20 a fused
                    VIO frame; bag bytes, convert s, capture s, graph
                    pool bytes, each side's median over its two runs.
                    The CPU tests (tests/test_torch_rigs*.py) import
                    this script's rig assembly at a smaller size.
                    The sequences of 26, 29-32 and the rigs' recordings
                    are built one after another by one child process
                    (`chip_smoke.py --make-sequences DIR`, nice 19) and
                    cached under build/.

Then the `kernels` line (K1's and K2's launches on the split LIVO path
and, as `launches_fused`, on the fused one; `launches_phases`, those of
phases 22-34), the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Any failed
phase exits non-zero before that line; there is no CPU fallback.
Imports nothing of JAX. Every
kernel phase reports `ms` (CUDA events around 100 back-to-back calls),
`host_us` (time.perf_counter around 1,000 calls), `device_ms` and the
device kernels a call (torch.profiler).

    python3 chip_smoke.py --turns OTHER_ROOT

times the three wrappers (K1 at both inputs) and torch.index_select,
hashes K1's output at the dense inputs (`k1_digest`: the same bits or
not) and profiles steady LIVO frames (`kernel_times`) in four processes
in turns, OTHER_ROOT's
package, this one's, this one's, OTHER_ROOT's (e.g. the parent commit
unpacked with `git archive` under build/), each building its own
kernels, and prints one `turns_kernels` line. `--kernel-times ROOT` is
one such process.

    python3 chip_smoke.py --backend-turns OTHER_ROOT

builds the long-indoor cut once, then in the same four processes runs
the online backend on it twice (`backend_times`: fused ONLY_LIO with
enable_online_refine, each run's median, p99 and max frame ms) and
prints one `turns_backend` line. `--backend-times ROOT DIR` is one such
process.

    python3 chip_smoke.py --rig-spread NAME [RUNS]

builds rig NAME's recording as the rigs phase does and prints how far
RUNS default split runs part, and how far a deterministic run moves
when every scan point moves by one ulp (`rig_spread`).

    python3 chip_smoke.py --det-kernels NAME

builds rig NAME's recording likewise and lists the device kernels of a
fused LIVO frame that torch's deterministic algorithms add, drop or
launch a different number of times (`det_kernels`).
"""

import contextlib
import copy
import datetime
import gc
import hashlib
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

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet), at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

K_MAIN, D_STATE = 64, 19  # cov_scan shapes on the main path
# Live IMU intervals of a main-path frame (200 Hz IMU, ~0.11 s a scan);
# the other K_MAIN - K1_LIVE steps are the batch's padding.
K1_LIVE = 21
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
# ordered_add at each call site's shape: (rows R incl. the sink, width
# W, lanes n) — the map insert (3 layers of 2^18 slots, 3 x 8,192 lanes
# of 16 moments), the downsample (~22.8k sorted scan points into 8,192
# voxels + the sink) and the TSDF (a frame chunk of 8,192 points x 7 ray
# samples into the mesh's 256^3 volume).
ORDERED_ADD_SHAPES = {"map_insert": (3 * (1 << 18) + 1, 16, 3 * 8192),
                      "downsample": (8193, 3, 22800),
                      "tsdf": (256 ** 3 + 1, 1, 8192 * 7)}
K2_SWEEP = (0, 1, 7, 9, M_MAIN, 4096)  # a block holds 8 points
K2_REPEATS = 20
TAIL_REPEATS = 20
REPO = os.path.dirname(os.path.abspath(__file__))


class PhaseError(RuntimeError):
    pass


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries `t_s`, the seconds since the
    script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
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


def one_kernel_timings(fn, kernel, what, tries=5):
    """timings(fn) where every call of fn launches one device kernel, whose
    name holds `kernel`. The profiler can drop a few kernel events of a
    cycle (the parent's kernels too, on an idle host), which only lowers
    the count: a profile that sees fewer than one a call is taken again,
    up to `tries` profiles; one that sees more, or another kernel, fails."""
    for n in range(1, tries + 1):
        t = timings(fn)
        per_call, names = t["device_kernels_per_call"], list(t["device_ms_by_kernel"])
        check(per_call <= 1 and all(kernel in k for k in names),
              f"{what}: device kernels a call {per_call}: {names}")
        if per_call == 1:
            return {**t, "profiles": n}
    check(False, f"{what}: device kernels a call {per_call} in each of "
                 f"{tries} profiles: {names}")


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


def k1_main_shape_inputs(seed=3):
    """The main path's K1 inputs in shape: k1_inputs' first K1_LIVE steps,
    then padding steps with F = I and Q = 0 by value, about a tenth of
    their zeros -0.0, as the IMU batch's padding has them."""
    F, Q, P0 = k1_inputs(K_MAIN, D_STATE, seed)
    rng = np.random.default_rng(seed + 1)
    F[K1_LIVE:] = np.eye(D_STATE, dtype=np.float32)
    Q[K1_LIVE:] = 0.0
    neg = rng.random((2,) + F[K1_LIVE:].shape) < 0.1
    F[K1_LIVE:][neg[0] & (F[K1_LIVE:] == 0)] = -0.0
    Q[K1_LIVE:][neg[1]] = -0.0
    return F, Q, P0


def k1_case(arrays, steps):
    """K1 on the card against its plain version at RTOL_K1 / ATOL_K1, one
    device kernel a call, and its times; `steps` is how many steps the
    inputs need computed (the rest are exact no-ops)."""
    from fast_livo2_tpu_torch.ops import cov_scan

    F, Q, P0 = (torch.from_numpy(a).cuda() for a in arrays)
    got = cov_scan.propagate_cov(F, Q, P0)
    torch.cuda.synchronize()
    want = cov_scan.propagate_cov_plain(F, Q, P0)
    err = (got - want).abs()
    max_abs_err = float(err.max())
    check(torch.isfinite(got).all().item(), "cov_scan kernel: non-finite output")
    check(bool(torch.all(err <= ATOL_K1 + RTOL_K1 * want.abs())),
          f"cov_scan kernel disagrees with its plain version ({steps} live "
          f"steps): max_abs_err {max_abs_err}")
    t = one_kernel_timings(lambda: cov_scan.propagate_cov(F, Q, P0),
                           "cov_scan_kernel", f"cov_scan ({steps} live steps)")
    plain_ms = time_cuda(lambda: cov_scan.propagate_cov_plain(F, Q, P0))
    # Least time for the same work: each input read once (the kernel reads
    # the padding steps too, to find them), the output written once; two
    # D x D x D products per computed step, 2 FLOP per FMA.
    nbytes = (2 * K_MAIN * D_STATE * D_STATE + 2 * D_STATE * D_STATE) * 4
    flops = steps * 4 * D_STATE ** 3
    bound_ms, bound_by = bound(nbytes, flops)
    return {"max_abs_err": max_abs_err, "plain_ms": plain_ms, "bytes": nbytes,
            "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by, **t}


def phase_kernel():
    dense = k1_case(k1_inputs(K_MAIN, D_STATE), K_MAIN)
    shaped = k1_case(k1_main_shape_inputs(), K1_LIVE)
    row = {"name": "cov_scan.propagate_cov", "route": "cuda",
           "source": "fast_livo2_tpu_torch/csrc/cov_scan.cu",
           "replaces": "fast_livo2_tpu/ops/cov_scan.py:69",
           "max_abs_err": dense["max_abs_err"], "ms": dense["ms"],
           "plain_ms": dense["plain_ms"], "bound_ms": dense["bound_ms"],
           "bound_by": dense["bound_by"],
           # No single PyTorch call computes this K-step recursion.
           "library_ms": None, "device_ms": dense["device_ms"],
           "host_us": dense["host_us"],
           "main_shape_ms": shaped["ms"],
           "main_shape_device_ms": shaped["device_ms"],
           "main_shape_max_abs_err": shaped["max_abs_err"],
           "main_shape_bound_ms": shaped["bound_ms"]}
    emit({"phase": "kernel", "K": K_MAIN, "D": D_STATE, "live_steps": K1_LIVE,
          "rtol": RTOL_K1, "atol": ATOL_K1, "dense": dense,
          "main_shape": shaped, **row})
    return row


def k2_inputs(img, with_dist, seed=7, M=M_MAIN, cam=None):
    """M points spread over the frame 1.5-8 m ahead of the camera, stride
    exponents 0-5, about 10 % masked out, the camera pose at the origin
    and the forward mount's Jacobian blocks. The camera: camera_config()'s
    (radtan coefficients if `with_dist`), or `cam` with its own model and
    coefficients (the row's model flag set for the equidistant one)."""
    from fast_livo2_tpu_torch.io import synthetic
    from fast_livo2_tpu_torch.models import camera
    from fast_livo2_tpu_torch.ops import photo_iteration as photo

    if cam is None:
        cam = camera.make_camera(camera_config())
        dist = [0.02, -0.01, 0.001, -0.002] if with_dist else [0.0] * 4
    else:
        dist = list(cam.d)
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
    par = photo.pack_params(torch.eye(3, device=dev), torch.zeros(3, device=dev),
                            torch.tensor(1.05, device=dev), Rci, 0.0 * Rci,
                            cam.fx, cam.fy, cam.cx, cam.cy, dist, 1.0,
                            1.0 if any(dist) else 0.0,
                            equidistant=cam.model == "equidistant")
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
    t = one_kernel_timings(lambda: photo.photo_iteration(*args),
                           "photo_iteration_kernel", "K2")
    plain_ms = time_cuda(lambda: photo.photo_iteration_plain(*args), calls=20)
    M = args[1].shape[0]
    bound_ms, bound_by, taps, nbytes, flops = k2_bound(img, args[1], args[3],
                                                       False)
    row = {"name": "photo_iteration.photo_iteration", "route": "cuda",
           "source": "fast_livo2_tpu_torch/csrc/photo_iteration.cu",
           "replaces": "fast_livo2_tpu/ops/pallas_photo.py:204",
           "max_abs_err": max_abs_err, "ms": t["ms"], "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           # No single PyTorch call computes the fused projection, strided
           # bilinear sampling, Jacobian chain and 7 x 7 reduction.
           "library_ms": None, "device_ms": t["device_ms"],
           "host_us": t["host_us"]}
    rigs = k2_rig_shapes()
    row["rig_shapes"] = {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "max_abs_err")}
                         for k, v in rigs.items()}
    emit({"phase": "kernel_photo", "M": M, "H": int(img.shape[0]),
          "W": int(img.shape[1]), "slog_max": 5,
          "max_scale_log2": photo.clamp_scale_log2(int(img.shape[1])),
          "rtol": RTOL_K2, "block_atol": BLOCK_ATOL_K2,
          "max_err_over_block_max": max_rel_err, "M_sweep": list(K2_SWEEP),
          "sweep_max_err_over_block_max": sweep_err,
          "bitwise_repeats": K2_REPEATS, "distinct_taps": taps,
          "bytes": nbytes, "flops": flops, **t, **row, "rig_shapes": rigs})
    return row, img


def k2_bound(img, meta, par, clip_taps):
    """K2's least time at these inputs: the distinct image taps the windows
    read, the point inputs and the parameter row read once, the 64-float
    output written once; FP32 operations as counted at FLOP_PER_*.
    Returns (bound_ms, bound_by, distinct taps, bytes, flops)."""
    from fast_livo2_tpu_torch.ops import photo_iteration as photo

    M = meta.shape[0]
    taps = int(torch.unique(photo.window_taps(img.shape, meta, par,
                                              clip_taps=clip_taps)).numel())
    nbytes = (taps + M * (photo.META_W + 64) + photo.PAR_W + photo.OUT_W) * 4
    flops = M * (64 * FLOP_PER_PIXEL + FLOP_PER_POINT) + M * photo.OUT_W
    return (*bound(nbytes, flops), taps, nbytes, flops)


def k2_rig_shapes():
    """K2 against its plain version at each rig's processed camera (its
    size, intrinsics and distortion; hilti22's equidistant fisheye in the
    kernel's equidistant instantiation) and tracked-slot count, in the
    sampling the port takes there (clip_taps_at(M, model): M = 486 is
    above the JAX package's 448-point gate, and the fisheye samples per
    tap at every M), on a smooth frame; each timed with its plain version
    and bounded."""
    from fast_livo2_tpu_torch.models import camera
    from fast_livo2_tpu_torch.ops import photo_iteration as photo
    from fast_livo2_tpu_torch.utils.config import load_config

    out = {}
    for name, M in RIG_K2_SHAPES:
        cam = camera.make_camera(load_config(*rig_paths(name)).camera)
        img = torch.from_numpy(smooth_image(cam.height, cam.width, seed=M)).cuda()
        args = k2_inputs(img, True, M=M, cam=cam)
        equi = cam.model == "equidistant"
        clip = photo.clip_taps_at(M, cam.model)
        check(clip == (M > 448 or equi),
              f"K2 {name}: clip_taps_at({M}, {cam.model}) = {clip}")
        before = photo.LAUNCHES
        got = photo.photo_iteration(*args, clip_taps=clip, equidistant=equi)
        torch.cuda.synchronize()
        check(photo.LAUNCHES == before + 1, f"K2 {name}: no launch counted")
        err, rel = check_k2(got, photo.photo_iteration_plain(
            *args, clip_taps=clip), f"{name} M={M}")
        bound_ms, bound_by, taps, nbytes, flops = k2_bound(
            img, args[1], args[3], clip)
        out[name] = {
            "H": cam.height, "W": cam.width, "M": M, "model": cam.model,
            "clip_taps": clip,
            "dist": list(cam.d), "max_abs_err": err,
            "max_err_over_block_max": rel,
            "ms": time_cuda(lambda: photo.photo_iteration(
                *args, clip_taps=clip, equidistant=equi)),
            "plain_ms": time_cuda(lambda: photo.photo_iteration_plain(
                *args, clip_taps=clip), calls=20),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "distinct_taps": taps, "bytes": nbytes, "flops": flops}
    return out


def tail_inputs(name, n, seed=0):
    """Float64 inputs of one photometric filter-tail call at rig `name`'s
    shape: HTH = J^T J and HTz = J^T r over its tracked slots (the grid's
    cells) x 64 pixels, J's columns at image-gradient scale (the exposure
    column at intensity scale, n = 7) and r at a few DN; P_scaled_inv =
    inv(cov / img_point_cov) of the filter's initial covariance (0.01 on
    rotation, position and velocity, 1e-5 on exposure, biases and
    gravity) with small correlations; state_prop 0.01 rad and 2 cm from
    the state. Returns ((carry, flags, P, HTH, HTz, error) float64 on
    the CPU, M)."""
    from fast_livo2_tpu_torch.core import state as st_mod
    from fast_livo2_tpu_torch.core import vio as vio_mod
    from fast_livo2_tpu_torch.models import camera
    from fast_livo2_tpu_torch.ops import photo_tail, so3
    from fast_livo2_tpu_torch.utils.config import load_config

    cfg = load_config(*rig_paths(name))
    _, gw, gh = vio_mod.derive_grid(camera.make_camera(cfg.camera),
                                    cfg.vio.grid_size, cfg.vio.grid_n_height)
    M = gw * gh
    rng = np.random.default_rng(seed)
    f64 = torch.float64
    J = rng.normal(size=(M * 64, n)) * np.array([40.0] * 6 + [120.0])[:n]
    r = rng.normal(size=M * 64) * 4.0
    HTH = torch.tensor(J.T @ J, dtype=f64)
    HTz = torch.tensor(J.T @ r, dtype=f64)
    cov = st_mod.init_cov("cpu", f64).numpy()
    L = rng.normal(size=(19, 19)) * 1e-4
    cov = cov + L @ L.T
    P = torch.tensor(np.linalg.inv(cov / cfg.vio.img_point_cov), dtype=f64)
    s = st_mod.init_state("cpu", f64)
    s = s._replace(rot=so3.exp(torch.tensor([0.1, -0.2, 0.3], dtype=f64)),
                   pos=torch.tensor([1.0, 2.0, 0.5], dtype=f64),
                   grav=torch.tensor([0.0, 0.0, -9.81], dtype=f64))
    sp = s._replace(rot=s.rot @ so3.exp(torch.tensor([0.006, 0.0, -0.008],
                                                     dtype=f64)),
                    pos=s.pos + 0.02)
    carry, flags = photo_tail.start_level(sp, s, torch.zeros((19, 19), dtype=f64),
                                          torch.zeros((), dtype=f64))
    carry[photo_tail.LAST_ERR] = 50.0
    return (carry, flags, P, HTH, HTz, torch.tensor(40.0, dtype=f64)), M


def check_tail(args64, device_loop, what):
    """The kernel against the plain tail on the card, as
    tests/test_torch_cuda.py::test_photo_tail_kernel_matches_plain holds
    it: the flags exactly; in each block of the carry the kernel's
    largest error against a float64 evaluation at most four times the
    plain float32 tail's largest (on these inputs and on three copies
    moved by one ulp) plus 2^-20 of the block's largest entry; one launch.
    Returns the kernel's largest error over the plain's largest."""
    from fast_livo2_tpu_torch.ops import photo_tail

    def on_card(a):
        return [t.to(device="cuda", dtype=torch.float32 if t.is_floating_point()
                     else t.dtype) for t in a]

    ref = [t.clone() for t in args64]
    photo_tail.photo_tail_plain(*ref, device_loop)
    plains = []
    for k in range(4):
        a = [t.clone() for t in args64]
        if k:
            rng = np.random.default_rng(k)
            for i, hi in ((0, photo_tail.G_KEEP), (2, None), (3, None), (4, None)):
                x = a[i].reshape(-1)[:hi]
                x.mul_(1.0 + torch.from_numpy(rng.choice([-1.0, 1.0], size=x.shape))
                       * 2.0 ** -23)
        a = on_card(a)
        photo_tail.photo_tail_plain(*a, device_loop)
        plains.append(a)
    got = on_card(args64)
    before = photo_tail.LAUNCHES
    photo_tail.photo_tail(*got, device_loop)
    torch.cuda.synchronize()
    check(photo_tail.LAUNCHES == before + 1, f"tail {what}: no launch counted")
    check(all(torch.equal(got[1], p[1]) for p in plains),
          f"tail {what}: flags {got[1].tolist()} vs plain {plains[0][1].tolist()}")
    worst = 0.0
    for lo, hi in ((photo_tail.STATE, photo_tail.OLD),
                   (photo_tail.OLD, photo_tail.G_KEEP),
                   (photo_tail.G_KEEP, photo_tail.FINAL_ERR),
                   (photo_tail.FINAL_ERR, photo_tail.CARRY_W)):
        want = ref[0][lo:hi]
        e_k = float((got[0][lo:hi].cpu().double() - want).abs().max())
        e_p = max(float((p[0][lo:hi].cpu().double() - want).abs().max())
                  for p in plains)
        check(e_k <= 4 * e_p + 2.0 ** -20 * float(want.abs().max()),
              f"tail {what}: carry[{lo}:{hi}] error {e_k} vs plain {e_p}")
        if e_p:
            worst = max(worst, e_k / e_p)
    return worst


def phase_kernel_tail():
    """The photometric filter tail (ops/photo_tail, no TPU kernel's port)
    against its plain version at avia's and hilti22's shapes (n = 7, the
    forward update both cells run) and at n = 6 (the inverse-compositional
    update), in both loop forms; bitwise the same over 20 calls; one
    device kernel a call; timed beside the plain tail at avia's shape."""
    from fast_livo2_tpu_torch.ops import photo_tail

    ratios, shapes = {}, {}
    for name in ("avia", "hilti22"):
        for n in (7, 6):
            args64, M = tail_inputs(name, n)
            shapes[name] = M
            for device_loop in (True, False):
                ratios[f"{name}_n{n}_{'device_loop' if device_loop else 'split'}"] = (
                    check_tail(args64, device_loop, f"{name} n={n}"))
    args64, _ = tail_inputs("avia", 7)
    args = [t.to(device="cuda", dtype=torch.float32 if t.is_floating_point()
                 else t.dtype) for t in args64]
    first = [t.clone() for t in args]
    photo_tail.photo_tail(*first, True)
    for k in range(TAIL_REPEATS):
        a = [t.clone() for t in args]
        photo_tail.photo_tail(*a, True)
        check(torch.equal(a[0].view(torch.int32), first[0].view(torch.int32))
              and torch.equal(a[1], first[1]),
              f"tail not bitwise repeatable at call {k + 1}")
    t = one_kernel_timings(lambda: photo_tail.photo_tail(*args, True),
                           "photo_tail_kernel", "tail")
    plain_ms = time_cuda(lambda: photo_tail.photo_tail_plain(*args, True), calls=20)
    # Least time for the same work: carry and flags read and written,
    # P (19 x 19), HTH (7 x 7), HTz and the error read once; the solve's
    # Gauss-Jordan FMAs (19 rows x the 25 - k live columns at step k),
    # G, K HTz and G vec, at 2 FLOP an FMA.
    nbytes = (2 * (photo_tail.CARRY_W + photo_tail.FLAGS_W) + 19 * 19 + 49
              + 7 + 1) * 4
    flops = 2 * (19 * sum(25 - k for k in range(19)) + 19 * 7 * 7 + 2 * 19 * 7)
    bound_ms, bound_by = bound(nbytes, flops)
    row = {"name": "photo_tail.photo_tail", "route": "cuda",
           "source": "fast_livo2_tpu_torch/csrc/photo_tail.cu",
           "replaces": None, "ms": t["ms"], "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           # No single PyTorch call computes the solve, boxminus, boxplus
           # and the accept rule.
           "library_ms": None, "device_ms": t["device_ms"],
           "host_us": t["host_us"]}
    emit({"phase": "kernel_tail", "M": shapes, "bytes": nbytes, "flops": flops,
          "error_over_plain": ratios, "bitwise_repeats": TAIL_REPEATS, **t, **row})
    return row


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


def drive(pipe, after=None):
    """poll(max_frames=1) until the queue is empty, each frame timed on
    its own with its synchronizing CUDA calls counted. A frame ends when
    the frame's stream has run it (the pose is out): the backend's
    refiner works on its own stream and is not waited for. Returns
    (frame_ms, syncs per frame); with `after`, also after(pipe) of each
    frame."""
    frame_ms, syncs, seen = [], [], []
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
        torch.cuda.current_stream().synchronize()
        if n:
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            syncs.append(sum("synchronizing CUDA operation" in str(w.message)
                             for w in caught))
            if after is not None:
                seen.append(after(pipe))
    return (frame_ms, syncs, seen) if after is not None else (frame_ms, syncs)


def reset_launches():
    from fast_livo2_tpu_torch.ops import cov_scan, gather, ordered_add
    from fast_livo2_tpu_torch.ops import photo_iteration as photo
    from fast_livo2_tpu_torch.ops import photo_tail

    cov_scan.LAUNCHES = photo.LAUNCHES = gather.LAUNCHES = 0
    ordered_add.LAUNCHES = photo_tail.LAUNCHES = 0


def read_launches():
    from fast_livo2_tpu_torch.ops import cov_scan, gather, ordered_add
    from fast_livo2_tpu_torch.ops import photo_iteration as photo
    from fast_livo2_tpu_torch.ops import photo_tail

    return {"cov_scan": cov_scan.LAUNCHES, "photo_iteration": photo.LAUNCHES,
            "gather_rows": gather.LAUNCHES, "ordered_add": ordered_add.LAUNCHES,
            "photo_tail": photo_tail.LAUNCHES}


def ordered_add_sites(pipe):
    """ordered_add launches of a frame after the first: the downsample's,
    and the compacted map insert's two (layer 0 on every point, then the
    descending lanes: tpu.descend_compact below the points a frame and
    more than one layer) or one. The first frame builds the map with the
    full insert: two."""
    m = pipe.map_cfg
    return 2 + bool(m.descend_compact and m.n_layers > 1
                    and m.descend_compact < pipe.cfg.tpu.max_points_down)


def check_ordered_add(name, launches, frames, sites):
    """ordered_add launched once a site the run's frames ran."""
    want = 2 + (frames - 1) * sites
    check(launches["ordered_add"] == want,
          f"{name}: ordered_add launched {launches['ordered_add']} times in "
          f"{frames} frames, {want} expected ({sites} a frame after the "
          f"first)")


def run_sequence(seq, mode, vio=None, cfg=None, **tpu):
    """`seq` on "cuda" in `mode` with full_width_config() (or `cfg`) and
    the vio.* and tpu.* options given, driven frame by frame (`drive`),
    the kernels' launch counts set to 0 just before and read just after.
    Returns (pipeline, the queued event times, frame ms, syncs a frame,
    launches)."""
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    cfg = copy.deepcopy(cfg) if cfg is not None else full_width_config()
    for k, v in (vio or {}).items():
        setattr(cfg.vio, k, v)
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    pipe = LIVOPipeline(cfg, mode, device="cuda")
    pipe.push_sequence(seq)
    events = _events(pipe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frame_ms, syncs = drive(pipe)
    launches = read_launches()
    pipe._finalize_host_views()
    return pipe, events, frame_ms, syncs, launches


def free_device_memory():
    """Return the memory of pipelines no longer referenced to the card."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms for the block (with cuBLAS's
    deterministic workspace setting, which the mode asks for). Default
    runs repeat bit for bit without it (ops/ordered_add sums the float
    scatter-adds in lane order); `--det-kernels` lists the kernels it
    changes in a frame and why none of them changes a value read
    (PERF.md §6)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def traj_diff(a, b):
    """(max position diff m, max rotation-matrix entry diff) of two runs
    over the same frames."""
    check([t for t, _, _ in a] == [t for t, _, _ in b],
          "the two runs cut different frames")
    return (max(float(np.abs(x[2] - y[2]).max()) for x, y in zip(a, b)),
            max(float(np.abs(x[1] - y[1]).max()) for x, y in zip(a, b)))


def synthetic_ate(traj, seq):
    from fast_livo2_tpu_torch.io import synthetic

    return synthetic.ate_rmse([(t, p) for t, _, p in traj], seq.gt)


def phase_pipeline(seq, mode):
    """The full-width sequence on "cuda" in `mode` (only_lio or livo):
    process(seq) unrolled so that each frame is timed on its own. The
    kernels' launch counts are set to 0 just before the run and read just
    after it."""
    cfg = full_width_config()
    pipe, events, frame_ms, syncs, launches = run_sequence(seq, mode)
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
    ate = synthetic_ate(traj, seq)
    check(ate < ATE_GATE_M, f"{mode}: ATE {ate} m >= {ATE_GATE_M} m")
    # Every frame (the map-building first one included) propagates
    # through the IMU batch once.
    check(launches["cov_scan"] == frames,
          f"cov_scan launched {launches['cov_scan']} times in {frames} frames")
    check_ordered_add(mode, launches, frames, ordered_add_sites(pipe))
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
           "ordered_add_launches": launches["ordered_add"],
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
        check(launches["photo_tail"] == pipe.photo_iterations,
              f"photo_tail launched {launches['photo_tail']} times for "
              f"{pipe.photo_iterations} photometric iterations")
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
    dp, dR = traj_diff(traj_cpu, traj_cuda[:frames])
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
    out = profile_frames(seq, mode, warm, frames, top)
    emit({"phase": "profile" if mode == "only_lio" else "profile_livo", **out})
    return out


def profile_frames(seq, mode, warm=12, frames=10, top=8, fused=False,
                   cfg=None):
    """Where a steady frame's time goes: `frames` frames after `warm`
    unprofiled ones, under torch.profiler. Reports wall and summed kernel
    time per frame, the device's idle share of the wall time, the kernel
    launches per frame, the kernels that take the most time, K1's device
    time and kernels a frame (by its kernel name: the main path's real K1
    calls), K2's share of the kernel time, its device kernels and the
    photometric iterations the frames ran (the launches a frame move with
    them). `fused`: tpu.fused_frame, each profiled frame one replay.
    `cfg`: the configuration (full_width_config() by default)."""
    from torch.profiler import ProfilerActivity, profile

    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
    from fast_livo2_tpu_torch.utils.timing import STAGES

    cfg = copy.deepcopy(cfg) if cfg is not None else full_width_config()
    cfg.tpu.fused_frame = fused
    pipe = LIVOPipeline(cfg, mode, device="cuda")
    pipe.push_sequence(seq)
    pipe.poll(max_frames=warm, flush=True)
    torch.cuda.synchronize()
    iterations = pipe.photo_iterations
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = pipe.poll(max_frames=frames, flush=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    iterations = int(pipe.photo_iterations - iterations)
    check(n == frames, f"profiled {n} frames, wanted {frames}")
    # the split frame's annotate() ranges show as device events too
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in STAGES]
    busy_ms = sum(e.device_time for e in kernels) / 1e3  # us -> ms
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    k2_ms = sum(v for k, v in by_name.items() if is_k2_kernel(k))
    k2_kernels = sum(is_k2_kernel(e.name) for e in kernels)
    k1_ms = sum(v for k, v in by_name.items() if "cov_scan_kernel" in k)
    k1_kernels = sum("cov_scan_kernel" in e.name for e in kernels)
    return {"frames": frames,
            "wall_ms_per_frame": wall_ms / frames,
            "kernel_ms_per_frame": busy_ms / frames,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
            "kernel_launches_per_frame": len(kernels) / frames,
            "cov_scan_ms_per_frame": k1_ms / frames,
            "cov_scan_kernels_per_frame": k1_kernels / frames,
            "photo_iteration_ms_per_frame": k2_ms / frames,
            "photo_iteration_kernels_per_frame": k2_kernels / frames,
            "photo_iterations_per_frame": iterations / frames,
            "photo_iteration_share_of_kernel_time": (k2_ms / busy_ms) if busy_ms else None,
            "top_kernels_ms_per_frame": [[k[:90], v / frames] for k, v in ranked]}


def profile_replays(seq, mode, what, tries=3, **kw):
    """profile_frames(fused=True) with K1, and in LIVO K2, found inside
    the replays by kernel name: more than 0.9 K1 and 19.0 K2 kernels a
    replayed frame (1 and 20 launched). The profiler can drop kernel
    events of a busy host, which only lowers the counts: a profile that
    sees fewer is taken again, each with a pipeline of its own, up to
    `tries` profiles; the counts of every profile taken are kept
    (`kernels_per_frame_by_profile`), and one that sees more than
    launched fails."""
    cfg = kw.get("cfg") or full_width_config()
    k2_launched = (cfg.vio.patch_pyrimid_level * cfg.vio.max_iterations
                   if mode == "livo" else 0)
    counts = []
    for _ in range(tries):
        out = profile_frames(seq, mode, fused=True, **kw)
        k1 = out["cov_scan_kernels_per_frame"]
        k2 = out["photo_iteration_kernels_per_frame"]
        counts.append([k1, k2])
        check(k1 <= 1.0 and k2 <= k2_launched,
              f"{what} profile: K1 {k1}, K2 {k2} kernels a replayed frame, "
              f"1 and {k2_launched} launched")
        if k1 > 0.9 and (mode != "livo" or k2 > 19.0):
            free_device_memory()
            return {**out, "kernels_per_frame_by_profile": counts}
        free_device_memory()
    check(False, f"{what}: K1 or K2 not found inside the replays in any of "
                 f"{tries} profiles ([K1, K2] a frame): {counts}")


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


def ordered_add_case(name, seed=0):
    """numpy (base (R, W), dst (n,) int64, src (n, W), sink row) at
    ORDERED_ADD_SHAPES[name], with the call site's duplicates: the map
    insert's lanes crowd 1,500 voxels of a non-zero map (a voxel holds
    ~10 lanes) and 40 % go to the sink; the downsample's are sorted,
    runs of 1-12 points a voxel, the last 1,500 (invalid) to the sink;
    the TSDF's 8,192 rays land on 20,000 voxels, 10 % out of the volume
    (the sink), the SDF samples in [-1, 1]. tests/test_torch_ordered_add.py
    and tests/test_torch_cuda.py take the same cases."""
    R, W, n = ORDERED_ADD_SHAPES[name]
    rng = np.random.default_rng(seed)
    base = np.zeros((R, W), np.float32)
    if name == "map_insert":
        voxels = rng.choice(R - 1, 1500, replace=False)
        base[voxels] = rng.normal(size=(1500, W)).astype(np.float32) * 50.0
        dst = voxels[rng.integers(0, 1500, n)]
        dst[rng.random(n) < 0.4] = R - 1
    elif name == "downsample":
        dst = np.minimum(np.repeat(np.arange(R), rng.integers(1, 13, R))[:n],
                         R - 1)
        dst[-1500:] = R - 1
    else:
        dst = rng.choice(R - 1, 20000, replace=False)[rng.integers(0, 20000, n)]
        dst[rng.random(n) < 0.1] = R - 1
    src = rng.normal(size=(n, W)).astype(np.float32)
    if name == "tsdf":
        src = np.clip(src, -1.0, 1.0)
    return base, dst.astype(np.int64), src, R - 1


def phase_kernel_ordered_add():
    """ordered_add against the CPU's index_add_ bit for bit on every row
    but the sink, at ORDERED_ADD_SHAPES (each twice: the same bits), the
    CUDA index_add_ (float atomics) and the same under deterministic
    algorithms beside it; then timed at each shape in turns (atomics,
    deterministic, kernel, kernel, deterministic, atomics): event ms,
    host us, device ms by kernel (the kernel and, but at the downsample,
    the stable sort before it). Returns the kernels-line row (the map
    insert's shape) and the phase's launches."""
    from fast_livo2_tpu_torch.ops import ordered_add

    ordered_add.LAUNCHES = 0
    shapes, row = {}, None
    for name, (R, W, n) in ORDERED_ADD_SHAPES.items():
        b_np, d_np, s_np, sink = ordered_add_case(name)
        want = torch.from_numpy(b_np.copy()).index_add_(
            0, torch.from_numpy(d_np), torch.from_numpy(s_np))[:sink]
        base0, dst, src = (torch.from_numpy(a).cuda() for a in (b_np, d_np, s_np))
        srt = name == "downsample"
        got = []
        for _ in range(2):
            before = ordered_add.LAUNCHES
            got.append(ordered_add.ordered_index_add_(base0.clone(), dst, src,
                                                      drop=sink, dst_sorted=srt))
            torch.cuda.synchronize()
            check(ordered_add.LAUNCHES == before + 1,
                  f"ordered_add {name}: no launch counted")
        check(torch.equal(got[0], got[1]), f"ordered_add {name}: two calls differ")
        err = float((got[0][:sink].cpu() - want).abs().max())
        check(torch.equal(got[0][:sink].cpu(), want),
              f"ordered_add {name}: differs from the CPU's index_add_ "
              f"(max abs {err})")
        atomic = base0.clone().index_add_(0, dst, src)
        with deterministic():
            det = base0.clone().index_add_(0, dst, src)
        torch.cuda.synchronize()
        base = base0.clone()
        fns = {"atomics": lambda: base.index_add_(0, dst, src),
               "kernel": lambda: ordered_add.ordered_index_add_(
                   base, dst, src, drop=sink, dst_sorted=srt)}
        t = {k: {"ms_turns": []} for k in ("atomics", "deterministic", "kernel")}
        # the deterministic index_add_ takes 0.3-2 ms a call: fewer calls
        slow = dict(reps=3, calls=20, warmup=5)
        for k in ("atomics", "deterministic", "kernel", "kernel",
                  "deterministic", "atomics"):
            with deterministic() if k == "deterministic" else contextlib.nullcontext():
                t[k]["ms_turns"].append(time_cuda(
                    fns.get(k, fns["atomics"]),
                    **(slow if k == "deterministic" else {})))
        for k, v in t.items():
            v["ms"] = statistics.mean(v["ms_turns"])
            if k == "deterministic":
                with deterministic():
                    per_call, by_name = device_profile(fns["atomics"], calls=10)
                    v.update(host_us=host_us(fns["atomics"], calls=100,
                                             batch=20),
                             device_ms=sum(by_name.values()),
                             device_kernels_per_call=per_call)
            else:
                v.update(timings(fns[k], event=False))
        kernel_dev = sum(v for k, v in t["kernel"]["device_ms_by_kernel"].items()
                         if "ordered_add_kernel" in k)
        # Least time: src and dst read once, each touched row read and
        # written once (the sink excluded); additions are n W flops.
        touched = int(torch.unique(dst).numel()) - int(bool((dst == sink).any()))
        nbytes = n * W * 4 + n * 8 + 2 * touched * W * 4
        bound_ms, bound_by = bound(nbytes, n * W)
        shapes[name] = {
            "R": R, "W": W, "n": n, "rows_touched": touched,
            "sink_lanes": int((dst == sink).sum()), "sorted_input": srt,
            "bitwise_cpu": True, "repeat_bitwise": True,
            "atomics_bitwise_cpu": bool(torch.equal(atomic[:sink].cpu(), want)),
            "deterministic_bitwise_cpu": bool(torch.equal(det[:sink].cpu(), want)),
            "atomics_max_abs_diff_cpu": float((atomic[:sink].cpu() - want).abs().max()),
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_device_ms": kernel_dev, "timings": t}
        if name == "map_insert":
            row = {"name": "ordered_add.ordered_index_add_", "route": "cuda",
                   "source": "fast_livo2_tpu_torch/csrc/ordered_add.cu",
                   "replaces": "none (no TPU kernel: CUDA's float index_add_ "
                               "sums in no fixed order)",
                   "max_abs_err": err, "ms": t["kernel"]["ms"],
                   "plain_ms": t["atomics"]["ms"], "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": t["deterministic"]["ms"],
                   "device_ms": t["kernel"]["device_ms"],
                   "kernel_device_ms": kernel_dev,
                   "host_us": t["kernel"]["host_us"]}
    emit({"phase": "kernel_ordered_add", "shapes": shapes,
          "phase_launches": ordered_add.LAUNCHES, "nvidia_smi": nvidia_smi()})
    return row, ordered_add.LAUNCHES


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
    dp, dR = traj_diff(b.trajectory, tail)
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


def phase_pipeline_fused(seq, mode):
    """tpu.fused_frame on the full-width sequence: four runs in turns,
    split, fused, fused, split, in one process. The fused run: frames,
    ATE, tracked points (LIVO), frame times, capture seconds, graphs,
    bytes copied back a frame, host syncs inside each replayed frame
    (0: frame 0 builds the map and frame 1 is the warm-up and capture),
    K1 / K2 launches (K2: pyramid levels x iterations a VIO frame, every
    iteration masked or not) beside the iterations that took effect.
    Returns the fused run's launches."""
    cfg = full_width_config()
    runs = []
    for fused in (False, True, True, False):
        pipe, _, ms, syncs, launches = run_sequence(seq, mode,
                                                    fused_frame=fused)
        runs.append(dict(fused=fused, traj=pipe.trajectory, ms=ms,
                         syncs=syncs, launches=launches,
                         sites=ordered_add_sites(pipe),
                         iterations=pipe.photo_iterations,
                         rows=pipe.log.rows,
                         graphs=(pipe._frame_graphs.summary() if fused
                                 else None)))
        del pipe
        free_device_memory()
    fz = runs[1]
    traj = fz["traj"]
    frames = len(traj)
    check(frames == len(runs[0]["traj"]) and frames == len(fz["ms"]),
          f"fused run: {frames} frames, split {len(runs[0]['traj'])}")
    ate = synthetic_ate(traj, seq)
    check(ate < ATE_GATE_M, f"{mode} fused: ATE {ate} m >= {ATE_GATE_M} m")
    g = fz["graphs"]
    check(g["graphs"] == 1, f"{g['graphs']} graphs captured, 1 expected")
    replayed = fz["syncs"][2:]
    check(max(replayed) == 0, f"host syncs inside replayed frames: {replayed}")
    check(fz["launches"]["cov_scan"] == frames,
          f"cov_scan launched {fz['launches']['cov_scan']} times in "
          f"{frames} fused frames")
    for r in runs:
        check_ordered_add(f"{mode} {'fused' if r['fused'] else 'split'}",
                          r["launches"], frames, r["sites"])
    check(g["launches_per_replay"][0]["ordered_add"] == fz["sites"],
          f"a replay launches ordered_add "
          f"{g['launches_per_replay'][0]['ordered_add']} times")
    # The default mode repeats: both runs of each form bit for bit (every
    # float scatter-add sums in lane order); the frame forms within the
    # golden tolerances (parity_fused's line).
    repeat = {"fused_vs_fused_2": traj_diff(runs[1]["traj"], runs[2]["traj"]),
              "split_vs_split_2": traj_diff(runs[0]["traj"], runs[3]["traj"]),
              "fused_vs_split": traj_diff(runs[1]["traj"], runs[0]["traj"])}
    for k, (dp, dR) in repeat.items():
        if k == "fused_vs_split":
            check(dp <= POS_TOL_M and dR <= ROT_TOL,
                  f"{mode} default {k}: {dp} m, {dR}")
        else:
            check(dp == dR == 0.0, f"{mode} default {k}: {dp} m, {dR}")
    dp, dR = repeat["fused_vs_split"]
    emit({"phase": "parity_fused" if mode == "only_lio"
          else "parity_fused_livo", "frames": frames, "deterministic": False,
          "runs": "the first fused and split runs of the turns",
          "max_pos_diff_m": dp, "max_rot_diff": dR, "pos_tol_m": POS_TOL_M,
          "rot_tol": ROT_TOL})
    out = {"phase": "pipeline_fused" if mode == "only_lio"
           else "pipeline_fused_livo", "mode": mode, "frames": frames,
           "ate_rmse_m": ate, "first_frame_ms": fz["ms"][0],
           "capture_frame_ms": fz["ms"][1],
           "median_frame_ms": statistics.median(fz["ms"][2:]),
           "p90_frame_ms": float(np.percentile(fz["ms"][2:], 90)),
           "turns_median_frame_ms": {
               "order": ["split", "fused", "fused", "split"],
               "median": [statistics.median(r["ms"][2:]) for r in runs]},
           "host_syncs_replayed_max": max(replayed),
           "host_syncs_split_median": statistics.median(runs[0]["syncs"][1:]),
           **g, "cov_scan_launches": fz["launches"]["cov_scan"],
           "photo_iteration_launches": fz["launches"]["photo_iteration"],
           "gather_rows_launches": fz["launches"]["gather_rows"],
           "ordered_add_launches": fz["launches"]["ordered_add"],
           "ordered_add_per_replay": fz["sites"],
           "default_mode_max_pos_diff_m": {k: v[0] for k, v in repeat.items()},
           "default_mode_max_rot_diff": {k: v[1] for k, v in repeat.items()}}
    if mode == "livo":
        vio_frames = frames - 1
        per_frame = cfg.vio.patch_pyrimid_level * cfg.vio.max_iterations
        check(fz["launches"]["photo_iteration"] == per_frame * vio_frames,
              f"photo_iteration launched {fz['launches']['photo_iteration']}"
              f" times in {vio_frames} fused VIO frames, {per_frame} each")
        tracked = [r["n_tracked"] for r in fz["rows"][3:]]
        check(np.mean(tracked) > TRACKED_GATE,
              f"fused: mean n_tracked {np.mean(tracked)} <= {TRACKED_GATE}")
        out.update({"mean_n_tracked": float(np.mean(tracked)),
                    "photo_iteration_launches_per_vio_frame":
                        fz["launches"]["photo_iteration"] / vio_frames,
                    "photo_iterations_taking_effect": fz["iterations"],
                    "photo_iterations_per_vio_frame":
                        fz["iterations"] / vio_frames,
                    "split_photo_iterations": runs[0]["iterations"]})
    emit(out)
    return fz["launches"]


def phase_profile_fused(seq, mode, warm=12, frames=10):
    """Steady fused frames under torch.profiler: kernel ms, idle share and
    kernels a frame; K1 and K2 found inside the replays by kernel name,
    with their ms a frame."""
    out = profile_replays(seq, mode, mode, warm=warm, frames=frames)
    emit({"phase": "profile_fused" if mode == "only_lio"
          else "profile_fused_livo", **out})
    return out


def phase_stage_timing(seq):
    """LIVO with tpu.stage_timing (the map insert before VIO, the device
    loops, stage marks on the card read once, at the end): every
    stage's ms > 0 on each staged frame, the table printed, and the
    trajectory against the split run with deferred_map_insert = False
    (the same order). Two default runs of one form repeat bit for bit
    (pipeline_fused_livo holds that), so the difference is the staged
    frame's."""
    from fast_livo2_tpu_torch.utils.timing import STAGES

    pipe, _, ms, syncs, _ = run_sequence(seq, "livo", stage_timing=True)
    rows = [r for r in pipe.log.rows if "lio_ms" in r]
    check(len(rows) == len(pipe.trajectory) - 1,
          f"{len(rows)} staged frames of {len(pipe.trajectory)}")
    bad = [(i, k) for i, r in enumerate(rows) for k in STAGES
           if not r.get(f"{k}_ms", 0.0) > 0.0]
    check(not bad, f"stages without time: {bad[:8]}")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        table = pipe.print_stage_table(last_n=20)
    check(printed.getvalue().strip() == table.strip()
          and all(n in table for n in STAGES + ("Total",)),
          f"stage table:\n{table}")
    staged = pipe.trajectory
    stage_ms = {k: statistics.median(r[f"{k}_ms"] for r in rows)
                for k in STAGES}
    del pipe
    free_device_memory()
    p = run_sequence(seq, "livo", deferred_map_insert=False)[0]
    dp, dR = traj_diff(staged, p.trajectory)
    del p
    free_device_memory()
    check(dp <= POS_TOL_M and dR <= ROT_TOL,
          f"staged vs split (deferred_map_insert = False): {dp} m, {dR}")
    emit({"phase": "stage_timing", "frames": len(staged),
          "staged_frames": len(rows), "median_stage_ms": stage_ms,
          "median_stage_total_ms": statistics.median(
              sum(r[f"{k}_ms"] for k in STAGES) for r in rows),
          "median_frame_ms": statistics.median(ms[1:]),
          "host_syncs_per_frame_median": statistics.median(syncs[1:]),
          "max_pos_diff_m": dp, "max_rot_diff": dR,
          "within_1e-4_m": dp <= 1e-4,
          "pos_tol_m": POS_TOL_M, "rot_tol": ROT_TOL, "table": table})


def phase_resume_fused(seq, frames):
    """tpu.fused_frame across a checkpoint: the saver runs to half the
    frames, saves and runs on uninterrupted; a second fused pipeline that
    has already captured its graph (3 frames of its own) loads the
    checkpoint, so that its next replay has to see the loaded state in
    its static buffers, and runs the rest, held to the golden tolerances
    against the uninterrupted run."""
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
    from fast_livo2_tpu_torch.io import checkpoint

    cfg = full_width_config()
    cfg.tpu.fused_frame = True
    half = frames // 2
    a = LIVOPipeline(cfg, "livo", device="cuda")
    a.push_sequence(seq)
    check(a.poll(max_frames=half, flush=True) == half, "first half")
    ck = os.path.join(REPO, "build", "smoke_resume_fused.npz")
    checkpoint.save(ck, a)
    a.poll(flush=True)
    a._finalize_host_views()
    tail = a.trajectory[half:]
    del a
    free_device_memory()
    b = LIVOPipeline(cfg, "livo", device="cuda")
    b.push_sequence(seq)
    own = 3
    check(b.poll(max_frames=own, flush=True) == own
          and len(b._frame_graphs.graphs) == 1,
          "the loading pipeline did not capture its graph first")
    static = [t.data_ptr() for t in b._frame_graphs.static_tensors()]
    checkpoint.load(ck, b)
    b._img_queue = []  # camera frames are not saved: push those after the cut
    exposure = cfg.time_offset.exposure_time_init
    for t, img in seq.images:
        if t + exposure > b.last_update_time:
            b.push_image(t, img)
    b.poll(flush=True)
    b._finalize_host_views()
    got = b.trajectory[own:]
    check([t.data_ptr() for t in b._frame_graphs.static_tensors()] == static
          and b.packed.data_ptr() == static[0]
          and len(b._frame_graphs.graphs) == 1,
          "the resumed frames did not replay the graph on its buffers")
    dp, dR = traj_diff(got, tail)
    check(dp <= POS_TOL_M and dR <= ROT_TOL,
          f"fused resumed tail vs uninterrupted fused run: {dp} m, {dR}")
    emit({"phase": "resume_fused", "frames_before": half,
          "frames_after": len(got), "max_pos_diff_m": dp,
          "max_rot_diff": dR, "pos_tol_m": POS_TOL_M, "rot_tol": ROT_TOL})
    del b
    free_device_memory()


def phase_vio_extras(seq):
    """The full-width LIVO sequence with vio.raycast_en, then with
    vio.inverse_composition_en, each split then fused: ATE, tracked
    points, raycast candidates a frame (counted in the split run's
    raycast_recover calls), frame times; fused against split at the
    golden tolerances, 0 host syncs in a replayed frame, K1 once a frame,
    K2 pyramid levels x iterations (20) a fused VIO frame with raycast
    and never with the IC update (tensor ops in both packages). The four
    runs use torch's deterministic algorithms; their frame times are
    those of that mode. Returns {flag: the fused run's launches}."""
    from fast_livo2_tpu_torch.core import vio as vio_mod

    with deterministic():
        return _vio_extras(seq, vio_mod)


def _vio_extras(seq, vio_mod):
    cfg = full_width_config()
    per_frame = cfg.vio.patch_pyrimid_level * cfg.vio.max_iterations
    out, fused_launches = {"phase": "vio_extras"}, {}
    for flag in ("raycast_en", "inverse_composition_en"):
        runs = {}
        for fused in (False, True):
            found = []
            recover = vio_mod.raycast_recover

            def spy(*a, **k):
                res = recover(*a, **k)
                found.append(torch.sum(res[2]))
                return res

            if not fused:  # (a graph would record one buffer)
                vio_mod.raycast_recover = spy
            try:
                pipe, _, ms, syncs, launches = run_sequence(
                    seq, "livo", vio={flag: True}, fused_frame=fused)
            finally:
                vio_mod.raycast_recover = recover
            traj = pipe.trajectory
            frames = len(traj)
            ate = synthetic_ate(traj, seq)
            tracked = float(np.mean([r["n_tracked"] for r in pipe.log.rows[3:]]))
            check(ate < ATE_GATE_M, f"{flag} fused={fused}: ATE {ate} m")
            check(tracked > TRACKED_GATE, f"{flag}: mean n_tracked {tracked}")
            check(launches["cov_scan"] == frames,
                  f"{flag}: cov_scan launched {launches['cov_scan']} times "
                  f"in {frames} frames")
            k2 = launches["photo_iteration"]
            if flag == "inverse_composition_en":
                check(k2 == 0, f"IC: photo_iteration launched {k2} times")
            elif fused:
                check(k2 == per_frame * (frames - 1),
                      f"raycast fused: photo_iteration launched {k2} times "
                      f"in {frames - 1} VIO frames")
            else:
                check(k2 == pipe.photo_iterations > 0,
                      f"raycast split: {k2} K2 launches, "
                      f"{pipe.photo_iterations} iterations")
            run = {"frames": frames, "ate_rmse_m": ate, "mean_n_tracked": tracked,
                   "median_frame_ms": statistics.median(ms[2:]),
                   "p90_frame_ms": float(np.percentile(ms[2:], 90)),
                   "host_syncs_per_frame_max": max(syncs[2:]),
                   "launches": launches}
            if fused:
                g = pipe._frame_graphs.summary()
                check(max(syncs[2:]) == 0,
                      f"{flag}: host syncs in replayed frames {syncs[2:]}")
                check(g["graphs"] == 1 and g["keys"][0][2]
                      == (flag == "raycast_en"), f"{flag}: graphs {g}")
                run.update(graph_keys=g["keys"], capture_seconds=g["capture_seconds"],
                           pool_bytes=g["pool_bytes"])
                fused_launches[flag] = launches
            elif flag == "raycast_en":
                n = [int(x) for x in found]
                check(len(n) == frames - 1 and sum(n) > 0,
                      f"raycast: {len(n)} recoveries, {sum(n)} candidates")
                run["raycast_candidates_per_frame"] = float(np.mean(n))
                run["raycast_candidates_max"] = max(n)
            runs["fused" if fused else "split"] = (run, traj)
            del pipe
            free_device_memory()
        dp, dR = traj_diff(runs["fused"][1], runs["split"][1])
        check(dp <= POS_TOL_M and dR <= ROT_TOL,
              f"{flag}: fused vs split {dp} m, {dR}")
        out[flag] = {"split": runs["split"][0], "fused": runs["fused"][0],
                     "fused_vs_split_pos_m": dp, "fused_vs_split_rot": dR}
    out.update(pos_tol_m=POS_TOL_M, rot_tol=ROT_TOL, deterministic=True,
               photo_iteration_launches_per_fused_vio_frame=per_frame)
    emit(out)
    return fused_launches


def _backend_graphs(pipe):
    """The graphs the backend has captured: the refiner's window variants
    and, with photometric factors on fused frames, the keyframe's capture
    (each capture synchronizes the device once)."""
    n = pipe._refiner.summary()["graphs"] if pipe._refiner else 0
    fg = pipe._frame_graphs
    return n + (len(fg.keyframe_captures) if fg is not None else 0)


def run_backend(seq, mode, refine=None, vio=None, **tpu):
    """One fused run of `seq` on the card with the backend's
    enable_online_refine(**refine) (None: without it), driven frame by
    frame, the launch counts set to 0 just before and read just after.
    Returns (pipeline, frame ms, syncs a frame, backend graphs after each
    frame, launches)."""
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    cfg = full_width_config()
    cfg.tpu.fused_frame = True
    for k, v in (vio or {}).items():
        setattr(cfg.vio, k, v)
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    pipe = LIVOPipeline(cfg, mode, device="cuda")
    if refine is not None:
        pipe.enable_online_refine(**refine)
    pipe.push_sequence(seq)
    torch.cuda.synchronize()
    reset_launches()
    ms, syncs, graphs = drive(pipe, after=_backend_graphs)
    launches = read_launches()
    pipe._finalize_host_views()
    return pipe, ms, syncs, graphs, launches


def replay_syncs(syncs, graphs):
    """Host syncs of the replayed frames (frame 0 builds the map, frame 1
    captures the frame graph) that captured no backend graph (torch's
    capture synchronizes the device once)."""
    return [n for i, n in enumerate(syncs)
            if i >= 2 and graphs[i] == graphs[i - 1]]


def refiner_numbers(pipe):
    """The refiner's numbers of one run: submits, completed windows,
    refined keyframes, its submits' host ms (the capturing ones apart),
    its windows' device ms on its stream, its graphs' capture s and pool
    MB."""
    r = pipe._refiner
    g = r.summary()
    n_cap = g["graphs"]
    return {"submits": pipe.refine_submits, "windows_completed": len(r.device_ms),
            "refined_keyframes": len(pipe.refined_keyframes),
            "keyframes": len(pipe._keyframes),
            "deltas_applied": len(pipe._refine_deltas),
            "submit_host_ms_capturing": r.submit_ms[:n_cap],
            "submit_host_ms_replay_median": (statistics.median(r.submit_ms[n_cap:])
                                             if r.submit_ms[n_cap:] else None),
            "submit_host_ms_replay_max": max(r.submit_ms[n_cap:], default=None),
            "window_device_ms_warm_up": r.device_ms[:n_cap],
            "window_device_ms_replay_median": (statistics.median(r.device_ms[n_cap:])
                                               if r.device_ms[n_cap:] else None),
            "refiner_graphs": n_cap, "refiner_variants": g["variants"],
            "refiner_capture_s": g["capture_seconds"],
            "refiner_pool_mb": [b / 2 ** 20 for b in g["pool_bytes"]]}


BACKEND = dict(keyframe_every=5, window=16, stride=8, outer_iters=2,
               gn_iters=2)


def phase_backend(lseq):
    """The online backend on the long-indoor cut, ONLY_LIO, fused frames:
    without the backend and with enable_online_refine(**BACKEND) (IMU
    links on) in turns (plain, backend, backend, plain), then with the
    submit gate at 0.05 (bench.py's). Reports the refiner's numbers, the
    refined keyframes' ATE beside the filter's at the same stamps, the
    front end's frame ms with and without it, and holds the feedback
    run's ATE to tests/test_long_run.py:120's max(1.3 x, + 0.02 m) of the
    run without it; 0 host syncs in every replayed frame that captured no
    refiner graph (so in every replayed submit), one a keyframe with the
    gate (its plane-conditioning read)."""
    from fast_livo2_tpu_torch.io import synthetic

    runs = []
    for refine in (None, BACKEND, BACKEND, None):
        pipe, ms, syncs, graphs, launches = run_backend(lseq, "only_lio",
                                                        refine)
        traj = pipe.trajectory
        run = {"backend": refine is not None, "frames": len(traj),
               "ate_rmse_m": synthetic_ate(traj, lseq),
               "median_frame_ms": statistics.median(ms[2:]),
               "p90_frame_ms": float(np.percentile(ms[2:], 90)),
               "p99_frame_ms": float(np.percentile(ms[2:], 99)),
               "max_frame_ms": max(ms[2:]),
               "replayed_frame_syncs_max": max(replay_syncs(syncs, graphs)),
               "launches": launches, "traj": traj}
        check(launches["cov_scan"] == len(traj),
              f"cov_scan launched {launches['cov_scan']} times in "
              f"{len(traj)} frames")
        check(run["replayed_frame_syncs_max"] == 0,
              f"host syncs in replayed frames: {replay_syncs(syncs, graphs)}")
        if refine is not None:
            run.update(refiner_numbers(pipe))
            refined = pipe.refined_keyframe_trajectory()
            run["refined"] = refined
            check(run["windows_completed"] == pipe.refine_submits >= 2,
                  f"{run['windows_completed']} windows completed of "
                  f"{pipe.refine_submits} submitted")
            check(all(np.isfinite(p).all() for _, _, p in refined),
                  "non-finite refined keyframe")
        runs.append(run)
        del pipe
        free_device_memory()
    plain, fb = runs[0], runs[1]
    ate_plain, ate_fb = plain["ate_rmse_m"], fb["ate_rmse_m"]
    check(ate_fb <= max(1.3 * ate_plain, ate_plain + 0.02),
          f"feedback ATE {ate_fb} m against {ate_plain} m without the backend")
    kf_ts = {t for t, _, _ in fb["refined"]}
    ate_kf_ref = synthetic.ate_rmse([(t, p) for t, _, p in fb["refined"]],
                                    lseq.gt)
    ate_kf_filter = synthetic.ate_rmse(
        [(t, p) for t, _, p in plain["traj"] if t in kf_ts], lseq.gt)
    pipe, ms, syncs, graphs, _ = run_backend(lseq, "only_lio",
                                             dict(BACKEND, gate=0.05))
    gated = {"submits": pipe.refine_submits, "skips": pipe.refine_gate_skips,
             "keyframes": len(pipe._keyframes),
             "ate_rmse_m": synthetic_ate(pipe.trajectory, lseq),
             "median_frame_ms": statistics.median(ms[2:]),
             "min_plane_cond": float(min(pipe._kf_conds)),
             "replayed_frame_syncs_max": max(replay_syncs(syncs, graphs))}
    check(pipe.refine_submits + pipe.refine_gate_skips > 0,
          "the gated run never reached a window")
    check(gated["replayed_frame_syncs_max"] <= 1,
          "gated run: more than the keyframe's one read in a replayed frame: "
          f"{replay_syncs(syncs, graphs)}")
    del pipe
    free_device_memory()
    strip = ("traj", "refined")
    emit({"phase": "backend", "sequence_s": LONG_INDOOR_S, "config": BACKEND,
          "turns": [{k: v for k, v in r.items() if k not in strip}
                    for r in runs],
          "turns_median_frame_ms": {"order": ["plain", "backend", "backend",
                                              "plain"],
                                    "median": [r["median_frame_ms"] for r in runs]},
          "ate_plain_m": ate_plain, "ate_feedback_m": ate_fb,
          "feedback_gate_m": max(1.3 * ate_plain, ate_plain + 0.02),
          "refined_keyframe_ate_m": ate_kf_ref,
          "filter_ate_at_keyframes_m": ate_kf_filter,
          "gated_0.05": gated})
    return fb["launches"]


def phase_backend_photo(seq):
    """The online backend with photometric factors on the full-width LIVO
    sequence, fused: enable_online_refine(photo=True, keyframe_every=2,
    window=8, stride=4). Photo factors captured (keyframes and their
    valid points), windows refined, ATE, K2 as in the fused LIVO phase
    (20 a VIO frame: the capture and the window's photometric terms run
    no K2), 0 syncs in replayed frames."""
    cfg = full_width_config()
    per_frame = cfg.vio.patch_pyrimid_level * cfg.vio.max_iterations
    refine = dict(photo=True, keyframe_every=2, window=8, stride=4,
                  outer_iters=2, gn_iters=2)
    pipe, ms, syncs, graphs, launches = run_backend(seq, "livo", refine)
    frames = len(pipe.trajectory)
    ate = synthetic_ate(pipe.trajectory, seq)
    caps = [kf[3] for kf in pipe._keyframes]
    valid = [int(c[4].sum()) for c in caps if c is not None]
    out = {"phase": "backend_photo", "config": refine, "frames": frames,
           "ate_rmse_m": ate, "keyframes_with_photo": len(valid),
           "photo_points_per_keyframe": float(np.mean(valid)) if valid else 0.0,
           "median_frame_ms": statistics.median(ms[2:]),
           "replayed_frame_syncs_max": max(replay_syncs(syncs, graphs)),
           "launches": launches, **refiner_numbers(pipe)}
    check(ate < ATE_GATE_M, f"backend_photo: ATE {ate} m")
    check(len(valid) == len(caps) >= refine["window"] and min(valid) > 0,
          f"photo captures: {valid} of {len(caps)} keyframes")
    check(out["windows_completed"] >= 2 and [True, True] in out["refiner_variants"],
          f"photo windows: {out['windows_completed']}, {out['refiner_variants']}")
    check(launches["photo_iteration"] == per_frame * (frames - 1),
          f"backend_photo: K2 launched {launches['photo_iteration']} times "
          f"in {frames - 1} VIO frames")
    check(out["replayed_frame_syncs_max"] == 0,
          f"host syncs in replayed frames: {replay_syncs(syncs, graphs)}")
    emit(out)
    del pipe
    free_device_memory()
    return launches


def phase_batch(seq, B=4):
    """MultiStreamReplay on the card, fused LIVO: one stream, then B
    streams of the same sequence (each its own pipeline and captured
    graph): every stream against the single one at the golden
    tolerances, aggregate frames/s beside the single stream's, peak
    memory; placement on a card the machine lacks raises."""
    from fast_livo2_tpu_torch.parallel.batch import MultiStreamReplay

    cfg = full_width_config()
    cfg.tpu.fused_frame = True
    res = {}
    for b in (1, B):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        rep = MultiStreamReplay(cfg, b, "livo", devices=["cuda:0"])
        trajs = rep.process([seq] * b)
        res[b] = dict(trajs=trajs, fps=rep.n_frames / rep.wall_s,
                      n_frames=rep.n_frames, wall_s=rep.wall_s,
                      launches=read_launches(),
                      graphs=[len(p._frame_graphs.graphs) for p in rep.pipes],
                      peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del rep
        free_device_memory()
    single = res[1]["trajs"][0]
    diffs = [traj_diff(t, single) for t in res[B]["trajs"]]
    check(all(dp <= POS_TOL_M and dR <= ROT_TOL for dp, dR in diffs),
          f"streams vs the single stream: {diffs}")
    check(res[B]["graphs"] == [1] * B, f"graphs per stream {res[B]['graphs']}")
    try:
        MultiStreamReplay(cfg, 2, "livo",
                          devices=["cuda:0", f"cuda:{torch.cuda.device_count()}"])
        raised = False
    except ValueError:
        raised = True
    check(raised, "placement on a missing card did not raise")
    emit({"phase": "batch", "streams": B, "frames_per_stream": len(single),
          "single_frames_per_s": res[1]["fps"],
          "aggregate_frames_per_s": res[B]["fps"],
          "aggregate_over_single": res[B]["fps"] / res[1]["fps"],
          "timed_frames": {1: res[1]["n_frames"], B: res[B]["n_frames"]},
          "wall_s": {1: res[1]["wall_s"], B: res[B]["wall_s"]},
          "peak_mem_gib": {1: res[1]["peak_gib"], B: res[B]["peak_gib"]},
          "max_pos_diff_m": max(d[0] for d in diffs),
          "max_rot_diff": max(d[1] for d in diffs),
          "launches": res[B]["launches"], "placement_raises": raised})
    return res[B]["launches"]


def phase_resume_backend(seq):
    """An ONLY_LIO fused run with the online backend (keyframes every 2
    frames, 4-keyframe windows) saved half-way, its window drained first,
    and loaded into a fresh pipeline: keyframes (time, state, scan) and
    refined poses equal, bit for bit; the resumed tail held to the golden
    tolerances against the uninterrupted run."""
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
    from fast_livo2_tpu_torch.io import checkpoint

    cfg = full_width_config()
    cfg.tpu.fused_frame = True
    refine = dict(keyframe_every=2, window=4, stride=2, outer_iters=1,
                  gn_iters=1)
    a = LIVOPipeline(cfg, "only_lio", device="cuda")
    a.enable_online_refine(**refine)
    a.push_sequence(seq)
    half = 25  # of the 6 s sequence's 58 frames
    check(a.poll(max_frames=half, flush=True) == half, "first half")
    a._consume_refine(force=True)
    ck = os.path.join(REPO, "build", "smoke_resume_backend.npz")
    checkpoint.save(ck, a)
    kfs = [(t, p.cpu(), sc.cpu()) for t, p, sc, _, _ in a._keyframes]
    refined = dict(a.refined_keyframes)
    a.poll(flush=True)
    a._finalize_host_views()
    tail = a.trajectory[half:]
    del a
    free_device_memory()
    b = LIVOPipeline(cfg, "only_lio", device="cuda")
    b.enable_online_refine(**refine)
    checkpoint.load(ck, b)
    same = (len(b._keyframes) == len(kfs) and all(
        t0 == kb[0] and torch.equal(p0, kb[1].cpu())
        and torch.equal(s0, kb[2].cpu())
        for (t0, p0, s0), kb in zip(kfs, b._keyframes)))
    same_ref = (set(refined) == set(b.refined_keyframes) and all(
        np.array_equal(refined[t][0], b.refined_keyframes[t][0])
        and np.array_equal(refined[t][1], b.refined_keyframes[t][1])
        for t in refined))
    check(same and same_ref and len(kfs) >= 4 and refined,
          f"loaded keyframes equal: {same}, refined poses equal: {same_ref}")
    b.poll(flush=True)
    b._finalize_host_views()
    check([t for t, _, _ in b.trajectory] == [t for t, _, _ in tail],
          f"resumed run cut {len(b.trajectory)} frames, {len(tail)} expected")
    dp, dR = traj_diff(b.trajectory, tail)
    check(dp <= POS_TOL_M and dR <= ROT_TOL,
          f"resumed backend tail vs uninterrupted run: {dp} m, {dR}")
    emit({"phase": "resume_backend", "frames_before": half,
          "frames_after": len(b.trajectory), "keyframes_loaded": len(kfs),
          "refined_loaded": len(refined),
          "refined_after": len(b.refined_keyframes),
          "max_pos_diff_m": dp, "max_rot_diff": dR, "pos_tol_m": POS_TOL_M,
          "rot_tol": ROT_TOL})
    del b
    free_device_memory()


def bag_messages(seq):
    """The sequence as the avia launch files' topics: /livox/imu
    (sensor_msgs/Imu), /livox/lidar (livox_ros_driver/CustomMsg,
    offset_time in ns, the valid-return tag 0x10) and /left_camera/image
    (raw mono8 sensor_msgs/Image, which needs no OpenCV to decode), the
    images cast to uint8 as save_sequence does."""
    from types import SimpleNamespace as NS

    from fast_livo2_tpu_torch.io import rosbag

    msgs = []
    for t, g, a in zip(seq.imu_stamps, seq.imu_gyr, seq.imu_acc):
        msgs.append(("/livox/imu", rosbag.IMU_TYPE, float(t), NS(
            header=rosbag.make_header(float(t), "imu"),
            angular_velocity=NS(x=float(g[0]), y=float(g[1]), z=float(g[2])),
            linear_acceleration=NS(x=float(a[0]), y=float(a[1]),
                                   z=float(a[2])))))
    for t, pts, offs in seq.scans:
        arr = np.zeros(len(pts), rosbag._LIVOX_PT)
        arr["offset_time"] = np.round(offs.astype(np.float64) * 1e9)
        arr["x"], arr["y"], arr["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        arr["tag"] = 0x10
        arr["line"] = np.arange(len(pts)) % 6
        msgs.append(("/livox/lidar", rosbag.LIVOX_TYPE, float(t), NS(
            header=rosbag.make_header(float(t), "livox"),
            timebase=int(round(t * 1e9)), points_arr=arr)))
    for t, img in seq.images:
        img = np.ascontiguousarray(img.astype(np.uint8))
        h, w = img.shape
        msgs.append(("/left_camera/image", rosbag.IMAGE_TYPE, float(t), NS(
            header=rosbag.make_header(float(t), "camera"), height=h, width=w,
            encoding="mono8", is_bigendian=False, step=w, data=img.tobytes())))
    return msgs


def cli_run(seq_dir, out, root):
    """`python -m fast_livo2_tpu_torch.run` in process on "cuda" over an npz
    sequence, under deterministic algorithms, the kernels' launch counts
    set to 0 just before and read just after: (summary, wall s, launches,
    trajectory rows)."""
    from fast_livo2_tpu_torch import run

    with deterministic():
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = run.main(["--config", os.path.join(root, "sensor.yaml"),
                                "--seq", seq_dir, "--out", out,
                                "--device", "cuda"])
        wall_s = time.perf_counter() - t0
        launches = read_launches()
    return summary, wall_s, launches, np.loadtxt(os.path.join(out,
                                                              "trajectory.txt"))


def ros_time(t):
    """t as a ROS1 header carries it and the converter reads it back:
    (sec, nsec) rounded to the nanosecond, then sec + nsec * 1e-9."""
    sec = int(t)
    return sec + int(round((t - sec) * 1e9)) * 1e-9


def phase_rosbag(seq, frames):
    """The user's bag: the full-width LIVO sequence written to a ROS1 bag
    by the port's write_bag, converted by `python -m
    fast_livo2_tpu_torch.convert_rosbag --blind 0` in a subprocess, and
    the converted sequence held against the source: points bit for bit
    as float32, IMU samples and images equal, stamps and point offsets
    within 1 us. Then the port's CLI on "cuda" under deterministic
    algorithms over the converted sequence and over the source saved as
    npz with its stamps as ROS time carries them (ros_time: the
    generator's float64 stamps, e.g. 0.05 + 0.1 = 0.15000000000000002,
    differ from the bag's 0.15 in the last bit, and where an IMU stamp
    equals a scan's end that bit decides which samples a frame
    integrates). The generator's gt.npz is copied beside the converted
    sequence (a bag carries no ground truth). Gates: run_cli's ATE gates
    on both runs, the two trajectories bit for bit the same, K1 and K2
    launched as often on the bag run as on the npz run."""
    from fast_livo2_tpu_torch.io import dataset, rosbag, synthetic

    root = os.path.join(REPO, "build", "smoke_bag")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    bag = os.path.join(root, "livo.bag")
    t0 = time.perf_counter()
    msgs = bag_messages(seq)
    rosbag.write_bag(bag, msgs)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(bag)
    conv = os.path.join(root, "converted")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "fast_livo2_tpu_torch.convert_rosbag",
                        bag, conv, "--blind", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    convert_s = time.perf_counter() - t0
    check(p.returncode == 0, f"convert_rosbag failed:\n{p.stderr[-3000:]}")
    src = os.path.join(root, "source")
    dataset.save_sequence(src, dataset.NpzSequence(
        imu_stamps=np.array([ros_time(t) for t in seq.imu_stamps]),
        imu_gyr=seq.imu_gyr, imu_acc=seq.imu_acc,
        scans=[(ros_time(t), p_, o) for t, p_, o in seq.scans],
        images=[(ros_time(t), im) for t, im in seq.images], gt=seq.gt))
    shutil.copy(os.path.join(src, "gt.npz"), os.path.join(conv, "gt.npz"))
    a, b = dataset.load_sequence(conv), dataset.load_sequence(src)
    check(len(a.scans) == len(seq.scans) and len(a.images) == len(seq.images)
          and len(a.imu_stamps) == len(seq.imu_stamps),
          f"converted {len(a.scans)} scans / {len(a.images)} images / "
          f"{len(a.imu_stamps)} IMU, source {len(seq.scans)} / "
          f"{len(seq.images)} / {len(seq.imu_stamps)}")
    points_equal = all(np.array_equal(x[1], y[1].astype(np.float32))
                       for x, y in zip(a.scans, seq.scans))
    images_equal = all(np.array_equal(x[1], y[1].astype(np.uint8))
                       for x, y in zip(a.images, seq.images))
    imu_equal = (np.array_equal(a.imu_gyr, seq.imu_gyr)
                 and np.array_equal(a.imu_acc, seq.imu_acc))
    stamp_err = max(
        float(np.abs(a.imu_stamps - seq.imu_stamps).max()),
        max(abs(x[0] - y[0]) for x, y in zip(a.scans, seq.scans)),
        max(abs(x[0] - y[0]) for x, y in zip(a.images, seq.images)))
    offs_err = max(float(np.abs(x[2].astype(np.float64) - y[2]).max())
                   for x, y in zip(a.scans, seq.scans))
    check(points_equal and images_equal and imu_equal,
          f"converted != source: points {points_equal}, images "
          f"{images_equal}, IMU {imu_equal}")
    check(stamp_err <= 1e-6 and offs_err <= 1e-6,
          f"converted stamps {stamp_err} s, point offsets {offs_err} s")
    # the two CLI inputs: the same arrays, bit for bit
    check(np.array_equal(a.imu_stamps, b.imu_stamps)
          and all(x[0] == y[0] and np.array_equal(x[1], y[1])
                  and np.array_equal(x[2], y[2])
                  for x, y in zip(a.scans, b.scans))
          and all(x[0] == y[0] and np.array_equal(x[1], y[1])
                  for x, y in zip(a.images, b.images)),
          "the converted sequence and the ROS-time source differ")
    sensor_yaml(os.path.join(root, "sensor.yaml"))
    runs = {}
    for name, d in (("bag", conv), ("npz", src)):
        summary, wall_s, launches, rows = cli_run(
            d, os.path.join(root, f"out_{name}"), root)
        check(summary["mode"] == "livo" and summary["frames"] == frames,
              f"{name}: CLI ran {summary['frames']} {summary['mode']} frames")
        check(summary["ate_rmse_m"] < ATE_GATE_M,
              f"{name}: CLI ATE {summary['ate_rmse_m']} m")
        ate_interp = synthetic.ate_rmse([(r[0], r[1:4]) for r in rows], seq.gt)
        check(ate_interp < ATE_GATE_M, f"{name}: trajectory ATE {ate_interp} m")
        runs[name] = dict(summary=summary, wall_s=wall_s, launches=launches,
                          rows=rows, ate_interp=ate_interp)
    rb, rn = runs["bag"]["rows"], runs["npz"]["rows"]
    check(rb.shape == rn.shape, f"the bag run wrote {rb.shape} rows, the npz "
                                f"run {rn.shape}")
    dp = float(np.abs(rb[:, 1:4] - rn[:, 1:4]).max())
    dq = float(np.abs(rb[:, 4:8] - rn[:, 4:8]).max())
    check(np.array_equal(rb, rn), f"bag vs npz trajectory: {dp} m, "
                                  f"quaternion {dq}")
    lb, ln = runs["bag"]["launches"], runs["npz"]["launches"]
    check(lb == ln and ln["cov_scan"] > 0 and ln["photo_iteration"] > 0,
          f"launches: bag run {lb}, npz run {ln}")
    emit({"phase": "rosbag", "messages": len(msgs), "bag_bytes": size,
          "write_s": write_s, "write_mb_per_s": size / 1e6 / write_s,
          "convert_s": convert_s, "convert_mb_per_s": size / 1e6 / convert_s,
          "converter_stdout": p.stdout.strip(),
          "points_bitwise_equal": points_equal, "images_equal": images_equal,
          "max_stamp_err_s": stamp_err, "max_offset_err_s": offs_err,
          "frames": frames, "traj_max_pos_diff_m": dp,
          "traj_max_quat_diff": dq, "deterministic": True,
          **{f"{n}_{k}": runs[n][k] for n in runs
             for k in ("wall_s", "launches", "ate_interp")},
          **{f"{n}_ate_rmse_m": runs[n]["summary"]["ate_rmse_m"] for n in runs}})
    return lb


SHARD_FRAMES = 36  # LIVO frames before the window: 17 keyframes, 1 in 2
SHARD_WINDOW = 16
SHARD_MAP_UPDATES = 10
SHARD_REPS = 3


def shard_inputs(seq, root):
    """The sharded phase's inputs from a split LIVO run on "cuda" of
    SHARD_FRAMES frames with a keyframe every 2 (photometric factors
    captured): the live map (3 layers of 2^18 slots), the posterior state
    and covariance, the next scan voxel-downsampled to max_points_down
    (8,192) as the LIO's body points, the next SHARD_MAP_UPDATES scans'
    downsampled points put into the world at that state as map updates,
    and the last SHARD_WINDOW keyframes' window, IMU links and
    photometric factors. Written to root/inputs.npz (the map's
    configuration to root/map_cfg.json); returned as (numpy arrays, the
    map configuration)."""
    from fast_livo2_tpu_torch.core import lio as lio_mod
    from fast_livo2_tpu_torch.core import voxel_map as vm
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
    from fast_livo2_tpu_torch.core.state import unpack_state

    cfg = full_width_config()
    pipe = LIVOPipeline(cfg, "livo", device="cuda")
    pipe.keyframe_every = 2
    pipe.refine_photo = True
    pipe.push_sequence(seq)
    check(pipe.poll(max_frames=SHARD_FRAMES, flush=True) == SHARD_FRAMES,
          "sharded: the LIVO run stopped early")
    kfs = pipe._keyframes[-SHARD_WINDOW:]
    check(len(kfs) == SHARD_WINDOW, f"sharded: {len(kfs)} keyframes")
    state, cov = unpack_state(pipe.packed)
    i_next = next(i for i, (t, _, _) in enumerate(seq.scans)
                  if t > pipe.last_update_time)

    def down(i):
        pts = torch.as_tensor(seq.scans[i][1], dtype=torch.float32,
                              device="cuda")
        return lio_mod.voxel_downsample(
            pts, torch.ones(pts.shape[0], dtype=torch.bool, device="cuda"),
            cfg.preprocess.filter_size_surf, cfg.tpu.max_points_down)

    body, valid = down(i_next)
    R_ext = state.rot @ pipe.ext_R
    frames, fvalid, var6 = [], [], []
    for i in range(i_next + 1, i_next + 1 + SHARD_MAP_UPDATES):
        pts, ok = down(i)
        frames.append((pts @ pipe.ext_R.T + pipe.ext_T) @ state.rot.T + state.pos)
        var6.append(vm.sym6(R_ext @ lio_mod.calc_body_cov(
            pts, cfg.lio.dept_err, cfg.lio.beam_err) @ R_ext.T))
        fvalid.append(ok)
    window = pipe._kf_window(kfs)
    links = pipe._build_links(kfs)
    photo = pipe._build_photo(kfs)
    check(photo is not None, "sharded: keyframes without photometric factors")
    data = {"map_keys": pipe.vmap_state.keys, "map_stats": pipe.vmap_state.stats,
            "map_rec": pipe.vmap_state.rec, "rot": state.rot, "pos": state.pos,
            "vel": state.vel, "bias_g": state.bias_g, "bias_a": state.bias_a,
            "grav": state.grav, "inv_expo": state.inv_expo, "cov": cov,
            "body": body, "valid": valid, "ext_R": pipe.ext_R,
            "ext_T": pipe.ext_T, "frames": torch.stack(frames),
            "frames_valid": torch.stack(fvalid), "frames_var6": torch.stack(var6),
            "Rci": pipe.Rci, "Pci": pipe.Pci,
            **{f"w_{k}": v for k, v in window._asdict().items()},
            **{f"l_{k}": v for k, v in links._asdict().items()},
            **{f"p_{k}": v for k, v in photo._asdict().items()}}
    data = {k: v.cpu().numpy() for k, v in data.items()}
    np.savez(os.path.join(root, "inputs.npz"), **data)
    map_cfg = pipe.map_cfg
    with open(os.path.join(root, "map_cfg.json"), "w") as f:
        json.dump(map_cfg._asdict(), f)
    del pipe
    free_device_memory()
    return data, map_cfg


def load_map_cfg(root):
    from fast_livo2_tpu_torch.core import voxel_map as vm

    with open(os.path.join(root, "map_cfg.json")) as f:
        d = json.load(f)
    return vm.VoxelMapConfig(**{**d, "layer_init_num": tuple(d["layer_init_num"])})


def shard_calls(data, map_cfg, mesh):
    """The sharded phase's four calls on "cuda" (mesh=None: one process),
    each run once and then timed SHARD_REPS times (host clock around the
    call and a device synchronize): the measurement-sharded lio_update,
    SHARD_MAP_UPDATES update_map(mesh=) calls in a row (the frame's
    insert), refine_window(mesh=) with IMU links and photometric factors,
    and refine_window_map_sharded (single process: the replicated
    refine_window it is held against). Returns (results as numpy, ms a
    call, collective bytes a call)."""
    from fast_livo2_tpu_torch.core import lio as lio_mod
    from fast_livo2_tpu_torch.core import voxel_map as vm
    from fast_livo2_tpu_torch.core.state import NavState, pack_state
    from fast_livo2_tpu_torch.models import camera
    from fast_livo2_tpu_torch.parallel import ba, map_shard
    from fast_livo2_tpu_torch.parallel import sharding as shd

    cfg = full_width_config()
    t = {k: torch.as_tensor(v, device="cuda") for k, v in data.items()}
    vmap = vm.VoxelMap(t["map_keys"], t["map_stats"], t["map_rec"])
    state = NavState(*(t[k] for k in NavState._fields))
    shard = ((lambda x: x) if mesh is None
             else (lambda x: shd.shard_points(x, mesh)))
    window = ba.Window(*(t[f"w_{k}"] for k in ba.Window._fields))
    links = ba.ImuLinks(*(t[f"l_{k}"] for k in ba.ImuLinks._fields))
    photo = ba.PhotoFactors(*(t[f"p_{k}"] for k in ba.PhotoFactors._fields))
    cam = camera.make_camera(cfg.camera)

    def lio():
        return lio_mod.lio_update(
            state, t["cov"], vmap, shard(t["body"]), shard(t["valid"]),
            t["ext_R"], t["ext_T"], map_cfg, dept_err=cfg.lio.dept_err,
            beam_err=cfg.lio.beam_err, max_iterations=cfg.lio.max_iterations,
            rematch_fresh=cfg.tpu.lio_rematch_fresh,
            fresh_every_iter=cfg.tpu.lio_fresh_every_iter,
            plane_info_cap=cfg.tpu.lio_plane_info_cap, mesh=mesh)

    def maps():
        m = vmap
        with shd.deterministic(m.keys.device):
            for f in range(SHARD_MAP_UPDATES):
                m = vm.update_map(m, shard(t["frames"][f]),
                                  shard(t["frames_var6"][f]),
                                  shard(t["frames_valid"][f]), map_cfg,
                                  mesh=mesh, compact=True)
        return m

    def refine():
        return ba.refine_window(
            window, map_cfg, outer_iters=2, gn_iters=2, mesh=mesh,
            imu_links=links, photo=photo, cam=cam, Rci=t["Rci"], Pci=t["Pci"],
            patch_size=cfg.vio.patch_size,
            photo_weight=1.0 / cfg.vio.img_point_cov)

    def refine_map():
        if mesh is None:
            return ba.refine_window(window, map_cfg, outer_iters=2, gn_iters=2)
        return map_shard.refine_window_map_sharded(window, map_cfg, mesh,
                                                   outer_iters=2, gn_iters=2)

    out, ms, nbytes = {}, {}, {}
    for name, fn in (("lio", lio), ("map", maps), ("refine", refine),
                     ("refine_map", refine_map)):
        res = fn()
        torch.cuda.synchronize()
        b0 = 0 if mesh is None else mesh.collective_bytes
        times = []
        for _ in range(SHARD_REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(times)
        nbytes[name] = (0 if mesh is None
                        else (mesh.collective_bytes - b0) / SHARD_REPS)
        if name == "lio":
            out["lio_packed"] = pack_state(res.state, res.cov)
            out["lio_n_eff"] = res.n_effective
        elif name == "map":
            for k, v in res._asdict().items():
                out[f"map_{k}_sha256"] = hashlib.sha256(
                    v.cpu().numpy().tobytes()).hexdigest()
            out["map_count"] = (res.keys[..., 0] != vm.EMPTY).sum()
        else:
            out[f"{name}_rot"], out[f"{name}_pos"] = res[0].rot, res[0].pos
            out[f"{name}_n_used"] = res[1]
    out = {k: v.cpu().numpy() if torch.is_tensor(v) else v
           for k, v in out.items()}
    return out, ms, nbytes


def shard_rank(argv):
    """`chip_smoke.py --shard-rank ADDR WORLD RANK DIR`: one gloo rank on
    cuda:0 of the sharded phase; its results to DIR/rank<RANK>.json."""
    import torch.distributed as dist

    from fast_livo2_tpu_torch.parallel import sharding as shd

    addr, world, rank, root = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=addr, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = shd.make_mesh(device="cuda")
        with np.load(os.path.join(root, "inputs.npz")) as z:
            data = {k: z[k] for k in z.files}
        out, ms, nbytes = shard_calls(data, load_map_cfg(root), mesh)
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump({"out": {k: v.tolist() if isinstance(v, np.ndarray)
                               else v for k, v in out.items()},
                       "ms": ms, "collective_bytes": nbytes,
                       "mesh": repr(mesh)}, f)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_sharded(seq, world=2):
    """Sharding over torch.distributed on the card: `world` gloo ranks,
    each a process of this script on cuda:0, run shard_calls at the full-
    width configuration (8,192 points, 3 layers of 2^18 slots, a 16-
    keyframe window) against this process's single-process calls on the
    same inputs: the LIO state and the refined windows at the golden
    tolerances, n_effective equal, the map replicas bit for bit equal
    after SHARD_MAP_UPDATES updates (and beside the single process's).
    Then the same lio_update under NCCL with world size 1 in this
    process, and a CUDA graph capture of the keyframe-sharded refine
    under NCCL attempted (recorded, not required). Each call's ms and
    collective bytes."""
    import torch.distributed as dist

    from fast_livo2_tpu_torch.parallel import sharding as shd

    root = os.path.join(REPO, "build", "smoke_shard")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    data, map_cfg = shard_inputs(seq, root)
    inputs_s = time.perf_counter() - t0
    single, single_ms, _ = shard_calls(data, map_cfg, None)
    addr = f"tcp://127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--shard-rank", addr, str(world), str(r), root],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO) for r in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=600)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks_s = time.perf_counter() - t0
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"sharded rank {r} failed:\n{errs[r][-3000:]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    got = ranks[0]["out"]
    for r in ranks[1:]:
        check(r["out"] == got, "the ranks returned different results: "
              + str([k for k in got if r["out"][k] != got[k]]))
    diffs = {}
    state_diff = float(np.abs(np.array(got["lio_packed"])[:25]
                              - single["lio_packed"][:25]).max())
    check(state_diff <= POS_TOL_M and got["lio_n_eff"] == int(single["lio_n_eff"]),
          f"sharded LIO vs one process: state {state_diff}, n_eff "
          f"{got['lio_n_eff']} vs {single['lio_n_eff']}")
    diffs["lio_state_max"] = state_diff
    for name in ("refine", "refine_map"):
        dp = float(np.abs(np.array(got[f"{name}_pos"]) - single[f"{name}_pos"]).max())
        dR = float(np.abs(np.array(got[f"{name}_rot"]) - single[f"{name}_rot"]).max())
        check(dp <= POS_TOL_M and dR <= ROT_TOL,
              f"sharded {name} vs one process: {dp} m, {dR}")
        diffs[f"{name}_pos_m"], diffs[f"{name}_rot"] = dp, dR
    map_equal_single = all(got[f"map_{k}_sha256"] == single[f"map_{k}_sha256"]
                           for k in ("keys", "stats", "rec"))

    # NCCL, world size 1, in this process
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = shd.make_mesh(device="cuda")
        nccl, nccl_ms, nccl_bytes = shard_calls(data, map_cfg, mesh)
        nccl_diff = float(np.abs(nccl["lio_packed"][:25]
                                 - single["lio_packed"][:25]).max())
        check(nccl_diff <= POS_TOL_M and nccl["lio_n_eff"] == single["lio_n_eff"],
              f"NCCL LIO vs one process: {nccl_diff}")
        capture = nccl_refine_capture(data, map_cfg, mesh)
    finally:
        dist.destroy_process_group()
    emit({"phase": "sharded", "world": world, "backend": "gloo",
          "device": "cuda:0 (every rank)", "mesh": ranks[0]["mesh"],
          "points": int(data["body"].shape[0]),
          "map_slots": list(data["map_keys"].shape[:2]),
          "window": list(data["w_scans"].shape[:2]),
          "inputs_s": inputs_s, "ranks_wall_s": ranks_s,
          "ms": {f"rank{r}": x["ms"] for r, x in enumerate(ranks)},
          "single_ms": single_ms,
          "collective_bytes_per_call": ranks[0]["collective_bytes"],
          "map_replicas_bitwise_equal": True,
          "map_equal_single_process": map_equal_single,
          "map_voxels": got["map_count"], "lio_n_eff": got["lio_n_eff"],
          "max_diff_vs_single": diffs, "pos_tol_m": POS_TOL_M,
          "rot_tol": ROT_TOL, "nccl_world1_lio_diff": nccl_diff,
          "nccl_world1_ms": nccl_ms, "nccl_world1_bytes_per_call": nccl_bytes,
          "nccl_refine_capture": capture})


def nccl_refine_capture(data, map_cfg, mesh):
    """Whether refine_window(mesh=) under NCCL captures as a CUDA graph
    (the OnlineRefiner runs it eagerly with a mesh): "ok" with the replay's
    largest difference from the eager call, or the capture's error."""
    from fast_livo2_tpu_torch.parallel import ba

    window = ba.Window(*(torch.as_tensor(data[f"w_{k}"], device="cuda")
                         for k in ba.Window._fields))
    eager, _ = ba.refine_window(window, map_cfg, outer_iters=1, gn_iters=2,
                                mesh=mesh)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on the capture's stream
        ba.refine_window(window, map_cfg, outer_iters=1, gn_iters=2, mesh=mesh)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out, _ = ba.refine_window(window, map_cfg, outer_iters=1,
                                      gn_iters=2, mesh=mesh)
        graph.replay()
        torch.cuda.synchronize()
        return {"result": "ok", "replay_vs_eager_pos_m":
                float((out.pos - eager.pos).abs().max())}
    except Exception as e:  # recorded: the capture is a question, not a gate
        torch.cuda.synchronize()
        return {"result": "error", "error": f"{type(e).__name__}: {e}"[:400]}


# ---- the JAX package's last operating points (bench.py's hard,
# long_outdoor and dense phases, scripts/soak.py) and the port's tools ----

# bench.py:142-144's image and LiDAR degradation
DEGRADE = dict(img_photon_noise=1.2, img_read_noise=2.5, img_blur_px=0.6,
               range_noise=0.02, lidar_dropout=0.05, lidar_outlier_frac=0.005)
LONG_INDOOR_S = 30.0  # of bench.py's 75 s long-indoor sequence
HARD_S, SOAK_S, OUTDOOR_S, DENSE_S = 3.0, 20.0, 45.0, 4.0
HARD_ATE_GATE_M = 0.03  # tests/test_hard_scene.py:66-71
# scripts/soak.py's capacities but tests/test_soak.py's 2,048-point pool:
# the 20 s flight allocates ~3,250 points (the port's CPU run), so the
# script's 4,096 would never wrap and the pool's churn would go unseen.
SOAK_POOL = 2048
SOAK_MIN = dict(map_slides=3, ring_wraps=20, pool_wraps=1)
# tests/test_long_run.py:237-309: drift (ATE / path length) in percent
OUTDOOR_DRIFT_GATES = {"capped": 0.5, "uncapped": 2.0, "voxel_1m": 0.5}
DENSE_ATE_GATE_M = 0.05
# the card's TSDF against the CPU's (phase_tools says why any voxel
# differs): how far off a voxel face a sample that changed voxel may lie,
# in voxels, and the share of touched voxels that may differ
MESH_FACE_TOL = 1e-3
MESH_VOXEL_SHARE = 1e-3
# in the order the phases read them
SEQUENCES = ("long_indoor", "hard", "soak", "outdoor", "dense")


def make_sequence(name):
    """The sequence of one of the backend's or this slice's phases, at its
    published width. long_indoor: the first LONG_INDOOR_S seconds of
    bench.py's long-indoor sequence (bench.py:372-387: the multi-room +
    corridor scene, the 74 s waypoint loop, its noise and biases),
    24 x 1000 points, without images (the backend phase runs ONLY_LIO);
    the others: bench.py:290-304, scripts/soak.py:53-74,
    bench.py:435-460, bench.py:510-520."""
    from fast_livo2_tpu_torch import soak
    from fast_livo2_tpu_torch.io import synthetic
    from fast_livo2_tpu_torch.models import camera

    if name == "long_indoor":
        return synthetic.make_sequence(
            duration=LONG_INDOOR_S, lidar_hz=10.0, imu_hz=200.0, seed=31,
            n_lines=24, n_per_line=1000, render=False, fov_deg=360.0,
            planes=synthetic.long_indoor_scene(),
            traj=synthetic.WaypointTrajectory(
                synthetic.long_indoor_waypoints(loops=1), duration=74.0),
            max_range=45.0, gyr_noise=2e-3, acc_noise=2e-2, range_noise=0.02,
            bias_g=np.array([0.002, -0.0015, 0.001]),
            bias_a=np.array([0.05, -0.03, 0.08]), lidar_dropout=0.05,
            lidar_outlier_frac=0.005)
    if name == "hard":
        return synthetic.make_sequence(
            duration=HARD_S, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0,
            cam=camera.make_camera(camera_config()), seed=7, n_lines=24,
            n_per_line=1000, render=True, fov_deg=360.0,
            planes=synthetic.hard_scene(), traj=synthetic.hard_trajectory(),
            exposure_fn=lambda t: 1.0 + 0.25 * np.sin(0.8 * t), **DEGRADE)
    if name == "soak":
        return soak.soak_sequence(SOAK_S, "livo", soak.soak_config(SOAK_POOL))
    if name == "outdoor":
        return synthetic.make_sequence(
            duration=OUTDOOR_S, lidar_hz=10.0, imu_hz=200.0, seed=32,
            n_lines=24, n_per_line=1000, render=False, fov_deg=360.0,
            planes=synthetic.long_outdoor_scene(),
            traj=synthetic.WaypointTrajectory(
                synthetic.long_outdoor_waypoints(), duration=44.0),
            max_range=80.0, gyr_noise=2e-3, acc_noise=2e-2, range_noise=0.03,
            bias_g=np.array([0.002, -0.0015, 0.001]),
            bias_a=np.array([0.05, -0.03, 0.08]), lidar_dropout=0.05,
            lidar_outlier_frac=0.005)
    if name == "dense":
        return synthetic.make_sequence(
            duration=DENSE_S, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0,
            cam=camera.make_camera(camera_config()), seed=5, n_lines=48,
            n_per_line=2000, render=True, fov_deg=360.0, **DEGRADE)
    raise ValueError(f"no sequence {name!r}")


def make_sequences(root):
    """Build SEQUENCES, then the rigs' recordings (make_rig), one after
    another into root/NAME (npz sequence directories; root/rig_NAME). Each
    lands under a temporary name and is renamed when complete, so
    `wait_built` can take it while the next one builds."""
    from fast_livo2_tpu_torch.io import dataset

    for name in SEQUENCES + tuple(f"rig_{r}" for r in RIGS):
        t0 = time.perf_counter()
        tmp = os.path.join(root, f".{name}")
        if name.startswith("rig_"):
            make_rig(name[4:], tmp)
        else:
            dataset.save_sequence(tmp, make_sequence(name))
        with open(os.path.join(tmp, "built_s.txt"), "w") as f:
            f.write(repr(time.perf_counter() - t0))
        os.replace(tmp, os.path.join(root, name))


def start_sequences():
    """Build the sequences in one child process at the lowest CPU priority
    (`chip_smoke.py --make-sequences DIR`), while the earlier phases use
    the card: one host core, as the one build before this slice's phases
    took, where a builder for each sequence would load the host under
    the profiled and host-timed phases. Returns (process, directory,
    start time)."""
    root = os.path.join(REPO, "build", "smoke_sequences")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    err = open(os.path.join(root, "stderr.txt"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--make-sequences", root],
                            stdout=subprocess.DEVNULL, stderr=err)
    err.close()
    return proc, root, time.perf_counter()


def wait_built(started, name):
    """Wait until the child has built `name`. Returns (its directory, when
    it was built and ready, and how long this waited)."""
    proc, root, t0 = started
    path = os.path.join(root, name)
    t_wait = time.perf_counter()
    while not os.path.isdir(path):
        if proc.poll() is not None or time.perf_counter() - t_wait > 900:
            with open(os.path.join(root, "stderr.txt")) as f:
                err = f.read()[-2000:]
            check(False, f"{name} not built (child exit "
                         f"{proc.poll()}):\n{err}")
        time.sleep(0.2)
    with open(os.path.join(path, "built_s.txt")) as f:
        built_s = float(f.read())
    return path, {"built_in_s": built_s,
                  "ready_after_s": time.perf_counter() - t0,
                  "waited_s": time.perf_counter() - t_wait}


def wait_sequence(started, name):
    """Wait until the child has built `name`, and load it."""
    from fast_livo2_tpu_torch.io import dataset

    path, ready = wait_built(started, name)
    seq = dataset.load_sequence(path)
    emit({"phase": f"{name}_sequence", "scans": len(seq.scans),
          "images": len(seq.images),
          "points_per_scan": int(np.median([len(p) for _, p, _ in seq.scans])),
          **ready})
    return seq


def run_forms(seq, mode, cfg, forms):
    """One run of `seq` per form: "split", "fused", or either with
    "_det" (under deterministic algorithms). Returns {form: dict(pipe,
    traj, ms, syncs, launches, graphs)}; the pipelines are released."""
    runs = {}
    for form in forms:
        ctx = deterministic() if form.endswith("_det") else contextlib.nullcontext()
        with ctx:
            pipe, _, ms, syncs, launches = run_sequence(
                seq, mode, cfg=cfg, fused_frame=form.startswith("fused"))
        runs[form] = dict(pipe=pipe, traj=pipe.trajectory, ms=ms, syncs=syncs,
                          launches=launches, ordered_add_sites=ordered_add_sites(pipe),
                          graphs=(pipe._frame_graphs.summary()
                                  if pipe._frame_graphs else None))
    return runs


def release(runs):
    for r in runs.values():
        r.pop("pipe", None)
    free_device_memory()


def fused_checks(name, r, vio_frames=None, per_frame=None):
    """A fused run's contract: one capture for the whole run (no
    recapture at a slide, a ring wrap or a pool wrap), 0 host syncs in
    every replayed frame, the slides' frames included (frame 0 builds the
    map, frame 1 captures), K1 once a frame and, on VIO frames, K2
    `per_frame` times. Returns the numbers."""
    g, frames = r["graphs"], len(r["traj"])
    check(g["graphs"] == 1, f"{name}: {g['graphs']} graphs captured")
    replayed = r["syncs"][2:]
    check(max(replayed) == 0, f"{name}: host syncs in replayed frames "
                              f"{[i + 2 for i, n in enumerate(replayed) if n]}")
    check(r["launches"]["cov_scan"] == frames,
          f"{name}: cov_scan launched {r['launches']['cov_scan']} times in "
          f"{frames} fused frames")
    check(g["launches_per_replay"][0]["ordered_add"] == r["ordered_add_sites"],
          f"{name}: a replay launches ordered_add "
          f"{g['launches_per_replay'][0]['ordered_add']} times, "
          f"{r['ordered_add_sites']} sites")
    check_ordered_add(name, r["launches"], frames, r["ordered_add_sites"])
    out = {"graphs": g["graphs"], "capture_s": g["capture_seconds"][0],
           "graph_pool_bytes": g["pool_bytes"][0],
           "host_syncs_replayed_max": max(replayed),
           "median_frame_ms": statistics.median(r["ms"][2:])}
    if vio_frames is not None:
        k2 = r["launches"]["photo_iteration"]
        check(k2 == per_frame * vio_frames,
              f"{name}: photo_iteration launched {k2} times in {vio_frames} "
              f"VIO frames, {per_frame} each")
        out["photo_iteration_launches_per_vio_frame"] = k2 / vio_frames
    return out


def split_checks(name, r, pipe_iterations=None):
    """A split run: K1 once a frame, ordered_add once a site; in LIVO, K2
    once a photometric iteration that took effect."""
    frames = len(r["traj"])
    check(r["launches"]["cov_scan"] == frames,
          f"{name}: cov_scan launched {r['launches']['cov_scan']} times in "
          f"{frames} split frames")
    check_ordered_add(name, r["launches"], frames, r["ordered_add_sites"])
    if pipe_iterations is not None:
        check(r["launches"]["photo_iteration"] == pipe_iterations > 0,
              f"{name}: photo_iteration launched "
              f"{r['launches']['photo_iteration']} times for "
              f"{pipe_iterations} photometric iterations")
    return {"median_frame_ms": statistics.median(r["ms"][1:]),
            "host_syncs_per_frame_median": statistics.median(r["syncs"][1:])}


def phase_hard(hseq):
    """bench.py:290-304's hard scene at full width (24 x 1000 points,
    640 x 512 frames with DEGRADE and an exposure ramp, the core
    configuration), LIVO split then fused: ATE < 0.03 m in both
    (tests/test_hard_scene.py:66-71). Returns the fused run's launches."""
    cfg = full_width_config()
    per_frame = cfg.vio.patch_pyrimid_level * cfg.vio.max_iterations
    runs = run_forms(hseq, "livo", cfg, ("split", "fused"))
    out = {"phase": "hard", "seconds": HARD_S}
    for form, r in runs.items():
        frames = len(r["traj"])
        check(frames >= 20, f"hard {form}: {frames} frames")
        ate = synthetic_ate(r["traj"], hseq)
        check(ate < HARD_ATE_GATE_M,
              f"hard {form}: ATE {ate} m >= {HARD_ATE_GATE_M} m")
        nums = (split_checks(f"hard {form}", r, r["pipe"].photo_iterations)
                if form == "split" else
                fused_checks(f"hard {form}", r, frames - 1, per_frame))
        out[form] = {"frames": frames, "ate_rmse_m": ate,
                     "cov_scan_launches": r["launches"]["cov_scan"],
                     "photo_iteration_launches":
                         r["launches"]["photo_iteration"], **nums}
    release(runs)
    emit(out)
    return runs["fused"]["launches"]


def phase_soak(sseq):
    """scripts/soak.py's capacity-cycling soak at its published width (20
    s, 12 x 500 points, 320 x 256 frames; 2^15 slots, 4 observations a
    point, an 8-frame ring, map sliding at 1 m, a 30-voxel half map) with
    a SOAK_POOL-point pool, LIVO split then fused. Both forms pass the
    script's gates and cycle at least SOAK_MIN (slides, ring wraps, pool
    wraps); the fused run captures once and syncs 0 times in a replay;
    the two read 0.0 m apart (the float scatter-adds sum in lane order,
    ops/ordered_add). Returns the fused run's launches."""
    from fast_livo2_tpu_torch import soak

    cfg = soak.soak_config(SOAK_POOL)
    per_frame = cfg.vio.patch_pyrimid_level * cfg.vio.max_iterations
    runs = run_forms(sseq, "livo", cfg, ("split", "fused"))
    out = {"phase": "soak", "seconds": SOAK_S, "pool": SOAK_POOL,
           "frame_ring": cfg.tpu.frame_ring}
    for form in ("split", "fused"):
        r = runs[form]
        pipe = r["pipe"]
        res = {**soak.gates(r["traj"], sseq, pipe), **soak.cycle_counts(pipe)}
        check(not res["failed"], f"soak {form}: {res['failed']}")
        for k, n in SOAK_MIN.items():
            check(res[k] >= n, f"soak {form}: {k} {res[k]} < {n}")
        nums = (split_checks(f"soak {form}", r, pipe.photo_iterations)
                if form == "split" else
                fused_checks(f"soak {form}", r, len(r["traj"]) - 1, per_frame))
        out[form] = {**res, **nums,
                     "cov_scan_launches": r["launches"]["cov_scan"],
                     "photo_iteration_launches":
                         r["launches"]["photo_iteration"]}
    dp, dR = traj_diff(runs["fused"]["traj"], runs["split"]["traj"])
    check(dp == 0.0 and dR == 0.0, f"soak fused vs split: {dp} m, {dR}")
    out["fused_vs_split"] = {"max_pos_diff_m": dp, "max_rot_diff": dR}
    release(runs)
    emit(out)
    return runs["fused"]["launches"]


def outdoor_config(voxel=2.0, info_cap=0):
    """bench.py:449-478: LIVOConfig() at the MARS_LVIG point, voxel_size
    `voxel`, filter_size_surf 0.5, map sliding (half map 50, threshold
    8 m), tpu.lio_plane_info_cap `info_cap`."""
    from fast_livo2_tpu_torch.utils.config import LIVOConfig

    cfg = LIVOConfig()
    cfg.lio.voxel_size = voxel
    cfg.preprocess.filter_size_surf = 0.5
    cfg.local_map.map_sliding_en = True
    cfg.local_map.half_map_size = 50
    cfg.local_map.sliding_thresh = 8.0
    cfg.tpu.lio_plane_info_cap = info_cap
    return cfg


def phase_outdoor(oseq):
    """bench.py:435-500's outdoor flight at full width (45 s, 24 x 1000
    points, 80 m range, 2 m voxels, map sliding), ONLY_LIO fused in three
    configurations: lio_plane_info_cap = 1 (the shipped MARS config), no
    cap, and 1 m voxels; drift (ATE / path) <= 0.5 / 2.0 / 0.5 %
    (tests/test_long_run.py:237-309), slides > 0. The capped run is a
    deterministic fused + split pair (0.0 m); its final map's census
    (diag_map.census) on a line of its own. Returns the capped fused
    run's launches."""
    from fast_livo2_tpu_torch import diag_map

    gt_p = np.array([g[2] for g in oseq.gt])
    path_m = float(np.sum(np.linalg.norm(np.diff(gt_p, axis=0), axis=1)))
    out = {"phase": "outdoor", "seconds": OUTDOOR_S, "path_m": path_m}
    variants = (("capped", outdoor_config(info_cap=1), ("fused_det", "split_det")),
                ("uncapped", outdoor_config(), ("fused",)),
                ("voxel_1m", outdoor_config(voxel=1.0), ("fused",)))
    launches = None
    for name, cfg, forms in variants:
        runs = run_forms(oseq, "only_lio", cfg, forms)
        r = runs[forms[0]]
        pipe = r["pipe"]
        ate = synthetic_ate(r["traj"], oseq)
        drift = 100.0 * ate / path_m
        gate = OUTDOOR_DRIFT_GATES[name]
        check(drift <= gate, f"outdoor {name}: drift {drift} % > {gate} %")
        check(pipe.map_slides > 0, f"outdoor {name}: the map never slid")
        out[name] = {"form": forms[0], "frames": len(r["traj"]),
                     "ate_rmse_m": ate, "drift_pct": drift,
                     "drift_gate_pct": gate, "map_slides": pipe.map_slides,
                     **fused_checks(f"outdoor {name}", r)}
        if name == "capped":
            launches = r["launches"]
            split = runs["split_det"]
            split_checks("outdoor capped split", split)
            dp, dR = traj_diff(r["traj"], split["traj"])
            check(dp == 0.0 and dR == 0.0,
                  f"outdoor capped fused vs split, deterministic: {dp} m, {dR}")
            out[name]["split_vs_fused"] = {"max_pos_diff_m": dp,
                                           "max_rot_diff": dR}
            out[name]["split_median_frame_ms"] = statistics.median(split["ms"][1:])
            emit({"phase": "outdoor_census", "variant": name,
                  "census": diag_map.census(pipe)})
        release(runs)
    emit(out)
    return launches


def dense_config():
    """bench.py:521-528: the core configuration with a 0.075 m leaf,
    131,072 points a scan, 32,768 after downsampling, descend_compact
    16,384, insert_compact 8,192 and max_tracked_points 512 (a field no
    path of either package reads: the tracked slots stay the 396 grid
    cells of a 640 x 512 frame)."""
    cfg = full_width_config()
    cfg.preprocess.filter_size_surf = 0.075
    cfg.tpu.max_points_per_scan = 131072
    cfg.tpu.max_points_down = 32768
    cfg.tpu.descend_compact = 16384
    cfg.tpu.insert_compact = 8192
    cfg.tpu.max_tracked_points = 512
    return cfg


def phase_dense(dseq):
    """bench.py:510-533's dense workload (4 s, 48 x 2000 points, 640 x
    512 frames), LIVO split then fused: ATE < 0.05 m in both, K2 20 times
    a fused VIO frame, the capture's seconds and pool bytes; then K1's
    and K2's device ms a frame from one profile of 10 replays. Returns the
    fused run's launches."""
    cfg = dense_config()
    per_frame = cfg.vio.patch_pyrimid_level * cfg.vio.max_iterations
    runs = run_forms(dseq, "livo", cfg, ("split", "fused"))
    out = {"phase": "dense", "seconds": DENSE_S,
           "points_per_scan": int(np.median([len(p) for _, p, _ in dseq.scans]))}
    for form, r in runs.items():
        ate = synthetic_ate(r["traj"], dseq)
        check(ate < DENSE_ATE_GATE_M,
              f"dense {form}: ATE {ate} m >= {DENSE_ATE_GATE_M} m")
        nums = (split_checks(f"dense {form}", r, r["pipe"].photo_iterations)
                if form == "split" else
                fused_checks(f"dense {form}", r, len(r["traj"]) - 1, per_frame))
        out[form] = {"frames": len(r["traj"]), "ate_rmse_m": ate, **nums,
                     "photo_iteration_launches":
                         r["launches"]["photo_iteration"]}
    vcfg = runs["fused"]["pipe"].vio_cfg
    out["tracked_slots"] = vcfg.grid_n_width * vcfg.grid_n_height
    release(runs)
    out["profile_fused"] = profile_replays(dseq, "livo", "dense", cfg=cfg)
    emit(out)
    return runs["fused"]["launches"]


def phase_tools(seq):
    """The port's tools on the card, as a user calls them:
    - mesh: `fast_livo2_tpu_torch.mesh` on the run_cli phase's cloud.pcd
      (TSDF on "cuda"), vertices and faces > 0; the volume integrated
      twice on the card, bit for bit the same (the SDF sums in lane
      order, ops/ordered_add); its volume against the
      same module's on "cpu". A voxel's tsdf is a weighted mean of
      samples in [-1, 1], and float32 sums of n terms in another order
      part by <= n x 2^-24 (~3e-6 at n = 448), hence 1e-5. The ray
      samples' positions are computed in another order too (a ray's
      length is a reduction), so a sample within a rounding of a voxel
      face may land on its other side, moving its weight to the
      neighbour. The check holds that cause to what it predicts: every
      sample whose voxel differs between the devices moved to a face
      neighbour and lies within MESH_FACE_TOL of that face (an ulp of a
      100 m coordinate is ~1e-5 of a voxel), and every voxel that
      differs in weight, or by more than 1e-5 in tsdf, is one such a
      sample left or entered; as a backstop, at most MESH_VOXEL_SHARE
      of the touched voxels differ;
    - export_planes: the CLI on run_cli's checkpoint, and
      export_plane_ply on a fused LIVO run's map: the PLY's planes equal
      the occupied _ISPL rows of derive_rec, 8 faces each;
    - fleet_scaling: B = 1, 2, 4 streams on cuda:0, aggregate frames/s
      ("placed" only with a second card)."""
    from fast_livo2_tpu_torch import export_planes, fleet_scaling, mesh
    from fast_livo2_tpu_torch.core import voxel_map as vm
    from fast_livo2_tpu_torch.io import tsdf
    from fast_livo2_tpu_torch.io.export import read_pcd

    cli = os.path.join(REPO, "build", "smoke_cli")
    root = os.path.join(REPO, "build", "smoke_tools")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {"phase": "tools"}
    pcd = os.path.join(cli, "out", "cloud.pcd")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        nv, nf = mesh.main([pcd, "-o", os.path.join(root, "mesh.ply")])
    mesh_s = time.perf_counter() - t0
    check(nv > 0 and nf > 0, f"mesh: {nv} vertices, {nf} faces")
    clouds = [read_pcd(pcd)]
    pts = clouds[0][0]
    vols = {d: mesh.integrate_clouds(clouds, device=d) for d in ("cuda", "cpu")}
    again = mesh.integrate_clouds(clouds, device="cuda")
    check(torch.equal(again.tsdf, vols["cuda"].tsdf)
          and torch.equal(again.weight, vols["cuda"].weight),
          "mesh: two integrations on the card differ")
    del again
    w_c, w_h = vols["cuda"].weight.cpu(), vols["cpu"].weight
    dt = (vols["cuda"].tsdf.cpu() - vols["cpu"].tsdf).abs()
    grid = w_h.shape[0]
    # each sample's position in voxels on each device, as integrate bins
    # it (floor), with integrate's 3 + 1 + 3 samples a ray
    u = {}
    for d, v in vols.items():
        u[d] = tsdf.ray_samples(
            v, torch.from_numpy(np.array(pts, np.float32)).to(d),
            torch.as_tensor(mesh.cloud_sensor(pts), device=d),
            7)[0].cpu().reshape(-1, 3)
    i_c, i_h = torch.floor(u["cuda"]).long(), torch.floor(u["cpu"]).long()

    def inside(i):
        return ((i >= 0) & (i < grid)).all(-1)

    moved = (i_c != i_h).any(-1) & (inside(i_c) | inside(i_h))
    step = (i_c - i_h)[moved]
    axis = step.abs().argmax(-1, keepdim=True)
    face = torch.maximum(i_c, i_h)[moved].gather(-1, axis)
    face_dist = (u["cpu"][moved].gather(-1, axis) - face).abs()
    face_dist_max = float(face_dist.max()) if len(face_dist) else 0.0
    check(bool((step.abs().sum(-1) == 1).all()),
          "mesh volume cuda vs cpu: a sample moved past a face neighbour")
    check(face_dist_max <= MESH_FACE_TOL,
          f"mesh volume cuda vs cpu: a sample moved from {face_dist_max} "
          "voxel off a face")
    near = torch.zeros(grid ** 3, dtype=torch.bool)
    for i in (i_c[moved], i_h[moved]):
        i = i[inside(i)]
        near[(i[:, 0] * grid + i[:, 1]) * grid + i[:, 2]] = True
    differs = ((w_c != w_h) | (dt > 1e-5)).reshape(-1)
    check(not bool((differs & ~near).any()),
          f"mesh volume cuda vs cpu: {int((differs & ~near).sum())} voxels "
          "differ that no face sample explains")
    touched = int(((w_c > 0) | (w_h > 0)).sum())
    share = int(differs.sum()) / max(touched, 1)
    check(share <= MESH_VOXEL_SHARE,
          f"mesh volume cuda vs cpu: {int(differs.sum())} of {touched} "
          "voxels differ")
    out["mesh"] = {"points": len(pts), "vertices": nv, "faces": nf,
                   "wall_s": mesh_s, "card_repeat_bitwise": True,
                   "touched_voxels": touched,
                   "voxels_differing_cpu": int(differs.sum()),
                   "weight_differing_cpu": int((w_c != w_h).sum()),
                   "samples": len(i_h), "samples_moved": int(moved.sum()),
                   "moved_face_dist_max_voxel": face_dist_max,
                   "face_tol_voxel": MESH_FACE_TOL,
                   "tsdf_max_abs_diff_equal_weight": float(
                       dt[w_c == w_h].max()),
                   "share_differing": share, "share_tol": MESH_VOXEL_SHARE}
    del vols
    with contextlib.redirect_stdout(io.StringIO()):
        n_cli = export_planes.main([os.path.join(cli, "ck.npz"), "--config",
                                    os.path.join(cli, "sensor.yaml"), "-o",
                                    os.path.join(root, "planes_cli.ply")])
    check(n_cli > 0, "export_planes CLI wrote no plane")
    runs = run_forms(seq, "livo", full_width_config(), ("fused",))
    pipe = runs["fused"]["pipe"]
    path = os.path.join(root, "planes.ply")
    t0 = time.perf_counter()
    n = export_planes.export_plane_ply(pipe.vmap_state, pipe.map_cfg, path)
    export_s = time.perf_counter() - t0
    rec = vm.derive_rec(pipe.vmap_state, pipe.map_cfg)
    occupied = (pipe.vmap_state.keys != vm.EMPTY).all(-1)
    n_ispl = int(((rec[..., vm._ISPL] > 0.5) & occupied).sum())
    with open(path) as f:
        faces = next(int(line.split()[-1]) for line in f
                     if line.startswith("element face"))
    check(n == n_ispl > 0 and faces == 8 * n,
          f"export_planes: {n} planes, {faces} faces, {n_ispl} _ISPL rows")
    out["export_planes"] = {"planes": n, "ispl_rows": n_ispl, "faces": faces,
                            "write_s": export_s, "cli_planes": n_cli,
                            "ply_bytes": os.path.getsize(path)}
    release(runs)
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rows = fleet_scaling.main(["1", "2", "4"])
    out["fleet_scaling"] = {
        "frames_per_s": {str(B): fps for B, fps, _ in rows},
        "placed": ("not measured: one card" if torch.cuda.device_count() < 2
                   else {str(B): p for B, _, p in rows}),
        "printed_not_measured": "placed: not measured" in printed.getvalue()}
    emit(out)


# ------------------------------------------------------------------ rigs
# The four sensor rigs the repo ships (configs/), each from its own
# recording to a trajectory through the CLI on the card. A rig: its
# config pair, scene, LiDAR pattern (lines x points over a horizontal
# field of view, the rig's points a scan), camera rate and seconds, and
# whether it is recorded as a ROS bag. K2 launches a fused VIO frame:
# pyramid levels x iterations, on the pinhole cameras and the fisheye.
RIGS = {
    # Every rig's default runs, two of each form, are held to 0.0 m apart:
    # the float scatter-adds sum in lane order (ops/ordered_add).
    "avia": dict(sensor="avia.yaml", camera="camera_pinhole.yaml",
                 scene="room", lines=24, per_line=1000, fov_deg=70.0,
                 img_hz=10.0, seconds=4.0, degrade=True, bag=True),
    "ntu_viral": dict(sensor="ntu_viral.yaml", camera="camera_ntu_viral.yaml",
                      scene="room", lines=16, per_line=1024, fov_deg=360.0,
                      img_hz=10.0, seconds=4.0, bag=True),
    "hilti22": dict(sensor="hilti22.yaml", camera="camera_fisheye_hilti22.yaml",
                    scene="room", lines=32, per_line=2000, fov_deg=360.0,
                    img_hz=40.0, seconds=4.0, bag=True),
    # the first 6 s of bench.py:435-450's outdoor flight (its scene,
    # waypoints, noise and biases), rendered at 2448 x 2048. Its LIVO
    # start is chaotic, in both packages: on this recording the JAX
    # package against itself with every scan point moved by one ulp
    # parts by centimetres (PERF.md §6). Its default runs repeat, but
    # which trajectory a repeatable run lands on is chaos: its drift gate
    # is on the deterministic pair.
    "mars_lvig": dict(sensor="mars_lvig.yaml", camera="camera_mars_lvig.yaml",
                      scene="outdoor", lines=24, per_line=1000, fov_deg=70.0,
                      img_hz=10.0, seconds=6.0, max_range=80.0, bag=False,
                      gate_default=False),
}
RIG_ATE_GATES = {"avia": 0.05, "ntu_viral": 0.05,
                 "hilti22": 0.06}  # tests/test_pipeline_livo.py:166
RIG_DRIFT_GATE_PCT = 0.5  # mars_lvig: tests/test_long_run.py:237-309
# bench.py:435-450's outdoor noise and biases (mars_lvig)
OUTDOOR_NOISE = dict(gyr_noise=2e-3, acc_noise=2e-2, range_noise=0.03,
                     bias_g=np.array([0.002, -0.0015, 0.001]),
                     bias_a=np.array([0.05, -0.03, 0.08]), lidar_dropout=0.05,
                     lidar_outlier_frac=0.005)
# PointCloud2 layouts (name, offset, datatype, numpy type): ouster_ros's
# point (x y z, intensity, t ns from the scan start, ring; 48 bytes) and
# hesai_ros's XT32 point (x y z, intensity, timestamp s, ring; 48 bytes).
OUSTER_FIELDS = (("x", 0, 7, "f4"), ("y", 4, 7, "f4"), ("z", 8, 7, "f4"),
                 ("intensity", 16, 7, "f4"), ("t", 20, 6, "u4"),
                 ("ring", 26, 2, "u1"))
XT32_FIELDS = (("x", 0, 7, "f4"), ("y", 4, 7, "f4"), ("z", 8, 7, "f4"),
               ("intensity", 16, 7, "f4"), ("timestamp", 24, 8, "f8"),
               ("ring", 32, 4, "u2"))
POINT_STEP = 48
# K2 at each rig's processed camera and tracked-slot count
RIG_K2_SHAPES = (("avia", 396), ("ntu_viral", 486), ("hilti22", 432),
                 ("mars_lvig", 378))


def rig_paths(name):
    r = RIGS[name]
    return (os.path.join(REPO, "configs", r["sensor"]),
            os.path.join(REPO, "configs", r["camera"]))


def rig_extrinsics(cfg):
    """(R, T, R_ci, P_ci): the yaml's LiDAR-to-IMU extrinsic (p_I = R p_L +
    T, as core/pipeline.py reads it) and the camera from the IMU
    (R_ci = Rcl R^T, P_ci = Pcl - Rcl R^T T)."""
    e = cfg.extrin_calib
    R = np.array(e.extrinsic_R, np.float64).reshape(3, 3)
    T = np.array(e.extrinsic_T, np.float64)
    Rcl = np.array(e.Rcl, np.float64).reshape(3, 3)
    Pcl = np.array(e.Pcl, np.float64)
    return R, T, Rcl @ R.T, Pcl - Rcl @ R.T @ T


def rig_frames(seq, cfg):
    """io/synthetic's sequence (points and poses in the IMU frame, true
    time) as the rig records it: each scan in the rig's LiDAR frame (p_L
    = R^T (p_I - T)), each stream's stamps the true time less the yaml's
    offset for it (load_sequence(cfg=) adds them back; the IMU's is
    subtracted there, so added here); the ground truth in true time."""
    from fast_livo2_tpu_torch.io import dataset

    R, T, _, _ = rig_extrinsics(cfg)
    off = cfg.time_offset
    return dataset.NpzSequence(
        imu_stamps=seq.imu_stamps + off.imu_time_offset,
        imu_gyr=seq.imu_gyr, imu_acc=seq.imu_acc,
        scans=[(t - off.lidar_time_offset,
                ((p.astype(np.float64) - T) @ R).astype(np.float32), o)
               for t, p, o in seq.scans],
        images=[(t - off.img_time_offset, im) for t, im in seq.images],
        gt=seq.gt)


def rig_sequence(name, cfg, seconds=None, lines=None, per_line=None,
                 seed=0):
    """The rig's recording (rig_frames): io/synthetic's scene rendered
    through cfg's camera at scale 1.0 (the shipped yaml: its full
    resolution) with the rig's extrinsics and camera rate, scanned with
    its LiDAR pattern. `seconds`, `lines`, `per_line`: RIGS' unless
    given (the CPU tests' smaller runs)."""
    from fast_livo2_tpu_torch.io import synthetic
    from fast_livo2_tpu_torch.models import camera as cam_mod

    r = RIGS[name]
    full = copy.deepcopy(cfg.camera)
    full.scale = 1.0
    _, _, R_ci, P_ci = rig_extrinsics(cfg)
    kw = dict(DEGRADE) if r.get("degrade") else {}
    if r["scene"] == "outdoor":
        kw.update(OUTDOOR_NOISE, planes=synthetic.long_outdoor_scene(),
                  traj=synthetic.WaypointTrajectory(
                      synthetic.long_outdoor_waypoints(), duration=44.0))
    seq = synthetic.make_sequence(
        duration=seconds or r["seconds"], lidar_hz=10.0, img_hz=r["img_hz"],
        imu_hz=200.0, cam=cam_mod.make_camera(full), seed=seed,
        n_lines=lines or r["lines"], n_per_line=per_line or r["per_line"],
        render=True, fov_deg=r["fov_deg"], R_ci=R_ci, P_ci=P_ci,
        max_range=r.get("max_range"), **kw)
    return rig_frames(seq, cfg)


def _pointcloud2(fields, t, values):
    """A sensor_msgs/PointCloud2 of one scan (`values`: field -> column)."""
    from types import SimpleNamespace as NS

    from fast_livo2_tpu_torch.io import rosbag

    dt = np.dtype({"names": [f[0] for f in fields],
                   "formats": [f[3] for f in fields],
                   "offsets": [f[1] for f in fields], "itemsize": POINT_STEP})
    n = len(values["x"])
    arr = np.zeros(n, dt)
    for f in dt.names:
        arr[f] = values[f]
    return NS(header=rosbag.make_header(t, "lidar"), height=1, width=n,
              fields=[NS(name=f[0], offset=f[1], datatype=f[2], count=1)
                      for f in fields],
              is_bigendian=False, point_step=POINT_STEP,
              row_step=POINT_STEP * n, data=arr.tobytes(), is_dense=True)


def rig_bag_messages(seq, cfg, lines):
    """The recording as (topic, type, stamp, message) on the yaml's topics:
    sensor_msgs/Imu, the rig's LiDAR driver's message (Livox CustomMsg
    for type 1, an Ouster or Hesai XT32 PointCloud2 for types 3 and 5,
    each point's line from its place in the scan) and raw mono8 images."""
    from types import SimpleNamespace as NS

    from fast_livo2_tpu_torch.io import rosbag

    c, lidar_type = cfg.common, cfg.preprocess.lidar_type
    msgs = [(c.imu_topic, rosbag.IMU_TYPE, float(t), NS(
        header=rosbag.make_header(float(t), "imu"),
        angular_velocity=NS(x=float(g[0]), y=float(g[1]), z=float(g[2])),
        linear_acceleration=NS(x=float(a[0]), y=float(a[1]), z=float(a[2]))))
        for t, g, a in zip(seq.imu_stamps, seq.imu_gyr, seq.imu_acc)]
    for t, pts, offs in seq.scans:
        t = float(t)
        ring = np.arange(len(pts)) % lines
        if lidar_type == 1:
            arr = np.zeros(len(pts), rosbag._LIVOX_PT)
            arr["offset_time"] = np.round(offs.astype(np.float64) * 1e9)
            arr["x"], arr["y"], arr["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
            arr["tag"] = 0x10
            arr["line"] = ring % 6
            mtype, msg = rosbag.LIVOX_TYPE, NS(
                header=rosbag.make_header(t, "livox"),
                timebase=int(round(t * 1e9)), points_arr=arr)
        else:
            cols = dict(x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
                        intensity=100.0, ring=ring)
            if lidar_type == 3:
                cols["t"] = np.round(offs.astype(np.float64) * 1e9)
                fields = OUSTER_FIELDS
            else:
                cols["timestamp"] = t + offs.astype(np.float64)
                fields = XT32_FIELDS
            mtype, msg = rosbag.PC2_TYPE, _pointcloud2(fields, t, cols)
        msgs.append((c.lid_topic, mtype, t, msg))
    for t, img in seq.images:
        img = np.ascontiguousarray(img.astype(np.uint8))
        h, w = img.shape
        msgs.append((c.img_topic, rosbag.IMAGE_TYPE, float(t), NS(
            header=rosbag.make_header(float(t), "camera"), height=h, width=w,
            encoding="mono8", is_bigendian=False, step=w, data=img.tobytes())))
    return msgs


def make_rig(name, path):
    """The rig's recording under `path`: rig.bag (the port's write_bag) and
    gt.npz, or (no bag) an npz sequence directory `seq` with gt.npz."""
    from fast_livo2_tpu_torch.io import dataset, rosbag
    from fast_livo2_tpu_torch.utils.config import load_config

    cfg = load_config(*rig_paths(name))
    seq = rig_sequence(name, cfg)
    if RIGS[name]["bag"]:
        os.makedirs(path)
        rosbag.write_bag(os.path.join(path, "rig.bag"),
                         rig_bag_messages(seq, cfg, RIGS[name]["lines"]))
        dataset.save_sequence(os.path.join(path, "truth"), dataset.NpzSequence(
            imu_stamps=seq.imu_stamps[:0], imu_gyr=seq.imu_gyr[:0],
            imu_acc=seq.imu_acc[:0], scans=[], images=[], gt=seq.gt))
        os.replace(os.path.join(path, "truth", "gt.npz"),
                   os.path.join(path, "gt.npz"))
    else:
        dataset.save_sequence(os.path.join(path, "seq"), seq)
        shutil.copy(os.path.join(path, "seq", "gt.npz"),
                    os.path.join(path, "gt.npz"))


def fused_yaml(sensor, path):
    """A copy of the sensor yaml with `tpu: fused_frame: true` (the tpu
    section is additive)."""
    import yaml

    with open(sensor) as f:
        doc = yaml.safe_load(f)
    doc.setdefault("tpu", {})["fused_frame"] = True
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)


def cli_rig_run(config, camera, seq_dir, out):
    """`python -m fast_livo2_tpu_torch.run --config --camera --seq --out
    --device cuda` in process, its pipeline's `process` driven frame by
    frame (`drive`: each frame timed, its host syncs counted) with the
    kernels' launch counts set to 0 just before and read just after.
    Returns (summary, wall s, dict(traj rows, ms, syncs, launches,
    graphs, n_tracked, iterations))."""
    from fast_livo2_tpu_torch import run
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    got = {}
    process = LIVOPipeline.process

    def driven(pipe, seq, max_frames=None, progress=False):
        pipe.push_sequence(seq)
        torch.cuda.synchronize()
        reset_launches()
        got["ms"], got["syncs"] = drive(pipe)
        got["launches"] = read_launches()
        pipe._finalize_host_views()
        got["graphs"] = (pipe._frame_graphs.summary()
                         if pipe._frame_graphs is not None else None)
        got["ordered_add_sites"] = ordered_add_sites(pipe)
        got["n_tracked"] = [r.get("n_tracked", 0) for r in pipe.log.rows]
        got["iterations"] = pipe.photo_iterations
        got["levels_x_iterations"] = (pipe.vio_cfg.pyramid_levels
                                      * pipe.vio_cfg.max_iterations)
        got["fused_k2"] = (pipe.cam.model in ("pinhole", "equidistant")
                           and pipe.vio_cfg.pallas_photo)
        got["traj"] = list(pipe.trajectory)
        return pipe.trajectory

    LIVOPipeline.process = driven
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = run.main(["--config", config, "--camera", camera,
                                "--seq", seq_dir, "--out", out,
                                "--device", "cuda"])
        wall_s = time.perf_counter() - t0
    finally:
        LIVOPipeline.process = process
    free_device_memory()
    return summary, wall_s, got


def rig_seq_dir(name, cfg, built, root, out):
    """The rig's recording under `built` as the CLI reads it: a bag
    converted by `python -m fast_livo2_tpu_torch.convert_rosbag` with the
    yaml's lidar type, blind, point_filter_num and topics, in a
    subprocess, into root/seq (the convert s, bag bytes and converter's
    line into `out`); or (no bag) the npz sequence as built."""
    if not RIGS[name]["bag"]:
        return os.path.join(built, "seq")
    bag = os.path.join(built, "rig.bag")
    seq_dir = os.path.join(root, "seq")
    c, p = cfg.common, cfg.preprocess
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fast_livo2_tpu_torch.convert_rosbag", bag,
         seq_dir, "--lidar-type", str(p.lidar_type), "--blind",
         str(p.blind), "--filter-num", str(p.point_filter_num),
         "--lid-topic", c.lid_topic, "--imu-topic", c.imu_topic,
         "--img-topic", c.img_topic],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    out["convert_s"] = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"rig {name}: convert_rosbag failed:\n{proc.stderr[-3000:]}")
    out["bag_bytes"] = os.path.getsize(bag)
    out["converter_stdout"] = proc.stdout.strip()
    shutil.copy(os.path.join(built, "gt.npz"), seq_dir)
    return seq_dir


def ulp_copy(seq_dir, out):
    """A copy of the npz sequence seq_dir with every scan point moved by
    one float32 ulp (toward +inf)."""
    shutil.copytree(seq_dir, out)
    with np.load(os.path.join(seq_dir, "scans.npz")) as z:
        scans = dict(z)
    scans["points"] = np.nextafter(scans["points"], np.float32(np.inf))
    np.savez_compressed(os.path.join(out, "scans.npz"), **scans)


def rig_spread(name, runs):
    """How far the card's split runs of a rig part (`chip_smoke.py
    --rig-spread NAME [RUNS]`): its recording built and converted as the
    rigs phase does, then `runs` default (non-deterministic) split runs
    through the CLI, and under deterministic algorithms one run of the
    recording and one of a copy with every scan point moved by one ulp.
    Prints one line: each run's ATE, and each run's gap from the first
    default run and the deterministic one-ulp run's from its base run
    (max |dp|, max rotation-entry gap, the first frame where |dp| > 1
    mm or the tracked-point count differs); the trajectories go to
    chiprun_out/rig_spread_NAME.npz."""
    from fast_livo2_tpu_torch.io import synthetic
    from fast_livo2_tpu_torch.utils.config import load_config

    sensor, camera = rig_paths(name)
    cfg = load_config(sensor, camera)
    root = os.path.join(REPO, "build", "rig_spread", name)
    shutil.rmtree(root, ignore_errors=True)
    make_rig(name, os.path.join(root, "rec"))
    out = {"phase": f"rig_spread_{name}"}
    seq_dir = rig_seq_dir(name, cfg, os.path.join(root, "rec"), root, out)
    ulp_copy(seq_dir, os.path.join(root, "ulp"))
    g = np.load(os.path.join(root, "rec", "gt.npz"))
    gt = [(t, None, p) for t, p in zip(g["stamps"], g["pos"])]
    got = {}
    for form in [f"split_{i}" for i in range(runs)] + ["det", "det_ulp"]:
        with (deterministic() if form.startswith("det")
              else contextlib.nullcontext()):
            _, _, got[form] = cli_rig_run(
                sensor, camera, os.path.join(root, "ulp")
                if form == "det_ulp" else seq_dir,
                os.path.join(root, f"out_{form}"))
    pos = {k: np.array([p for _, _, p in v["traj"]]) for k, v in got.items()}
    rot = {k: np.array([R for _, R, _ in v["traj"]]) for k, v in got.items()}

    def gap(a, b):
        dp = np.linalg.norm(pos[a] - pos[b], axis=1)
        over = np.flatnonzero(dp > 1e-3)
        tracked = np.flatnonzero(np.array(got[a]["n_tracked"])
                                 != np.array(got[b]["n_tracked"]))
        return {"max_dp_m": float(dp.max()),
                "max_dR": float(np.abs(rot[a] - rot[b]).max()),
                "first_frame_dp_over_1mm": int(over[0]) if len(over) else None,
                "first_frame_n_tracked_differs":
                    int(tracked[0]) if len(tracked) else None}

    out["ate_m"] = {k: synthetic.ate_rmse(
        [(t, p) for t, _, p in v["traj"]], gt) for k, v in got.items()}
    out["vs_split_0"] = {k: gap(k, "split_0") for k in got if k != "split_0"}
    out["det_ulp_vs_det"] = gap("det_ulp", "det")
    out["nvidia_smi"] = nvidia_smi()
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    np.savez(os.path.join(REPO, "chiprun_out", f"rig_spread_{name}.npz"),
             **{f"pos_{k}": v for k, v in pos.items()},
             **{f"tracked_{k}": np.array(got[k]["n_tracked"]) for k in got})
    emit(out)


def frame_kernels(seq, cfg, warm=12, frames=10):
    """{device kernel name: [launches, device ms] a frame} over `frames`
    fused LIVO frames after `warm` (the capture among them), under
    torch.profiler; the pipeline is built, captured and replayed under
    whatever mode the caller set."""
    from torch.profiler import ProfilerActivity, profile

    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    pipe = LIVOPipeline(cfg, "livo", device="cuda")
    pipe.push_sequence(seq)
    pipe.poll(max_frames=warm, flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        n = pipe.poll(max_frames=frames, flush=True)
        torch.cuda.synchronize()
    check(n == frames, f"profiled {n} frames, wanted {frames}")
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = out.setdefault(e.name, [0.0, 0.0])
            k[0] += 1.0 / frames
            k[1] += e.device_time / 1e3 / frames
    del pipe
    free_device_memory()
    return out


# aten ops whose CUDA kernels deterministic algorithms may replace
DET_OP_WORDS = ("scatter", "index_put", "index_add", "index_copy", "cumsum",
                "pad", "put_", "index_fill")


AUDIT_KEYS = ("duplicate_lanes", "conflicting_lanes", "conflicting_targets",
              "conflicting_targets_in_sink")


def _dup_audit(targets, values, sink):
    """AUDIT_KEYS of a write of `values` (one row per lane) to flat
    `targets`: lanes whose target repeats, those of them whose value
    differs from the lane before it on that target, the distinct targets
    so written, and how many of those are sinks (`sink(t)`: a row or
    column the caller drops)."""
    targets = targets.reshape(-1)
    if targets.numel() < 2:
        return 0, 0, 0, 0
    values = values.reshape(targets.numel(), -1)
    order = torch.sort(targets, stable=True).indices
    t, v = targets[order], values[order]
    same = t[1:] == t[:-1]
    differ = same & (v[1:] != v[:-1]).any(-1)
    conflict = torch.unique(t[1:][differ]).tolist()
    return (int(same.sum()), int(differ.sum()), len(conflict),
            sum(bool(sink(c)) for c in conflict))


def op_sources(seq, cfg, warm=4, frames=4, device="cuda"):
    """Where the ops that deterministic algorithms may reroute (names with
    a word of DET_OP_WORDS) are called in `frames` split LIVO frames
    after `warm`, and whether their result depends on the order: every
    aten call is seen through a TorchDispatchMode, attributed to the
    innermost frame of the port on the Python stack, and for the writes
    that can meet duplicate targets (scatter_, index_put_ without
    accumulate, index_copy_) the duplicates counted, those with unequal
    values, and how many of those land in the write's last row or
    column along its dimension (the port's sinks); for index_add_,
    whether every added value is a whole number (counts are exact in any
    order below 2^24). Returns {op: {site: numbers a frame}}."""
    import traceback

    from torch.utils._python_dispatch import TorchDispatchMode

    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    out = {}

    def audit(name, args, kwargs):
        if name.startswith("aten.scatter_.") or name == "aten.scatter.src":
            self_, dim, index, src = args[:4]
            if not isinstance(src, torch.Tensor):
                src = torch.full(index.shape, float(src), device=index.device)
            dim = dim % self_.dim()
            coords = list(torch.meshgrid(
                *[torch.arange(n, device=index.device) for n in index.shape],
                indexing="ij"))
            coords[dim] = index
            flat = sum(c * int(torch.tensor(self_.shape[k + 1:]).prod())
                       for k, c in enumerate(coords))
            vals = src[tuple(slice(0, n) for n in index.shape)]
            last = self_.shape[dim] - 1
            stride = int(torch.tensor(self_.shape[dim + 1:]).prod())
            return _dup_audit(flat, vals[..., None],
                              lambda f: (f // stride) % self_.shape[dim] == last)
        if name.startswith("aten.index_put_") or name.startswith("aten._index_put_impl_"):
            self_, indices, values = args[:3]
            acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
            if (acc or len(indices) != 1 or indices[0] is None
                    or indices[0].dtype == torch.bool):
                return None
            idx = indices[0].reshape(-1)
            vals = values.expand(indices[0].shape + self_.shape[1:])
            return _dup_audit(idx, vals.reshape(idx.numel(), -1),
                              lambda r: r == self_.shape[0] - 1)
        if name.startswith("aten.index_copy_"):
            self_, dim, index, source = args[:4]
            rows = source.movedim(dim, 0).reshape(index.numel(), -1)
            return _dup_audit(index, rows,
                              lambda r: r == self_.shape[dim] - 1)
        if name.startswith("aten.index_add_"):
            src = args[3]
            return (bool(torch.all(src == torch.round(src))),)
        return None

    class Audit(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func)
            if any(w in name for w in DET_OP_WORDS):
                site = next((f"{f.filename.split('fast_livo2_tpu_torch/')[-1]}:"
                             f"{f.lineno} {f.name}"
                             for f in reversed(traceback.extract_stack())
                             if "fast_livo2_tpu_torch/" in f.filename),
                            "outside the port")
                with torch.utils._python_dispatch._disable_current_modes():
                    found = audit(name, args, kwargs)
                rec = out.setdefault(name, {}).setdefault(site, {"calls": 0})
                rec["calls"] += 1.0 / frames
                if found is not None and len(found) == len(AUDIT_KEYS):
                    for k, v in zip(AUDIT_KEYS, found):
                        rec[k] = rec.get(k, 0) + v / frames
                elif found is not None:
                    rec["whole_numbers"] = rec.get("whole_numbers", True) and found[0]
                if name.startswith("aten.cumsum"):
                    rec["dtype"] = str(args[0].dtype)
            return func(*args, **kwargs)

    cfg = copy.deepcopy(cfg)
    cfg.tpu.fused_frame = False
    pipe = LIVOPipeline(cfg, "livo", device=device)
    pipe.push_sequence(seq)
    pipe.poll(max_frames=warm, flush=True)
    with Audit():
        n = pipe.poll(max_frames=frames, flush=True)
    check(n == frames, f"audited {n} frames, wanted {frames}")
    del pipe
    if device == "cuda":
        free_device_memory()
    return out


def det_kernels(name):
    """Which ops torch's deterministic algorithms reroute in a fused LIVO
    frame of rig NAME (`chip_smoke.py --det-kernels NAME`): its recording
    built and converted as the rigs phase does, its yaml pair with
    tpu.fused_frame, then 10 replayed frames profiled in the default mode
    and 10 under deterministic(), each pipeline captured in its mode, in
    turns (default, deterministic, deterministic, default). Prints one
    line: the kernel names found in one mode's profiles and in none of
    the other's, the names whose launches a frame differ between the
    modes (a profile can drop events, so a count is the largest of a
    mode's profiles), and where in the port the candidate ops are called
    (`op_sources`, split frames in the default mode); every profile goes
    to chiprun_out/det_kernels_NAME.json."""
    from fast_livo2_tpu_torch.io import dataset
    from fast_livo2_tpu_torch.utils.config import load_config

    sensor, camera = rig_paths(name)
    cfg = load_config(sensor, camera)
    cfg.tpu.fused_frame = True
    root = os.path.join(REPO, "build", "det_kernels", name)
    shutil.rmtree(root, ignore_errors=True)
    make_rig(name, os.path.join(root, "rec"))
    out = {"phase": f"det_kernels_{name}"}
    seq = dataset.load_sequence(
        rig_seq_dir(name, cfg, os.path.join(root, "rec"), root, out), cfg=cfg)
    profiles = {"default": [], "deterministic": []}
    for mode in ("default", "deterministic", "deterministic", "default"):
        with deterministic() if mode == "deterministic" else contextlib.nullcontext():
            profiles[mode].append(frame_kernels(seq, cfg))
    sources = op_sources(seq, cfg)
    names = {m: set().union(*p) for m, p in profiles.items()}
    most = {m: {k: max(p.get(k, [0.0])[0] for p in ps) for k in names[m]}
            for m, ps in profiles.items()}
    both = names["default"] & names["deterministic"]
    out.update(
        only_deterministic=sorted(k[:160] for k in names["deterministic"]
                                  - names["default"]),
        only_default=sorted(k[:160] for k in names["default"]
                            - names["deterministic"]),
        launches_differ={k[:160]: [most["default"][k], most["deterministic"][k]]
                         for k in sorted(both)
                         if abs(most["default"][k] - most["deterministic"][k]) > 0.5},
        kernel_ms_per_frame={m: [sum(v[1] for v in p.values()) for p in ps]
                             for m, ps in profiles.items()},
        launches_per_frame={m: [sum(v[0] for v in p.values()) for p in ps]
                            for m, ps in profiles.items()},
        op_sources_split_frame=sources, nvidia_smi=nvidia_smi())
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"det_kernels_{name}.json"),
              "w") as f:
        json.dump({"summary": out, "profiles": profiles}, f, indent=1)
    emit(out)


def phase_rig(name, built, ready):
    """One rig from its recording to a trajectory on the card: (bag rigs)
    `python -m fast_livo2_tpu_torch.convert_rosbag` with the yaml's lidar
    type, blind, point_filter_num and topics, in a subprocess; then the
    CLI with the shipped yaml pair, split and fused (a copy of the yaml
    with tpu.fused_frame, one CUDA graph a frame) in turns (split, fused,
    fused, split: each side's median over its two runs); mars_lvig, whose
    gates are on it (RIGS says why), then the same pair under
    deterministic algorithms. Gates on the default runs (mars_lvig: on
    the deterministic pair): ATE (ground truth interpolated at each pose)
    < 0.05 m (avia, ntu_viral) or 0.06 m (hilti22), mean tracked points >
    20 from frame 3 on; drift <= 0.5 % of the path (mars_lvig, whose
    tracked points are reported). On every rig: each fused run and the
    split run beside it 0.0 m apart, and the two runs of each form
    (split, split_2 and fused, fused_2) 0.0 m apart (every float
    scatter-add sums in lane order, ops/ordered_add; deterministic
    algorithms change no value read); one graph, 0 host syncs in every
    replayed frame; K1 once a frame; ordered_add once a site a frame;
    K2 on every fused VIO frame levels x iterations times
    and on a split run once an iteration that took effect. The phase's line is printed before a failed gate fails it.
    Returns the first fused run's launches."""
    from fast_livo2_tpu_torch.io import synthetic
    from fast_livo2_tpu_torch.utils.config import load_config

    r = RIGS[name]
    sensor, camera = rig_paths(name)
    cfg = load_config(sensor, camera)
    root = os.path.join(REPO, "build", "smoke_rigs", name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {"phase": f"rig_{name}", "seconds": r["seconds"], "recording": ready,
           "lidar": f"type {cfg.preprocess.lidar_type}, {r['lines']} x "
                    f"{r['per_line']} over {r['fov_deg']} deg",
           "camera": [cfg.camera.cam_width, cfg.camera.cam_height,
                      cfg.camera.scale, cfg.camera.cam_model]}
    seq_dir = rig_seq_dir(name, cfg, built, root, out)
    g = np.load(os.path.join(built, "gt.npz"))
    gt = [(t, None, p) for t, p in zip(g["stamps"], g["pos"])]
    path = float(np.sum(np.linalg.norm(np.diff(g["pos"], axis=0), axis=1)))
    fused_cfg = os.path.join(root, "fused.yaml")
    fused_yaml(sensor, fused_cfg)
    # the deterministic pair only where the gates are on it (mars_lvig)
    forms = (("split", "fused", "fused_2", "split_2")
             + (() if r.get("gate_default", True) else ("split_det",
                                                          "fused_det")))
    runs = {}
    for form in forms:
        ctx = (deterministic() if form.endswith("_det")
               else contextlib.nullcontext())
        with ctx:
            summary, wall_s, got = cli_rig_run(
                fused_cfg if form.startswith("fused") else sensor, camera,
                seq_dir, os.path.join(root, f"out_{form}"))
        check(summary["mode"] == "livo" and summary["frames"] == len(got["traj"]),
              f"rig {name} {form}: CLI ran {summary['frames']} "
              f"{summary['mode']} frames")
        runs[form] = dict(got, summary=summary, wall_s=wall_s)
    per_frame = (runs["fused"]["levels_x_iterations"]
                 if runs["fused"]["fused_k2"] else 0)
    gated = [f for f in forms if f.endswith("_det")
             != r.get("gate_default", True)]
    failed = []

    def gate(cond, msg):
        if not cond:
            failed.append(msg)

    for form in forms:
        x = runs[form]
        frames = len(x["traj"])
        gate(frames >= 10 * r["seconds"] - 12, f"rig {name} {form}: "
                                               f"{frames} frames")
        ate = synthetic.ate_rmse([(t, p) for t, _, p in x["traj"]], gt)
        tracked = float(np.mean(x["n_tracked"][3:]))
        nums = {"frames": frames, "ate_rmse_m": ate,
                "cli_ate_rmse_m": x["summary"].get("ate_rmse_m"),
                "drift_pct": 100.0 * ate / path, "mean_n_tracked": tracked,
                "cli_wall_s": x["wall_s"], "launches": x["launches"],
                "gated": form in gated}
        if form in gated:
            if name in RIG_ATE_GATES:
                gate(ate < RIG_ATE_GATES[name], f"rig {name} {form}: ATE "
                                                f"{ate} m >= {RIG_ATE_GATES[name]} m")
                gate(tracked > TRACKED_GATE,
                     f"rig {name} {form}: mean n_tracked {tracked}")
            else:
                gate(nums["drift_pct"] <= RIG_DRIFT_GATE_PCT,
                     f"rig {name} {form}: drift {nums['drift_pct']} % of "
                     f"{path} m")
        if form.startswith("split"):
            nums.update(split_checks(f"rig {name} {form}", x,
                                     x["iterations"] if per_frame else None))
            check(per_frame or x["launches"]["photo_iteration"] == 0,
                  f"rig {name} {form}: K2 launched with the fused "
                  f"photometric update off")
        else:
            nums.update(fused_checks(f"rig {name} {form}", x, frames - 1,
                                     per_frame))
        out[form] = nums
    for a, b in (("fused", "split"), ("fused_2", "split_2"),
                 ("fused_det", "split_det"), ("split_2", "split"),
                 ("fused_2", "fused")):
        if a not in runs:
            continue
        dp, dR = traj_diff(runs[a]["traj"], runs[b]["traj"])
        gate(dp == dR == 0.0, f"rig {name}: {a} vs {b} {dp} m, {dR}")
        out[f"{a}_vs_{b}"] = {"max_pos_diff_m": dp, "max_rot_diff": dR}
    # each side's median frame over its two runs, taken in turns (a
    # split run's first frame and a fused run's first two are set-up)
    out["median_frame_ms_in_turns"] = {
        "split": statistics.median(runs["split"]["ms"][1:]
                                   + runs["split_2"]["ms"][1:]),
        "fused": statistics.median(runs["fused"]["ms"][2:]
                                   + runs["fused_2"]["ms"][2:])}
    out.update(path_m=path, k2_per_fused_vio_frame=per_frame,
               nvidia_smi=nvidia_smi(), failed=failed)
    emit(out)
    check(not failed, "; ".join(failed))
    return runs["fused"]["launches"]


def phase_rigs(started):
    """Each rig in RIGS, as its recording is ready (built by the sequence
    child). Returns {"rig_<name>": the fused run's launches}."""
    return {f"rig_{name}": phase_rig(name, *wait_built(started, f"rig_{name}"))
            for name in RIGS}


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
    K = 64, D = 19 on the dense and the main-path-shaped inputs, with the
    sha256 of its output's bytes at the dense ones (`k1_digest`); K2 at
    M = 396 on a smooth 512 x 640 image; K3 and
    index_select on the LIO map's gather, in turns; the LIVO frames'
    launches, K2 kernels and photometric iterations (profile_frames)."""
    from fast_livo2_tpu_torch.ops import _build, cov_scan, gather
    from fast_livo2_tpu_torch.ops import photo_iteration as photo

    _build.build(_build.sources())
    dense = [torch.from_numpy(a).cuda() for a in k1_inputs(K_MAIN, D_STATE)]
    shaped = [torch.from_numpy(a).cuda() for a in k1_main_shape_inputs()]
    img = torch.from_numpy(smooth_image(512, 640)).cuda()
    args = k2_inputs(img, False)
    table, nxt, group = gather_timing_inputs(np.random.default_rng(11))
    digest = hashlib.sha256(
        cov_scan.propagate_cov(*dense).cpu().numpy().tobytes()).hexdigest()
    out = {"k1_digest": digest,
           "cov_scan": timings(lambda: cov_scan.propagate_cov(*dense)),
           "cov_scan_main_shape": timings(lambda: cov_scan.propagate_cov(*shaped)),
           "photo_iteration": timings(lambda: photo.photo_iteration(*args)),
           **gather_timings(table, nxt, group)}
    out["profile_livo"] = profile_frames(full_width_sequence(), "livo")
    return out


def backend_times(seq_dir):
    """The backend's frame times through the package's public API alone
    (run_backend), so that `--backend-times ROOT
    DIR` measures the package of another tree: two fused ONLY_LIO runs
    of the sequence saved at DIR with enable_online_refine(**BACKEND),
    each's median, p99 and max frame ms and its windows' device ms."""
    from fast_livo2_tpu_torch.io import dataset
    from fast_livo2_tpu_torch.ops import _build

    _build.build(_build.sources())
    lseq = dataset.load_sequence(seq_dir)
    out = []
    for _ in range(2):
        pipe, ms, _, _, _ = run_backend(lseq, "only_lio", BACKEND)
        out.append({"median_frame_ms": statistics.median(ms[2:]),
                    "p99_frame_ms": float(np.percentile(ms[2:], 99)),
                    "max_frame_ms": max(ms[2:]),
                    "window_device_ms": pipe._refiner.device_ms})
        del pipe
        free_device_memory()
    return {"backend_runs": out}


def run_turns(other, what):
    """kernel_times ("kernels") or backend_times ("backend", on the
    long-indoor cut, built once here) of `other`'s package and this one's
    in four processes, other, this, this, other; one `turns` line."""
    flag = {"kernels": ["--kernel-times"], "backend": ["--backend-times"]}[what]
    extra = []
    if what == "backend":
        from fast_livo2_tpu_torch.io import dataset

        path = os.path.join(REPO, "build", "turns_long_indoor")
        dataset.save_sequence(path, make_sequence("long_indoor"))
        extra = [path]
    runs = []
    for root in (other, REPO, REPO, other):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            *flag, root, *extra],
                           capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            print(f"chip_smoke: {flag[0]} {root} failed:\n"
                  f"{p.stderr[-4000:]}", file=sys.stderr)
            return 1
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    line = {"phase": f"turns_{what}", "roots": [other, REPO, REPO, other],
            "runs": runs}
    if what == "kernels":
        line["k1_digests_equal"] = len({r["k1_digest"] for r in runs}) == 1
    emit(line)
    print(nvidia_smi(), flush=True)
    return 0


def main(argv):
    # The port runs without JAX: make any import of it fail loudly here.
    # (Here and not at import: the CPU tests import this script's rig
    # assembly beside the JAX package.)
    sys.modules["jax"] = None
    sys.modules["fast_livo2_tpu"] = None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 2
    mode = argv[0] if argv else None
    times = ("--kernel-times", "--backend-times")
    root = os.path.abspath(argv[1]) if mode in times else REPO
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
    if mode == "--backend-times":
        emit({"package": os.path.dirname(fast_livo2_tpu_torch.__file__),
              **backend_times(argv[2])})
        return 0
    if mode == "--shard-rank":
        return shard_rank(argv[1:])
    if mode == "--rig-spread":
        rig_spread(argv[1], int(argv[2]) if len(argv) > 2 else 4)
        return 0
    if mode == "--det-kernels":
        det_kernels(argv[1])
        return 0
    if mode == "--make-sequences":
        os.nice(19)  # behind the card's phases on the host's cores
        make_sequences(argv[1])
        return 0
    if mode in ("--turns", "--backend-turns"):
        return run_turns(os.path.abspath(argv[1]),
                         "kernels" if mode == "--turns" else "backend")
    if mode is not None:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    started = None
    try:
        smi = phase_device()
        phase_build()
        k1 = phase_kernel()
        t0 = time.perf_counter()
        seq = full_width_sequence()
        emit({"phase": "sequence", "scans": len(seq.scans),
              "images": len(seq.images), "seconds": time.perf_counter() - t0})
        k2, frame = phase_kernel_photo(seq)
        k5 = phase_kernel_tail()
        phase_side_stream(frame)
        # (after the kernel phases: a busy host makes the profiler drop
        # kernel events, and those phases count them)
        started = start_sequences()
        traj, _ = phase_pipeline(seq, "only_lio")
        phase_parity(seq, traj, "only_lio", PARITY_FRAMES)
        phase_profile(seq, "only_lio")
        traj, launches = phase_pipeline(seq, "livo")
        phase_parity(seq, traj, "livo", PARITY_FRAMES_LIVO)
        k1_frame = phase_profile(seq, "livo")
        k3, k3_phase_launches = phase_kernel_gather()
        k4, k4_phase_launches = phase_kernel_ordered_add()
        phase_run_cli(seq, len(traj))
        phase_resume(seq, len(traj))
        free_device_memory()
        fused = {}
        for mode in ("only_lio", "livo"):
            fused[mode] = phase_pipeline_fused(seq, mode)
            fused_frame = phase_profile_fused(seq, mode)
            free_device_memory()
        phase_stage_timing(seq)
        phase_resume_fused(seq, len(traj))
        extras = phase_vio_extras(seq)
        phases = {"vio_extras_raycast_fused": extras["raycast_en"],
                  "vio_extras_ic_fused": extras["inverse_composition_en"],
                  "backend_photo": phase_backend_photo(seq),
                  "batch": phase_batch(seq)}
        phase_resume_backend(seq)
        phases["backend"] = phase_backend(wait_sequence(started, "long_indoor"))
        phases["rosbag"] = phase_rosbag(seq, len(traj))
        phase_sharded(seq)
        phases["hard"] = phase_hard(wait_sequence(started, "hard"))
        phases["soak"] = phase_soak(wait_sequence(started, "soak"))
        phases["outdoor"] = phase_outdoor(wait_sequence(started, "outdoor"))
        phases["dense"] = phase_dense(wait_sequence(started, "dense"))
        for ph in ("hard", "soak", "dense"):
            check(phases[ph]["cov_scan"] > 0 and phases[ph]["photo_iteration"] > 0,
                  f"K1 or K2 never launched in the {ph} phase: {phases[ph]}")
        check(phases["outdoor"]["cov_scan"] > 0,
              "cov_scan never launched in the outdoor phase")
        phase_tools(seq)
        phases.update(phase_rigs(started))
        # the fused LIVO path's run (tpu.fused_frame: the kernels launch
        # from its graph's replays), and K1's and K2's ms a replayed frame
        for k, name in ((k1, "cov_scan"), (k2, "photo_iteration")):
            k["launches_fused"] = fused["livo"][name]
            k["fused_device_ms_per_frame"] = fused_frame[f"{name}_ms_per_frame"]
            check(k["launches_fused"] > 0,
                  f"{name} never launched on the fused LIVO path")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if started is not None and started[0].poll() is None:
            started[0].kill()
            started[0].wait()
    # launches: the LIVO main path's run, which goes through K1 and K2;
    # no path runs K3 (0), its own phase's count beside it
    k1["launches"] = launches["cov_scan"]
    k1["main_path_device_ms_per_frame"] = k1_frame["cov_scan_ms_per_frame"]
    k2["launches"] = launches["photo_iteration"]
    k3["launches_fused"] = fused["livo"]["gather_rows"]
    k3["launches"] = launches["gather_rows"]
    k3["phase_launches"] = k3_phase_launches
    # ordered_add: the LIVO main path's split run (checked there: once a
    # site a frame), its fused run, and its own phase's count beside them
    k4["launches"] = launches["ordered_add"]
    k4["launches_fused"] = fused["livo"]["ordered_add"]
    k4["phase_launches"] = k4_phase_launches
    # the filter tail: once a photometric iteration on both paths
    k5["launches"] = launches["photo_tail"]
    k5["launches_fused"] = fused["livo"]["photo_tail"]
    # the launches of each of this slice's phases (their fused runs)
    for k, name in ((k1, "cov_scan"), (k2, "photo_iteration"),
                    (k3, "gather_rows"), (k4, "ordered_add"),
                    (k5, "photo_tail")):
        k["launches_phases"] = {ph: n[name] for ph, n in phases.items()}
    emit({"kernels": [k1, k2, k3, k4, k5]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

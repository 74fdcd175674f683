"""One run of one cell: set-up, the measured window, the traced stretch
(with --trace 1), then the check of what the window produced.

Set-up is everything before the window and counts in `setup_s`: imports,
the card's first touch, the recording made on the card from the seed and
copied to the host, the pipeline, the kernels' build (first run of a
checkout only), and the mix's warm frames run as fast as they go (IMU
init, the map-building frame, the capture of the frame graph; with a
`backend`, the refiner's first windows and the capture of their graphs).

A mix with a `backend` object turns the pipeline's online backend on
with it (`enable_online_refine(**backend)`), watches the refiner
(lib/refine.py) and adds its windows to the check; a mix without one
runs none of that.
"""

import gc
import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, deployment, drive, generator, profiling, refine


@dataclass
class RunRecord:
    """What the metric readers read."""

    cell: dict
    deploy: dict
    mix: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    frames: list = field(default_factory=list)
    late_s: list = field(default_factory=list)
    n_eff: list = field(default_factory=list)
    photo_iterations: int = 0
    vio_frames: int = 0
    profile: dict = None  # profiling.reduce() of the traced stretch
    profile_frames: list = field(default_factory=list)
    profile_launches: dict = field(default_factory=dict)
    push_s: float = 0.0  # the feeder's pushes in the window
    refine: dict = None  # the refiner's submit and device ms, windows completed
    # and submits refused in the window (a mix with a backend)


def _launch_counts():
    from fast_livo2_tpu_torch.ops import cov_scan, ordered_add
    from fast_livo2_tpu_torch.ops import photo_iteration

    return {"cov_scan": cov_scan.LAUNCHES, "photo_iteration": photo_iteration.LAUNCHES,
            "ordered_add": ordered_add.LAUNCHES}


def _diff(a, b):
    return {k: b[k] - a[k] for k in a}


def recording_seconds(mix: dict, seconds: float, trace: bool) -> float:
    """Sensor seconds the run consumes: the warm start, the window (a
    replay runs faster than the sensor: at most `max_speedup` times), the
    traced stretch and a margin."""
    span = seconds * (mix["max_speedup"] if mix["mode"] == "replay" else 1.0)
    return mix["warm_s"] + span + (mix["profile_s"] if trace else 0.0) + mix["margin_s"]


def run(cell_name, seed, seconds, trace, t_process0, control=False,
        device="cuda", bench=None, root=None):
    """(result dict for the last line, compared rows, info lines)."""
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    bench = bench or deployment.benchmark()
    cell = deployment.cell(bench, cell_name)
    deploy = deployment.deployment(bench, cell["config"], root)
    mix = deployment.mix(cell["traffic"], root)
    info = {}
    cuda = torch.device(device).type == "cuda"

    rec_s = recording_seconds(mix, seconds, trace)
    t0 = time.perf_counter()
    marks = {"imports_and_card_s": t0 - t_process0}
    rec = generator.make_recording(deploy, rec_s, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    info["recording"] = {"seconds": rec_s, "scans": len(rec.scans), "images": len(rec.images),
                         "points": int(sum(len(s[1]) for s in rec.scans)),
                         "make_s": time.perf_counter() - t0, **(rec.seconds or {})}

    t1 = time.perf_counter()
    marks["recording_s"] = t1 - t0
    cfg = deployment.port_config(deploy, os.path.join(deployment.WORK, "configs"))
    pipe = LIVOPipeline(cfg, deploy["slam_mode"], device=device)
    backend = mix.get("backend")
    if backend is not None:
        pipe.enable_online_refine(**backend)
    exposure = float(deploy["sensor"].get("time_offset", {}).get("exposure_time_init", 0.0))
    feed = drive.Feed(rec, 1.0 / generator.LIDAR_HZ, exposure)
    events = sorted(feed.ready_due)

    # The checked frames, drawn from the seed over the window from
    # `check_from_s` to its last second: live, among the frames due
    # then; in a replay, the frame that starts after each of as many
    # moments of the window's clock (the frames a replay reaches are
    # the program's pace).
    rng = np.random.default_rng(int(seed) % (1 << 63))
    n_check = mix["check_frames"]
    lo, hi = mix["check_from_s"], seconds - 1.0
    if mix["mode"] == "live":
        due = [t for t in events if lo <= feed.ready_due[t] - mix["warm_s"] < hi]
        n_check = min(n_check, len(due))
        sample = sorted(rng.choice(due, size=n_check, replace=False).tolist())
        moments = []
    else:
        sample, moments = [], sorted(rng.uniform(lo, hi, n_check).tolist())
    # With a backend: the checked windows (lib/refine.py), and the frame
    # after each one's pose delta is fed back, step-checked from the
    # prior with the delta applied.
    watch, n_windows, follow = None, 0, []
    if backend is not None:
        n_windows = mix["check"]["check_windows"]
        period = refine.period_s(deploy, backend)
        watch = refine.Watch(pipe._refiner,
                             refine.draw_ordinals(rng, n_windows, lo, hi, period))
    t2 = time.perf_counter()
    marks["pipeline_s"] = t2 - t1
    snaps = check.Snapshots(pipe, n_check + n_windows, frame0=True)
    snaps.want.update(sample)
    marks["check_buffers_s"] = time.perf_counter() - t2
    nxt = {events[i]: events[i + 1] for i in range(len(events) - 1)}
    spans = drive.Spans()
    clock = drive.Clock()
    window = {"t0": None}

    def after(p, j):
        t_next = nxt.get(float(p.trajectory[j][0]))
        if (window["t0"] is not None and moments and t_next is not None
                and clock.now() - window["t0"] >= moments[0]):
            moments.pop(0)
            snaps.want.add(t_next)
            sample.append(t_next)
        if watch is not None and watch.fed_back is not None:
            watch.fed_back = None
            deltas = p._refine_deltas
            if (watch.open and t_next is not None and t_next not in snaps.want
                    and deltas and deltas[-1][0] == float(p.trajectory[j][0])):
                snaps.want.add(t_next)
                follow.append(t_next)
        snaps.after_frame(p, j, t_next)

    def read_pose(row):
        row[1][0:12].cpu()

    drv = drive.Runner(pipe, feed, clock, spans, count_syncs=trace and cuda,
                       after_frame=after, read_pose=read_pose)
    t3 = time.perf_counter()
    drv.warm(mix["warm_s"])
    if cuda:
        torch.cuda.synchronize()
    marks["warm_frames_s"] = time.perf_counter() - t3
    it0 = int(pipe.photo_iterations)
    n_rows0 = len(pipe.trajectory)
    out = RunRecord(cell=cell, deploy=deploy, mix=mix)
    # What set-up made (the recording above all) is kept from the
    # collector's scans during the window: the benchmark's own objects
    # add no pauses to the program's frames.
    gc.collect()
    gc.freeze()
    out.setup_s = time.perf_counter() - t_process0
    info["setup_parts_s"] = marks
    info["warm_frames"] = n_rows0

    # ---- the measured window
    first_span = len(spans.rows)
    if watch is not None:
        info["refiner_at_window_start"] = {**pipe._refiner.summary(),
                                           "refused": watch.refused}
        marks0 = watch.marks()
        watch.open = True
    if mix["mode"] == "live":
        out.frames = drv.live(mix["warm_s"], seconds)
        out.window_s = seconds
        t_next = mix["warm_s"] + seconds
    else:
        window["t0"] = clock.now()
        out.frames, out.window_s = drv.replay(seconds, mix["lookahead_s"])
        window["t0"] = None
        t_next = pipe.last_update_time
    if cuda:
        torch.cuda.synchronize()
    if watch is not None:
        watch.open = False
        summary = pipe._refiner.summary()
        info["refiner_at_window_end"] = {**summary, "refused": watch.refused}
        if summary["graphs"] != info["refiner_at_window_start"]["graphs"]:
            raise RuntimeError("a refiner graph was captured inside the measured window: "
                               "the mix's warm_s is too short for its backend")
        marks1 = watch.marks()
        r = pipe._refiner
        out.refine = dict(submit_ms=r.submit_ms[marks0[0]:marks1[0]],
                          device_ms=r.device_ms[marks0[1]:marks1[1]],
                          completed=watch.completed, refused=watch.refused,
                          nonfinite=watch.nonfinite)
    info["window_cut_by_recording_end"] = drv.cut
    out.late_s = list(drv.late)
    out.push_s = sum(b - a for n, a, b in spans.rows[first_span:] if n == "push")
    n_rows1 = len(pipe.trajectory)
    out.photo_iterations = int(pipe.photo_iterations) - it0
    out.vio_frames = sum(1 for r in pipe.log.rows[n_rows0:n_rows1] if "vdiag" in r)

    # ---- the traced stretch
    if trace:
        l1 = _launch_counts()
        with profiling.profiled() as (prof, ranges):
            spans.ranges = ranges
            tb = clock.now()
            if mix["mode"] == "live":
                out.profile_frames = drv.live(t_next, mix["profile_s"])
            else:
                out.profile_frames, _ = drv.replay(math.inf, mix["lookahead_s"],
                                                   max_frames=mix["profile_frames"])
            te = clock.now()
        spans.ranges = None
        out.profile = profiling.reduce(prof, spans, tb, te)
        out.profile_launches = _diff(l1, _launch_counts())
        del prof

    # ---- what the window produced, read once it has closed
    kept = watch.finish() if watch is not None else []
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rows = pipe.trajectory
    win = range(n_rows0, n_rows1)
    times = [float(rows[j][0]) for j in win]
    pos = torch.stack([rows[j][1][9:12] for j in win]).cpu().numpy().astype(np.float64)
    diags = torch.stack([pipe.log.rows[j]["diag"] for j in win]).cpu().numpy()
    out.n_eff = diags[:, 0].tolist()
    vd = [pipe.log.rows[j]["vdiag"] for j in win if "vdiag" in pipe.log.rows[j]]
    if vd:
        n_tr = torch.stack(vd)[:, 0].cpu().numpy()
        info["tracked_points"] = {"min": float(n_tr.min()), "median": float(np.median(n_tr)),
                                  "max": float(n_tr.max())}
    deltas = ({t: (R_d, p_d) for t, R_d, p_d in pipe._refine_deltas}
              if watch is not None else {})
    ran = {float(r[0]) for r in rows}
    want_steps = n_check + sum(t in ran for t in follow)
    steps = []
    for j in sorted(snaps.rows):
        if j - 1 in snaps.after and j in snaps.after:
            lg = pipe.log.rows[j]
            steps.append(dict(row=j, t0=float(rows[j - 1][0]), t1=float(rows[j][0]),
                              prior=rows[j - 1][1].detach().cpu(),
                              delta=deltas.get(float(rows[j - 1][0])),
                              post=rows[j][1].detach().cpu(),
                              before=snaps.after[j - 1], after=snaps.after[j],
                              vio_before=snaps.before_vio.get(j),
                              diag=lg["diag"].cpu().numpy(),
                              vdiag=lg["vdiag"].cpu().numpy() if "vdiag" in lg else None))
    start = dict(t1=float(rows[0][0]), post=rows[0][1].detach().cpu(),
                 after=snaps.after.get(0))
    map_shape = tuple(pipe.vmap_state.keys.shape)
    graphs = getattr(pipe, "_frame_graphs", None)
    info["frame_graphs"] = graphs.summary() if graphs is not None else None
    info["dropped_inputs"] = dict(pipe.dropped_inputs)
    del drv, pipe, snaps
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    readings, extra = judge_run(rec, deploy, steps, start, map_shape, device, False,
                                want_steps)
    info["check"] = extra
    if control:
        creadings, cextra = judge_run(rec, deploy, steps, start, map_shape, device, True,
                                      want_steps)
        info["control"] = {"readings": creadings, **cextra}
    limits = deploy["check"]["limits"]
    if watch is not None:
        rr, crr, rextra = refine.judge(kept, rec, deploy, backend, device, control, n_windows)
        readings.update(rr, refine_nonfinite_windows=out.refine["nonfinite"])
        extra.update(refine=rextra, follow_frames=follow)
        if control:
            info["control"]["readings"].update(crr)
        limits = {**limits, **mix["check"]["limits"]}
    correct, compared = check.judge(readings, limits)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace and out.profile is not None:
        device_info["busy_s"] = out.profile["busy_s"]
        device_info["window_s"] = out.profile["window_s"]
    info["ground_truth"] = {"ate_m": ate_rmse(rec, times, pos),
                            "widest_m": check.gt_error(rec, times, pos)}
    info["sampled_frames"] = sample
    return out, correct, compared, device_info, info


def judge_run(rec, deploy, steps, start, map_shape, device, control, want_steps):
    """The compared readings, from the reference (or, as the control,
    the reference in TF32 put in the program's place)."""
    from ..reference import lio as ref

    sensor = deploy["sensor"]
    mcfg = ref.map_cfg(sensor)
    exposure = float(sensor.get("time_offset", {}).get("exposure_time_init", 0.0))
    image_t = np.array([float(t) + exposure for t, _ in rec.images])
    event_t = sorted(image_t.tolist())
    livo = deploy["slam_mode"] == "livo"
    t_init, grav, norm = ref.imu_init(rec.imu_t, rec.imu_acc, event_t,
                                      max(int(sensor["imu"]["imu_int_frame"]), 5))
    noise = ref.noise_cfg(sensor, norm)
    P64 = ref.Precision(False)
    Pj = ref.Precision(control)
    s0, c0 = ref.init_state(grav, device, torch.float64)

    def empty(dtype):
        return ref.Map.from_tables(torch.full(map_shape, ref.EMPTY, dtype=torch.int32,
                                              device=device),
                                   torch.zeros(map_shape[:2] + (16,), device=device), dtype)

    def frame(P, prior, mp, t0, t1, first):
        return check.ref_frame(P, rec, sensor, mcfg, noise, prior, mp, t0, t1, first, device)

    # the start: the map-building frame from the init state
    prior0 = ref.pack(s0, c0)
    want0 = frame(P64, prior0, empty(torch.float64), t_init, start["t1"], True)
    if control:
        got0 = frame(Pj, prior0, empty(Pj.dtype), t_init, start["t1"], True)
        post0, pc0, pd0 = got0[0], got0[1], got0[2]
    else:
        post0 = start["post"]
        pc0, pd0 = (check.program_delta(
            (torch.full(map_shape, ref.EMPTY, dtype=torch.int32),
             torch.zeros(map_shape[:2] + (16,), dtype=torch.float32)),
            start["after"], torch.float64, device) if start["after"] is not None
            else (None, None))
    start_gap = check.state_gap(post0.to(device), want0[0])
    gaps, widest, flips, voxels, eff = [], [], [], [], []
    vio_gaps, vio_cov, tracked = [], [], []

    def compare(pc, pd, rc, rd):
        g, w, nf, nv = check.compare_inserts(pc, pd, rc, rd)
        gaps.append(g)
        widest.append(w)
        flips.append(nf)
        voxels.append(nv)

    if pc0 is not None:
        compare(pc0, pd0.to(torch.float64), want0[1], want0[2])
    for st in steps:
        mp = ref.Map.from_tables(st["before"][0].to(device), st["before"][1].to(device),
                                 torch.float64)
        # the program's prior: its previous row, with the backend's pose
        # delta where one was fed back after that row
        prior = (st["prior"] if st.get("delta") is None
                 else check.apply_delta(st["prior"], *st["delta"]))
        want = frame(P64, prior, mp, st["t0"], st["t1"], False)
        if control:
            mpj = ref.Map.from_tables(st["before"][0].to(device), st["before"][1].to(device),
                                      Pj.dtype)
            got = frame(Pj, prior, mpj, st["t0"], st["t1"], False)
            pc, pd, n_eff = got[1], got[2].to(torch.float64), got[3]
        else:
            pc, pd = check.program_delta(st["before"], st["after"], torch.float64, device)
            n_eff = int(st["diag"][0])
        compare(pc, pd, want[1], want[2])
        eff.append([n_eff, want[3]])
        if not livo:
            continue
        if st["vio_before"] is None or st["vdiag"] is None:
            vio_gaps.append(None)
            vio_cov.append(None)
            continue
        img = rec.images[int(np.argmin(np.abs(image_t - st["t1"])))][1]
        want_v, n_ref = check.ref_vio(P64, deploy, want[0], want[5], st["vio_before"], img,
                                      st["row"], device)
        if control:
            got_v, n_got = check.ref_vio(Pj, deploy, got[0], got[5], st["vio_before"], img,
                                         st["row"], device)
        else:
            got_v, n_got = st["post"], int(st["vdiag"][0])
        vio_gaps.append(check.state_gap(got_v.to(device), want_v))
        vio_cov.append(check.pose_cov_gap(got_v.to(device), want_v))
        tracked.append([n_got, n_ref])
    if len(steps) < want_steps:  # a sampled frame was not checked
        gaps.append(None)
        flips.append(None)
        vio_gaps.append(None)
        vio_cov.append(None)
    # the window frames' flips pooled: late in a run a frame adds to a
    # few voxels only, where one flip would read as a large share
    k = len(steps)
    flip_share = (sum(flips[-k:]) / max(sum(voxels[-k:]), 1)
                  if k and None not in flips else None)
    readings = {"start_gap": start_gap, "insert_gap_m": check.second_worst(gaps),
                "flip_share": flip_share}
    if livo:
        readings.update(vio_state_gap=check.second_worst(vio_gaps),
                        vio_cov_gap=check.second_worst(vio_cov))
    return readings, {"step_frames": len(steps), "insert_gaps_m": gaps,
                      "widest_gaps_m": widest, "flips": flips, "voxels": voxels,
                      "n_eff_program_reference": eff, "vio_state_gaps": vio_gaps,
                      "vio_cov_gaps": vio_cov, "tracked_program_reference": tracked}


def ate_rmse(rec, times, pos):
    """RMSE of the window's positions against the ground truth, in the
    filter's starting frame (a sanity record, not compared)."""
    R0, p0 = rec.gt_R[0], rec.gt_p[0]
    idx = np.clip(np.searchsorted(rec.gt_t, np.asarray(times) - 1e-9), 0, len(rec.gt_t) - 1)
    d = pos @ R0.T + p0 - rec.gt_p[idx]
    return float(np.sqrt(np.mean(np.sum(d * d, -1))))

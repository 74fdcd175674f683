"""The program's own trace, read beside the profile of the traced stretch:
its stage marks and host spans (LIVOPipeline.enable_tracing,
fast_livo2_tpu_torch/utils/timing.py) and each captured graph's kernel
nodes by stage.

- `collect` gathers, after a traced run, what the per-layer readers of
  the stages read (the run's `trace`): the stage ms of the window's
  frames, the program's host spans, the kernel nodes by stage, the
  traced kernels by stage and the idle gaps by program span.
- `kernels_by_stage` assigns each traced kernel to the innermost stage
  open between its frame's mark kernels (`stage_mark_kernel<slot>`),
  or to "outside the graph"; a mark the profiler dropped widens the
  interval, whose kernels then go to the innermost stage that holds it
  whole.
- `idle_gaps_by_program_span` labels each idle gap of the device with
  the innermost program span that covers it, else as
  `profiling.reduce` labels it (the benchmark's own spans).

Nothing here changes `profiling.reduce` or what it returns. A program
without the tracer leaves `trace` None, and the readers return None.
"""

import re

from fast_livo2_tpu_torch.utils.timing import stage_paths, stage_times

from . import profiling

MARK = re.compile(r"stage_mark_kernel<(\d+)>")
OUTSIDE = "outside the graph"
# device events that are no kernel node: copies and fills, which the
# profiler names "Memcpy ..." / "Memset ...", or, for some of a graph's
# copy and fill nodes, after the CUDA kernels that run them
# (memcpy32_post, memset32, ...)
NOT_KERNEL = ("memcpy", "memset")


def mark_frames(kernels):
    """The mark kernels of a profile grouped into frames, in time order:
    [[(slot, start, end), ...], ...]; a frame starts where the slot does
    not rise."""
    frames = []
    for name, a, b in sorted(kernels, key=lambda k: k[1]):
        m = MARK.search(name)
        if m is None:
            continue
        slot = int(m.group(1))
        if not frames or slot <= frames[-1][-1][0]:
            frames.append([])
        frames[-1].append((slot, a, b))
    return frames


def _owner(spans, keys, s0, s1):
    """The path of the innermost span open from mark s0 up to mark s1
    ("other": none is)."""
    best = None
    for i, (_, _, b, e, *_) in enumerate(spans):
        if b <= s0 and s1 <= e and (best is None or b > spans[best][2]):
            best = i
    return "other" if best is None else keys[best]


def kernels_by_stage(kernels, layouts):
    """Assign the traced kernels (profiling.reduce's `kernels`: (name,
    start, end), the marks among them) to stages. `layouts`: each traced
    frame's stage spans, in order (a frame with no layout takes the
    last). Returns {"by_stage": {path: [kernels, seconds]}, "frames":
    [{"first", "last", "marks", "kernels"}: the frame's first mark's
    start, last mark's end, marks seen and kernels (copies and fills left
    out) between them], "assigned_share", "outside_share" (of the
    kernels that are not marks)}."""
    frames = mark_frames(kernels)
    if not frames or not layouts:
        return None
    extents = []
    for i, marks in enumerate(frames):
        spans = layouts[min(i, len(layouts) - 1)]
        extents.append((marks[0][1], marks[-1][2], marks, spans,
                        stage_paths(spans)))
    by = {}
    info = [{"first": e[0], "last": e[1], "marks": len(e[2]), "kernels": 0}
            for e in extents]
    n = outside = 0
    for name, a, b in sorted(kernels, key=lambda k: k[1]):
        if MARK.search(name):
            continue
        n += 1
        key = OUTSIDE
        for j, (first, last, marks, spans, keys) in enumerate(extents):
            if first <= a <= last:
                k = max(i for i, m in enumerate(marks) if m[1] <= a)
                s1 = marks[k + 1][0] if k + 1 < len(marks) else marks[k][0] + 1
                key = _owner(spans, keys, marks[k][0], s1)
                if not name.lower().startswith(NOT_KERNEL):
                    info[j]["kernels"] += 1
                break
        if key == OUTSIDE:
            outside += 1
        acc = by.setdefault(key, [0, 0.0])
        acc[0] += 1
        acc[1] += b - a
    return {"by_stage": by, "frames": info,
            "assigned_share": (n - outside) / n if n else None,
            "outside_share": outside / n if n else None}


def graph_idle_pct(profile):
    """Share of the traced frames' spans from their first mark to their
    last in which no kernel ran (None without marks)."""
    if not profile:
        return None
    frames = mark_frames(profile["kernels"])
    span = sum(f[-1][2] - f[0][1] for f in frames)
    if span <= 0:
        return None
    busy = sum(profiling.busy_within(profile["intervals"], f[0][1], f[-1][2])
               for f in frames)
    return 100.0 * (1.0 - busy / span)


def idle_gaps_by_program_span(intervals, t_begin, t_end, program_spans,
                              bench_spans):
    """Every idle gap of the device in [t_begin, t_end] (busy
    `intervals` as profiling.reduce gives them), as [label, seconds],
    longest first: the innermost program span (row, name, parent, t0, t1)
    covering its middle, else the benchmark's span there, else "other
    host work"."""
    gaps, prev = [], t_begin
    for a, b in intervals:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t_end > prev:
        gaps.append((prev, t_end))
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label, width = None, None
        for _, name, _, s0, s1 in program_spans:
            if s0 <= mid <= s1 and (width is None or s1 - s0 < width):
                label, width = name, s1 - s0
        if label is None:
            label = next((name for name, s0, s1 in bench_spans if s0 <= mid <= s1),
                         "other host work")
        out.append([label, b - a])
    out.sort(key=lambda x: -x[1])
    return out


def window_stage_ms(rows):
    """{f"{stage}_ms": ms} of each FrameLog row that holds marks (the
    rows before the pipeline's finalize, which pops them), in one
    transfer; None where no row does."""
    import torch

    marked = [r for r in rows if "marks" in r]
    if not marked:
        return None
    host = torch.stack([r["marks"] for r in marked]).cpu().numpy()
    return [stage_times(r["stage_spans"], m)[0] for r, m in zip(marked, host)]


def collect(pipe, window_rows, profiled_rows, profile, t_begin, t_end,
            bench_spans):
    """The run's `trace` after a traced run with the pipeline's tracer on
    (None without it): the window frames' stage ms, the program's host
    spans in the window and the traced stretch ([start row, end row)
    each), the kernel nodes by stage of each captured graph, and the
    traced stretch's kernels by stage and idle gaps by program span."""
    tracer = getattr(pipe, "tracing", None)
    if tracer is None:
        return None
    rows = pipe.log.rows
    w0, w1 = window_rows
    p0, p1 = profiled_rows
    graphs = getattr(pipe, "_frame_graphs", None)
    spans = [s for s in tracer.spans if w0 <= s[0] < p1]
    out = {"window_rows": [w0, w1], "profiled_rows": [p0, p1],
           "stage_ms": window_stage_ms(rows[w0:w1]), "host_spans": spans,
           "kernel_nodes_by_stage": (graphs.summary()["kernel_nodes_by_stage"]
                                     if graphs is not None else None),
           "profile_by_stage": None, "idle_gaps_by_program_span": None}
    if profile:
        layouts = [rows[j]["stage_spans"] for j in range(p0, p1)
                   if "stage_spans" in rows[j]]
        out["profile_by_stage"] = kernels_by_stage(profile["kernels"], layouts)
        out["idle_gaps_by_program_span"] = idle_gaps_by_program_span(
            profile["intervals"], t_begin, t_end,
            [s for s in spans if p0 <= s[0] < p1], bench_spans.rows)
    return out


def mean_stage_ms(run, names, vio_only=False):
    """Mean over the window's frames of the summed ms of the named
    stages (a frame lacking one counts it 0; `vio_only`: over the frames
    that ran VIO), from the run's `trace`; None where no frame has one."""
    t = getattr(run, "trace", None)
    rows = t and t["stage_ms"]
    if not rows:
        return None
    if vio_only:
        rows = [r for r in rows if "vio_ms" in r]
    if not any(f"{n}_ms" in r for r in rows for n in names):
        return None
    return sum(sum(r.get(f"{n}_ms", 0.0) for n in names) for r in rows) / len(rows)


def poll_span_ms(run, names):
    """Mean over the window's frames of the summed ms of the named host
    spans of the poll that ran each, from the run's `trace`."""
    t = getattr(run, "trace", None)
    if not t:
        return None
    w0, w1 = t["window_rows"]
    if w1 <= w0:
        return None
    total = sum(s1 - s0 for row, name, _, s0, s1 in t["host_spans"]
                if w0 <= row < w1 and name in names)
    return 1e3 * total / (w1 - w0)

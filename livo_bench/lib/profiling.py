"""A short traced stretch of frames under torch.profiler, reduced to
kernel time by name, launches, busy seconds and idle gaps labelled by
what the host was doing (the benchmark's own spans, recorded as
profiler ranges so that both clocks line up).

Copied in spirit from chip_smoke.py's `profile_frames`: the profiler
slows a replayed frame (~50-60 % on this card), so the stretch is short
and only per-layer numbers come from it.
"""

from contextlib import contextmanager

PREFIX = "livo_bench."


@contextmanager
def profiled():
    """(profiler, ranges): a CPU + CUDA profile and the range factory the
    runner's spans use inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranges(name):
        return record_function(PREFIX + name)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof, ranges
    torch.cuda.synchronize()


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(prof, spans, t_begin, t_end, top=10):
    """Kernel events of the profile, in the clock of `spans` (seconds):
    {kernels: [(name, start, end)], by_name: {name: s}, busy_s, window_s,
    device_ops, idle_gaps}. The profiler's clock is mapped onto the
    spans' by the benchmark's own ranges."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    mine = [e for e in events if e.name.startswith(PREFIX) and e.device_type != cuda]
    # the same spans in both clocks, in order: the offset of the two
    offs = []
    named = [r for r in spans.rows if t_begin <= r[1] <= t_end]
    for (name, a, _), e in zip(named, sorted(mine, key=lambda e: e.time_range.start)):
        offs.append(e.time_range.start * 1e-6 - a)
    offs.sort()
    off = offs[len(offs) // 2] if offs else 0.0
    kernels = [(e.name, e.time_range.start * 1e-6 - off, e.time_range.end * 1e-6 - off)
               for e in events if e.device_type == cuda and not e.name.startswith(PREFIX)]
    by_name = {}
    for name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    busy = _union([(max(a, t_begin), min(b, t_end)) for _, a, b in kernels
                   if b > t_begin and a < t_end])
    gaps, prev = [], t_begin
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if t_end > prev:
        gaps.append((prev, t_end))
    labelled = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = "other host work"
        for name, s0, s1 in spans.rows:
            if s0 <= mid <= s1:
                label = name
                break
        labelled.append((label, b - a))
    labelled.sort(key=lambda x: -x[1])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"kernels": kernels, "by_name": by_name, "intervals": busy,
            "busy_s": sum(b - a for a, b in busy), "window_s": t_end - t_begin,
            "device_ops": [[k[:120], v] for k, v in ranked[:top]],
            "idle_gaps": [[k, v] for k, v in labelled[:top]]}


def busy_within(intervals, a, b):
    """Seconds of [a, b] during which a kernel ran."""
    return sum(max(0.0, min(y, b) - max(x, a)) for x, y in intervals)

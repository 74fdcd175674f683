"""Share of the traced frames' spans, each from its last input's due to
its pose on the host, in which no kernel ran."""

from livo_bench.lib import profiling


def read(run):
    p = run.profile
    fr = [f for f in run.profile_frames if f.out == f.out and f.due == f.due]
    if not p or not fr:
        return None
    span = sum(f.out - f.due for f in fr)
    busy = sum(profiling.busy_within(p["intervals"], f.due, f.out) for f in fr)
    return 100.0 * (1.0 - busy / span) if span > 0 else None

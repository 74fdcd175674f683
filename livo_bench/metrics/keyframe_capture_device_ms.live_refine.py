"""Median device milliseconds of the keyframe's photometric capture over
the traced stretch: the profiler's `keyframe_capture` ranges (the
program's annotate range around the capture's graph replay, which
follows a keyframe frame's graph). None where the stretch holds none (a
program without that range)."""

import numpy as np

RANGE = "keyframe_capture"


def read(run):
    p = run.profile
    if not p:
        return None
    ms = [(b - a) * 1e3 for n, a, b in p["kernels"] if n == RANGE]
    return float(np.median(ms)) if ms else None

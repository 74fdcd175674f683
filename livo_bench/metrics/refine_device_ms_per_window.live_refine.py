"""Median milliseconds of a backend window on the refiner's own CUDA
stream (OnlineRefiner's events around the window's graph replay), over
the windows completed in the measured window."""

import numpy as np


def read(run):
    ms = (run.refine or {}).get("device_ms")
    return float(np.median(ms)) if ms else None

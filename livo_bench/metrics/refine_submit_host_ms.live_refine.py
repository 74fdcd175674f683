"""Median host milliseconds of OnlineRefiner.submit (the window's input
copies into the graph's buffers and the replay's launch, paid on the
frame's path) over the submits in the measured window."""

import numpy as np


def read(run):
    ms = (run.refine or {}).get("submit_ms")
    return float(np.median(ms)) if ms else None

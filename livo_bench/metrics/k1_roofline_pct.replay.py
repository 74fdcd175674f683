"""K1 (cov_scan) as a share of its roofline: the least time of a call
(lib/rooflines.k1 at a frame's live intervals) over the profiler's
device time per K1 kernel in the traced stretch."""

from livo_bench.lib import rooflines


def read(run):
    p = run.profile
    if not p:
        return None
    ks = [b - a for n, a, b in p["kernels"] if "cov_scan_kernel" in n]
    if not ks:
        return None
    least, _ = rooflines.bound_s(*rooflines.k1(rooflines.K1_LIVE))
    return 100.0 * least / (sum(ks) / len(ks))

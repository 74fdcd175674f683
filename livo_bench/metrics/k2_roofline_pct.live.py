"""K2 (photo_iteration) as a share of its roofline: the least time of a
call at the main path's shape (lib/rooflines.k2) over the profiler's
device time per K2 kernel in the traced stretch."""

from livo_bench.lib import rooflines


def read(run):
    p = run.profile
    if not p:
        return None
    ks = [b - a for n, a, b in p["kernels"] if "photo_iteration_kernel" in n]
    if not ks:
        return None
    least, _ = rooflines.bound_s(*rooflines.k2())
    return 100.0 * least / (sum(ks) / len(ks))

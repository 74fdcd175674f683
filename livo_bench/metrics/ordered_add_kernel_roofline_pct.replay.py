"""The ordered segment add's kernel (`ordered_add_kernel`,
csrc/ordered_add.cu) as a share of its roofline: the least time of a
fused frame's three calls at their lane counts
(lib/rooflines.ordered_add_frame; rows touched not counted, so a lower
bound) over the device time of that kernel in the traced stretch, per
frame. The kernel alone: the stable sort that comes before the map
insert's call runs as library sort kernels that no name ties to the add
(a frame runs other sorts), so it is not in this share."""

from livo_bench.lib import rooflines
from livo_bench.reference.lio import setting


def read(run):
    p = run.profile
    if not p or not run.profile_frames:
        return None
    ks = [b - a for n, a, b in p["kernels"] if "ordered_add_kernel" in n]
    if not ks:
        return None
    s = run.deploy["sensor"]
    least, _ = rooflines.bound_s(*rooflines.ordered_add_frame(
        setting(s, "tpu.max_points_per_scan"), setting(s, "tpu.max_points_down"),
        setting(s, "tpu.descend_compact")))
    return 100.0 * least / (sum(ks) / len(run.profile_frames))

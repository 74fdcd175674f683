"""Device ms a window frame of the ordered segment add's calls, each its
stable sort and its kernel (the program's `ordered_add` stage spans:
one in the downsample, two in the map insert at these deployments)."""

from livo_bench.lib import stages


def read(run):
    return stages.mean_stage_ms(run, ("ordered_add",))

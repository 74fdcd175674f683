"""Share of the traced frames' spans, each from its first stage mark
kernel to its last (the frame graph's run on the device), in which no
kernel ran: the launch gaps inside the graph."""

from livo_bench.lib import stages


def read(run):
    return stages.graph_idle_pct(run.profile)

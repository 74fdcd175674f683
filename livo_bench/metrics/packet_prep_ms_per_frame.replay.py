"""Host ms a window frame of packet preparation in the poll that ran it:
the program's `packet` span (a packet not prefetched) and `prefetch`
span (the next frame's packet), pinned uploads included."""

from livo_bench.lib import stages


def read(run):
    return stages.poll_span_ms(run, ("packet", "prefetch"))

"""Host ms a window frame of the program's `replay` span: binding the
state, copying the inputs into the graph's buffers and the graph's
launch (which waits where the launch queue is full)."""

from livo_bench.lib import stages


def read(run):
    return stages.poll_span_ms(run, ("replay",))

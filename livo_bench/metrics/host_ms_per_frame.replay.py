"""Host milliseconds a replay window frame: the poll that ran it (its
launch, the next packet's prefetch) plus the feeder's pushes, from the
benchmark's spans."""


def read(run):
    if not run.frames:
        return None
    polls = sum(f.host_ms for f in run.frames)
    pushes = run.push_s * 1e3
    return (polls + pushes) / len(run.frames)

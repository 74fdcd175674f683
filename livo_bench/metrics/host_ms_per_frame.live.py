"""Host milliseconds of the poll that ran each live window frame
(packet preparation, the replay's launch and the frame's bookkeeping),
before the pose is read: the benchmark's span around the poll."""


def read(run):
    ms = [f.host_ms for f in run.frames]
    return sum(ms) / len(ms) if ms else None

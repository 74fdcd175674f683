"""Frames completed in the replay window over its seconds (from its
start to the synchronize that closes it)."""


def read(run):
    return len(run.frames) / run.window_s if run.window_s > 0 else None

"""Synchronizing CUDA calls inside the poll that ran each live window
frame (torch's sync debug mode, counted in the traced run)."""


def read(run):
    s = [f.syncs for f in run.frames]
    return sum(s) / len(s) if s else None

"""Synchronizing CUDA calls inside the poll that ran each replay window
frame (torch's sync debug mode, counted in the traced run): a poll that
waits on the card shows here."""


def read(run):
    s = [f.syncs for f in run.frames]
    return sum(s) / len(s) if s else None

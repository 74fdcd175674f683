"""Scan points matched to a map plane in the final LIO iteration, per
replay window frame (the FrameLog's n_eff)."""


def read(run):
    return sum(run.n_eff) / len(run.n_eff) if run.n_eff else None

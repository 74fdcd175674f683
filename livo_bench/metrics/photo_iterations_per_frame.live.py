"""Photometric ESIKF iterations that took effect per VIO frame of the
live window (the pipeline's own counter)."""


def read(run):
    return run.photo_iterations / run.vio_frames if run.vio_frames else None

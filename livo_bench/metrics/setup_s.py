"""Set-up seconds: process start to the window's start (imports, the
card, the recording, the pipeline, a first run's kernel build, the warm
frames and the frame graph's capture)."""


def read(run):
    return run.setup_s

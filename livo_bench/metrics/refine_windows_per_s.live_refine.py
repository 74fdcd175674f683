"""Backend windows completed (polled back by the pipeline) per second of
the measured window; a slower refiner has more submits refused as
pending, and fewer windows complete."""


def read(run):
    r = run.refine
    return r["completed"] / run.window_s if r and run.window_s > 0 else None

"""Device ms a window frame of the iterated LIO update (the plane
matches and the ESIKF device loop), from the program's stage marks."""

from livo_bench.lib import stages


def read(run):
    return stages.mean_stage_ms(run, ("lio",))

"""Device ms a window frame of the voxel map's insert (its ordered adds
included), from the program's stage marks."""

from livo_bench.lib import stages


def read(run):
    return stages.mean_stage_ms(run, ("map",))

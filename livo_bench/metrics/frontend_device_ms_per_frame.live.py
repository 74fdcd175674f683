"""Device ms a window frame of the front end: the propagate, undistort
and downsample stages (K1, the undistortion and the voxel downsample
with its ordered add), from the program's stage marks."""

from livo_bench.lib import stages


def read(run):
    return stages.mean_stage_ms(run, ("propagate", "undistort", "downsample"))

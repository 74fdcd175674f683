"""Device ms a window frame that ran VIO of the VIO half (ring insert,
raster, retrieval, the photometric update, pool upkeep), from the
program's stage marks."""

from livo_bench.lib import stages


def read(run):
    return stages.mean_stage_ms(run, ("vio",), vio_only=True)

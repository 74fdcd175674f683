"""The benchmark's copies of the kernels' counts give chip_smoke.py's
numbers at its shapes."""

from livo_bench.lib import rooflines


def test_counts_at_chip_smoke_shapes():
    assert rooflines.k1() == (187_720, 1_755_904)
    assert rooflines.k2() == (212_264, 1_808_928)
    assert rooflines.ordered_add(3 * 8192, 16, touched=1500)[0] == 1_961_472
    least, by = rooflines.bound_s(*rooflines.k1())
    assert by == "bytes" and abs(least - 187_720 / 3.35e12) < 1e-15

"""The yardstick's peaks and the operations and bytes of each kernel,
from shapes (copied from chip_smoke.py's `bound`, `k1_case`, `k2_bound`
and `phase_kernel_ordered_add`).

Peaks: NVIDIA's published H100 SXM figures (data sheet, dense), which
assume the full 700 W power limit; every share is reported with the
card's limit beside it.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# K1 (cov_scan): K steps of D x D covariance propagation.
K1_STEPS, K1_D = 64, 19
# Live IMU intervals of a 10 Hz frame at 200 Hz (the rest is padding the
# kernel skips).
K1_LIVE = 21

# K2 (photo_iteration): per pixel 5 bilinear evaluations (35), du/dv (4),
# the residual (2), ten products and their sums (20); per point ~600;
# one add per output entry in the sum over points.
K2_FLOP_PER_PIXEL, K2_FLOP_PER_POINT = 61, 600
K2_META_W, K2_PAR_W, K2_OUT_W, K2_PIXELS = 8, 64, 64, 64
# Distinct image taps of the 396 tracked points' windows on a rendered
# 640 x 512 frame (chip_smoke.py's kernel_photo case): the taps the
# kernel must read at the main path's shape. A frame's own taps are not
# visible from outside the graph; this count stands for them.
K2_TAPS_M396 = 24426


def bound_s(nbytes: float, flops: float):
    """(least seconds, what bounds it): the larger of bytes over the HBM
    peak and operations over the FP32 peak."""
    b, f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(b, f), ("bytes" if b >= f else "operations")


def k1(steps: int = K1_STEPS, D: int = K1_D):
    """(bytes, flops) of one K1 call: F and Q read once (all K steps),
    P0 read and the result written once; two D^3 products a computed
    step, 2 flops a multiply-add."""
    nbytes = (2 * K1_STEPS * D * D + 2 * D * D) * 4
    return nbytes, steps * 4 * D ** 3


def k2(M: int = 396, taps: int = K2_TAPS_M396):
    """(bytes, flops) of one K2 call over M points: the distinct taps,
    each point's meta row and 64-pixel reference patch and the parameter
    row read once, the output row written once."""
    nbytes = (taps + M * (K2_META_W + K2_PIXELS) + K2_PAR_W + K2_OUT_W) * 4
    flops = M * (K2_PIXELS * K2_FLOP_PER_PIXEL + K2_FLOP_PER_POINT) + M * K2_OUT_W
    return nbytes, flops


def ordered_add(n: int, W: int, touched: int = 0):
    """(bytes, flops) of one ordered segment add of n lanes of W floats:
    sources and int64 destinations read once, each touched row read and
    written once; n W additions. With `touched` unknown (0), a lower
    bound."""
    return n * W * 4 + n * 8 + 2 * touched * W * 4, n * W


def ordered_add_frame(max_points_per_scan: int, max_points_down: int,
                      descend: int):
    """(bytes, flops) of a steady fused frame's three ordered adds at
    their lane counts: the downsample's centroids (every packet lane, 3
    floats), the map insert's layer 0 (every downsampled lane) and its
    finer layers (two layers of `descend` lanes), 16 moments each;
    touched rows not counted (not visible from outside the graph)."""
    parts = [ordered_add(max_points_per_scan, 3),
             ordered_add(max_points_down, 16), ordered_add(2 * descend, 16)]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)

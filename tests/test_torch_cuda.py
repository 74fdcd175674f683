"""Tests of the port that need an NVIDIA GPU and nvcc (marker `cuda`).

Without a card each test skips itself; the check runs inside the test,
never at import. This file imports nothing of JAX, so on a machine with
a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import math
import os

import numpy as np
import pytest
import torch

from fast_livo2_tpu_torch.ops import _launch
from fast_livo2_tpu_torch.ops import cov_scan
from fast_livo2_tpu_torch.ops import gather, ordered_add
from fast_livo2_tpu_torch.ops import photo_iteration as photo

# tests/test_imu.py:176-177: two float32 evaluation orders of the same
# recursion (here FFMA in the kernel against ATen's matmul).
RTOL_COV, ATOL_COV = 2e-4, 2e-5
# K2: each HTH / HTz entry within 1e-4 of the plain block's largest
# absolute entry plus rtol 2e-4 (the card sums the 64 pixels and the M
# rows in another order); err rtol 1e-4; cnt exact. All-zero outputs
# (M = 0) must be exactly zero.
RTOL_PHOTO, BLOCK_ATOL_PHOTO = 2e-4, 1e-4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")


def _cov_inputs(K, D=19, seed=3):
    """tests/test_imu.py:156-163's construction."""
    rng = np.random.default_rng(seed)
    F = (np.eye(D)[None] + rng.normal(size=(K, D, D)) * 0.02).astype(np.float32)
    Q = rng.normal(size=(K, D, D)) * 0.01
    Q = np.einsum("kij,klj->kil", Q, Q).astype(np.float32)
    P0 = rng.normal(size=(D, D)) * 0.1
    P0 = (P0 @ P0.T + np.eye(D) * 0.01).astype(np.float32)
    return F, Q, P0


def _cov_with_noops(live, K=64, D=19, seed=3):
    """_cov_inputs with the steps not in `live` (a boolean mask over K)
    made exact no-ops: F = I and Q = 0 by value, about a tenth of their
    zeros -0.0, as the IMU batch's padding has them."""
    F, Q, P0 = _cov_inputs(K, D, seed)
    rng = np.random.default_rng(seed + 1)
    pad = ~np.asarray(live)
    F[pad] = np.eye(D, dtype=np.float32)
    Q[pad] = 0.0
    neg = rng.random((2,) + F.shape) < 0.1
    F[neg[0] & pad[:, None, None] & (F == 0)] = -0.0
    Q[neg[1] & pad[:, None, None]] = -0.0
    return F, Q, P0


@pytest.mark.cuda
@pytest.mark.parametrize("K,D", [(64, 19), (1, 19), (64, 32), (7, 5), (0, 19),
                                 (64, 1), (64, 21), (13, 19), (200, 19)])
def test_cov_scan_kernel_matches_plain(K, D):
    """The hand-written kernel against its plain version on the card, at
    the main path's K = 64, D = 19 and at the edges it accepts: no step
    (P0 back), one step, the widest and narrowest D, a D whose padded
    row stride is not D rounded up to 4 (21 -> 28), a last group of 5
    steps whose last 16-byte copy holds one float, and more steps than
    one chunk stages (64)."""
    _need_card()
    F, Q, P0 = (torch.from_numpy(a).cuda() for a in _cov_inputs(K, D))
    before = cov_scan.LAUNCHES
    got = cov_scan.propagate_cov(F, Q, P0)
    torch.cuda.synchronize()
    assert cov_scan.LAUNCHES == before + 1
    want = cov_scan.propagate_cov_plain(F, Q, P0)
    torch.testing.assert_close(got, want, rtol=RTOL_COV, atol=ATOL_COV)


@pytest.mark.cuda
def test_cov_scan_kernel_on_unaligned_views():
    """F and Q starting 4 bytes past a 16-byte boundary: the kernel copies
    them 4 bytes at a time instead of 16, with the same result."""
    _need_card()
    F, Q, P0 = (torch.from_numpy(a).cuda() for a in _cov_inputs(64))
    views = []
    for t in (F, Q):
        flat = torch.zeros(t.numel() + 1, device="cuda")
        flat[1:] = t.reshape(-1)
        views.append(flat[1:].view(t.shape))
    assert all(v.data_ptr() % 16 == 4 for v in views)
    got = cov_scan.propagate_cov(*views, P0)
    torch.cuda.synchronize()
    assert torch.equal(got, cov_scan.propagate_cov(F, Q, P0))
    torch.testing.assert_close(got, cov_scan.propagate_cov_plain(F, Q, P0),
                               rtol=RTOL_COV, atol=ATOL_COV)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["trailing", "interleaved", "all"])
def test_cov_scan_kernel_skips_noop_steps(pattern):
    """Steps with F = I and Q = 0 by value (-0.0 among the zeros), which
    the kernel skips: the main path's 21 live steps then 43 padding steps,
    every third step live, and no live step at all, which gives P0 back
    by value."""
    _need_card()
    K = 64
    live = {"trailing": np.arange(K) < 21, "interleaved": np.arange(K) % 3 == 0,
            "all": np.zeros(K, bool)}[pattern]
    F, Q, P0 = (torch.from_numpy(a).cuda() for a in _cov_with_noops(live, K))
    got = cov_scan.propagate_cov(F, Q, P0)
    torch.cuda.synchronize()
    want = cov_scan.propagate_cov_plain(F, Q, P0)
    torch.testing.assert_close(got, want, rtol=RTOL_COV, atol=ATOL_COV)
    if pattern == "all":
        assert torch.equal(got, P0)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["dense", "trailing"])
def test_cov_scan_kernel_bitwise_repeatable(pattern):
    """One block, a fixed order of operations: 20 calls give the same
    bits, with and without skipped steps."""
    _need_card()
    live = np.arange(64) < (64 if pattern == "dense" else 21)
    F, Q, P0 = (torch.from_numpy(a).cuda() for a in _cov_with_noops(live))
    first = cov_scan.propagate_cov(F, Q, P0)
    for _ in range(20):
        assert torch.equal(cov_scan.propagate_cov(F, Q, P0), first)


@pytest.mark.cuda
def test_cov_scan_kernel_noop_steps_keep_an_inf():
    """The one case where skipping changes values: a non-finite P. A
    skipped step keeps an Inf of P0, where the full step (the plain
    version) makes NaN of it (0 * Inf in the off-diagonal terms)."""
    _need_card()
    F, Q, P0 = _cov_with_noops(np.zeros(8, bool), K=8)
    P0[2, 5] = P0[5, 2] = np.inf
    F, Q, P0 = (torch.from_numpy(a).cuda() for a in (F, Q, P0))
    got = cov_scan.propagate_cov(F, Q, P0)
    torch.cuda.synchronize()
    assert torch.equal(got, P0)
    assert torch.isnan(cov_scan.propagate_cov_plain(F, Q, P0)).any()


@pytest.mark.cuda
def test_cov_scan_wrapper_rejects_bad_input():
    _need_card()
    F, Q, P0 = (torch.from_numpy(a).cuda() for a in _cov_inputs(8))
    before = cov_scan.LAUNCHES
    with pytest.raises(TypeError):
        cov_scan.propagate_cov(F.double(), Q, P0)
    with pytest.raises(ValueError):
        cov_scan.propagate_cov(F.transpose(1, 2), Q, P0)
    with pytest.raises(ValueError):
        cov_scan.propagate_cov(F.cpu(), Q, P0)
    big = torch.zeros((2, 33, 33), device="cuda")
    with pytest.raises(ValueError):
        cov_scan.propagate_cov(big, big, big[0].contiguous())
    assert cov_scan.LAUNCHES == before


@pytest.mark.cuda
def test_only_lio_on_card_matches_cpu():
    """A short ONLY_LIO run on "cuda" (kernel path) against "cpu" (plain
    path), at the golden tolerances: 8e-3 m and 4e-3 (float scatter-adds
    run in no fixed order on the card)."""
    _need_card()
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
    from fast_livo2_tpu_torch.io import synthetic
    from fast_livo2_tpu_torch.utils.config import LIVOConfig

    cfg = LIVOConfig()
    cfg.tpu.max_points_per_scan = 8192
    cfg.tpu.max_points_down = 4096
    cfg.tpu.hash_capacity_log2 = 15
    cfg.lio.max_layer = 1
    cfg.preprocess.filter_size_surf = 0.15
    seq = synthetic.make_sequence(duration=2.4, lidar_hz=10.0, imu_hz=200.0,
                                  seed=7, n_lines=12, n_per_line=500,
                                  render=False, fov_deg=360.0)
    before = cov_scan.LAUNCHES
    gpu = LIVOPipeline(cfg, "only_lio", device="cuda").process(seq)
    assert cov_scan.LAUNCHES - before == len(gpu)
    cpu = LIVOPipeline(cfg, "only_lio", device="cpu").process(seq)
    assert [t for t, _, _ in gpu] == [t for t, _, _ in cpu]
    np.testing.assert_allclose(np.array([p for _, _, p in gpu]),
                               np.array([p for _, _, p in cpu]), atol=8e-3)
    np.testing.assert_allclose(np.array([R for _, R, _ in gpu]),
                               np.array([R for _, R, _ in cpu]), atol=4e-3)


def _photo_inputs(H, W, M, with_dist, seed=0):
    """A smooth DN-scale image and M points ahead of the camera with stride
    exponents 0-5 (the clamp to 4 bites) and about 10 % masked out."""
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.standard_normal((H, W)), 0), 1)
    img = ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.float32)
    f = 0.6 * W
    pos = np.stack([rng.uniform(-0.4, 0.4, M) * 4, rng.uniform(-0.3, 0.3, M) * 4,
                    np.full(M, 4.0)], -1).astype(np.float32)
    ref = rng.uniform(0, 255, (M, 64)).astype(np.float32)
    slog = rng.integers(0, 6, M).astype(np.int32)
    ok = rng.random(M) > 0.1
    d = [0.02, -0.01, 0.001, -0.002] if with_dist else [0.0] * 4
    dev = "cuda"
    meta, refp = photo.pack_points(*(torch.from_numpy(a).to(dev)
                                     for a in (pos, ref, slog, ok)))
    eye = torch.eye(3, device=dev)
    par = photo.pack_params(eye, torch.zeros(3, device=dev),
                            torch.tensor(1.05, device=dev), eye, 0.1 * eye,
                            f, f, W / 2, H / 2, d, 1.0, 1.0 if with_dist else 0.0)
    return torch.from_numpy(img).to(dev), meta, refp, par


def _assert_photo_close(got, want):
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(
            g, w, rtol=RTOL_PHOTO, atol=BLOCK_ATOL_PHOTO * float(w.abs().max()))
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
    assert float(got[3]) == float(want[3])


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,M,with_dist", [
    (512, 640, 396, False), (512, 640, 396, True), (96, 128, 8, True),
    (48, 12, 3, False)])
def test_photo_iteration_kernel_matches_plain(H, W, M, with_dist):
    """K2 against its plain version on the card: the main path's 640 x 512
    frame with M = 396, a small case where the clamp lowers the stride
    exponent to 3, and the narrowest width the kernel takes."""
    _need_card()
    args = _photo_inputs(H, W, M, with_dist)
    before = photo.LAUNCHES
    got = photo.photo_iteration(*args)
    torch.cuda.synchronize()
    assert photo.LAUNCHES == before + 1
    _assert_photo_close(got, photo.photo_iteration_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,M", [(480, 752, 486), (96, 128, 9)])
def test_photo_iteration_kernel_clip_taps_matches_plain(H, W, M):
    """K2 in the sampling above 448 tracked points (clip_taps: each tap
    clipped, no stride clamp) against its plain version: NTU-VIRAL's frame
    and M, and a small frame where exponents up to 5 exceed the width's
    clamp; the block-clip sampling of the same inputs differs."""
    _need_card()
    args = _photo_inputs(H, W, M, True, seed=M)
    before = photo.LAUNCHES
    got = photo.photo_iteration(*args, clip_taps=True)
    torch.cuda.synchronize()
    assert photo.LAUNCHES == before + 1
    _assert_photo_close(got, photo.photo_iteration_plain(*args, clip_taps=True))
    block = photo.photo_iteration(*args)
    assert not torch.allclose(block[0], got[0], rtol=RTOL_PHOTO, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [0, 1, 7, 9, 396, 4096])
@pytest.mark.parametrize("with_dist", [False, True])
def test_photo_iteration_kernel_block_edges(M, with_dist):
    """K2 at point counts around its eight points a block: none (one
    block writes zeros), one, a block short of full, one over, the main
    path's 396 (50 blocks) and 4096 (512 blocks, a longer final sum)."""
    _need_card()
    args = _photo_inputs(512, 640, M, with_dist, seed=M)
    before = photo.LAUNCHES
    got = photo.photo_iteration(*args)
    torch.cuda.synchronize()
    assert photo.LAUNCHES == before + 1
    want = photo.photo_iteration_plain(*args)
    if M == 0:
        assert all(not torch.any(g) for g in got)
    _assert_photo_close(got, want)


def _photo_flat(out):
    return torch.cat([out[0].reshape(-1), out[1], out[2].reshape(1),
                      out[3].reshape(1)])


@pytest.mark.cuda
def test_photo_iteration_kernel_bitwise_repeatable():
    """The sum over blocks runs in a fixed order whichever block finishes
    last: 20 calls give the same bits, with calls at other M (other
    grids, the ticket reset by each call's last block) in between."""
    _need_card()
    args = _photo_inputs(512, 640, 396, True)
    others = [_photo_inputs(512, 640, M, False, seed=M) for M in (9, 4096)]
    first = _photo_flat(photo.photo_iteration(*args))
    for k in range(20):
        assert torch.equal(_photo_flat(photo.photo_iteration(*args)), first)
        photo.photo_iteration(*others[k % 2])


@pytest.mark.cuda
def test_photo_iteration_one_device_kernel_per_call():
    """One launch a call: no second stage, no memset, no copy."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile, schedule

    args = _photo_inputs(512, 640, 396, False)
    photo.photo_iteration(*args)  # the stream's scratch is allocated here
    torch.cuda.synchronize()
    recorded = []
    # the second of two cycles is recorded: the first warms the tracer up
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: recorded.append(
                     [e.name for e in p.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA])) as prof:
        for _ in range(2):
            for _ in range(10):
                photo.photo_iteration(*args)
            torch.cuda.synchronize()
            prof.step()
    names = recorded[-1]
    assert len(names) == 10, names
    assert all("photo_iteration_kernel" in n for n in names), names


@pytest.mark.cuda
def test_raw_stream_is_the_current_stream():
    _need_card()
    dev = torch.cuda.current_device()
    assert _launch.raw_stream(dev) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert (_launch.raw_stream(dev) == torch.cuda.current_stream().cuda_stream
                == side.cuda_stream)
    assert _launch.raw_stream(dev) != side.cuda_stream


@pytest.mark.cuda
def test_wrappers_on_a_side_stream_match_plain():
    """Each wrapper launched inside torch.cuda.stream(side) runs on that
    stream (K2 with the side stream's own scratch) and agrees with its
    plain version."""
    _need_card()
    F, Q, P0 = (torch.from_numpy(a).cuda() for a in _cov_inputs(64))
    k2 = _photo_inputs(512, 640, 396, True)
    table, idx = _gather_inputs(4096, 128, 1024)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    counts = (cov_scan.LAUNCHES, photo.LAUNCHES, gather.LAUNCHES)
    with torch.cuda.stream(side):
        cov = cov_scan.propagate_cov(F, Q, P0)
        pho = photo.photo_iteration(*k2)
        gat = gather.gather_rows(table, idx)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert (cov_scan.LAUNCHES, photo.LAUNCHES, gather.LAUNCHES) == tuple(
        c + 1 for c in counts)
    torch.testing.assert_close(cov, cov_scan.propagate_cov_plain(F, Q, P0),
                               rtol=RTOL_COV, atol=ATOL_COV)
    _assert_photo_close(pho, photo.photo_iteration_plain(*k2))
    assert torch.equal(gat, gather.gather_rows_plain(table, idx))


@pytest.mark.cuda
def test_photo_iteration_wrapper_rejects_bad_input():
    _need_card()
    img, meta, refp, par = _photo_inputs(64, 96, 8, False)
    before = photo.LAUNCHES
    with pytest.raises(TypeError):
        photo.photo_iteration(img.double(), meta, refp, par)
    with pytest.raises(ValueError):
        photo.photo_iteration(img.t(), meta, refp, par)
    with pytest.raises(ValueError):
        photo.photo_iteration(img, meta.cpu(), refp, par)
    with pytest.raises(ValueError):
        photo.photo_iteration(img, meta, refp, par, ps=4)
    with pytest.raises(ValueError):
        photo.photo_iteration(img[:, :11].contiguous(), meta, refp, par)
    assert photo.LAUNCHES == before


def _tail_case(n, axis, angle, hz, cond=1e2, seed=0):
    """Float64 inputs of one filter-tail call: state_prop = state rotated
    by `angle` about `axis` (near identity and near pi reach so3.log's
    series and axis branches), P_scaled_inv = inv(cov / 100) of an SPD
    covariance whose eigenvalues spread over `cond`, HTH = J^T J of 64
    rows, HTz = hz * HTH e + noise (hz = 0: HTz = 0)."""
    from fast_livo2_tpu_torch.core.state import NavState, boxminus
    from fast_livo2_tpu_torch.ops import photo_tail, so3

    rng = np.random.default_rng(seed)
    f64 = torch.float64

    def rot(ax, ang):
        ax = np.asarray(ax, np.float64)
        return so3.exp(torch.tensor(ax / np.linalg.norm(ax) * ang, dtype=f64))

    r = lambda k, s: torch.tensor(rng.normal(size=k) * s, dtype=f64)
    st = NavState(rot=rot(rng.normal(size=3), 0.7), pos=r(3, 0.3),
                  vel=r(3, 0.3), bias_g=r(3, 0.003), bias_a=r(3, 0.03),
                  grav=r(3, 0.1) + torch.tensor([0.0, 0.0, -9.81], dtype=f64),
                  inv_expo=torch.tensor(1.02, dtype=f64))
    sp = st._replace(rot=st.rot @ rot(axis, angle)) if angle else st
    Q, _ = np.linalg.qr(rng.normal(size=(19, 19)))
    cov = (Q * np.geomspace(1e-2, 1e-2 / cond, 19)) @ Q.T
    P = torch.tensor(np.linalg.inv((cov + cov.T) / 200.0), dtype=f64)
    J = rng.normal(size=(64, n)) * 30.0
    HTH = torch.tensor(J.T @ J, dtype=f64)
    e = boxminus(sp, st)[0:n]
    HTz = (HTH @ e) * hz + r(n, hz)
    carry, flags = photo_tail.start_level(sp, st, torch.zeros((19, 19), dtype=f64),
                                          torch.zeros((), dtype=f64))
    return carry, flags, P, HTH, HTz


# Filter-tail cases: (n, rotation axis and angle of state_prop against
# state, HTz scale, condition of the covariance, error, last_error, stop
# already set). 5 < 9: accepted; 9 > 5: rejected; a NaN error is
# rejected.
TAIL_CASES = {
    "accept": (7, [0.3, -0.5, 0.8], 0.02, 1.0, 1e2, 5.0, 9.0, 0),
    "reject": (7, [1, 2, 3], 0.1, 1.0, 1e2, 9.0, 5.0, 0),
    "stopped": (7, [1, 2, 3], 0.1, 1.0, 1e2, 5.0, 9.0, 1),
    "converged": (7, [1, 0, 0], 0.0, 0.0, 1e2, 5.0, 9.0, 0),
    "near_identity": (6, [0.2, 0.1, -1.0], 3e-5, 1.0, 1e2, 5.0, 9.0, 0),
    "near_pi": (6, [0.6, -0.3, 0.74], math.pi - 2e-4, 1.0, 1e2, 5.0, 9.0, 0),
    "ill_conditioned": (7, [0, 1, 1], 0.5, 1.0, 1e6, 5.0, 9.0, 0),
    "ill_conditioned_n6": (6, [1, 1, 0], 0.3, 1.0, 1e6, 5.0, 9.0, 0),
    "nan_error": (7, [1, 2, 3], 0.1, 1.0, 1e2, float("nan"), 9.0, 0),
}


def _tail_inputs(name, device_loop):
    from fast_livo2_tpu_torch.ops import photo_tail

    n, axis, angle, hz, cond, error, last, stop = TAIL_CASES[name]
    carry, flags, P, HTH, HTz = _tail_case(n, axis, angle, hz, cond)
    carry[photo_tail.LAST_ERR] = last
    flags[photo_tail.STOP] = stop if device_loop else 0
    return carry, flags, P, HTH, HTz, torch.tensor(error, dtype=torch.float64)


def _on(args, device, dtype):
    return [a.to(device=device, dtype=dtype if a.is_floating_point() else a.dtype)
            for a in args]


def _perturbed(args64, seed):
    """The inputs with every state, P, HTH and HTz entry moved by about
    one float32 ulp (x (1 +- 2^-23)); the error, last_error and flags,
    which decide the accept rule, kept."""
    from fast_livo2_tpu_torch.ops import photo_tail

    rng = np.random.default_rng(seed)
    out = [a.clone() for a in args64]
    for i, lo, hi in ((0, 0, photo_tail.G_KEEP), (2, 0, None), (3, 0, None),
                      (4, 0, None)):
        x = out[i].reshape(-1)[lo:hi]
        s = torch.from_numpy(rng.choice([-1.0, 1.0], size=x.shape))
        x.mul_(1.0 + s * 2.0 ** -23)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("device_loop", [True, False])
@pytest.mark.parametrize("name", list(TAIL_CASES))
def test_photo_tail_kernel_matches_plain(name, device_loop):
    """The kernel against the plain tail (ops/photo_tail.photo_tail_plain:
    inv_ex, boxminus / boxplus, the selects) on the card, at n = 7 and
    n = 6, in both loop forms, through accept, reject, an already-set
    stop, convergence, rotations near identity and near pi and an
    ill-conditioned SPD system. The flags (stop, iterations, done) are
    held exactly, and where the accept rule only copies, every value.
    The computed values (state', G_keep) are held to a float64
    evaluation of the same tail: in each block the kernel's largest
    error may not exceed four times the largest error of the plain
    float32 tail on these inputs and on three copies of them moved by one
    ulp, plus 2^-20 of the block's largest entry. Both are float32 and
    differ in the solve (Gauss-Jordan against cuSOLVER's LU and inverse)
    and in summation order, so neither is the other's reference; the
    ulp-moved copies measure how far rounding alone moves this case
    (near pi the float32 acos resolves the angle only to ~1e-4 rad)."""
    _need_card()
    from fast_livo2_tpu_torch.ops import photo_tail

    args64 = _tail_inputs(name, device_loop)
    ref = [a.clone() for a in args64]
    photo_tail.photo_tail_plain(*ref, device_loop)
    plains = []
    for k in range(4):
        a = _on(_perturbed(args64, k) if k else args64, "cuda", torch.float32)
        photo_tail.photo_tail_plain(*a, device_loop)
        plains.append(a)
    got = _on(args64, "cuda", torch.float32)
    before = photo_tail.LAUNCHES
    photo_tail.photo_tail(*got, device_loop)
    torch.cuda.synchronize()
    assert photo_tail.LAUNCHES == before + 1
    for p in plains:
        assert torch.equal(got[1], p[1]), (got[1], p[1])
    rejected = name in ("reject", "nan_error") or (name == "stopped"
                                                   and device_loop)
    if rejected:
        assert torch.equal(got[0], plains[0][0])  # copies only
        assert torch.equal(ref[0][photo_tail.STATE:photo_tail.OLD],
                           args64[0][photo_tail.STATE:photo_tail.OLD])
    for lo, hi in ((photo_tail.STATE, photo_tail.OLD),
                   (photo_tail.OLD, photo_tail.G_KEEP),
                   (photo_tail.G_KEEP, photo_tail.FINAL_ERR),
                   (photo_tail.FINAL_ERR, photo_tail.CARRY_W)):
        want = ref[0][lo:hi]
        e_k = float((got[0][lo:hi].cpu().double() - want).abs().max())
        e_p = max(float((p[0][lo:hi].cpu().double() - want).abs().max())
                  for p in plains)
        scale = float(want.abs().max())
        assert e_k <= 4 * e_p + 2.0 ** -20 * scale, (name, lo, e_k, e_p, scale)
    if name == "converged":
        flag = photo_tail.STOP if device_loop else photo_tail.DONE
        assert int(got[1][flag]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("device_loop", [True, False])
def test_photo_tail_kernel_bitwise_repeatable_and_captures(device_loop):
    """Two calls on the same inputs give the same bits, and a captured
    CUDA graph's replay the same bits as the eager call; a chain of five
    calls (the level's iterations, each reading what the last wrote)
    too."""
    _need_card()
    from fast_livo2_tpu_torch.ops import photo_tail

    args = _on(_tail_inputs("ill_conditioned", device_loop), "cuda",
               torch.float32)
    runs = []
    for _ in range(2):
        a = [t.clone() for t in args]
        for _ in range(5):
            photo_tail.photo_tail(*a, device_loop)
        runs.append(a)
    a = [t.clone() for t in args]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up, as torch's recipe does
        photo_tail.photo_tail(*[t.clone() for t in args], device_loop)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    before = photo_tail.LAUNCHES
    with torch.cuda.graph(g):
        for _ in range(5):
            photo_tail.photo_tail(*a, device_loop)
    assert photo_tail.LAUNCHES == before + 5
    g.replay()
    torch.cuda.synchronize()
    runs.append(a)
    for r in runs[1:]:
        assert torch.equal(r[0].view(torch.int32), runs[0][0].view(torch.int32))
        assert torch.equal(r[1], runs[0][1])


@pytest.mark.cuda
def test_photo_tail_wrapper_rejects_bad_input():
    _need_card()
    from fast_livo2_tpu_torch.ops import photo_tail

    carry, flags, P, HTH, HTz, err = _on(_tail_inputs("accept", True), "cuda",
                                         torch.float32)
    before = photo_tail.LAUNCHES
    with pytest.raises(ValueError):
        photo_tail.photo_tail(carry, flags, P.cpu(), HTH, HTz, err, True)
    with pytest.raises(TypeError):
        photo_tail.photo_tail(carry, flags.float(), P, HTH, HTz, err, True)
    with pytest.raises(ValueError):
        photo_tail.photo_tail(carry, flags, P, torch.zeros(8, 8, device="cuda"),
                              torch.zeros(8, device="cuda"), err, True)
    with pytest.raises(ValueError):
        photo_tail.photo_tail(carry[:-1], flags, P, HTH, HTz, err, True)
    assert photo_tail.LAUNCHES == before
    # strided matrices are taken as they are (inv_ex returns column-major)
    photo_tail.photo_tail(carry.clone(), flags.clone(), P.t().contiguous().t(),
                          HTH.t(), HTz, err, True)
    assert photo_tail.LAUNCHES == before + 1


@pytest.mark.cuda
def test_livo_on_card_matches_cpu():
    """A short LIVO run on "cuda" (the kernels) against "cpu" (plain
    versions), at the golden tolerances, and K2 and the filter tail
    launched once per photometric iteration."""
    _need_card()
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
    from fast_livo2_tpu_torch.io import synthetic
    from fast_livo2_tpu_torch.models import camera
    from fast_livo2_tpu_torch.utils.config import CameraConfig, LIVOConfig

    cfg = LIVOConfig()
    cfg.camera = CameraConfig(cam_model="Pinhole", cam_width=320,
                              cam_height=256, cam_fx=200.0, cam_fy=200.0,
                              cam_cx=160.0, cam_cy=128.0)
    cfg.extrin_calib.Rcl = list(synthetic.R_CI_FORWARD.reshape(-1))
    cfg.tpu.max_points_per_scan = 8192
    cfg.tpu.max_points_down = 4096
    cfg.tpu.hash_capacity_log2 = 15
    cfg.tpu.vis_point_capacity = 8192
    cfg.tpu.frame_ring = 32
    cfg.lio.max_layer = 1
    cfg.preprocess.filter_size_surf = 0.15
    seq = synthetic.make_sequence(
        duration=1.6, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0,
        cam=camera.make_camera(cfg.camera), seed=0, n_lines=12,
        n_per_line=500, render=True, fov_deg=360.0)
    from fast_livo2_tpu_torch.ops import photo_tail

    before, tail_before = photo.LAUNCHES, photo_tail.LAUNCHES
    pipe = LIVOPipeline(cfg, "livo", device="cuda")
    gpu = pipe.process(seq)
    assert photo.LAUNCHES - before == pipe.photo_iterations > 0
    assert photo_tail.LAUNCHES - tail_before == pipe.photo_iterations
    cpu = LIVOPipeline(cfg, "livo", device="cpu").process(seq)
    assert [t for t, _, _ in gpu] == [t for t, _, _ in cpu]
    np.testing.assert_allclose(np.array([p for _, _, p in gpu]),
                               np.array([p for _, _, p in cpu]), atol=8e-3)
    np.testing.assert_allclose(np.array([R for _, R, _ in gpu]),
                               np.array([R for _, R, _ in cpu]), atol=4e-3)


def _gather_inputs(C, W, N, seed=0):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(C, W)).astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.integers(0, C, N).astype(np.int32)).cuda()
    return table, idx


@pytest.mark.cuda
@pytest.mark.parametrize("C,W,N,group", [
    (262144, 128, 8192, 128), (2048, 128, 512, 64), (2048, 13, 512, 64),
    (100, 1, 64, 64)])
def test_gather_rows_kernel_matches_plain_bitwise(C, W, N, group):
    """K3 against table[idx] on the card: the LIO map's shape (16-byte
    path), tests/test_eig3.py's, an odd width and a one-float width
    (scalar path). A gather moves bytes only: equal bit for bit."""
    _need_card()
    table, idx = _gather_inputs(C, W, N)
    before = gather.LAUNCHES
    got = gather.gather_rows(table, idx, group=group)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1
    assert torch.equal(got, gather.gather_rows_plain(table, idx))


@pytest.mark.cuda
def test_gather_rows_kernel_on_unaligned_view():
    """A table view starting one float into its storage: W % 4 == 0 but
    the base is not 16-byte aligned, so the wrapper takes the scalar path."""
    _need_card()
    flat = torch.arange(2048 * 128 + 1, dtype=torch.float32, device="cuda")
    table = flat[1:].view(2048, 128)
    assert table.data_ptr() % 16 != 0
    _, idx = _gather_inputs(2048, 128, 256)
    got = gather.gather_rows(table, idx, group=128)
    torch.cuda.synchronize()
    assert torch.equal(got, table[idx.long()])


@pytest.mark.cuda
def test_gather_rows_wrapper_rejects_bad_input():
    _need_card()
    table, idx = _gather_inputs(64, 8, 128)
    before = gather.LAUNCHES
    with pytest.raises(TypeError):
        gather.gather_rows(table.double(), idx)
    with pytest.raises(TypeError):
        gather.gather_rows(table, idx.long())
    with pytest.raises(ValueError):
        gather.gather_rows(table.t(), idx, group=64)
    with pytest.raises(ValueError):
        gather.gather_rows(table, idx.cpu())
    with pytest.raises(ValueError):
        gather.gather_rows(table, idx[:100], group=64)
    assert gather.LAUNCHES == before


def _small_livo(duration=1.6, **tpu):
    """A small LIVO configuration and its rendered sequence (the LIVO
    test above: 1.6 s), with the tpu.* options given."""
    from fast_livo2_tpu_torch.io import synthetic
    from fast_livo2_tpu_torch.models import camera
    from fast_livo2_tpu_torch.utils.config import CameraConfig, LIVOConfig

    cfg = LIVOConfig()
    cfg.camera = CameraConfig(cam_model="Pinhole", cam_width=320,
                              cam_height=256, cam_fx=200.0, cam_fy=200.0,
                              cam_cx=160.0, cam_cy=128.0)
    cfg.extrin_calib.Rcl = list(synthetic.R_CI_FORWARD.reshape(-1))
    cfg.tpu.max_points_per_scan = 8192
    cfg.tpu.max_points_down = 4096
    cfg.tpu.hash_capacity_log2 = 15
    cfg.tpu.vis_point_capacity = 8192
    cfg.tpu.frame_ring = 32
    cfg.lio.max_layer = 1
    cfg.preprocess.filter_size_surf = 0.15
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    seq = synthetic.make_sequence(
        duration=duration, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0,
        cam=camera.make_camera(cfg.camera), seed=0, n_lines=12,
        n_per_line=500, render=True, fov_deg=360.0)
    return cfg, seq


def _state_tensors(pipe):
    """The state a fused frame reads or writes, in the order of the
    graph's static buffers."""
    return [pipe.packed, *pipe.vmap_state, *pipe.noise, *pipe.pool,
            *pipe.ring]


@pytest.mark.cuda
def test_fused_replays_equal_eager_device_loop_frames():
    """Two replays of the captured LIVO frame give bit for bit what two
    eager device-loop frames (`_fused_frame` called directly) give from the
    same state and inputs. Deterministic algorithms are on, so that the
    float scatter-adds of the downsample and the map insert sum in one
    order in both."""
    _need_card()
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    cfg, seq = _small_livo(fused_frame=True)
    was = torch.are_deterministic_algorithms_enabled()
    # cuBLAS's deterministic workspace setting, which the mode asks for
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        graph = LIVOPipeline(cfg, "livo", device="cuda")
        eager = LIVOPipeline(cfg, "livo", device="cuda")
        eager._frame_graphs = None  # the same frame function, no graph
        for p in (graph, eager):
            p.push_sequence(seq)
            # the IMU init, the map-building frame, the warm-up + capture
            while p.frame_id < 2:
                p.poll(max_frames=1, flush=True)
        assert len(graph._frame_graphs.graphs) == 1
        for a, b in zip(_state_tensors(graph), _state_tensors(eager)):
            assert torch.equal(a, b)
        for _ in range(2):
            assert graph.poll(max_frames=1, flush=True) == 1
            assert eager.poll(max_frames=1, flush=True) == 1
            for a, b in zip(_state_tensors(graph), _state_tensors(eager)):
                assert torch.equal(a, b)
        assert graph.photo_iterations.item() == eager.photo_iterations.item()
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.cuda
def test_fused_replays_through_a_map_slide_on_the_q16_wire():
    """Every frame of a fused run equal, bit for bit, to the eager
    device-loop frames, with the int16 points wire (its own static
    input shape) and map sliding on: the slide replaces the map between
    frames, and the next replay must read it from the graph's static
    buffers, which keep their addresses."""
    _need_card()
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    # 2.6 s: the slide check at frame 20 reads the position of frame 10
    cfg, seq = _small_livo(2.6, fused_frame=True, wire_q16=True)
    cfg.local_map.map_sliding_en = True
    cfg.local_map.sliding_thresh = 0.05
    cfg.local_map.half_map_size = 10
    was = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        graph = LIVOPipeline(cfg, "livo", device="cuda")
        eager = LIVOPipeline(cfg, "livo", device="cuda")
        eager._frame_graphs = None
        for p in (graph, eager):
            p.push_sequence(seq)
        static = None
        while graph._img_queue:
            n = graph.poll(max_frames=1, flush=True)
            assert eager.poll(max_frames=1, flush=True) == n
            for a, b in zip(_state_tensors(graph), _state_tensors(eager)):
                assert torch.equal(a, b)
            if not graph._frame_graphs.graphs:
                continue
            buffers = [t.data_ptr()
                       for t in graph._frame_graphs.static_tensors()]
            assert static is None or buffers == static
            static = buffers
            ptrs = [t.data_ptr() for t in _state_tensors(graph)]
            if (graph.frame_id - 1) % 10:  # no slide after this replay
                assert ptrs == static
            else:  # a slide may have replaced the map: the next replay
                assert ptrs[0] == static[0]  # copies it into the buffers
        assert graph.frame_id > 20 and np.any(graph._last_slide_pos != 0)
        assert len(graph._frame_graphs.graphs) == 1
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.cuda
def test_fused_run_keeps_distinct_outputs():
    """A replay overwrites its outputs and the state is written back in
    place: the trajectory, the state traces, the cloud chunks and the
    diagnostics of a 5-frame fused run are each their own tensors with
    their own values."""
    _need_card()
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    cfg, seq = _small_livo(fused_frame=True)
    cfg.pcd_save.pcd_save_en = True
    cfg.evo.pose_output_en = True
    cfg.publish.pub_effect_point_en = True
    pipe = LIVOPipeline(cfg, "livo", device="cuda")
    pipe.push_sequence(seq)
    while len(pipe.trajectory) < 5:
        assert pipe.poll(max_frames=1, flush=True) == 1
    assert len(pipe._frame_graphs.graphs) == 1
    kept = {
        "trajectory": [v for _, v in pipe.trajectory],
        "trace_pre": [v for _, v in pipe.trace_pre],
        "trace_post": [v for _, v in pipe.trace_post],
        "cloud": [c[0] for c in pipe._cloud_chunks],
        "cloud_keep": [c[2] for c in pipe._cloud_chunks],
        "cloud_sensor": [c[3] for c in pipe._cloud_chunks],
        "effect": [pg.pts_w for _, pg in pipe._effect_chunks],
        "diag": [r["diag"] for r in pipe.log.rows],
        "vdiag": [r["vdiag"] for r in pipe.log.rows if "vdiag" in r],
    }
    state = {t.data_ptr() for t in _state_tensors(pipe)}
    for name, ts in kept.items():
        assert len(ts) >= 3, name
        ptrs = [t.data_ptr() for t in ts]
        assert len(set(ptrs)) == len(ptrs), f"{name}: shared storage"
        assert not state & set(ptrs), f"{name}: aliases the static state"
        if name != "cloud_keep":
            for a, b in zip(ts, ts[1:]):
                assert not torch.equal(a, b), f"{name}: equal consecutive values"
    # the trajectory's last entry is the state the last replay wrote
    assert torch.equal(kept["trajectory"][-1], pipe.packed)


@pytest.mark.cuda
def test_fused_frame_with_raycast_and_ic_makes_no_host_sync():
    """A replayed fused LIVO frame with vio.raycast_en and
    vio.inverse_composition_en reads nothing on the host (the IC loop
    masked, lookup_or_insert's 8 probe rounds static), under the sync
    debug mode's "error"; the graph key carries the raycast rows."""
    _need_card()
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    cfg, seq = _small_livo(fused_frame=True)
    cfg.vio.raycast_en = cfg.vio.inverse_composition_en = True
    pipe = LIVOPipeline(cfg, "livo", device="cuda")
    pipe.push_sequence(seq)
    while not (pipe._frame_graphs.graphs and pipe.frame_id > 3):
        pipe.poll(max_frames=1, flush=True)
    assert list(pipe._frame_graphs.graphs) == [(True, True, True)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            assert pipe.poll(max_frames=1, flush=True) == 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pipe._finalize_host_views()
    assert all(np.isfinite(p).all() for _, _, p in pipe.trajectory)


def _card_window(K=8, N=1500, seed=0):
    """A K-keyframe window of three 10 x 10 m planes with 2 cm pose noise,
    and zero-motion IMU links, on the card."""
    from fast_livo2_tpu_torch.parallel import ba

    rng = np.random.default_rng(seed)
    planes = []
    for axis, off in ((2, -1.0), (0, 6.0), (1, 6.0)):
        pts = rng.uniform(-5, 5, size=(N // 3, 3))
        pts[:, axis] = off
        planes.append(pts)
    world = np.concatenate(planes)
    pos = np.array([[0.2 * k, 0.0, 0.0] for k in range(K)])
    scans = np.stack([world - p for p in pos]).astype(np.float32)
    noisy = (pos + rng.normal(size=pos.shape) * 0.02).astype(np.float32)
    dev = "cuda"
    window = ba.Window(
        rot=torch.eye(3, device=dev).expand(K, 3, 3).contiguous(),
        pos=torch.from_numpy(noisy).to(dev),
        scans=torch.from_numpy(scans).to(dev),
        valid=torch.ones(K, scans.shape[1], dtype=torch.bool, device=dev))
    links = ba.ImuLinks(
        dR=torch.eye(3, device=dev).expand(K, 3, 3).contiguous(),
        dp=torch.from_numpy(np.diff(pos, axis=0, append=pos[-1:])
                            .astype(np.float32)).to(dev),
        dt=torch.full((K,), 0.5, device=dev),
        vel=torch.zeros(K, 3, device=dev), grav=torch.zeros(3, device=dev),
        valid=torch.arange(K, device=dev) < K - 1)
    return window, links


@pytest.mark.cuda
def test_refiner_graph_matches_warm_up_and_submits_without_host_sync():
    """OnlineRefiner on the card: the first submit of a variant is the
    eager warm-up on the refiner's stream (its result refine_window's),
    then the capture; a later submit of the same window replays the graph
    with no host sync (sync debug mode "error") and gives the warm-up's
    poses within the golden tolerances (the map's float scatter-adds run
    in no fixed order). Each variant has its own graph and pool."""
    _need_card()
    from fast_livo2_tpu_torch.core.voxel_map import VoxelMapConfig
    from fast_livo2_tpu_torch.parallel import ba

    cfg = VoxelMapConfig(voxel_size=0.5, n_layers=2, capacity_log2=14,
                         layer_init_num=(5, 5))
    window, links = _card_window()
    r = ba.OnlineRefiner(cfg, outer_iters=2, gn_iters=2)
    for lk in (None, links):
        eager, _ = ba.refine_window(window, cfg, outer_iters=2, gn_iters=2,
                                    imu_links=lk)
        assert r.submit(window, meta="warm", links=lk)
        _, rot_w, pos_w = r.poll(force=True)
        np.testing.assert_allclose(pos_w, eager.pos.cpu().numpy(), atol=8e-3)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            assert r.submit(window, meta="replay", links=lk)
            assert not r.submit(window, meta="refused", links=lk)
            r.poll()  # a query, never a wait
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out = r.poll(force=True)
        if out is not None:  # (the query above may have collected it)
            meta, rot_r, pos_r = out
            assert meta == "replay"
            np.testing.assert_allclose(pos_r, pos_w, atol=8e-3)
            np.testing.assert_allclose(rot_r, rot_w, atol=4e-3)
        # the refinement tightened the window (its common offset is
        # unobservable: compare with the mean offset removed)
        truth = np.stack([0.2 * np.arange(8), np.zeros(8), np.zeros(8)], -1)
        e0 = window.pos.cpu().numpy() - truth
        e1 = pos_w - truth
        assert (np.abs(e1 - e1.mean(0)).max()
                < 0.5 * np.abs(e0 - e0.mean(0)).max())
    s = r.summary()
    assert s["graphs"] == 2 and s["variants"] == [[False, False], [True, False]]
    assert all(b > 0 for b in s["pool_bytes"])
    assert len(r.device_ms) == 4 and all(ms > 0 for ms in r.device_ms)


@pytest.mark.cuda
def test_backend_delta_reaches_the_next_replay():
    """A pose delta fed back between two replays (the backend's
    `_apply_delta`, which replaces the packed state) is what the next
    replay reads: with the same 5 cm delta applied, the replayed frame
    gives bit for bit the eager device-loop frame (`_fused_frame` with no
    graph) from the shifted state, a twin replay without the delta ends
    elsewhere, and the graph keeps its static buffers. Deterministic
    algorithms are on, as in the replay-vs-eager test above."""
    _need_card()
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    cfg, seq = _small_livo(fused_frame=True)
    was = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        moved, eager, twin = (LIVOPipeline(cfg, "only_lio", device="cuda")
                              for _ in range(3))
        eager._frame_graphs = None
        for p in (moved, eager, twin):
            p.push_sequence(seq)
            while p.frame_id < 4:
                p.poll(max_frames=1, flush=True)
        static = moved._frame_graphs._state["packed"]
        assert moved.packed.data_ptr() == static.data_ptr()
        for p in (moved, eager):
            p.packed = p._apply_delta(p.packed, np.eye(3),
                                      np.array([0.05, 0.0, 0.0]))
        assert moved.packed.data_ptr() != static.data_ptr()
        for p in (moved, eager, twin):
            assert p.poll(max_frames=1, flush=True) == 1
        assert moved.packed.data_ptr() == static.data_ptr()
        for a, b in zip([moved.packed, *moved.vmap_state],
                        [eager.packed, *eager.vmap_state]):
            assert torch.equal(a, b)
        dp = (moved.packed[9:12] - twin.packed[9:12]).abs().max().item()
        assert dp > 1e-3, dp
        assert len(moved._frame_graphs.graphs) == 1
    finally:
        torch.use_deterministic_algorithms(was)


def _keyframe_capture_run(photo, trace=False, duration=2.4):
    """A fused LIVO run of `_small_livo` with the online backend on (a
    keyframe every frame, photometric factors with `photo`); each
    keyframe's capture is also made eagerly, right after the pipeline's,
    with vio.capture_photo_factors on the same state. Returns (pipeline,
    [(capture graphs before the keyframe, the pipeline's factors, the
    eager ones)])."""
    from fast_livo2_tpu_torch.core import vio as vio_mod
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
    from fast_livo2_tpu_torch.core.state import unpack_state

    cfg, seq = _small_livo(duration=duration, fused_frame=True)
    pipe = LIVOPipeline(cfg, "livo", device="cuda")
    if trace:
        pipe.enable_tracing()
    pipe.enable_online_refine(keyframe_every=1, window=4, stride=2,
                              photo=photo)
    made, orig = [], pipe._capture_photo

    def both(packed, img_dev, pg):
        n = len(pipe._frame_graphs.keyframe_captures)
        got = orig(packed, img_dev, pg)
        state, _ = unpack_state(packed)
        want = vio_mod.capture_photo_factors(
            pipe.pool, pipe.ring, img_dev.to(torch.float32), state, pg.pts_w,
            pg.valid, pipe.cam, pipe.Rci, pipe.Pci, pipe.vio_cfg)
        made.append((n, got[2:], want))
        return got

    pipe._capture_photo = both
    pipe.push_sequence(seq)
    while pipe.poll(max_frames=1, flush=True):
        pass
    torch.cuda.synchronize()
    return pipe, made


@pytest.mark.cuda
def test_keyframe_capture_graph_equals_eager_capture():
    """With the photometric backend on fused frames, the keyframe's
    photometric capture is captured once, as a graph of its own, and
    replayed after the frame's graph on every later keyframe: over the
    replayed keyframes (three or more) its factors equal, bit for bit,
    vio.capture_photo_factors called eagerly on the same state; the
    traced pipeline's summary counts the capture's kernel nodes, and its
    tracer holds a `keyframe_capture` host span a keyframe."""
    _need_card()
    pipe, made = _keyframe_capture_run(photo=True, trace=True)
    replays = [m for m in made if m[0] == 1]
    assert len(replays) >= 3 and made[0][0] == 0
    for _, got, want in made:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert any(bool(w[2].any()) for _, _, w in replays)  # factors were valid
    s = pipe._frame_graphs.summary()
    kc = s["keyframe_capture"]
    assert kc["graphs"] == 1 and s["graphs"] == 1
    assert kc["kernel_nodes"][0] > 100, kc
    n_kf = sum(n == "keyframe_capture" for _, n, *_ in pipe.tracing.spans)
    assert n_kf == len(made)
    assert pipe.refine_submits >= 2
    pipe._consume_refine(force=True)
    r = pipe._refiner
    assert len(r.device_ms) >= 1 and r.summary()["photo_unused_slots"] >= 0


@pytest.mark.cuda
def test_fused_backend_without_photo_captures_no_keyframe_graph():
    """A fused LIVO run with the online backend but no photometric
    factors replays only the frame graph: no keyframe capture graph."""
    _need_card()
    pipe, made = _keyframe_capture_run(photo=False, duration=1.6)
    assert not made and pipe.refine_submits >= 1
    s = pipe._frame_graphs.summary()
    assert s["graphs"] == 1 and s["keyframe_capture"]["graphs"] == 0
    assert pipe._refiner.summary()["photo_unused_slots"] is None


@pytest.mark.cuda
def test_fused_capture_with_a_host_read_raises():
    """A host read inside the frame cannot be captured: the pipeline
    raises, naming the line, and does not run the frame eagerly
    instead. (Last in the file: a failed capture may leave the device's
    capture state unusable for the rest of the process.)"""
    _need_card()
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    cfg, seq = _small_livo(fused_frame=True)
    pipe = LIVOPipeline(cfg, "only_lio", device="cuda")
    pipe.push_sequence(seq)
    while pipe.frame_id < 1:  # the IMU init and the map-building frame
        pipe.poll(max_frames=1, flush=True)
    stage_lio = pipe._stage_lio

    def with_host_read(*args, **kwargs):
        out = stage_lio(*args, **kwargs)
        float(out[1][0])  # a device-to-host read
        return out

    pipe._stage_lio = with_host_read
    frames = len(pipe.trajectory)
    with pytest.raises(RuntimeError, match="capture.*float\\(out"):
        pipe.poll(max_frames=1, flush=True)
    assert len(pipe.trajectory) == frames
    assert not pipe._frame_graphs.graphs


def _plane_pts(rng, n, normal, d, extent=4.0):
    normal = np.asarray(normal, np.float64)
    a = np.array([1.0, 0, 0]) if abs(normal[0]) < 0.9 else np.array([0, 1.0, 0])
    b1 = np.cross(normal, a)
    b1 /= np.linalg.norm(b1)
    b2 = np.cross(normal, b1)
    uv = rng.uniform(-extent, extent, size=(n, 2))
    return (-d * normal + uv[:, :1] * b1 + uv[:, 1:] * b2
            + rng.normal(size=(n, 3)) * 0.004).astype(np.float32)


@pytest.mark.cuda
def test_sharded_map_replicas_bitwise_equal_on_one_card(tmp_path):
    """2 gloo ranks on cuda:0 (tests/test_torch_dist_worker.py): a map
    write from sharded points, then ten in a row, leave both ranks' keys,
    stats and rec bit for bit equal (update_map(mesh=) inserts under
    deterministic algorithms), and equal to one process's updates under
    the same mode; the measurement-sharded LIO update returns the same
    bits on both ranks, within 1e-5 of one process's."""
    _need_card()
    import importlib.util

    from fast_livo2_tpu_torch.parallel import sharding as shd

    # by path: another installed package may own the name `tests`
    spec = importlib.util.spec_from_file_location(
        "test_torch_dist_worker", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "test_torch_dist_worker.py"))
    W = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(W)

    rng = np.random.default_rng(0)
    data = {"lio/scene": np.concatenate([
        _plane_pts(rng, 4000, [0, 0, 1], 1.0), _plane_pts(rng, 4000, [1, 0, 0], -5.0),
        _plane_pts(rng, 4000, [0, 1, 0], -5.0)]),
        "lio/body": np.concatenate([_plane_pts(rng, 512, [0, 0, 1], 1.0),
                                    _plane_pts(rng, 512, [1, 0, 0], -5.0)]),
        "map/pts": rng.uniform(-4, 4, (1024, 3)).astype(np.float32)}
    frames = np.stack([np.concatenate([
        _plane_pts(rng, 512, [0, 0, 1], 1.0), _plane_pts(rng, 512, [1, 0, 0], -5.0)])
        for _ in range(W.MAP_FRAMES)])
    data["map/frames"] = frames
    data["map/frames_valid"] = rng.uniform(size=frames.shape[:2]) > 0.1
    var6 = np.zeros(frames.shape[:2] + (6,), np.float32)
    var6[..., [0, 3, 5]] = rng.uniform(1e-5, 1e-3, frames.shape[:2] + (3,))
    data["map/frames_var6"] = var6
    np.savez(tmp_path / "inputs.npz", **data)
    ranks = W.launch(tmp_path, 2, tmp_path / "inputs.npz", device="cuda",
                     cases=("map_update", "lio"))
    for k in ranks[0]:
        if k.startswith(("map_update/", "lio/")):
            np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
    with shd.deterministic(torch.device("cuda")):
        one = W.case_map_update(data, None, torch.device("cuda"))
    for k, v in one.items():
        np.testing.assert_array_equal(ranks[0][f"map_update/{k}"], v, err_msg=k)
    lio = W.case_lio(data, None, torch.device("cuda"))
    for k in ("split_packed", "loop_packed", "cap_packed"):
        np.testing.assert_allclose(ranks[0][f"lio/{k}"], lio[k], atol=1e-5)


def _deterministic():
    """torch's deterministic algorithms (the downsample's and the map's
    float scatter-adds in one order), restored by the returned callable."""
    was = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    return lambda: torch.use_deterministic_algorithms(was)


@pytest.mark.cuda
def test_fused_ring_wraps_like_split():
    """A fused LIVO run with an 8-frame ring and a 2,048-point pool over
    30 frames: the ring slot and the frame id a replay writes come from
    the frame-id buffer, not from the capture, so after every wrap the
    ring's ids equal the split run's, as do the pool's cursor and rows
    (deterministic algorithms); a replayed frame makes no host sync."""
    _need_card()
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    restore = _deterministic()
    try:
        pipes = {}
        for fused in (False, True):
            cfg, seq = _small_livo(3.2, fused_frame=fused, frame_ring=8,
                                   vis_point_capacity=2048)
            pipes[fused] = LIVOPipeline(cfg, "livo", device="cuda")
            pipes[fused].push_sequence(seq)
        split, fused = pipes[False], pipes[True]
        wraps = 0
        while fused._img_queue:
            replay = bool(fused._frame_graphs.graphs)
            if replay:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                n = fused.poll(max_frames=1, flush=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert split.poll(max_frames=1, flush=True) == n
            assert torch.equal(fused.ring.ids, split.ring.ids)
            if fused.frame_id % 8 == 1 and fused.frame_id > 8:
                wraps += 1  # this frame wrote slot 0 again
                assert int(fused.ring.ids[0]) == fused.frame_id - 1
            for a, b in zip(fused.pool, split.pool):
                assert torch.equal(a, b)
        assert fused.frame_id >= 24 and wraps >= 2
        assert list(fused._frame_graphs.graphs) == [(True, True, False)]
    finally:
        restore()


@pytest.mark.cuda
def test_fused_only_lio_slides_bit_for_bit_split():
    """The soak's ONLY_LIO configuration (map sliding at 1 m) over 5 s:
    at least three slides replace the map between replays, and the fused
    run is bit for bit its split run frame by frame (deterministic
    algorithms), with no host sync in any replayed frame, the slide
    frames included (the slide decision reads a pinned copy queued ten
    frames earlier; the first slide's constants upload without blocking,
    and this is the process's first slide of a 30-voxel half map)."""
    _need_card()
    from fast_livo2_tpu_torch import soak
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    seq = soak.soak_sequence(5.0, "only_lio", soak.soak_config())
    restore = _deterministic()
    try:
        split = LIVOPipeline(soak.soak_config(), "only_lio", device="cuda")
        fused = LIVOPipeline(soak.soak_config(fused=True), "only_lio",
                             device="cuda")
        for p in (split, fused):
            p.push_sequence(seq)
        while fused._scan_events:
            if fused._frame_graphs.graphs:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                n = fused.poll(max_frames=1, flush=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert split.poll(max_frames=1, flush=True) == n
            for a, b in zip((fused.packed, *fused.vmap_state),
                            (split.packed, *split.vmap_state)):
                assert torch.equal(a, b)
        assert fused.map_slides == split.map_slides >= 3
        assert len(fused._frame_graphs.graphs) == 1
    finally:
        restore()


@pytest.mark.cuda
def test_fused_pipeline_is_freed_without_gc():
    """A fused pipeline with map sliding (it holds a pinned host copy of
    its position) is freed by reference counting when dropped, its graphs
    with it: a garbage collection that freed it later could run inside
    another stream's CUDA graph capture, where freeing pinned memory
    records events that invalidate the capture."""
    _need_card()
    import gc
    import weakref

    from fast_livo2_tpu_torch import soak
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    cfg = soak.soak_config(fused=True)
    pipe = LIVOPipeline(cfg, "only_lio", device="cuda")
    pipe.process(soak.soak_sequence(2.1, "only_lio", cfg))
    assert pipe._frame_graphs.graphs and pipe._pos_snapshot is not None
    ref = weakref.ref(pipe)
    enabled = gc.isenabled()
    gc.disable()
    try:
        del pipe
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["map_insert", "downsample", "tsdf"])
def test_ordered_add_kernel_matches_cpu_index_add_bitwise(name):
    """ordered_add against the CPU's index_add_ at each call site's shape
    (chip_smoke.ORDERED_ADD_SHAPES): bit for bit on every row but the
    sink, which the kernel leaves as it was; two calls the same bits."""
    _need_card()
    import chip_smoke

    base, dst, src, sink = chip_smoke.ordered_add_case(name)
    want = torch.from_numpy(base.copy()).index_add_(
        0, torch.from_numpy(dst), torch.from_numpy(src))
    b, d, s = (torch.from_numpy(a).cuda() for a in (base, dst, src))
    before = ordered_add.LAUNCHES
    got = [ordered_add.ordered_index_add_(b.clone(), d, s, drop=sink,
                                          dst_sorted=name == "downsample")
           for _ in range(2)]
    torch.cuda.synchronize()
    assert ordered_add.LAUNCHES == before + 2
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0][:sink].cpu(), want[:sink])
    assert torch.equal(got[0][sink].cpu(), torch.from_numpy(base[sink]))


@pytest.mark.cuda
@pytest.mark.parametrize("n,W,R", [(0, 4, 8), (1, 1, 3), (5000, 7, 33),
                                   (70000, 2, 70001)])
def test_ordered_add_kernel_without_sink(n, W, R):
    """No sink (drop=None): every row summed, the CPU's bits; no lane, one
    lane, an odd width, more lanes than rows and a grid of many blocks."""
    _need_card()
    rng = np.random.default_rng(n)
    base = torch.from_numpy(rng.normal(size=(R, W)).astype(np.float32))
    dst = torch.from_numpy(rng.integers(0, R, n))
    src = torch.from_numpy(rng.normal(size=(n, W)).astype(np.float32))
    want = base.clone().index_add_(0, dst, src)
    got = ordered_add.ordered_index_add_(base.cuda(), dst.cuda(), src.cuda())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_ordered_add_wrapper_rejects_bad_input():
    """A wrong dtype, a non-contiguous tensor or a dst on another device
    raises; nothing launches and nothing falls back to index_add_."""
    _need_card()
    base = torch.zeros((16, 4), device="cuda")
    dst = torch.zeros(8, dtype=torch.int64, device="cuda")
    src = torch.ones((8, 4), device="cuda")
    before = ordered_add.LAUNCHES
    with pytest.raises(TypeError):
        ordered_add.ordered_index_add_(base.double(), dst, src.double())
    with pytest.raises(TypeError):
        ordered_add.ordered_index_add_(base, dst.int(), src)
    with pytest.raises(ValueError):
        ordered_add.ordered_index_add_(torch.zeros((4, 16), device="cuda").t(),
                                       dst, src)
    with pytest.raises(ValueError):
        ordered_add.ordered_index_add_(base, dst.cpu(), src)
    with pytest.raises(ValueError):
        ordered_add.ordered_index_add_(base, dst, src[:, :3])
    assert ordered_add.LAUNCHES == before
    assert not bool(base.any())


def _read_state(pipe):
    """The state a frame reads: _state_tensors without the pool's sink
    row."""
    return [pipe.packed, *pipe.vmap_state, *pipe.noise,
            *(t[:-1] for t in pipe.pool[:3]), pipe.pool.alloc, *pipe.ring]


@pytest.mark.cuda
def test_default_mode_fused_livo_runs_repeat_bitwise():
    """Two fused LIVO runs of the core scene in the default mode (no
    deterministic algorithms): every frame's state bit for bit the same,
    as the float scatter-adds sum in lane order; each run one capture, 0
    host syncs in a replay, and ordered_add launched once a site a
    replay (the downsample and the compacted insert's layer-0 and
    descending writes where the insert descends, else one). The visual
    pool's sink row is left out: the pool write sends every dropped row
    there, duplicates in any order, and nothing reads it (core/vio.py)."""
    _need_card()
    import chip_smoke
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    assert not torch.are_deterministic_algorithms_enabled()
    cfg, seq = _small_livo(3.2, fused_frame=True)
    pipes = [LIVOPipeline(cfg, "livo", device="cuda") for _ in range(2)]
    for p in pipes:
        p.push_sequence(seq)
    sites = chip_smoke.ordered_add_sites(pipes[0])
    while pipes[0]._img_queue:
        replay = bool(pipes[0]._frame_graphs.graphs)
        for p in pipes:
            if replay:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                n = p.poll(max_frames=1, flush=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert n == 1
        for i, (a, b) in enumerate(zip(_read_state(pipes[0]),
                                       _read_state(pipes[1]), strict=True)):
            assert torch.equal(a, b), (pipes[0].frame_id, i)
    for p in pipes:
        s = p._frame_graphs.summary()
        assert s["graphs"] == 1
        assert s["launches_per_replay"][0]["ordered_add"] == sites
    assert pipes[0].frame_id >= 24
    for p in pipes:
        p._finalize_host_views()
    for (ta, Ra, pa), (tb, Rb, pb) in zip(pipes[0].trajectory,
                                          pipes[1].trajectory, strict=True):
        assert ta == tb and np.array_equal(Ra, Rb) and np.array_equal(pa, pb)

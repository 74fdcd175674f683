"""Tests of the port that need an NVIDIA GPU and nvcc (marker `cuda`).

Without a card each test skips itself; the check runs inside the test,
never at import. This file imports nothing of JAX, so on a machine with
a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fast_livo2_tpu_torch.ops import _launch
from fast_livo2_tpu_torch.ops import cov_scan
from fast_livo2_tpu_torch.ops import gather
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


@pytest.mark.cuda
@pytest.mark.parametrize("K,D", [(64, 19), (1, 19), (64, 32), (7, 5)])
def test_cov_scan_kernel_matches_plain(K, D):
    """The hand-written kernel against its plain version on the card, at
    the main path's K = 64, D = 19 and at the edges it accepts."""
    _need_card()
    F, Q, P0 = (torch.from_numpy(a).cuda() for a in _cov_inputs(K, D))
    before = cov_scan.LAUNCHES
    got = cov_scan.propagate_cov(F, Q, P0)
    torch.cuda.synchronize()
    assert cov_scan.LAUNCHES == before + 1
    want = cov_scan.propagate_cov_plain(F, Q, P0)
    torch.testing.assert_close(got, want, rtol=RTOL_COV, atol=ATOL_COV)


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


@pytest.mark.cuda
def test_livo_on_card_matches_cpu():
    """A short LIVO run on "cuda" (both kernels) against "cpu" (plain
    versions), at the golden tolerances, and K2 launched once per
    photometric iteration."""
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
    before = photo.LAUNCHES
    pipe = LIVOPipeline(cfg, "livo", device="cuda")
    gpu = pipe.process(seq)
    assert photo.LAUNCHES - before == pipe.photo_iterations > 0
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

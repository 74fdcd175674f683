"""The port's streaming ingestion (push/poll) and IMU-rate odometry on the
CPU: tests/test_streaming.py's cases on fast_livo2_tpu_torch, with their
gates unchanged. Packets fed incrementally reproduce the offline replay,
events wait for their input streams, poses are pollable at IMU rate
between two frame updates, corrupt and oversized inputs are dropped and
counted, the IMU buffer is trimmed, camera frames stay on the host
beyond a bounded window, a late scan leaves the cursor monotonic and an
oversized packet is decimated evenly. Each case compares the port with
itself, as the JAX test compares the JAX package with itself.

test_streaming.py's two checkpoint cases (mid-stream resume, resume with
a prefetch in flight) are held bit for bit, a stricter gate, in
tests/test_torch_checkpoint.py, and its backend-keyframe case in
tests/test_torch_backend.py.
"""

import copy

import numpy as np
import pytest

from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import synthetic
from fast_livo2_tpu_torch.models import camera as cam_mod
from fast_livo2_tpu_torch.utils.config import CameraConfig
from tests.test_torch_pipeline import one_torch_thread, small_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(
        duration=2.5, lidar_hz=10.0, imu_hz=200.0, seed=0,
        n_lines=12, n_per_line=500, render=False, fov_deg=360.0,
    )


@pytest.fixture(scope="module")
def offline(seq):
    """One offline replay of `seq` (ONLY_LIO), shared by the cases that
    compare against it."""
    ref = LIVOPipeline(small_config(), slam_mode="only_lio", device="cpu")
    return ref.process(seq)


def _pipe(cfg=None, mode="only_lio"):
    return LIVOPipeline(cfg or small_config(), slam_mode=mode, device="cpu")


def _stream(pipe, seq, chunk_s=0.3):
    """Feed the sequence in wall-clock chunks, polling after each."""
    t_max = max(seq.imu_stamps[-1],
                max(t + (o[-1] if len(o) else 0) for t, _, o in seq.scans))
    t = 0.0
    si = ii = 0
    frames = 0
    while t < t_max + chunk_s:
        t += chunk_s
        while si < len(seq.scans) and seq.scans[si][0] + (
                seq.scans[si][2][-1] if len(seq.scans[si][2]) else 0) <= t:
            tb, pts, offs = seq.scans[si]
            pipe.push_scan(tb, pts, offs)
            si += 1
        j = np.searchsorted(seq.imu_stamps, t)
        if j > ii:
            pipe.push_imu(seq.imu_stamps[ii:j], seq.imu_gyr[ii:j],
                          seq.imu_acc[ii:j])
            ii = j
        frames += pipe.poll()
    frames += pipe.poll(flush=True)
    return frames


def test_streaming_matches_offline_replay(seq, offline):
    pipe = _pipe()
    n = _stream(pipe, seq)
    pipe._finalize_host_views()
    traj = pipe.trajectory

    assert n == len(traj) == len(offline)
    for (t0, R0, p0), (t1, R1, p1) in zip(offline, traj):
        assert t0 == t1
        np.testing.assert_allclose(p0, p1, atol=1e-5)
        np.testing.assert_allclose(R0, R1, atol=1e-5)


def test_poll_waits_for_imu_coverage(seq, offline):
    """An event must not fire until IMU samples extend past its cut time
    (the sync_packages wait condition)."""
    pipe = _pipe()
    for tb, pts, offs in seq.scans:
        pipe.push_scan(tb, pts, offs)
    # IMU only up to 1.0 s: events beyond must wait
    m = seq.imu_stamps <= 1.0
    pipe.push_imu(seq.imu_stamps[m], seq.imu_gyr[m], seq.imu_acc[m])
    n1 = pipe.poll()
    events_left = len(pipe._scan_events)
    assert events_left > 0  # tail still queued
    pipe.push_imu(seq.imu_stamps[~m], seq.imu_gyr[~m], seq.imu_acc[~m])
    n2 = pipe.poll()
    assert n2 > 0
    assert n1 + n2 == len(offline)


def test_imu_rate_poses_between_updates(seq):
    """Pull IMU-rate poses between two frame updates: they start at the
    last posterior, advance at the IMU period, and stay near ground
    truth over the short horizon."""
    pipe = _pipe()
    for tb, pts, offs in seq.scans:
        pipe.push_scan(tb, pts, offs)
    pipe.push_imu(seq.imu_stamps, seq.imu_gyr, seq.imu_acc)
    pipe.poll(max_frames=8)
    t_last = pipe.last_update_time
    assert pipe.frame_id >= 5

    out = pipe.imu_rate_poses(t_until=t_last + 0.1)  # one frame gap
    assert len(out) >= 15  # ~200 Hz over 100 ms
    ts = np.array([t for t, _, _, _ in out])
    assert (np.diff(ts) > 0).all() and ts[0] > t_last and ts[-1] <= t_last + 0.1
    np.testing.assert_allclose(np.median(np.diff(ts)), 1 / 200.0, rtol=0.2)
    gt_t = np.array([g[0] for g in seq.gt])
    gt_p = np.array([g[2] for g in seq.gt])
    for t, R, p, v in out:
        i = np.clip(np.searchsorted(gt_t, t), 1, len(gt_t) - 1)
        w = (t - gt_t[i - 1]) / (gt_t[i] - gt_t[i - 1])
        p_gt = gt_p[i - 1] * (1 - w) + gt_p[i] * w
        assert np.linalg.norm(p - p_gt) < 0.05


def test_streaming_livo_with_images_matches_offline():
    """LIVO-mode streaming: images + scans + IMU pushed in time order,
    image events held until LiDAR covers the capture time, trajectory
    matches the offline replay."""
    cam_cfg = CameraConfig(cam_model="Pinhole", cam_width=320,
                           cam_height=256, scale=1.0, cam_fx=200.0,
                           cam_fy=200.0, cam_cx=160.0, cam_cy=128.0)
    cam = cam_mod.make_camera(cam_cfg)
    lseq = synthetic.make_sequence(
        duration=2.0, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0, cam=cam,
        seed=3, n_lines=12, n_per_line=500, render=True, fov_deg=360.0,
    )
    cfg = small_config()
    cfg.camera = cam_cfg
    cfg.extrin_calib.Rcl = list(synthetic.R_CI_FORWARD.reshape(-1))
    cfg.extrin_calib.Pcl = [0.0, 0.0, 0.0]
    cfg.tpu.vis_point_capacity = 8192
    cfg.tpu.frame_ring = 32
    cfg.vio.patch_pyrimid_level = 3

    traj_ref = _pipe(cfg, "livo").process(lseq)

    pipe = _pipe(copy.deepcopy(cfg), "livo")
    events = (
        [("scan", s[0] + (s[2][-1] if len(s[2]) else 0), s) for s in lseq.scans]
        + [("img", t, (t, im)) for t, im in lseq.images]
        + [("imu", t, i) for i, t in enumerate(lseq.imu_stamps)]
    )
    events.sort(key=lambda e: e[1])
    n = 0
    for kind, _, payload in events:
        if kind == "scan":
            pipe.push_scan(payload[0], payload[1], payload[2])
        elif kind == "img":
            pipe.push_image(*payload)
        else:
            i = payload
            pipe.push_imu(lseq.imu_stamps[i:i + 1], lseq.imu_gyr[i:i + 1],
                          lseq.imu_acc[i:i + 1])
        n += pipe.poll()
    n += pipe.poll(flush=True)
    pipe._finalize_host_views()

    assert n == len(pipe.trajectory) == len(traj_ref)
    for (t0, R0, p0), (t1, R1, p1) in zip(traj_ref, pipe.trajectory):
        assert t0 == t1
        np.testing.assert_allclose(p0, p1, atol=1e-5)


def test_corrupt_inputs_dropped_and_counted(seq):
    """NaN sensor rows, IMU loop-backs, and oversized scans are rejected
    at ingestion (counted in dropped_inputs) and the pipeline still
    tracks."""
    pipe = _pipe()
    for i, (tb, pts, offs) in enumerate(seq.scans):
        if i == 3:
            bad = pts.copy()
            bad[::7] = np.nan
            pipe.push_scan(tb, np.concatenate([bad, pts]),
                           np.concatenate([offs, offs]))
        else:
            pipe.push_scan(tb, pts, offs)
    pipe.push_imu(seq.imu_stamps, seq.imu_gyr, seq.imu_acc)
    pipe.push_imu(seq.imu_stamps[:5], seq.imu_gyr[:5], seq.imu_acc[:5])  # loop-back
    pipe.push_imu(np.array([seq.imu_stamps[-1] + 0.005]),
                  np.full((1, 3), np.nan), np.zeros((1, 3)))  # NaN row
    n = pipe.poll(flush=True)
    pipe._finalize_host_views()
    assert n >= 15
    assert pipe.dropped_inputs["lidar_nan"] > 0
    assert pipe.dropped_inputs["imu"] == 6
    p = np.array([p for _, _, p in pipe.trajectory])
    assert np.isfinite(p).all()
    est = [(t, p) for t, _, p in pipe.trajectory]
    assert synthetic.ate_rmse(est, seq.gt) < 0.06


def test_oversized_scan_truncated():
    pipe = _pipe()
    cap = 4 * pipe.cfg.tpu.max_points_per_scan
    big = np.random.default_rng(0).uniform(-5, 5, (cap + 100, 3)).astype(np.float32)
    offs = np.linspace(0, 0.1, cap + 100).astype(np.float32)
    pipe.push_scan(0.0, big, offs)
    assert pipe.dropped_inputs["lidar_oversize"] == 100
    assert len(pipe.pending[0][0]) == cap


def test_imu_rate_trajectory_via_config(seq):
    """uav/imu_rate_odom=true fills imu_rate_trajectory during process()
    with poses strictly between frame updates."""
    cfg = small_config()
    cfg.uav.imu_rate_odom = True
    pipe = _pipe(cfg)
    traj = pipe.process(seq)
    assert len(pipe.imu_rate_trajectory) > 5 * len(traj)
    ts = np.array([t for t, _, _ in pipe.imu_rate_trajectory])
    assert (np.diff(ts) > 0).all()


def test_imu_buffer_trimmed(seq):
    """Consumed IMU samples are dropped as frames run (the reference pops
    its imu deque as packets are consumed)."""
    pipe = _pipe()
    pipe.process(seq)
    # 2.5 s at 200 Hz = ~500 pushed; only the post-last-event tail (+2
    # interval-start samples) may remain.
    assert len(pipe._imu_t) < 30
    assert len(pipe._imu_gyr) == len(pipe._imu_t) == len(pipe._imu_acc)


def test_push_image_rejected_in_lidar_only_modes(seq):
    """push_image into 'only_lio'/'only_lo' is dropped and counted; it
    must NOT flip the pipeline to image-driven events (those modes cut at
    scan ends)."""
    pipe = _pipe()
    img = np.zeros((8, 8), np.uint8)
    pipe.push_image(0.5, img)
    pipe.push_image(0.6, img)
    assert pipe.dropped_inputs["image_mode"] == 2
    assert not pipe._use_images and not pipe._img_queue
    for tb, pts, offs in seq.scans[:5]:
        pipe.push_scan(tb, pts, offs)
    pipe.push_imu(seq.imu_stamps, seq.imu_gyr, seq.imu_acc)
    assert pipe.poll() > 0  # scan-end events still fire


def test_images_queue_host_resident():
    """Queued camera frames stay on the host beyond a bounded device
    window (shipping every image at push would park the whole sequence in
    device memory)."""
    cfg = small_config()
    cfg.camera = CameraConfig(cam_model="Pinhole", cam_width=64,
                              cam_height=48, scale=1.0, cam_fx=40.0,
                              cam_fy=40.0, cam_cx=32.0, cam_cy=24.0)
    pipe = _pipe(cfg, "livo")
    img = np.zeros((48, 64), np.uint8)
    for i in range(10):
        pipe.push_image(0.1 * (i + 1), img)
    assert len(pipe._img_queue) == 10
    n_dev = sum(not isinstance(im, np.ndarray)
                for _, im in pipe._img_queue)
    assert 0 < n_dev <= cfg.tpu.img_upload_ahead


def test_late_scan_does_not_corrupt_cursor(seq):
    """A scan arriving AFTER later scans were already processed must not
    fire a backwards event (the sync cursor is monotonic). The late event
    is dropped + counted and timestamps stay strictly increasing; a late
    scan that is still AHEAD of the cursor is processed in order."""
    pipe = _pipe()
    scans = list(seq.scans)
    late = scans[4]
    for i, (tb, pts, offs) in enumerate(scans[:9]):
        if i != 4:
            pipe.push_scan(tb, pts, offs)
    pipe.push_imu(seq.imu_stamps, seq.imu_gyr, seq.imu_acc)
    pipe.poll()
    n_before = pipe.frame_id
    assert n_before >= 4

    pipe.push_scan(*late)  # now behind the cursor
    pipe.poll()
    assert pipe.dropped_inputs.get("stale_event", 0) == 1
    for tb, pts, offs in scans[9:12]:
        pipe.push_scan(tb, pts, offs)
    pipe.poll(flush=True)
    pipe._finalize_host_views()
    ts = [t for t, _, _ in pipe.trajectory]
    assert all(t1 > t0 for t0, t1 in zip(ts, ts[1:]))

    # not-yet-stale out-of-order push: events re-order, nothing dropped
    p2 = _pipe()
    p2.push_scan(*scans[0])
    p2.push_scan(*scans[2])
    p2.push_scan(*scans[1])  # late but ahead of the (unstarted) cursor
    assert p2._scan_events == sorted(p2._scan_events)
    p2.push_imu(seq.imu_stamps, seq.imu_gyr, seq.imu_acc)
    p2.poll(flush=True)
    p2._finalize_host_views()
    ts2 = [t for t, _, _ in p2.trajectory]
    assert all(t1 > t0 for t0, t1 in zip(ts2, ts2[1:]))
    assert p2.dropped_inputs.get("stale_event", 0) == 0


def test_packet_overflow_decimates_evenly():
    """Packet points are time-sorted, so head-truncating an oversized
    packet would keep only the sweep's first azimuth wedge. The packet
    builder must decimate EVENLY to exactly max_points_per_scan."""
    cfg = small_config()  # max_points_per_scan = 8192
    pipe = _pipe(cfg, "only_lo")
    n = 20000
    offs = np.linspace(0.0, 0.1, n, endpoint=False).astype(np.float32)
    az = offs / 0.1 * 2 * np.pi
    pts = np.stack([5 * np.cos(az), 5 * np.sin(az),
                    np.zeros_like(az)], axis=-1).astype(np.float32)
    pipe.push_scan(0.0, pts, offs)
    pipe.last_update_time = 0.0
    _, pack = pipe._prepare_packet(0.1, pipe._imu_buf())
    pack = pack.cpu().numpy()
    cap = cfg.tpu.max_points_per_scan
    assert pack[:, 4].sum() == cap  # budget fully used
    t = pack[pack[:, 4] > 0.5, 3]
    assert t.max() > 0.095  # spans the whole sweep, not a head wedge
    hist, _ = np.histogram(t, bins=10, range=(0.0, 0.1))
    assert hist.min() > 0.8 * cap / 10  # even coverage per time decile

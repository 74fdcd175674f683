"""The accuracy gates of tests/test_pipeline_lio.py on the port's pipeline
(CPU): ONLY_LIO tracks the synthetic ground truth to centimetre ATE,
matches thousands of points a frame, ONLY_LO stays bounded, and a LiDAR
dropout degrades to pure propagation. The gates are the JAX package's,
unchanged."""

import numpy as np
import pytest

from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import synthetic
from tests.test_torch_pipeline import one_torch_thread, small_config  # noqa: F401


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(
        duration=3.0, lidar_hz=10.0, imu_hz=200.0, seed=0,
        n_lines=12, n_per_line=500, render=False, fov_deg=360.0)


def test_only_lio_tracks_synthetic_groundtruth(seq):
    pipe = LIVOPipeline(small_config(), slam_mode="only_lio", device="cpu")
    traj = pipe.process(seq)
    assert len(traj) >= 20
    est = [(t, p) for t, _, p in traj]
    rmse = synthetic.ate_rmse(est, seq.gt)
    assert rmse < 0.05, f"ATE RMSE {rmse:.3f} m"
    span = np.ptp(np.array([p for _, p in est]), axis=0)
    assert span.max() > 0.5
    effs = [r["n_eff"] for r in pipe.log.rows[:5] if r["n_eff"] > 0]
    assert effs and np.mean(effs) > 300


def test_lio_effective_points_nonzero(seq):
    """tests/test_pipeline_lio.py:45: thousands of points a frame match
    a map plane in the first frames."""
    pipe = LIVOPipeline(small_config(), slam_mode="only_lio", device="cpu")
    pipe.process(seq, max_frames=5)
    effs = [r["n_eff"] for r in pipe.log.rows if r["n_eff"] > 0]
    assert effs and np.mean(effs) > 300


def test_only_lo_mode_runs():
    seq = synthetic.make_sequence(
        duration=2.0, lidar_hz=10.0, imu_hz=200.0, seed=2,
        n_lines=12, n_per_line=500, render=False, fov_deg=360.0)
    pipe = LIVOPipeline(small_config(), slam_mode="only_lo", device="cpu")
    traj = pipe.process(seq)
    assert len(traj) >= 15
    rmse = synthetic.ate_rmse([(t, p) for t, _, p in traj], seq.gt)
    assert rmse < 0.5, f"LO ATE RMSE {rmse:.3f} m"


def test_sensor_dropout_robustness():
    seq = synthetic.make_sequence(
        duration=3.0, lidar_hz=10.0, imu_hz=200.0, seed=4,
        n_lines=12, n_per_line=500, render=False, fov_deg=360.0)
    seq.scans = [(t, p, o) if not (1.5 < t < 2.0) else (t, p[:0], o[:0])
                 for t, p, o in seq.scans]
    pipe = LIVOPipeline(small_config(), slam_mode="only_lio", device="cpu")
    traj = pipe.process(seq)
    p_arr = np.array([p for _, _, p in traj])
    assert np.isfinite(p_arr).all()
    rmse = synthetic.ate_rmse([(t, p) for t, _, p in traj], seq.gt)
    assert rmse < 0.12, f"dropout ATE {rmse:.3f}"


def test_map_sliding_and_streaming_push_poll(seq):
    """Map sliding on (it evicts voxels as the walk leaves the box) and
    the streaming entry points: pushing the sequence in two halves and
    polling between them gives the trajectory of one `process` call."""
    cfg = small_config()
    cfg.local_map.map_sliding_en = True
    cfg.local_map.half_map_size = 8
    cfg.local_map.sliding_thresh = 0.2
    ref = LIVOPipeline(cfg, slam_mode="only_lio", device="cpu").process(seq)
    pipe = LIVOPipeline(cfg, slam_mode="only_lio", device="cpu")
    half = len(seq.scans) // 2
    t_cut = seq.scans[half][0]
    for t_begin, pts, offs in seq.scans[:half]:
        pipe.push_scan(t_begin, pts, offs)
    m = seq.imu_stamps <= t_cut + 0.05
    pipe.push_imu(seq.imu_stamps[m], seq.imu_gyr[m], seq.imu_acc[m])
    n_first = pipe.poll()
    for t_begin, pts, offs in seq.scans[half:]:
        pipe.push_scan(t_begin, pts, offs)
    pipe.push_imu(seq.imu_stamps[~m], seq.imu_gyr[~m], seq.imu_acc[~m])
    pipe.poll(flush=True)
    pipe._finalize_host_views()
    assert 0 < n_first < len(ref)
    assert np.linalg.norm(pipe._last_slide_pos) > 0  # the map slid
    assert [t for t, _, _ in pipe.trajectory] == [t for t, _, _ in ref]
    np.testing.assert_allclose(np.array([p for _, _, p in pipe.trajectory]),
                               np.array([p for _, _, p in ref]), atol=1e-5)
    rmse = synthetic.ate_rmse([(t, p) for t, _, p in ref], seq.gt)
    assert rmse < 0.05, f"sliding ATE RMSE {rmse:.3f} m"

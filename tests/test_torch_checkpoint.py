"""Checkpoint / resume of the port's pipeline (io/checkpoint.py) and the
carry-across of a JAX package checkpoint (io/convert.load_jax_checkpoint).

On the CPU resume is exact: a pipeline saved after k frames and loaded
into a fresh pipeline runs the rest bit for bit as the uninterrupted run
(every CPU op of the port is deterministic at one thread). That holds
with the one-ahead prefetch packet in flight, in both wire formats, mid-
stream (push/poll) and in LIVO mode (camera frames re-pushed). A JAX
checkpoint loaded into the port continues the JAX run within the golden
tolerances (8e-3 m, 4e-3): two packages, float32 in other orders.
"""

import numpy as np
import pytest

from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu.io import checkpoint as jax_checkpoint
from fast_livo2_tpu.utils.config import LIVOConfig as JaxConfig
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import checkpoint, convert, synthetic
from fast_livo2_tpu_torch.models import camera as tcam
from fast_livo2_tpu_torch.utils.config import LIVOConfig
from tests.test_torch_pipeline import one_torch_thread, small_config  # noqa: F401
from tests.test_torch_vio import livo_config

POS_TOL_M, ROT_TOL = 8e-3, 4e-3


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(
        duration=2.5, lidar_hz=10.0, imu_hz=200.0, seed=0, n_lines=12,
        n_per_line=500, render=False, fov_deg=360.0)


@pytest.fixture(scope="module")
def livo_seq():
    cam = tcam.make_camera(livo_config(LIVOConfig).camera)
    return synthetic.make_sequence(
        duration=1.4, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0, cam=cam,
        seed=0, n_lines=12, n_per_line=500, render=True, fov_deg=360.0)


def _assert_tail_exact(ref_traj, ref_pipe, n_done, pipe):
    pipe._finalize_host_views()
    tail = pipe.trajectory
    assert n_done + len(tail) == len(ref_traj)
    for (t0, R0, p0), (t1, R1, p1) in zip(ref_traj[n_done:], tail):
        assert t0 == t1
        np.testing.assert_array_equal(R1, R0)
        np.testing.assert_array_equal(p1, p0)
    assert np.array_equal(pipe.packed.numpy(), ref_pipe.packed.numpy())


def _push_all(pipe, seq):
    for tb, pts, offs in seq.scans:
        pipe.push_scan(tb, pts, offs)
    pipe.push_imu(seq.imu_stamps, seq.imu_gyr, seq.imu_acc)


@pytest.mark.parametrize("wire_q16", [False, True], ids=["f32", "q16"])
def test_resume_exact_with_prefetch_in_flight(tmp_path, seq, wire_q16):
    cfg = small_config()
    cfg.tpu.wire_q16 = wire_q16
    ref = LIVOPipeline(cfg, "only_lio", device="cpu")
    ref_traj = ref.process(seq)

    a = LIVOPipeline(cfg, "only_lio", device="cpu")
    _push_all(a, seq)
    a.poll(max_frames=8)
    assert a._prefetch is not None, "the scenario needs a prefetch in flight"
    ck = str(tmp_path / "ck.npz")
    checkpoint.save(ck, a)

    b = LIVOPipeline(cfg, "only_lio", device="cpu")
    checkpoint.load(ck, b)
    assert b._prefetch is not None and b._prefetch[0] == a._prefetch[0]
    b.poll(flush=True)
    _assert_tail_exact(ref_traj, ref, a.frame_id, b)


def test_resume_exact_mid_stream(tmp_path, seq):
    """Scans pushed, IMU only up to t_cut: the checkpoint holds the
    undelivered scans, the IMU buffer and the queued scan events."""
    cfg = small_config()
    ref = LIVOPipeline(cfg, "only_lio", device="cpu")
    ref_traj = ref.process(seq)

    a = LIVOPipeline(cfg, "only_lio", device="cpu")
    for tb, pts, offs in seq.scans:
        a.push_scan(tb, pts, offs)
    m = seq.imu_stamps <= 1.3
    a.push_imu(seq.imu_stamps[m], seq.imu_gyr[m], seq.imu_acc[m])
    a.poll()
    assert 0 < a.frame_id < len(ref_traj) and a._scan_events
    ck = str(tmp_path / "mid.npz")
    checkpoint.save(ck, a)

    b = LIVOPipeline(cfg, "only_lio", device="cpu")
    checkpoint.load(ck, b)
    assert b._scan_events == a._scan_events
    b.push_imu(seq.imu_stamps[~m], seq.imu_gyr[~m], seq.imu_acc[~m])
    b.poll(flush=True)
    _assert_tail_exact(ref_traj, ref, a.frame_id, b)


def _push_images_after(pipe, seq, t_after):
    for t, img in seq.images:
        if t + pipe.cfg.time_offset.exposure_time_init > t_after:
            pipe.push_image(t, img)


def test_resume_exact_livo(tmp_path, livo_seq):
    """LIVO: pool, ring and noise round-trip (the pool's sink row rebuilt),
    the camera frames after the cut re-pushed, the rest bit for bit."""
    cfg = livo_config(LIVOConfig)
    ref = LIVOPipeline(cfg, "livo", device="cpu")
    ref_traj = ref.process(livo_seq)

    a = LIVOPipeline(cfg, "livo", device="cpu")
    a.push_sequence(livo_seq)
    a.poll(max_frames=7, flush=True)
    assert a._prefetch is not None
    ck = str(tmp_path / "livo.npz")
    checkpoint.save(ck, a)

    b = LIVOPipeline(cfg, "livo", device="cpu")
    checkpoint.load(ck, b)
    # every loaded tensor is the saved one, bit for bit; the sink is zero
    meta, arr = checkpoint.read(ck)
    assert meta["frame_id"] == b.frame_id == a.frame_id
    for name, got in zip(("point", "obs", "obs_patch", "alloc"),
                         convert.pool_to_numpy(b.pool)):
        np.testing.assert_array_equal(got, arr[f"pool_{name}"])
    assert not b.pool.point[-1].any() and not b.pool.obs_patch[-1].any()
    for got, want in zip(convert.state_to_numpy(b.packed, b.vmap_state),
                         convert.state_to_numpy(a.packed, a.vmap_state)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(b.noise, a.noise):
        assert np.array_equal(got.numpy(), want.numpy())
    _push_images_after(b, livo_seq, b.last_update_time)
    b.poll(flush=True)
    _assert_tail_exact(ref_traj, ref, a.frame_id, b)


def test_load_rejects_foreign_and_mismatched_checkpoints(tmp_path, seq):
    a = LIVOPipeline(small_config(), "only_lio", device="cpu")
    _push_all(a, seq)
    a.poll(max_frames=3)
    ck = str(tmp_path / "ck.npz")
    checkpoint.save(ck, a)
    other = small_config()
    other.tpu.hash_capacity_log2 = 14
    with pytest.raises(ValueError, match="config changed"):
        checkpoint.load(ck, LIVOPipeline(other, "only_lio", device="cpu"))
    with pytest.raises(ValueError, match="visual pool"):
        checkpoint.load(ck, LIVOPipeline(small_config(), "livo", device="cpu"))
    with pytest.raises(ValueError, match="version"):
        convert.load_jax_checkpoint(
            ck, LIVOPipeline(small_config(), "only_lio", device="cpu"))


def _jax_run_and_checkpoint(tmp_path, seq, cfg_j, mode, k):
    """The JAX pipeline's uninterrupted run, and a JAX checkpoint after k
    frames with everything pushed (a prefetch in flight)."""
    ref = JaxPipeline(cfg_j(), slam_mode=mode)
    ref_traj = ref.process(seq)
    a = JaxPipeline(cfg_j(), slam_mode=mode)
    for tb, pts, offs in seq.scans:
        a.push_scan(tb, pts, offs)
    a.push_imu(seq.imu_stamps, seq.imu_gyr, seq.imu_acc)
    if mode == "livo":
        for t, img in seq.images:
            a.push_image(t, img)
    a.poll(max_frames=k, flush=True)
    assert a._prefetch is not None
    ck = str(tmp_path / "jax.npz")
    jax_checkpoint.save(ck, a)
    return ref_traj, a, ck


def _assert_close_tail(ref_traj, n_done, traj):
    assert n_done + len(traj) == len(ref_traj)
    assert [t for t, _, _ in traj] == [t for t, _, _ in ref_traj[n_done:]]
    np.testing.assert_allclose(np.array([p for _, _, p in traj]),
                               np.array([p for _, _, p in ref_traj[n_done:]]),
                               atol=POS_TOL_M)
    np.testing.assert_allclose(np.array([R for _, R, _ in traj]),
                               np.array([R for _, R, _ in ref_traj[n_done:]]),
                               atol=ROT_TOL)


@pytest.mark.parametrize("mode", ["only_lio", "livo"])
def test_load_jax_checkpoint_continues_the_jax_run(tmp_path, seq, livo_seq,
                                                   mode):
    if mode == "livo":
        s, cfg_t, cfg_j, k = livo_seq, lambda: livo_config(LIVOConfig), \
            lambda: livo_config(JaxConfig), 7
    else:
        s, cfg_t, cfg_j, k = seq, small_config, lambda: small_config(JaxConfig), 8
    ref_traj, a, ck = _jax_run_and_checkpoint(tmp_path, s, cfg_j, mode, k)
    b = LIVOPipeline(cfg_t(), mode, device="cpu")
    convert.load_jax_checkpoint(ck, b)
    assert b.frame_id == a.frame_id and b._prefetch[0] == a._prefetch[0]
    np.testing.assert_array_equal(b.packed.numpy(), np.asarray(a.packed))
    np.testing.assert_array_equal(b.vmap_state.keys.numpy(),
                                  np.asarray(a.vmap_state.keys))
    if mode == "livo":
        np.testing.assert_array_equal(convert.pool_to_numpy(b.pool)[1],
                                      np.asarray(a.pool.obs))
        _push_images_after(b, s, b.last_update_time)
    b.poll(flush=True)
    b._finalize_host_views()
    _assert_close_tail(ref_traj, a.frame_id, b.trajectory)


def test_jax_checkpoint_with_keyframes_raises(tmp_path, seq):
    """A JAX checkpoint that carries the online backend's keyframes (v4
    and later) loads: keyframes, refined poses and the last submit count
    come across bit for bit, and the port's backend goes on refining from
    them."""
    a = JaxPipeline(small_config(JaxConfig), slam_mode="only_lio")
    a.enable_online_refine(keyframe_every=2, window=4, stride=2,
                           outer_iters=1, gn_iters=1)
    _push_all(a, seq)
    a.poll(max_frames=12)
    a._consume_refine(force=True)
    assert len(a._keyframes) >= 4 and a.refined_keyframes
    ck = str(tmp_path / "jax_kf.npz")
    jax_checkpoint.save(ck, a)
    b = LIVOPipeline(small_config(), "only_lio", device="cpu")
    b.enable_online_refine(keyframe_every=2, window=4, stride=2,
                           outer_iters=1, gn_iters=1)
    convert.load_jax_checkpoint(ck, b)
    assert [kf[0] for kf in b._keyframes] == [kf[0] for kf in a._keyframes]
    for kf_a, kf_b in zip(a._keyframes, b._keyframes):
        np.testing.assert_array_equal(kf_b[1].numpy(), np.asarray(kf_a[1]))
        np.testing.assert_array_equal(kf_b[2].numpy(), np.asarray(kf_a[2]))
    assert b._last_refine_k == a._last_refine_k
    assert set(b.refined_keyframes) == set(a.refined_keyframes)
    for t, (R, p) in a.refined_keyframes.items():
        np.testing.assert_array_equal(b.refined_keyframes[t][1], p)
    n_ref, n_kf = len(b.refined_keyframes), len(b._keyframes)
    b.poll(flush=True)
    b._finalize_host_views()
    assert len(b._keyframes) > n_kf and b.refine_submits > 0
    assert len(b.refined_keyframes) >= n_ref

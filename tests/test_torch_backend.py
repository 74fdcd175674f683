"""The sliding-window backend through the port's pipeline on the CPU
(core/pipeline.py keyframes, refine_trajectory, enable_online_refine,
checkpointed keyframes) and multi-stream replay (parallel/batch.py),
with the JAX package's gates.

Tolerances: refine_trajectory's poses against the JAX package's at the
golden trajectory tolerances (8e-3 m, 4e-3: the keyframes come from two
filter runs that agree to those, tests/test_torch_pipeline.py); the
streams of a multi-stream replay bit for bit a single pipeline's run
(the streams are independent pipelines: any difference is cross-talk).
"""

import json

import numpy as np
import pytest
import torch

from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu.utils.config import LIVOConfig as JaxConfig
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import checkpoint, synthetic
from fast_livo2_tpu_torch.parallel.batch import MultiStreamReplay
from tests.test_torch_pipeline import one_torch_thread, small_config  # noqa: F401

POS_TOL_M, ROT_TOL = 8e-3, 4e-3


@pytest.fixture(scope="module")
def seq():
    """tests/test_streaming.py's sequence."""
    return synthetic.make_sequence(
        duration=2.5, lidar_hz=10.0, imu_hz=200.0, seed=0, n_lines=12,
        n_per_line=500, render=False, fov_deg=360.0)


def _push(pipe, seq):
    for tb, pts, offs in seq.scans:
        pipe.push_scan(tb, pts, offs)
    pipe.push_imu(seq.imu_stamps, seq.imu_gyr, seq.imu_acc)


def _errs(refined, seq):
    gt_t = np.array([g[0] for g in seq.gt])
    gt_p = np.array([g[2] for g in seq.gt])
    return [np.linalg.norm(p - gt_p[np.clip(np.searchsorted(gt_t, t), 1,
                                            len(gt_t) - 1)])
            for t, _, p in refined]


def test_refine_trajectory_matches_jax():
    """tests/test_ba.py's test_pipeline_refine_trajectory in both
    packages: keyframes every 2 frames of an ONLY_LIO run, refined after
    it (IMU links on)."""
    seq = synthetic.make_sequence(duration=2.5, lidar_hz=10.0, imu_hz=200.0,
                                  seed=9, n_lines=12, n_per_line=500,
                                  render=False, fov_deg=360.0)
    out = []
    for pipe in (LIVOPipeline(small_config(), "only_lio", device="cpu"),
                 JaxPipeline(small_config(JaxConfig), slam_mode="only_lio")):
        pipe.keyframe_every = 2
        pipe.process(seq)
        out.append(pipe.refine_trajectory(outer_iters=1, gn_iters=2))
    refined, jrefined = out
    assert len(refined) == len(jrefined) >= 5
    assert [t for t, _, _ in refined] == [t for t, _, _ in jrefined]
    np.testing.assert_allclose(np.array([p for _, _, p in refined]),
                               np.array([p for _, _, p in jrefined]),
                               atol=POS_TOL_M)
    np.testing.assert_allclose(np.array([R for _, R, _ in refined]),
                               np.array([R for _, R, _ in jrefined]),
                               atol=ROT_TOL)
    assert np.mean(_errs(refined, seq)) < 0.1


def test_online_refine_with_feedback(seq):
    """tests/test_long_run.py's online-refine gates on a short run:
    refinements complete during the run, every applied delta passed the
    small-delta gate (< 2 deg, < 0.5 m), the refined keyframes track the
    ground truth, and the feedback does not destabilise the filter
    (ATE within max(1.3 x, + 0.02 m) of the run without the backend)."""
    plain = LIVOPipeline(small_config(), "only_lio", device="cpu")
    ate_plain = synthetic.ate_rmse(
        [(t, p) for t, _, p in plain.process(seq)], seq.gt)
    pipe = LIVOPipeline(small_config(), "only_lio", device="cpu")
    pipe.enable_online_refine(keyframe_every=2, window=4, stride=2,
                              outer_iters=1, gn_iters=1)
    traj = pipe.process(seq)
    ate_fb = synthetic.ate_rmse([(t, p) for t, _, p in traj], seq.gt)
    assert pipe.refine_submits >= 2
    assert len(pipe.refined_keyframes) >= pipe.refine_window_size
    assert pipe._refine_deltas, "no delta was fed back"
    for _, R_d, p_d in pipe._refine_deltas:
        ang = np.degrees(np.arccos(np.clip((np.trace(R_d) - 1) / 2, -1, 1)))
        assert ang < 2.0 and np.linalg.norm(p_d) < 0.5
    refined = pipe.refined_keyframe_trajectory()
    assert len(refined) == len(pipe._keyframes)
    assert np.mean(_errs(refined, seq)) < 0.05
    # each link was preintegrated once, at its end keyframe: the last
    # window's links come from that cache, bit for bit a fresh build
    kfs = pipe._keyframes[-pipe.refine_window_size:]
    assert all((a[0], b[0]) in pipe._links for a, b in zip(kfs, kfs[1:]))
    cached = pipe._build_links(kfs)
    pipe._links = {}
    for c, f in zip(cached, pipe._build_links(kfs)):
        assert torch.equal(c, f)
    assert ate_fb <= max(ate_plain * 1.3, ate_plain + 0.02), (ate_fb, ate_plain)
    # the gate: a window whose keyframes all have plane_cond >= gate is
    # healthy and skipped (this room's walls give plane_cond ~0.1-0.3)
    gated = LIVOPipeline(small_config(), "only_lio", device="cpu")
    gated.enable_online_refine(keyframe_every=2, window=4, stride=2,
                               outer_iters=1, gn_iters=1, gate=1e-3)
    gated.process(seq, max_frames=12)
    assert len(gated._kf_conds) == len(gated._keyframes) >= 4
    assert min(gated._kf_conds) >= 1e-3
    assert gated.refine_submits == 0 and gated.refine_gate_skips > 0


def test_checkpoint_preserves_backend_keyframes(tmp_path, seq):
    """tests/test_streaming.py:340 on the port: the online backend's
    keyframes and refined poses survive a resume (checkpoint version 2),
    so refinement goes on from its history."""
    a = LIVOPipeline(small_config(), "only_lio", device="cpu")
    a.enable_online_refine(keyframe_every=2, window=4, stride=2,
                           outer_iters=1, gn_iters=1)
    _push(a, seq)
    a.poll(max_frames=14)
    a._consume_refine(force=True)
    assert len(a._keyframes) >= 4
    n_kf = len(a._keyframes)
    n_ref = len(a.refined_keyframes)
    assert n_ref >= 4
    ck = str(tmp_path / "kf.npz")
    checkpoint.save(ck, a)

    b = LIVOPipeline(small_config(), "only_lio", device="cpu")
    b.enable_online_refine(keyframe_every=2, window=4, stride=2,
                           outer_iters=1, gn_iters=1)
    checkpoint.load(ck, b)
    assert len(b._keyframes) == n_kf
    assert len(b.refined_keyframes) == n_ref
    assert b._last_refine_k == a._last_refine_k
    for kf_a, kf_b in zip(a._keyframes, b._keyframes):
        assert kf_a[0] == kf_b[0]
        np.testing.assert_array_equal(kf_b[1].numpy(), kf_a[1].numpy())
        np.testing.assert_array_equal(kf_b[2].numpy(), kf_a[2].numpy())
    for t, (R, p) in a.refined_keyframes.items():
        np.testing.assert_array_equal(b.refined_keyframes[t][0], R)
        np.testing.assert_array_equal(b.refined_keyframes[t][1], p)
    # a version-1 file (no backend arrays) still loads, with no keyframes
    meta, arrays = checkpoint.read(ck)
    meta["version"] = 1
    v1 = str(tmp_path / "v1.npz")
    np.savez_compressed(v1, __meta__=json.dumps(meta), **{
        k: v for k, v in arrays.items()
        if not k.startswith(("kf_", "refined_"))})
    c = LIVOPipeline(small_config(), "only_lio", device="cpu")
    checkpoint.load(v1, c)
    assert not c._keyframes and not c.refined_keyframes
    assert torch.equal(c.packed, b.packed)
    # the resumed pipeline keeps refining, and resume stays exact
    b.poll(flush=True)
    b._finalize_host_views()
    assert len(b.refined_keyframes) >= n_ref
    a.poll(flush=True)
    a._finalize_host_views()
    assert len(b._keyframes) == len(a._keyframes)
    for (t0, R0, p0), (t1, R1, p1) in zip(a.trajectory[-len(b.trajectory):],
                                          b.trajectory):
        assert t0 == t1
        np.testing.assert_array_equal(p1, p0)
        np.testing.assert_array_equal(R1, R0)


def _two_sequences():
    """tests/test_batched.py's two sequences (other seeds and
    trajectories), at 2.5 s."""
    trajs = [synthetic.Trajectory(),
             synthetic.Trajectory(pos_amp=np.array([0.8, 1.6, 0.2]),
                                  yaw_rate=-0.2)]
    return [synthetic.make_sequence(duration=2.5, lidar_hz=10.0, imu_hz=200.0,
                                    seed=s, n_lines=12, n_per_line=500,
                                    render=False, fov_deg=360.0, traj=tc)
            for s, tc in zip([0, 11], trajs)]


def test_multistream_matches_single_pipelines():
    """tests/test_batched.py's gates with B = 2 over 14 frames a stream:
    each stream tracks its own sequence, the streams differ, and each is
    bit for bit the single pipeline's run of its sequence."""
    seqs = _two_sequences()
    bp = MultiStreamReplay(small_config(), batch=2, slam_mode="only_lio",
                           devices=["cpu"])
    trajs = bp.process(seqs, max_frames=14)
    assert bp.n_frames > 0 and bp.wall_s > 0
    for b, s in enumerate(seqs):
        assert len(trajs[b]) == 14
        assert synthetic.ate_rmse([(t, p) for t, _, p in trajs[b]],
                                  s.gt) < 0.08
        single = LIVOPipeline(small_config(), "only_lio",
                              device="cpu").process(s, max_frames=14)
        assert [t for t, _, _ in single] == [t for t, _, _ in trajs[b]]
        for (_, R0, p0), (_, R1, p1) in zip(single, trajs[b]):
            np.testing.assert_array_equal(p1, p0)
            np.testing.assert_array_equal(R1, R0)
    d = np.linalg.norm(np.array([p for _, _, p in trajs[0]])
                       - np.array([p for _, _, p in trajs[1]]), axis=-1)
    assert d.max() > 0.2
    with pytest.raises(ValueError, match="sequences"):
        bp.process(seqs[:1])


def test_multistream_placement_beyond_the_cards_raises():
    """Placing a stream on a CUDA device the machine does not have raises
    (here: any, on a machine without one)."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="CUDA device"):
        MultiStreamReplay(small_config(), batch=2, slam_mode="only_lio",
                          devices=["cpu", f"cuda:{n}"])


def test_raw_keyframe_scans(seq):
    """kf_use_raw keeps the raw (distorted) packet's strided rows instead
    of the undistorted posterior scan (the JAX package's distortion
    comparison, tests/test_ba.py:157). In ONLY_LIO a frame's packet is
    one whole scan in time order, so a raw keyframe holds every second
    point of its scan (8192 packet rows strided to 4096)."""
    runs = {}
    for raw in (False, True):
        pipe = LIVOPipeline(small_config(), "only_lio", device="cpu")
        pipe.keyframe_every = 2
        pipe.kf_use_raw = raw
        pipe.process(seq, max_frames=7)
        runs[raw] = pipe._keyframes
    assert [kf[0] for kf in runs[True]] == [kf[0] for kf in runs[False]]
    assert len(runs[True]) == 3
    ends = [tb + offs[-1] for tb, _, offs in seq.scans]
    for und, raw in zip(runs[False], runs[True]):
        assert und[2].shape == raw[2].shape == (4096, 4)
        tb, pts, offs = seq.scans[int(np.argmin(np.abs(np.array(ends) - raw[0])))]
        want = pts[np.argsort(offs, kind="stable")][0::2]
        got = raw[2].numpy()
        np.testing.assert_array_equal(got[:len(want), :3], want)
        assert (got[:len(want), 3] == 1).all() and (got[len(want):] == 0).all()
        # the undistorted scan is another one (body frame, posterior)
        assert not np.allclose(und[2].numpy()[:len(want), :3], want,
                               atol=1e-3)

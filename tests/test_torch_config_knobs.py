"""The reference config knobs on the port, on the CPU: the cases of
tests/test_config_knobs.py that tests/test_torch_frame_modes.py does not
already hold (it holds test_stage_timing_mode and
test_print_stage_table_renders), with their gates unchanged. Each case
flips one knob and asserts the observable change (or the invariance
where the knob is a no-op on the data): normal_en off, the NCC gate,
exposure_time_init, feature_extract_enabled, the time offsets and
hilti_en at ingestion, the estimation toggles from yaml to the ImuNoise
gates and their frozen blocks, the q16 wire, ros_driver_bug_fix and
pub_effect_point_en.

The configuration is the JAX test's (tests/test_torch_frame_modes.py's
`knobs_config`: tpu.pallas_photo at its default, so the port runs K2's
plain version) on its 2 s sequence; the LIVO run with every knob at its
default is shared by a module fixture.
"""

import numpy as np
import pytest

from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import dataset, synthetic
from fast_livo2_tpu_torch.models import camera as cam_mod
from fast_livo2_tpu_torch.utils.config import load_config
from tests.test_torch_frame_modes import knobs_config as livo_config
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def seq():
    cam = cam_mod.make_camera(livo_config().camera)
    return synthetic.make_sequence(
        duration=2.0, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0, cam=cam,
        seed=11, n_lines=12, n_per_line=500, render=True, fov_deg=360.0,
    )


def _pipe(cfg, mode):
    return LIVOPipeline(cfg, slam_mode=mode, device="cpu")


def _run(cfg, seq, mode="livo"):
    pipe = _pipe(cfg, mode)
    traj = pipe.process(seq)
    est = [(t, p) for t, R, p in traj]
    rmse = synthetic.ate_rmse(est, seq.gt)
    tracked = [r.get("n_tracked", 0) for r in pipe.log.rows[3:]]
    return pipe, rmse, float(np.mean(tracked)) if tracked else 0.0


@pytest.fixture(scope="module")
def base_livo(seq):
    """The LIVO run with every knob at its default: (rmse, tracked)."""
    _, rmse, tracked = _run(livo_config(), seq)
    return rmse, tracked


def test_normal_en_off_closest_view_path(seq):
    """normal_en=false: closest-view ref selection + fronto-parallel warp
    (getCloseViewObs + getWarpMatrixAffine, vio.cpp:696-734) must still
    track the sequence."""
    cfg = livo_config()
    cfg.vio.normal_en = False
    _, rmse, tracked = _run(cfg, seq)
    assert rmse < 0.08, f"normal_en=false ATE {rmse:.3f}"
    assert tracked > 20, f"normal_en=false tracked {tracked}"


def test_ncc_gate_rejects_and_passes(seq, base_livo):
    """ncc_en (vio.cpp:753-762): an impossible threshold must reject all
    tracked patches; a permissive one must change nothing."""
    _, tracked_off = base_livo

    hard = livo_config()
    hard.vio.ncc_en = True
    hard.vio.ncc_thre = 1.1  # NCC <= 1 always -> rejects every patch
    _, _, tracked_hard = _run(hard, seq)

    soft = livo_config()
    soft.vio.ncc_en = True
    soft.vio.ncc_thre = -1.1  # NCC >= -1 always -> rejects nothing
    _, rmse_soft, tracked_soft = _run(soft, seq)

    assert tracked_hard == 0.0, f"ncc_thre=1.1 still tracked {tracked_hard}"
    assert tracked_off > 20
    assert abs(tracked_soft - tracked_off) / tracked_off < 0.25
    assert rmse_soft < 0.08


def test_exposure_time_init_shifts_capture_time(seq):
    """time_offset/exposure_time_init is added to the image stamp to form
    the capture (stream-cut) time (sync_packages, LIVMapper.cpp:949-1010):
    frame timestamps in the output trajectory must shift by exactly it."""
    t0 = [t for t, _, _ in _pipe(livo_config(), "livo").process(seq, max_frames=5)]

    cfg1 = livo_config()
    cfg1.time_offset.exposure_time_init = 0.013
    t1 = [t for t, _, _ in _pipe(cfg1, "livo").process(seq, max_frames=5)]

    assert len(t0) == len(t1) == 5
    np.testing.assert_allclose(np.array(t1) - np.array(t0), 0.013, atol=1e-9)


def test_feature_extract_enabled_filters_scan_points(seq):
    """preprocess/feature_extract_enabled gates the LOAM surf path
    (give_feature, preprocess.cpp:746-980): the pipeline must ingest a
    strict subset of the raw points."""
    total_raw = sum(len(p) for _, p, _ in seq.scans)

    pipe_off = _pipe(livo_config(), "livo")
    pipe_off.process(seq, max_frames=0)  # builds pending only
    n_off = sum(len(p) for p, _ in pipe_off.pending)

    cfg = livo_config()
    cfg.preprocess.feature_extract_enabled = True
    pipe_on = _pipe(cfg, "livo")
    pipe_on.process(seq, max_frames=0)
    n_on = sum(len(p) for p, _ in pipe_on.pending)

    assert n_off == total_raw
    assert 0 < n_on < n_off, f"feature path kept {n_on}/{n_off}"


def test_load_sequence_cfg_time_offsets(tmp_path, seq):
    """io.dataset.load_sequence(cfg=...) applies the time_offset section
    at ingestion exactly as the reference callbacks do
    (lidar +, imu -, img +; LIVMapper.cpp:708,776,847)."""
    d = tmp_path / "seq"
    dataset.save_sequence(str(d), seq)
    base = dataset.load_sequence(str(d))

    cfg = livo_config()
    cfg.time_offset.imu_time_offset = 0.004
    cfg.time_offset.img_time_offset = 0.05
    cfg.time_offset.lidar_time_offset = -0.1
    off = dataset.load_sequence(str(d), cfg=cfg)

    np.testing.assert_allclose(off.imu_stamps, base.imu_stamps - 0.004)
    np.testing.assert_allclose(off.scans[0][0], base.scans[0][0] - 0.1)
    np.testing.assert_allclose(off.images[0][0], base.images[0][0] + 0.05)


def test_hilti_en_decimates_images(tmp_path, seq):
    """preprocess/hilti_en keeps 1-in-4 images (LIVMapper.cpp:841-845)."""
    d = tmp_path / "seq"
    dataset.save_sequence(str(d), seq)
    base = dataset.load_sequence(str(d))
    cfg = livo_config()
    cfg.preprocess.hilti_en = True
    dec = dataset.load_sequence(str(d), cfg=cfg)
    assert len(dec.images) == (len(base.images) + 3) // 4
    assert dec.images[0][0] == base.images[0][0]


def test_imu_est_toggle_yaml_wiring(tmp_path):
    """imu/gravity_est_en + imu/ba_bg_est_en + vio/exposure_estimate_en
    (LIVMapper.cpp:85-86,64 -> ImuProcess::disable_*, :158-160) load from
    the reference YAML schema and reach the ImuNoise gates."""
    y = tmp_path / "s.yaml"
    y.write_text("imu:\n  gravity_est_en: false\n  ba_bg_est_en: false\n"
                 "vio:\n  exposure_estimate_en: false\n")
    cfg = load_config(str(y))
    assert cfg.imu.gravity_est_en is False
    assert cfg.imu.ba_bg_est_en is False
    assert cfg.vio.exposure_estimate_en is False

    pipe = _pipe(cfg, "only_lio")
    t = np.arange(200) / 200.0
    pipe.push_imu(t, np.zeros((200, 3)),
                  np.tile([0.0, 0.0, 9.81], (200, 1)))
    assert pipe._init_imu(pipe._imu_buf(), 1.0)
    assert float(pipe.noise.est_gravity) == 0.0
    assert float(pipe.noise.est_bias) == 0.0
    assert float(pipe.noise.est_exposure) == 0.0
    # defaults stay on
    pipe_on = _pipe(livo_config(), "only_lio")
    pipe_on.push_imu(t, np.zeros((200, 3)),
                     np.tile([0.0, 0.0, 9.81], (200, 1)))
    assert pipe_on._init_imu(pipe_on._imu_buf(), 1.0)
    assert float(pipe_on.noise.est_bias) == 1.0


def test_ba_bg_gravity_est_toggles_freeze_blocks(seq):
    """With ba_bg_est_en=false the bias blocks never move over a full run
    (the F_x couplings are gated, IMU_Processing.cpp:386-390, so no cross
    covariance forms and the update can't touch them); same for
    gravity_est_en and the gravity block. With defaults on, both move."""
    def final_blocks(gravity_en, ba_bg_en):
        cfg = livo_config()
        cfg.imu.gravity_est_en = gravity_en
        cfg.imu.ba_bg_est_en = ba_bg_en
        cfg.evo.pose_output_en = True
        pipe = _pipe(cfg, "only_lio")
        pipe.process(seq)
        first = pipe.trace_pre[0][1].numpy()
        last = pipe.packed.numpy()
        d_bias = np.abs(last[15:21] - first[15:21]).max()
        d_grav = np.abs(last[21:24] - first[21:24]).max()
        return d_bias, d_grav

    d_bias_off, d_grav_off = final_blocks(False, False)
    assert d_bias_off < 1e-9, f"bias moved {d_bias_off} with est off"
    assert d_grav_off < 1e-9, f"gravity moved {d_grav_off} with est off"
    d_bias_on, d_grav_on = final_blocks(True, True)
    assert d_bias_on > 1e-7 and d_grav_on > 1e-7


def test_wire_q16_quantization_neutral(seq):
    """tpu.wire_q16 (int16 point wire format, 8 B/pt vs 20 B): <= 2.5 mm
    quantization must be trajectory-neutral relative to sensor noise."""
    traj_ref = _pipe(livo_config(), "only_lio").process(seq)

    cfg = livo_config()
    cfg.tpu.wire_q16 = True
    traj = _pipe(cfg, "only_lio").process(seq)

    assert len(traj) == len(traj_ref)
    d = [np.linalg.norm(p0 - p1) for (_, _, p0), (_, _, p1)
         in zip(traj_ref, traj)]
    assert max(d) < 0.02, f"wire_q16 moved poses by up to {max(d):.4f} m"
    rmse_ref = synthetic.ate_rmse([(t, p) for t, _, p in traj_ref], seq.gt)
    rmse_q = synthetic.ate_rmse([(t, p) for t, _, p in traj], seq.gt)
    assert rmse_q < rmse_ref + 0.005, (rmse_q, rmse_ref)


def test_ros_driver_bug_fix_realigns_imu(seq):
    """common/ros_driver_bug_fix (imu_cbk, LIVMapper.cpp:779-784): IMU
    stamped a whole number of seconds off the LiDAR clock is rounded
    back into alignment when the knob is on; with it off the streams
    never sync and no frame fires."""
    def run(fix, shift):
        # interleaved per-message pushes (the fix compares each incoming
        # IMU stamp against the CURRENT lidar clock, as the reference's
        # callback does)
        cfg = livo_config()
        cfg.common.ros_driver_bug_fix = fix
        pipe = _pipe(cfg, "only_lio")
        ii = 0
        for tb, pts, offs in seq.scans:
            pipe.push_scan(tb, pts, offs)
            t_end = tb + (offs[-1] if len(offs) else 0.0)
            j = int(np.searchsorted(seq.imu_stamps, t_end + 0.05))
            if j > ii:
                pipe.push_imu(seq.imu_stamps[ii:j] + shift,
                              seq.imu_gyr[ii:j], seq.imu_acc[ii:j])
                ii = j
        pipe.poll()
        pipe._finalize_host_views()
        return pipe

    ref = run(False, 0.0)
    broken = run(False, -97.0)
    fixed = run(True, -97.0)
    assert ref.frame_id > 10
    assert broken.frame_id == 0  # IMU never covers any event
    assert fixed.frame_id == ref.frame_id
    for (t0, _, p0), (t1, _, p1) in zip(ref.trajectory, fixed.trajectory):
        assert t0 == t1
        np.testing.assert_allclose(p0, p1, atol=1e-6)


def test_pub_effect_point_en_collects_matched_points(seq):
    """publish/pub_effect_point_en (publish_effect_world,
    LIVMapper.cpp:446): per-frame effective points are retained and
    their count equals the filter's n_eff diagnostic."""
    cfg = livo_config()
    cfg.publish.pub_effect_point_en = True
    pipe = _pipe(cfg, "only_lio")
    pipe.process(seq, max_frames=6)
    ep = pipe.effect_points()
    assert len(ep) >= 4
    rows = {round(r["t"], 6): r for r in pipe.log.rows if "n_eff" in r}
    checked = 0
    for t, pts in ep:
        r = rows.get(round(t, 6))
        if r is None:
            continue
        assert len(pts) == r["n_eff"], (len(pts), r["n_eff"])
        assert np.isfinite(pts).all()
        checked += 1
    assert checked >= 3

    pipe2 = _pipe(livo_config(), "only_lio")
    pipe2.process(seq, max_frames=3)
    assert pipe2.effect_points() == []

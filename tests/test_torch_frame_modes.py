"""The port's fused and staged frames (tpu.fused_frame, tpu.stage_timing)
on the CPU, against the JAX package and against the port's split frame.

On the CPU the fused frame runs the same frame function as the card's
captured graph, eagerly: the LIO and photometric device loops
(every iteration masked, no host read) and the state written back in
place. The device loops compute what the early-exit loops compute, bit
for bit (tests/test_torch_lio.py, tests/test_torch_vio.py), so the fused
and staged runs equal the split runs of the same order exactly.

Tolerances: the port's fused LIVO run against the JAX package's
fused_frame run of the same sequence at the golden-trace tolerances,
8e-3 m and 4e-3 (tests/test_golden_trace.py; the photometric error feeds
back through up to 15 iterations a frame in another float32 evaluation
order). Both sides take the torch-op / XLA photometric path
(tpu.pallas_photo = False), as tests/test_torch_vio.py does. The
stage-timing tests are tests/test_config_knobs.py:215 and :265 on the
port, their gates unchanged; the staged run and its reference run once,
in a module fixture.
"""

import numpy as np
import pytest
import torch

from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu.utils.config import LIVOConfig as JaxConfig
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import synthetic
from fast_livo2_tpu_torch.models import camera as tcam
from fast_livo2_tpu_torch.utils import timing
from fast_livo2_tpu_torch.utils.config import LIVOConfig
from tests.test_torch_vio import livo_config, one_torch_thread  # noqa: F401

POS_TOL_M, ROT_TOL = 8e-3, 4e-3


@pytest.fixture(scope="module")
def seq():
    """tests/test_torch_vio.py's 1.6 s rendered sequence (12 x 500
    points a scan)."""
    cam = tcam.make_camera(livo_config(LIVOConfig).camera)
    return synthetic.make_sequence(
        duration=1.6, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0, cam=cam,
        seed=0, n_lines=12, n_per_line=500, render=True, fov_deg=360.0)


def _port(seq, mode="livo", max_frames=None, **tpu):
    cfg = livo_config(LIVOConfig)
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    pipe = LIVOPipeline(cfg, slam_mode=mode, device="cpu")
    return pipe.process(seq, max_frames=max_frames), pipe


def _assert_same(a, b):
    assert [t for t, _, _ in a] == [t for t, _, _ in b]
    for (_, Ra, pa), (_, Rb, pb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(Ra, Rb)


def test_fused_livo_matches_jax_fused(seq):
    """The port's fused LIVO run against the JAX package's fused_frame
    run of the same sequence."""
    jcfg = livo_config(JaxConfig)
    jcfg.tpu.fused_frame = True
    jtraj = JaxPipeline(jcfg, slam_mode="livo").process(seq)
    traj, pipe = _port(seq, fused_frame=True)
    assert pipe._frame_graphs is None  # the CPU runs the frame eagerly
    assert [t for t, _, _ in traj] == [t for t, _, _ in jtraj]
    assert len(traj) >= 12
    np.testing.assert_allclose(np.array([p for _, _, p in traj]),
                               np.array([p for _, _, p in jtraj]),
                               atol=POS_TOL_M)
    np.testing.assert_allclose(np.array([R for _, R, _ in traj]),
                               np.array([R for _, R, _ in jtraj]),
                               atol=ROT_TOL)
    tracked = [r["n_tracked"] for r in pipe.log.rows[3:]]
    assert np.mean(tracked) > 20
    # the iterations that took effect, counted on the device
    assert isinstance(pipe.photo_iterations, int)
    assert 0 < pipe.photo_iterations <= 15 * (len(traj) - 1)


@pytest.mark.parametrize("mode,tpu", [("only_lio", {}),
                                      ("only_lo", dict(wire_q16=True))],
                         ids=["only_lio", "only_lo_q16"])
def test_fused_camera_less_modes_equal_split(seq, mode, tpu):
    """The fused frame in the two camera-less modes (ONLY_LO on the int16
    points wire): the same trajectory as the split frames over 8 frames,
    bit for bit."""
    fused, _ = _port(seq, mode, max_frames=8, fused_frame=True, **tpu)
    split, _ = _port(seq, mode, max_frames=8, **tpu)
    assert len(fused) == 8
    _assert_same(fused, split)


def test_stage_clock_laps():
    """Stages run in `annotate` ranges inside an active clock, one after
    another, read back in order."""
    with timing.StageClock(torch.device("cpu")) as clock:
        for name in timing.STAGES[:3]:
            with timing.annotate(name):
                pass
    ms = timing.stage_times(clock.spans, clock.marks.numpy())[0]
    assert list(ms) == [f"{n}_ms" for n in timing.STAGES[:3]]
    assert all(v >= 0.0 for v in ms.values())


# tests/test_config_knobs.py's configuration (tpu.pallas_photo at its
# default, True: the port takes K2's plain version) and sequence

def knobs_config():
    return livo_config(LIVOConfig, pallas_photo=True)


@pytest.fixture(scope="module")
def knobs_runs():
    """tests/test_config_knobs.py's sequence through the split frames
    with deferred_map_insert = False and through the staged frames."""
    cam = tcam.make_camera(knobs_config().camera)
    seq = synthetic.make_sequence(
        duration=2.0, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0, cam=cam,
        seed=11, n_lines=12, n_per_line=500, render=True, fov_deg=360.0,
    )
    base = knobs_config()
    base.tpu.deferred_map_insert = False
    ref = LIVOPipeline(base, slam_mode="livo", device="cpu")
    traj_ref = ref.process(seq)

    cfg = knobs_config()
    cfg.tpu.deferred_map_insert = False
    cfg.tpu.stage_timing = True
    pipe = LIVOPipeline(cfg, slam_mode="livo", device="cpu")
    traj = pipe.process(seq)
    return traj_ref, traj, pipe


def test_stage_timing_mode(knobs_runs):
    """tests/test_config_knobs.py:215 on the port: per-stage columns in
    FrameLog rows of a production run, and the staged frame reproduces
    the normal path's trajectory (stage order = map insert before VIO,
    i.e. the deferred_map_insert = False order)."""
    traj_ref, traj, pipe = knobs_runs
    assert len(traj) == len(traj_ref)
    for (t0, R0, p0), (t1, R1, p1) in zip(traj_ref, traj):
        assert t0 == t1
        np.testing.assert_allclose(p0, p1, atol=1e-4)
    rows = [r for r in pipe.log.rows if "lio_ms" in r]
    assert len(rows) >= len(traj) - 2
    for k in ("propagate_ms", "undistort_ms", "downsample_ms", "lio_ms",
              "map_ms", "vio_ms"):
        assert k in rows[-1] and rows[-1][k] > 0.0


def test_staged_frames_equal_split_bitwise(knobs_runs):
    """With the device loops computing what the early-exit loops do, the
    staged run is the split run without the deferred insert, bit for
    bit, and every staged frame (all but the first) has every stage."""
    traj_ref, traj, pipe = knobs_runs
    _assert_same(traj, traj_ref)
    rows = [r for r in pipe.log.rows if "lio_ms" in r]
    assert len(rows) == len(traj) - 1
    for r in rows:
        assert all(r[f"{k}_ms"] > 0.0 for k in timing.STAGES)


def test_print_stage_table_renders(knobs_runs):
    """tests/test_config_knobs.py:265 on the port: the reference's
    per-frame stage table rendered from a production run's FrameLog
    rows."""
    out = knobs_runs[2].print_stage_table(last_n=4)
    for name in ("propagate", "lio", "map", "vio", "Total"):
        assert name in out, out

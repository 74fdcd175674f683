"""The exposure ramp of tests/test_exposure_and_export.py on the port,
on the CPU: the 7th state column (inverse exposure) must track a
synthetic 30 % exposure drop (the residual tau*I_cur - tau_ref*I_ref
only vanishes when tau compensates, vio.cpp:1612-1628), under the JAX
test's gates unchanged (tau past 40 % of the expected rise, ATE
< 0.08 m), and end within 4e-3 of the JAX run's tau on the same
sequence, its trajectory within 8e-3 m / 4e-3 (tests/test_golden_trace.py's
tolerances).
"""

import numpy as np

from fast_livo2_tpu.core.pipeline import LIVOPipeline as JaxPipeline
from fast_livo2_tpu.utils.config import LIVOConfig as JaxConfig
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import synthetic
from fast_livo2_tpu_torch.models import camera as cam_mod
from fast_livo2_tpu_torch.utils.config import LIVOConfig
from tests.test_torch_vio import livo_config, one_torch_thread  # noqa: F401

POS_TOL_M, ROT_TOL = 8e-3, 4e-3


def expo(t):
    """Exposure drops 30 % over the sequence after the still phase."""
    return 1.0 / (1.0 + 0.5 * max(0.0, t - 0.6))


def test_exposure_estimation_tracks_brightness_change():
    cfg = livo_config(LIVOConfig)
    seq = synthetic.make_sequence(
        duration=3.0, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0,
        cam=cam_mod.make_camera(cfg.camera), seed=5, n_lines=12,
        n_per_line=500, render=True, fov_deg=360.0, exposure_fn=expo)
    pipe = LIVOPipeline(cfg, slam_mode="livo", device="cpu")
    traj = pipe.process(seq)
    assert len(traj) >= 20
    tau = float(pipe.state.inv_expo)
    expected_ratio = 1.0 / expo(traj[-1][0])  # tau_end / tau_start
    assert tau > 1.0 + 0.4 * (expected_ratio - 1.0), (tau, expected_ratio)
    rmse = synthetic.ate_rmse([(t, p) for t, _, p in traj], seq.gt)
    assert rmse < 0.08, rmse
    jpipe = JaxPipeline(livo_config(JaxConfig), slam_mode="livo")
    jtraj = jpipe.process(seq)
    assert abs(tau - float(np.asarray(jpipe.state.inv_expo))) < ROT_TOL
    np.testing.assert_allclose(np.array([p for _, _, p in traj]),
                               np.array([p for _, _, p in jtraj]),
                               atol=POS_TOL_M)
    np.testing.assert_allclose(np.array([R for _, R, _ in traj]),
                               np.array([R for _, R, _ in jtraj]),
                               atol=ROT_TOL)

"""The port's run CLI (fast_livo2_tpu_torch/run.py) on the CPU:
tests/test_run_cli.py's scenario (config yaml -> npz sequence ->
trajectory.txt + artifacts + JSON summary with ATE/drift), a run cut by
--max-frames and finished with --resume (exactly the uninterrupted run's
tail), the mode derivation, the per-stage table (--stage-table) and the
backend (--online-refine)."""

import json
import os

import numpy as np
import pytest
import yaml

from fast_livo2_tpu_torch import run
from fast_livo2_tpu_torch.io import dataset, synthetic
from fast_livo2_tpu_torch.utils.config import LIVOConfig
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """test_run_cli.py's sequence and sensor yaml, and the CLI's full run
    with --pcd, --traces and --checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    seq = synthetic.make_sequence(
        duration=2.0, lidar_hz=10.0, imu_hz=200.0, seed=5, n_lines=12,
        n_per_line=400, render=False, fov_deg=360.0)
    dataset.save_sequence(str(root / "seq"), seq)
    cfg_yaml = root / "sensor.yaml"
    cfg_yaml.write_text(yaml.safe_dump({
        "common": {"img_en": 0, "lidar_en": 1},
        "preprocess": {"filter_size_surf": 0.15},
        "lio": {"max_layer": 1},
        "tpu": {"max_points_per_scan": 8192, "max_points_down": 4096,
                "hash_capacity_log2": 15},
    }))
    summary = run.main([
        "--config", str(cfg_yaml), "--seq", str(root / "seq"),
        "--out", str(root / "out"), "--pcd", "--traces", "--checkpoint",
        str(root / "ck.npz"), "--device", "cpu"])
    return root, seq, summary


def test_run_cli_end_to_end(case):
    root, _, summary = case
    out = root / "out"
    assert summary["mode"] == "only_lio"  # derived from img_en: 0
    assert summary["device"] == "cpu"
    assert summary["frames"] >= 12
    assert summary["ate_rmse_m"] < 0.06
    assert "drift_pct" in summary and "rpe_1s_m" in summary
    assert summary["pcd_points"] > 0  # geometry-only accumulation
    for name in ("trajectory.txt", "cloud.pcd", "mat_pre.txt", "mat_out.txt"):
        assert os.path.exists(out / name), name
    assert os.path.exists(root / "ck.npz")
    rows = np.loadtxt(out / "trajectory.txt")
    assert rows.shape[1] == 8 and len(rows) == summary["frames"]
    assert np.loadtxt(out / "mat_out.txt").shape == (summary["frames"], 17)


def test_run_cli_resume_finishes_the_cut_run(case, capsys):
    """--max-frames k --checkpoint, then --resume on a sequence holding
    nothing more (the checkpoint carries the rest of the stream): the
    second run's trajectory is the full run's tail, bit for bit."""
    root, seq, full = case
    args = ["--config", str(root / "sensor.yaml"), "--device", "cpu"]
    first = run.main(args + ["--seq", str(root / "seq"), "--out",
                             str(root / "first"), "--max-frames", "7",
                             "--checkpoint", str(root / "cut.npz")])
    assert first["frames"] == 7
    empty = synthetic.SyntheticSequence(
        imu_stamps=seq.imu_stamps[:0], imu_gyr=seq.imu_gyr[:0],
        imu_acc=seq.imu_acc[:0], scans=[], images=[], gt=seq.gt)
    dataset.save_sequence(str(root / "rest"), empty)
    rest = run.main(args + ["--seq", str(root / "rest"), "--out",
                            str(root / "second"), "--resume",
                            str(root / "cut.npz")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rest
    assert first["frames"] + rest["frames"] == full["frames"]
    whole = np.loadtxt(root / "out" / "trajectory.txt")
    np.testing.assert_array_equal(
        np.concatenate([np.loadtxt(root / "first" / "trajectory.txt"),
                        np.loadtxt(root / "second" / "trajectory.txt")]), whole)


def test_derive_mode():
    c = LIVOConfig()
    c.imu.imu_en = False
    assert run.derive_mode(c) == "only_lo"
    c = LIVOConfig()
    c.common.img_en = False
    assert run.derive_mode(c) == "only_lio"
    assert run.derive_mode(LIVOConfig()) == "livo"


@pytest.mark.parametrize("flag,written", [("--online-refine",
                                            "trajectory_refined.txt")])
def test_unported_options_raise(case, monkeypatch, flag, written):
    """The option that was not ported runs: --online-refine turns the
    backend on (enable_online_refine, here at a 2-frame keyframe interval
    and a 4-keyframe window so that the 2 s sequence refines windows) and
    writes the refined keyframe trajectory, with `refined_keyframes` in
    the summary."""
    from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline

    enable = LIVOPipeline.enable_online_refine
    monkeypatch.setattr(
        LIVOPipeline, "enable_online_refine",
        lambda self: enable(self, keyframe_every=2, window=4, stride=2,
                            outer_iters=1, gn_iters=1))
    root, _, full = case
    out = root / "refined"
    summary = run.main(["--config", str(root / "sensor.yaml"), "--seq",
                        str(root / "seq"), "--out", str(out), flag,
                        "--device", "cpu"])
    assert summary["frames"] == full["frames"]
    assert summary["refined_keyframes"] >= 4
    rows = np.loadtxt(out / written)
    assert rows.shape == (summary["refined_keyframes"], 8)
    assert summary["ate_rmse_m"] < 0.06


def test_run_cli_stage_table(case, capsys):
    """--stage-table sets tpu.stage_timing and prints the per-frame stage
    table before the summary line."""
    root, _, full = case
    summary = run.main(["--config", str(root / "sensor.yaml"), "--seq",
                        str(root / "seq"), "--out", str(root / "staged"),
                        "--stage-table", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == summary
    assert summary["frames"] == full["frames"]
    table = "\n".join(printed[:-1])
    for name in ("propagate", "undistort", "downsample", "lio", "map",
                 "Total"):
        assert name in table, table
    assert "vio" not in table  # ONLY_LIO: no VIO stage

"""The online backend in the benchmark, on the CPU.

- reference/ba.py's plain float64 `refine_window` against the port's
  `ba.refine_window` on seeded windows (K 4, N 256 on three planes, the
  poses perturbed), plain, with IMU links the port builds from raw
  samples as its pipeline does and the reference works out again, and
  with links and photometric factors;
- check.apply_delta against the pipeline's `_apply_delta`;
- a cell whose mix turns the backend on, run end to end at the CPU size
  (`tiny`, conftest.py): sound, the refined windows read at the
  program's float32 rounding and the control (the reference in TF32 in
  the program's place) well beyond; a mix without `backend` builds no
  watch and turns no backend on;
- faults planted underneath, each reading `correct` false: the IMU links
  dropped from the refinement, the photometric terms dropped, the
  refiner handing back the poses it was given, the step check ignoring
  the pose delta fed back into the filter, and one window's refined
  poses turned to NaN where they are produced (a window the draw cannot
  take, so that `refine_nonfinite_windows` alone reads it). One
  Gauss-Newton step fewer a sweep is not among them: on the card it
  reads inside the band that sound runs reach (PERF.md, section 2).

The CPU runs a frame several times slower than the sensor, so the tiny
cell's replay submits a window every ~2 s of its clock rather than every
0.8 s: the draw of the checked windows is given a 3 s pace, which puts
both checked windows among the first three of a 12 s window.
"""

import json
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fast_livo2_tpu_torch.core import voxel_map as tvm
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.io import convert, synthetic
from fast_livo2_tpu_torch.models import camera as tcam
from fast_livo2_tpu_torch.ops import image as img_ops
from fast_livo2_tpu_torch.ops import so3
from fast_livo2_tpu_torch.parallel import ba
from fast_livo2_tpu_torch.utils.config import CameraConfig
from livo_bench.lib import check, deployment, harness, refine
from livo_bench.reference import ba as ref_ba
from livo_bench.reference import lio as ref
from livo_bench.reference import vio as vio_ref

SEED = 2 ** 31 + 4242
TOL = 1e-5  # rad and m: float32 against float64 (read: 1e-7 to 6e-7)
MAP = dict(voxel_size=0.5, n_layers=2, capacity_log2=12, layer_init_num=(5, 5))
REF_MAP = dict(voxel=0.5, layers=2, planner_threshold=0.0025, sigma_num=3.0,
               init_num=[5.0] * 10, max_points=50.0, margin=0.5, dept_err=0.02,
               beam_err=0.05)
CAM = dict(cam_model="Pinhole", cam_width=320, cam_height=256, scale=1.0,
           cam_fx=200.0, cam_fy=200.0, cam_cx=160.0, cam_cy=128.0)
BACKEND = dict(outer_iters=2, gn_iters=2)
W_WORLD = np.array([0.05, -0.1, 0.2])  # rad/s, world frame
V_WORLD = np.array([0.4, 0.1, 0.05])  # m/s
GRAV = np.array([0.0, 0.0, -9.81])


def _exp(w):
    return so3.exp(torch.as_tensor(np.asarray(w, np.float64))).numpy()


def _truth(t):
    return _exp(W_WORLD * t) @ _exp([0.02, -0.03, 0.1]), np.array([0.1, -0.2, 0.0]) + V_WORLD * t


def _window(K=4, N=256, seed=0):
    """(window arrays, truth poses, keyframe stamps): three 2.5 m planes
    seen from K poses of a constant-rate motion, the poses perturbed by
    0.02 rad and 0.02 m."""
    rng = np.random.default_rng(seed)
    stamps = 0.3 + 0.25 * np.arange(K)

    def plane(n, normal, d):
        normal = np.asarray(normal, np.float64)
        a = np.array([1.0, 0, 0]) if abs(normal[0]) < 0.9 else np.array([0, 1.0, 0])
        b1 = np.cross(normal, a)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(normal, b1)
        uv = rng.uniform(-1.25, 1.25, size=(n, 2))
        return -d * normal + uv[:, :1] * b1 + uv[:, 1:] * b2 + rng.normal(size=(n, 3)) * 0.004

    rot, pos, scans = [], [], []
    for t in stamps:
        R, p = _truth(t)
        world = np.concatenate([plane(N // 3, [0, 0, 1], 1.0), plane(N // 3, [1, 0, 0], -3.0),
                                plane(N - 2 * (N // 3), [0, 1, 0], -3.0)])
        rot.append(R)
        pos.append(p)
        scans.append((world - p) @ R)
    rot, pos = np.array(rot), np.array(pos)
    noisy = np.array([_exp(rng.normal(size=3) * 0.02) @ R for R in rot])
    arrays = (noisy.astype(np.float32), (pos + rng.normal(size=(K, 3)) * 0.02).astype(np.float32),
              np.array(scans, np.float32), np.ones((K, N), bool))
    return arrays, rot, pos, stamps


def _imu(stamps):
    """200 Hz samples of the constant-rate motion (no biases, no noise)."""
    t = np.arange(0.0, stamps[-1] + 0.1, 0.005)
    gyr, acc = [], []
    for ti in t:
        R, _ = _truth(ti)
        gyr.append(R.T @ W_WORLD)
        acc.append(R.T @ -GRAV)
    return t, np.array(gyr), np.array(acc)


def _states(rot, pos):
    K = len(rot)
    return np.concatenate([rot.reshape(K, 9), pos, np.tile(V_WORLD, (K, 1)), np.zeros((K, 6)),
                           np.tile(GRAV, (K, 1)), np.ones((K, 1))], -1)


def _port_links(imu, stamps, states):
    """The port's ImuLinks, built as LIVOPipeline._build_links builds them."""
    K = len(stamps)
    dR, dp, dts, ok = np.tile(np.eye(3), (K, 1, 1)), np.zeros((K, 3)), np.full(K, 1e-3), \
        np.zeros(K, bool)
    st = states.astype(np.float32).astype(np.float64)
    for k in range(K - 1):
        dR[k], dp[k], d = ba.preintegrate(*imu, st[k, 15:18], st[k, 18:21], stamps[k],
                                          stamps[k + 1])
        dts[k], ok[k] = max(d, 1e-3), d > 1e-3
    return convert.links_from_numpy(dR, dp, dts, st[:, 12:15], st[-1, 21:24], ok, device="cpu")


def _photo(rot, pos, M=64, ps=8, seed=3):
    """Factors on a textured wall at x = 4 before a forward camera,
    targets sampled from each keyframe's own image at its true pose."""
    rng = np.random.default_rng(seed)
    cam = tcam.make_camera(CameraConfig(**CAM))
    Rci = synthetic.R_CI_FORWARD.astype(np.float32)
    v, u = np.mgrid[0:256, 0:320].astype(np.float32)
    imgs, pts, tgts, oks = [], [], [], []
    for k, (R, p) in enumerate(zip(rot, pos)):
        img = (128 + 60 * np.sin(0.11 * u + 0.05 * v + k) + 40 * np.sin(0.07 * v - 0.13 * u)
               ).astype(np.float32)
        wp = np.stack([np.full(M, 4.0), p[1] + rng.uniform(-1.2, 1.2, M),
                       p[2] + rng.uniform(-0.8, 0.8, M)], -1)
        pf = (wp - p) @ (Rci @ R.T).T
        px = tcam.world2cam(cam, torch.from_numpy(pf.astype(np.float32)))
        tgt, _, _ = img_ops.sample_patches_with_grad(torch.from_numpy(img), px,
                                                     torch.ones(M, dtype=torch.int32), ps)
        imgs.append(img)
        pts.append(wp)
        tgts.append(tgt.numpy())
        oks.append(tcam.in_frame(cam, px, 12).numpy())
    K = len(rot)
    return (np.array(imgs), np.ones(K), np.array(pts), np.array(tgts), np.array(oks),
            np.ones((K, M), np.int32)), Rci


@pytest.mark.parametrize("variant", ["plain", "links", "links_photo"])
def test_reference_matches_port(variant):
    torch.set_num_threads(2)
    w, rot, pos, stamps = _window()
    states = _states(rot, pos)
    imu = _imu(stamps)
    photo, Rci = _photo(rot, pos)
    use_l, use_p = variant != "plain", variant == "links_photo"
    got, _ = ba.refine_window(
        convert.window_from_numpy(*w, device="cpu"), tvm.VoxelMapConfig(**MAP),
        outer_iters=2, gn_iters=2,
        imu_links=_port_links(imu, stamps, states) if use_l else None,
        photo=convert.photo_from_numpy(*photo, device="cpu") if use_p else None,
        cam=tcam.make_camera(CameraConfig(**CAM)), Rci=torch.from_numpy(Rci),
        Pci=torch.zeros(3))
    win = dict(zip(refine.FLAT, (torch.from_numpy(np.asarray(a)) for a in w)))
    win["links"] = ref_ba.links(*imu, stamps, states) if use_l else None
    win["photo"] = [torch.from_numpy(np.asarray(a)) for a in photo] if use_p else None
    f = torch.float64
    want = ref_ba.refine_window(ref.Precision(False), win, REF_MAP, BACKEND,
                                vio_ref.camera(CAM), torch.from_numpy(Rci).to(f),
                                torch.zeros(3, dtype=f), dict(patch_size=8, weight=0.01))
    rot_gap, pos_gap = ref_ba.gaps(got.rot, got.pos, *want)
    assert rot_gap < TOL and pos_gap < TOL, (rot_gap, pos_gap)
    # the refinement moved the poses well beyond that
    moved = ref_ba.gaps(torch.from_numpy(w[0]), torch.from_numpy(w[1]), *want)
    assert min(moved) > 100 * TOL, moved


def test_apply_delta_matches_pipeline():
    rng = np.random.default_rng(5)
    packed = torch.from_numpy(rng.normal(size=25 + 19 * 19).astype(np.float32))
    packed[0:9] = torch.from_numpy(_exp(rng.normal(size=3)).astype(np.float32).reshape(9))
    R_d = _exp(rng.normal(size=3) * 0.01).astype(np.float32)
    p_d = (rng.normal(size=3) * 0.01).astype(np.float32)
    fake = SimpleNamespace(_put=torch.from_numpy)
    want = LIVOPipeline._apply_delta(fake, packed, R_d, p_d)
    got = check.apply_delta(packed, R_d, p_d)
    assert got.dtype == torch.float64
    assert torch.allclose(got, want.to(torch.float64), atol=2e-6, rtol=0)
    assert not torch.allclose(got[9:15], packed[9:15].to(torch.float64), atol=1e-4)


@pytest.fixture
def tiny_refine(tiny, monkeypatch):
    """`tiny` with the cell `tiny.refine_tiny`: the live_refine mix's
    backend on the tiny deployment, replayed, two windows checked."""
    bench, root = tiny
    mix = deployment.mix("live_refine")
    mix.update(mode="replay", lookahead_s=1.0, max_speedup=1.5, margin_s=1.0, warm_s=2.5,
               check_from_s=0.2, check_frames=2)
    mix["check"]["check_windows"] = 2
    with open(f"{root}/traffic/refine_tiny.json", "w") as f:
        json.dump(mix, f)
    bench["workloads"].append({"name": "tiny.refine_tiny", "config": "tiny",
                               "traffic": "refine_tiny", "chips": 1, "why": "test"})
    monkeypatch.setattr(refine, "period_s", lambda deploy, backend: 3.0)
    return bench, root


def run_refine(tiny_refine, control=False):
    bench, root = tiny_refine
    return harness.run("tiny.refine_tiny", SEED, 12.0, False, time.perf_counter(),
                       control=control, device="cpu", bench=bench, root=root)


def test_refine_cell_sound_and_control(tiny_refine):
    out, correct, compared, device, info = run_refine(tiny_refine, control=True)
    assert correct, compared
    names = {name: v for name, v, _ in compared}
    assert {"refine_rot_gap", "refine_pos_gap_m", "insert_gap_m"} <= set(names)
    assert names["refine_nonfinite_windows"] == 0
    windows = info["check"]["refine"]["windows"]
    assert len(windows) == 2 and all(w["program_links"] and w["links_used"] == 7
                                     for w in windows)
    assert info["check"]["follow_frames"]
    assert info["refiner_at_window_start"]["refused"] == info["refiner_at_window_end"]["refused"]
    lim = out.mix["check"]["limits"]
    ctl = info["control"]["readings"]
    assert ctl["refine_rot_gap"] > lim["refine_rot_gap"] \
        or ctl["refine_pos_gap_m"] > lim["refine_pos_gap_m"], ctl
    bench, root = tiny_refine
    read = {m: deployment.reader(m).read(out)
            for m in ("refine_submit_host_ms.live_refine", "refine_windows_per_s.live_refine",
                      "refine_device_ms_per_window.live_refine")}
    assert read["refine_submit_host_ms.live_refine"] > 0
    assert math.isclose(read["refine_windows_per_s.live_refine"],
                        out.refine["completed"] / out.window_s)
    assert read["refine_device_ms_per_window.live_refine"] is None  # no CUDA events here


def test_mix_without_backend_runs_no_backend_code(tiny, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("backend code ran in a cell whose mix has no backend")

    monkeypatch.setattr(refine.Watch, "__init__", refuse)
    monkeypatch.setattr(LIVOPipeline, "enable_online_refine", refuse)
    bench, root = tiny
    out, correct, compared, device, info = harness.run(
        "tiny.replay_tiny", SEED, 4.0, False, time.perf_counter(), device="cpu",
        bench=bench, root=root)
    assert correct, compared
    assert out.refine is None and "refiner_at_window_start" not in info
    assert "refine_rot_gap" not in {name for name, _, _ in compared}


def _links_dropped(monkeypatch):
    monkeypatch.setattr(LIVOPipeline, "_build_links", lambda self, kfs: None)


def _photo_dropped(monkeypatch):
    orig = ba._photo_terms

    def none(*a, **k):
        H, g = orig(*a, **k)
        return torch.zeros_like(H), torch.zeros_like(g)

    monkeypatch.setattr(ba, "_photo_terms", none)


def _refine_unchanged(monkeypatch):
    def unchanged(window, *a, **k):
        return window, torch.zeros(window.pos.shape[0], dtype=torch.int32)

    monkeypatch.setattr(ba, "refine_window", unchanged)


def _delta_ignored(monkeypatch):
    monkeypatch.setattr(check, "apply_delta", lambda packed, R_d, p_d: packed.to(torch.float64))


def _window_nan(monkeypatch):
    """The second window refined (the window's first submit: ordinal 0,
    which the draw from check_from_s never takes) comes back NaN."""
    orig, calls = ba.refine_window, []

    def nan(*a, **k):
        w, n_used = orig(*a, **k)
        calls.append(1)
        return (w._replace(pos=w.pos * float("nan")) if len(calls) == 2 else w), n_used

    monkeypatch.setattr(ba, "refine_window", nan)


@pytest.mark.parametrize("fault", [_links_dropped, _photo_dropped, _refine_unchanged,
                                   _delta_ignored, _window_nan],
                         ids=["links_dropped", "photo_dropped", "refine_unchanged",
                              "delta_ignored", "window_nan"])
def test_refine_fault_fails(tiny_refine, monkeypatch, fault):
    fault(monkeypatch)
    out, correct, compared, device, info = run_refine(tiny_refine)
    assert not correct, compared

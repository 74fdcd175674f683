"""The photometric backend cell (`avia.live_refine`) on the CPU.

- reference/ba.py's plain float64 `refine_window` against the port's on
  test_livo_bench_refine.py's window with links and photometric factors,
  under the Avia rig's pinhole distortion, with unused factor slots
  (valid false) holding stale points 4 cm before a keyframe camera's
  plane, which project beyond 1e12 px: the reference never forms an
  unused factor's terms, and the port must match it (it turned the
  window to NaN when it weighted such terms by 0 after forming them);
- the deployment `avia_refine` states, under `assumed`, the backend that
  its cell's mix (traffic/live_refine.json) turns on, and is avia's rig
  otherwise;
- the reader of `keyframe_capture_device_ms.live_refine` on a synthetic
  profile.
"""

import json
import types

import numpy as np
import pytest
import torch

import test_livo_bench_refine as base
from fast_livo2_tpu_torch.core import voxel_map as tvm
from fast_livo2_tpu_torch.io import convert
from fast_livo2_tpu_torch.models import camera as tcam
from fast_livo2_tpu_torch.parallel import ba
from fast_livo2_tpu_torch.utils.config import CameraConfig
from livo_bench.lib import deployment, refine
from livo_bench.reference import ba as ref_ba
from livo_bench.reference import lio as ref
from livo_bench.reference import vio as vio_ref

# avia's config/camera_pinhole.yaml distortion on the tests' small camera
CAM_D = dict(base.CAM, cam_d0=-0.07616, cam_d1=0.123001, cam_d2=-0.00113, cam_d3=0.000251)
STALE = np.array([5.94, 2.19, 0.04])  # camera frame (m): beyond 1e12 px


@pytest.mark.parametrize("variant", ["links_photo_unused_near_plane"])
def test_reference_matches_port(variant, monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setattr(base, "CAM", CAM_D)
    w, rot, pos, stamps = base._window()
    states = base._states(rot, pos)
    imu = base._imu(stamps)
    photo, Rci = base._photo(rot, pos)
    cam = tcam.make_camera(CameraConfig(**CAM_D))
    assert tcam.world2cam(cam, torch.tensor(STALE[None], dtype=torch.float32)).abs().max() > 1e12
    photo = [np.array(a) for a in photo]
    k, slots = 1, slice(0, 8)
    Rcw = Rci.astype(np.float64) @ w[0][k].astype(np.float64).T
    photo[4][k, slots] = False
    photo[2][k, slots] = STALE @ Rcw + w[1][k]  # p_w = Rcw^T p_cam + pos
    got, _ = ba.refine_window(
        convert.window_from_numpy(*w, device="cpu"), tvm.VoxelMapConfig(**base.MAP),
        outer_iters=2, gn_iters=2, imu_links=base._port_links(imu, stamps, states),
        photo=convert.photo_from_numpy(*photo, device="cpu"), cam=cam,
        Rci=torch.from_numpy(Rci), Pci=torch.zeros(3))
    assert torch.isfinite(got.rot).all() and torch.isfinite(got.pos).all()
    win = dict(zip(refine.FLAT, (torch.from_numpy(np.asarray(a)) for a in w)))
    win["links"] = ref_ba.links(*imu, stamps, states)
    win["photo"] = [torch.from_numpy(a) for a in photo]
    f = torch.float64
    want = ref_ba.refine_window(ref.Precision(False), win, base.REF_MAP, base.BACKEND,
                                vio_ref.camera(CAM_D), torch.from_numpy(Rci).to(f),
                                torch.zeros(3, dtype=f), dict(patch_size=8, weight=0.01))
    rot_gap, pos_gap = ref_ba.gaps(got.rot, got.pos, *want)
    assert rot_gap < base.TOL and pos_gap < base.TOL, (rot_gap, pos_gap)
    moved = ref_ba.gaps(torch.from_numpy(w[0]), torch.from_numpy(w[1]), *want)
    assert min(moved) > 100 * base.TOL, moved


def test_avia_refine_states_its_mix_backend():
    bench = deployment.benchmark()
    cell = deployment.cell(bench, "avia.live_refine")
    got = deployment.deployment(bench, cell["config"])
    mix = deployment.mix(cell["traffic"])
    assert got["assumed"]["backend"] == mix["backend"]
    avia = deployment._json("configs", "avia")
    for key in ("slam_mode", "reduced", "scene", "rig", "reference", "sensor", "camera",
                "check"):
        assert got[key] == avia[key], key
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    assert entry["reduced"] == got["reduced"] and cell["chips"] == 1


def test_keyframe_capture_reader():
    read = deployment.reader("keyframe_capture_device_ms.live_refine").read
    kernels = [("keyframe_capture", 1.0, 1.0015), ("k", 1.0, 1.001),
               ("keyframe_capture", 2.0, 2.0025), ("keyframe_capture_x", 3.0, 3.1)]
    run = types.SimpleNamespace(profile={"kernels": kernels})
    assert read(run) == pytest.approx(2.0)
    run.profile = {"kernels": kernels[1:2]}
    assert read(run) is None
    run.profile = None
    assert read(run) is None
    json.dumps(read(types.SimpleNamespace(profile={"kernels": kernels[:1]})))

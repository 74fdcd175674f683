"""The check that decides `correct`, on a cell made of new files alone,
run on the CPU: a sound run passes at the benchmark's limits, the
control (the plain reference in TF32 put in the program's place) fails,
and so does the run with its timed path broken underneath, for each
fault the cells can have: a frame that leaves its state unchanged, half
the scan left out, a LIO pose moved where it is produced, the
photometric iteration (K2) returning nothing, so that VIO never moves
the pose."""

import time

import pytest
import torch

from fast_livo2_tpu_torch.core import lio as lio_mod
from fast_livo2_tpu_torch.ops import photo_iteration as photo_mod
from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from livo_bench.lib import check, deployment, harness

SEED = 2 ** 31 + 12345


def run_tiny(tiny, control=False, seconds=6.0):
    bench, root = tiny
    return harness.run("tiny.replay_tiny", SEED, seconds, False, time.perf_counter(),
                       control=control, device="cpu", bench=bench, root=root)


def test_sound_run_and_control(tiny):
    out, correct, compared, device, info = run_tiny(tiny, control=True)
    assert correct, compared
    assert info["check"]["step_frames"] == 2
    # the checked frames' VIO tracked points, as many on both sides
    assert all(a == b > 20 for a, b in info["check"]["tracked_program_reference"])
    reader = deployment.reader("frames_run.tiny", tiny[1])
    assert reader.read(out) == len(out.frames) > 2
    ok, rows = check.judge(info["control"]["readings"], out.deploy["check"]["limits"])
    assert not ok, rows


def _state_unchanged(monkeypatch):
    orig = LIVOPipeline._fused_frame

    def frozen(self, *a):
        keep = (self.packed.clone(), [t.clone() for t in self.vmap_state])
        res = orig(self, *a)
        self.packed.copy_(keep[0])
        for dst, src in zip(self.vmap_state, keep[1]):
            dst.copy_(src)
        return res

    monkeypatch.setattr(LIVOPipeline, "_fused_frame", frozen)


def _half_the_points(monkeypatch):
    orig = LIVOPipeline._unpack_pts

    def half(self, pack):
        pts, t, valid = orig(self, pack)
        keep = torch.arange(valid.shape[0], device=valid.device) % 2 == 0
        return pts, t, valid & keep

    monkeypatch.setattr(LIVOPipeline, "_unpack_pts", half)


def _pose_altered(monkeypatch):
    orig = lio_mod.lio_update

    def moved(*a, **k):
        r = orig(*a, **k)
        st = r.state._replace(pos=r.state.pos + 0.01)
        return r._replace(state=st, pts_w=r.pts_w + 0.01)

    monkeypatch.setattr(lio_mod, "lio_update", moved)


def _k2_zeroed(monkeypatch):
    orig = photo_mod.photo_iteration

    def zero(*a, **k):
        return tuple(torch.zeros_like(x) for x in orig(*a, **k))

    monkeypatch.setattr(photo_mod, "photo_iteration", zero)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_points, _pose_altered,
                                   _k2_zeroed],
                         ids=["state_unchanged", "half_the_points", "pose_altered",
                              "k2_zeroed"])
def test_fault_fails(tiny, monkeypatch, fault):
    fault(monkeypatch)
    out, correct, compared, device, info = run_tiny(tiny)
    assert not correct, compared

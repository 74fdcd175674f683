"""The online backend in a cell whose mix has a `backend` object: the
pipeline's OnlineRefiner watched through its `submit` and `poll`, and
the windows it refined judged against the plain reference
(reference/ba.py) once the run's window has closed.

- `Watch` wraps the refiner's `submit` and `poll` on the instance (a
  mix without `backend` builds none). While the measured window is
  open it counts the refused submits, the windows completed and those
  whose refined poses are not all finite (every window, from the poll's
  own host arrays: a pose that is not finite is wrong whatever the
  reference says). For `check_windows` windows drawn from the seed it
  queues pinned host copies of the submitted inputs on the submitting
  stream (the keyframes' poses, scans and valid masks, their filter
  states, the photometric factors) and keeps the refined rotations and
  positions that `poll` hands back. The draw: ordinals of the windows
  submitted in the window, among those a live run submits from
  `check_from_s` to the window's last second (one a submit period of
  sensor time; a replay on the card submits faster).
- `judge` refines each kept window with the reference (float64) or, as
  the control, the reference in TF32 put in the program's place, and
  reads the widest rotation and position gap over its keyframes.
"""

import math

import numpy as np
import torch

from ..reference import ba as ref_ba
from ..reference import lio as ref
from ..reference import vio as vio_ref
from . import check
from .generator import LIDAR_HZ

FLAT = ("rot", "pos", "scans", "valid")


def period_s(deploy: dict, backend: dict) -> float:
    """Sensor seconds between two submits: `stride` keyframes of
    `keyframe_every` frames at the deployment's frame rate (a LIVO frame
    an image kept, else a scan)."""
    rig = deploy["rig"]
    hz = (rig["img_hz"] / rig.get("img_keep_every", 1)
          if deploy["slam_mode"] == "livo" else LIDAR_HZ)
    return backend["keyframe_every"] * backend["stride"] / hz


def draw_ordinals(rng, n: int, lo: float, hi: float, period: float):
    """n ordinals (0: the window's first submit) of the windows submitted
    from `lo` to `hi` seconds into the window."""
    first, last = math.ceil(lo / period), math.floor(hi / period)
    if last - first < n:
        raise ValueError(f"the window submits {last - first} windows from check_from_s, "
                         f"fewer than check_windows {n}")
    return set(rng.choice(np.arange(first, last), size=n, replace=False).tolist())


class Watch:
    """The refiner's submits and polls, seen from outside (see the module
    docstring)."""

    def __init__(self, refiner, drawn):
        self.refiner = refiner
        self.drawn = set(drawn)
        self.open = False  # the measured window is
        self.bufs = []  # pinned buffer sets, made at the first submit
        self.kept = []  # {"stamps", host copies, "rot", "pos"} a drawn window
        self.ordinal = 0  # successful submits in the window
        self.pending = None  # the kept entry whose window is in flight
        self.refused = 0
        self.completed = 0  # windows polled back while the window was open
        self.nonfinite = 0  # of those, with a refined pose not finite
        self.fed_back = None  # a kept window just polled back: its delta follows
        self._submit, self._poll = refiner.submit, refiner.poll
        refiner.submit, refiner.poll = self.submit, self.poll

    def _buffers(self, tensors):
        pin = tensors[0].is_cuda
        return [[torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for t in tensors]
                for _ in range(len(self.drawn))]

    def submit(self, window, meta=None, links=None, photo=None):
        ok = self._submit(window, meta=meta, links=links, photo=photo)
        if not ok:
            self.refused += self.open
            return ok
        take = self.open and self.ordinal in self.drawn
        self.ordinal += self.open
        if take or (not self.bufs and self.drawn):
            src = list(window) + [torch.stack([kf[1][0:25] for kf in meta])]
            src += list(photo) if photo is not None else []
            if not self.bufs:
                self.bufs = self._buffers(src)
        if take:
            dst = self.bufs.pop()
            for d, s in zip(dst, src):
                d.copy_(s, non_blocking=True)
            self.pending = dict(ordinal=self.ordinal - 1, stamps=[float(kf[0]) for kf in meta],
                                win=dict(zip(FLAT, dst[0:4])), states=dst[4],
                                photo=dst[5:] if photo is not None else None,
                                links=links is not None)
            self.kept.append(self.pending)
        else:
            self.pending = None
        return ok

    def poll(self, force: bool = False):
        out = self._poll(force)
        if out is None:
            return out
        self.completed += self.open
        self.nonfinite += self.open and not (np.isfinite(out[1]).all()
                                             and np.isfinite(out[2]).all())
        if self.pending is not None:
            self.pending["rot"], self.pending["pos"] = out[1].copy(), out[2].copy()
            self.fed_back = self.pending
            self.pending = None
        return out

    def marks(self):
        """How many submits and completed windows the refiner has timed."""
        return len(self.refiner.submit_ms), len(self.refiner.device_ms)

    def finish(self):
        """Wait for a drawn window still in flight, and let the refiner
        go: the kept windows."""
        if self.pending is not None:
            self.poll(force=True)
        self.refiner.submit, self.refiner.poll = self._submit, self._poll
        self.refiner = self._submit = self._poll = None
        return self.kept


def judge(kept, rec, deploy, backend, device, control, want):
    """The readings {refine_rot_gap, refine_pos_gap_m} at the second-worst
    judged window (None where fewer than `want` came back), the
    control's (with `control`, else None), and each window's gaps."""
    sensor = deploy["sensor"]
    cfg = ref.map_cfg(sensor)
    cam = vio_ref.camera(deploy["camera"])
    Rci, Pci = check.extrinsics(sensor, torch.float64, device)[2:]
    photo_cfg = dict(patch_size=int(ref.setting(sensor, "vio.patch_size")),
                     weight=1.0 / float(ref.setting(sensor, "vio.img_point_cov")))
    gaps = {"program": [], "control": []}
    rows = []
    for k in kept:
        if "rot" not in k or (backend.get("photo") and k["photo"] is None):
            continue  # never came back, or came without its factors
        win = {n: t.to(device) for n, t in k["win"].items()}
        win["links"] = ref_ba.links(rec.imu_t, rec.imu_gyr, rec.imu_acc, k["stamps"],
                                    k["states"].numpy().astype(np.float64))
        win["photo"] = ([t.to(device) for t in k["photo"]]
                        if backend.get("photo") else None)

        def refined(P):
            return [x.cpu() for x in ref_ba.refine_window(
                P, win, cfg, backend, cam, Rci.to(P.dtype), Pci.to(P.dtype), photo_cfg)]

        want_rot, want_pos = refined(ref.Precision(False))
        row = {"ordinal": k["ordinal"], "links_used": int(win["links"]["ok"].sum()),
               "program_links": k["links"]}
        sides = {"program": (torch.from_numpy(k["rot"]), torch.from_numpy(k["pos"]))}
        if control:
            sides["control"] = refined(ref.Precision(True))
        for side, (rot, pos) in sides.items():
            dr, dp = ref_ba.keyframe_gaps(rot, pos, want_rot, want_pos)
            gaps[side].append((max(dr), max(dp)))
            row[side] = gaps[side][-1]
            row[side + "_keyframes"] = [dr, dp]
        rows.append(row)

    def readings(g):
        g = g + [(None, None)] * max(want - len(g), 0)
        return {"refine_rot_gap": check.second_worst([x[0] for x in g]),
                "refine_pos_gap_m": check.second_worst([x[1] for x in g])}

    return (readings(gaps["program"]), readings(gaps["control"]) if control else None,
            {"windows": rows})

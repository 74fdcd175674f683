"""The one runner of every traffic mix: a recording pushed into the
pipeline through its streaming entry (`push_imu`, `push_scan`,
`push_image`, `poll`), one frame a `poll(max_frames=1)`.

- `live` (open loop): each packet is pushed when its stamp comes due on
  the wall clock (sensor time mapped 1:1), every ready frame is run at
  once and its pose copied to the host. A frame's latency runs from the
  moment its last required input was due (not when it was pushed, so a
  late push counts) to its pose on the host.
- `replay` (closed loop): a feeder keeps `lookahead_s` of sensor time
  pushed beyond the last frame, as a bag reader would, and frames run
  back to back with no synchronize of the benchmark's own between
  them; the window closes with one.

The clock is an object so that the tests can drive a fake one.
"""

import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

IMU, SCAN, IMAGE = 0, 1, 2


class Clock:
    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, s: float):
        if s > 0:
            time.sleep(s)


@dataclass
class Spans:
    """Host spans (name, start, end) in the clock's seconds, and the
    profiler's range for each when one is given."""

    rows: list = field(default_factory=list)
    ranges: Optional[Callable] = None  # name -> context manager

    @contextmanager
    def span(self, name, clock):
        t0 = clock.now()
        if self.ranges is None:
            yield
        else:
            with self.ranges(name):
                yield
        self.rows.append((name, t0, clock.now()))


class Feed:
    """A recording as pushes ordered by due time: an IMU sample at its
    stamp, a scan at the end of its period, an image at its stamp."""

    def __init__(self, rec, scan_period: float, exposure: float):
        # three arrays, not a list of tuples: the feed adds no objects
        # for the interpreter's collector to walk during the window
        due = np.concatenate([np.asarray(rec.imu_t, np.float64),
                              np.array([tb + scan_period for tb, _, _ in rec.scans]),
                              np.array([t for t, _ in rec.images], np.float64)])
        kind = np.concatenate([np.full(len(rec.imu_t), IMU), np.full(len(rec.scans), SCAN),
                               np.full(len(rec.images), IMAGE)])
        idx = np.concatenate([np.arange(len(rec.imu_t)), np.arange(len(rec.scans)),
                              np.arange(len(rec.images))])
        order = np.lexsort((idx, kind, due))
        self.due, self.kind, self.idx = due[order], kind[order], idx[order]
        self.rec = rec
        self.cursor = 0
        # the pipeline's LIVO event of each image, and when it can run:
        # the image, an IMU sample past it and LiDAR covering it are in
        self.event_t = np.array([t + exposure for t, _ in rec.images])
        horizon = np.array([tb + (float(o.max()) if len(o) else 0.0)
                            for tb, _, o in rec.scans])
        scan_due = np.array([tb + scan_period for tb, _, _ in rec.scans])
        cover = np.maximum.accumulate(horizon)
        self.ready_due = {}
        for i, te in enumerate(self.event_t):
            j = int(np.searchsorted(cover, te, side="left"))
            k = int(np.searchsorted(rec.imu_t, te, side="right"))
            if j < len(cover) and k < len(rec.imu_t):
                self.ready_due[float(te)] = max(rec.images[i][0], scan_due[j],
                                                float(rec.imu_t[k]))

    def push_until(self, pipe, due: float, late=None, now=None):
        """Push every item due at or before `due`; with `late`, append how
        late each push ran (now - the item's due, in sensor seconds)."""
        n, r = len(self.due), self.rec
        while self.cursor < n and self.due[self.cursor] <= due:
            c = self.cursor
            kind, i = self.kind[c], int(self.idx[c])
            if kind == IMU:
                pipe.push_imu(r.imu_t[i:i + 1], r.imu_gyr[i:i + 1], r.imu_acc[i:i + 1])
            elif kind == SCAN:
                tb, p, o = r.scans[i]
                pipe.push_scan(tb, p, o)
            else:
                pipe.push_image(*r.images[i])
            if late is not None:
                late.append(now() - float(self.due[c]))
            self.cursor += 1

    @property
    def done(self):
        return self.cursor >= len(self.due)

    def next_due(self):
        return float(self.due[self.cursor])


@dataclass
class Frame:
    t_ev: float
    host_ms: float  # the poll that ran it, before any synchronize
    syncs: int  # synchronizing CUDA calls inside that poll (trace runs)
    due: float = float("nan")  # clock time its last input was due (live)
    out: float = float("nan")  # clock time its pose reached the host (live),
    # or its poll returned (replay)


class Runner:
    """Runs frames of one pipeline from a Feed. `after_frame(pipe, j)` is
    called after each frame's poll (j: its trajectory row)."""

    def __init__(self, pipe, feed: Feed, clock: Clock, spans: Spans,
                 count_syncs: bool = False, after_frame=None,
                 read_pose=None):
        self.pipe, self.feed, self.clock, self.spans = pipe, feed, clock, spans
        self.count_syncs = count_syncs
        self.after_frame = after_frame or (lambda pipe, j: None)
        self.read_pose = read_pose or (lambda row: None)
        self.late: List[float] = []
        self.cut = False  # a replay window that the recording's end cut

    def _poll_one(self):
        """One poll(max_frames=1): (frames run, host ms, syncs)."""
        c = self.clock
        t0 = c.now()
        if not self.count_syncs:
            with self.spans.span("poll", c):
                n = self.pipe.poll(max_frames=1)
            return n, (c.now() - t0) * 1e3, 0
        import torch

        with self.spans.span("poll", c):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    n = self.pipe.poll(max_frames=1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
        return n, (c.now() - t0) * 1e3, syncs

    def run_ready(self, frames: Optional[list], wall=None, most=None):
        """Run the frames that are ready (at most `most`), one poll each;
        with `wall` (sensor time -> clock time) read each pose to the host
        and time it from its due."""
        done = 0
        while most is None or done < most:
            n, host_ms, syncs = self._poll_one()
            if not n:
                return
            done += 1
            j = len(self.pipe.trajectory) - 1
            t_ev = self.pipe.trajectory[j][0]
            fr = Frame(t_ev, host_ms, syncs)
            if wall is not None:
                with self.spans.span("pose_read", self.clock):
                    self.read_pose(self.pipe.trajectory[j])
                fr.out = self.clock.now()
                fr.due = wall(self.feed.ready_due.get(float(t_ev), float("nan")))
            else:
                fr.out = self.clock.now()
            self.after_frame(self.pipe, j)
            if frames is not None:
                frames.append(fr)

    def warm(self, until: float):
        """Push and run everything due by sensor time `until` as fast as
        it goes (set-up: IMU init, the map frame, the capture)."""
        while not self.feed.done and self.feed.next_due() <= until:
            self.feed.push_until(self.pipe, min(self.feed.next_due() + 0.05, until))
            self.run_ready(None)

    def live(self, t_sensor0: float, seconds: float) -> List[Frame]:
        """The open loop from sensor time t_sensor0 for `seconds`; frames
        whose last input is due inside it."""
        c = self.clock
        wall0 = c.now()

        def wall(t):
            return wall0 + (t - t_sensor0)

        frames: List[Frame] = []
        end = t_sensor0 + seconds
        nxt_end = np.nextafter(end, -np.inf)  # nothing due at the end is pushed
        while True:
            if self.feed.done:
                raise RuntimeError("the recording ended inside the live window")
            nxt = self.feed.next_due()
            if nxt >= end:
                break
            wait = wall(nxt) - c.now()
            if wait > 0:
                with self.spans.span("sleep", c):
                    c.sleep(wait)
            with self.spans.span("push", c):
                # after the sleep, `nxt` is due even where the clock's
                # rounding puts "now" an ulp short of it
                now_s = max(t_sensor0 + (c.now() - wall0), nxt)
                self.feed.push_until(self.pipe, min(now_s, nxt_end),
                                     self.late, lambda: c.now() - wall0 + t_sensor0)
            self.run_ready(frames, wall)
        return frames

    def replay(self, seconds: float, lookahead: float, max_frames=None):
        """The closed loop for `seconds` (or `max_frames`): (frames, clock
        seconds from the start to the synchronize that closes the
        window)."""
        import torch

        c = self.clock
        t0 = c.now()
        frames: List[Frame] = []
        while c.now() - t0 < seconds and (max_frames is None or len(frames) < max_frames):
            with self.spans.span("push", c):
                self.feed.push_until(self.pipe, self.pipe.last_update_time + lookahead)
            before = len(frames)
            self.run_ready(frames, most=1)
            if len(frames) == before and self.feed.done:
                self.cut = True  # the recording ran out: the window ends here
                break
        with self.spans.span("close", c):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        return frames, c.now() - t0

"""Per-frame stage timing and the frame tracer: `StageClock` marks one
frame's stages on the device, `FrameTracer` (LIVOPipeline.enable_tracing)
adds the host spans of each poll, and `StageTable` renders the tables
(the PyTorch port's own copy of `StageTable` from
fast_livo2_tpu/utils/timing.py); `device_trace` and `annotate` are the
profiler hooks.

The reference prints per-frame ANSI box tables of stage wall-times
(LIO: DownSample/ICP/updateVoxelMap, LIVMapper.cpp:465-476; VIO stage
table, vio.cpp:1851-1868) with running averages. `StageTable` collects
rows (`mark`, `end_frame`) and renders the same style of table on
demand. The JAX module's `stage` timer and `averages` have no caller
here and are left out. Its `device_trace` and `annotate` wrap
jax.profiler; here they wrap torch.profiler (and NVTX on a card), and
the pipeline's stages run inside `annotate` ranges, so a trace shows
them by name. While a StageClock is active, each `annotate` range is
also a span of that clock, bounded by mark kernels (csrc/stage_mark.cu)
that a CUDA graph captures like any other kernel: a replayed frame
shows its stage ranges too.
"""

import contextlib
import contextvars
import ctypes
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

# The staged frame's stages, in order (the JAX package's
# _run_frame_staged, fast_livo2_tpu/core/pipeline.py:561-598).
STAGES = ("propagate", "undistort", "downsample", "lio", "map", "vio")
# The most stage bounds one frame marks (kSlots of csrc/stage_mark.cu).
SLOTS = 64
# A range outside the frame: the keyframe's photometric capture for the
# online backend, replayed after the frame graph (core/frame_graph.py). It
# is an `annotate` range (a device range in a profile) and, with the
# tracer on, a host span of the poll.
KEYFRAME_CAPTURE = "keyframe_capture"

_ACTIVE = contextvars.ContextVar("stage_clock", default=None)
_fns = {}


def _entry(symbol: str, argtypes):
    """Entry point `symbol` of csrc/stage_mark.cu, built and loaded at its
    first call (never while tracing is off)."""
    fn = _fns.get(symbol)
    if fn is None:
        from ..ops import _launch

        fn = _fns[symbol] = _launch.load("stage_mark", symbol, argtypes)
    return fn


def _mark_kernel(marks: torch.Tensor, slot: int):
    """Launch the mark of `slot` into the int64 device buffer `marks`, on
    the current stream."""
    from ..ops import _launch

    dev = marks.get_device()
    # marks, slot, device, stream
    err = _entry("stage_mark_launch", [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p])(
        marks.data_ptr(), slot, dev, _launch.raw_stream(dev))
    if err:
        _launch.fail("stage_mark", err)


def graph_kernel_nodes(graph: Optional[int] = None, device: int = 0) -> int:
    """Kernel nodes of a cudaGraph_t (an int, as CUDAGraph.raw_cuda_graph()
    gives it), or with `graph` None, of the graph that the current stream
    of CUDA device `device` captures into (-1 where it captures none)."""
    from ..ops import _launch

    n = ctypes.c_longlong(0)
    if graph is None:
        err = _entry("capture_kernel_nodes", [ctypes.c_void_p,
                                              ctypes.c_void_p])(
            _launch.raw_stream(device), ctypes.byref(n))
    else:
        err = _entry("graph_kernel_nodes", [ctypes.c_void_p,
                                            ctypes.c_void_p])(
            graph, ctypes.byref(n))
    if err:
        _launch.fail("graph_kernel_nodes", err)
    return n.value


def stage_paths(spans) -> List[str]:
    """Each span's path: its ancestors' names and its own, joined by "/"."""
    paths: List[str] = []
    for name, parent, *_ in spans:
        paths.append(name if parent < 0 else f"{paths[parent]}/{name}")
    return paths


def by_stage(spans, before, end, per_mark: int) -> Dict[str, np.ndarray]:
    """Split counts read at a frame's marks over its stages. `before[s]` is
    the count just before mark s, `end` the count after the last mark.
    What was added between mark s and the next (less `per_mark`, the mark's
    own share) goes to the path of the innermost span open there; what was
    added before the first mark, or while no span was open, to "other".
    Returns {path: count} (numpy, as `before`'s rows), zeros left out."""
    before = np.asarray(before)
    after = np.concatenate([before[1:], np.asarray(end)[None]])
    paths = stage_paths(spans)
    out = {"other": before[0].copy()}
    for s in range(len(before)):
        key = "other"
        for path, (_, _, b, e) in zip(paths, spans):
            if b <= s < e:
                key = path  # spans open in order: the last is innermost
        out[key] = out.get(key, 0) + after[s] - before[s] - per_mark
    return {k: v for k, v in out.items() if np.any(v)}


def stage_times(spans, marks: np.ndarray):
    """One frame's stage times from its marks (ns, on the host): the
    columns {f"{name}_ms": ms, summed over the frame's spans of that name}
    and the timed spans [(name, parent, begin slot, end slot, begin ms,
    end ms)], in ms from the frame's first mark."""
    t0 = int(marks[0])
    timed = [(n, p, b, e, (int(marks[b]) - t0) * 1e-6,
              (int(marks[e]) - t0) * 1e-6) for n, p, b, e in spans]
    cols: Dict[str, float] = {}
    for n, _, _, _, a, z in timed:
        cols[f"{n}_ms"] = cols.get(f"{n}_ms", 0.0) + (z - a)
    return cols, timed


class StageClock:
    """The stage spans of one frame. Active inside `with clock:`, where
    every `annotate` range opens a span: a mark on entry and one on exit,
    its parent the innermost span open. On a CUDA device a mark is a
    one-thread kernel (csrc/stage_mark.cu) that writes the card's
    %globaltimer (ns) into its slot of `marks`, a device buffer: it runs
    in stream order with the frame's kernels, a CUDA graph captures it and
    every replay writes it again, and nothing waits for it. On the CPU a
    mark is a perf_counter_ns reading (the ops run as they are called),
    and `marks` is filled when the clock closes. Spans are (name, parent
    index or -1, begin slot, end slot).

    Under a graph capture each mark also reads the kernel nodes the graph
    holds and the counts of `counters` (a callable returning a tuple of
    launch counts), which `kernel_nodes_by_stage` and `launches_by_stage`
    split over the stages."""

    def __init__(self, device, counters=None):
        device = torch.device(device)
        self.marks = (torch.empty(SLOTS, dtype=torch.int64, device=device)
                      if device.type == "cuda" else None)
        self.spans: List[list] = []
        self._open: List[int] = []
        self._host: List[int] = []
        self._n = 0
        self._counters = counters or tuple
        self._captured: List[tuple] = []  # at each mark: (nodes, *counts)
        self._captured_end = None
        self._token = None

    def _capture_read(self):
        return (graph_kernel_nodes(device=self.marks.get_device()),
                *self._counters())

    def _mark(self) -> int:
        s = self._n
        if s == SLOTS:
            raise RuntimeError(f"StageClock: more than {SLOTS} stage bounds "
                               "in one frame")
        self._n = s + 1
        if self.marks is None:
            self._host.append(time.perf_counter_ns())
        else:
            if torch.cuda.is_current_stream_capturing():
                self._captured.append(self._capture_read())
            _mark_kernel(self.marks, s)
        return s

    def begin(self, name: str):
        self._open.append(len(self.spans))
        self.spans.append([name, self._open[-2] if len(self._open) > 1
                           else -1, self._mark(), -1])

    def end(self):
        self.spans[self._open.pop()][3] = self._mark()

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        self.spans = [tuple(s) for s in self.spans]
        if self.marks is None:
            self.marks = torch.tensor(
                self._host + [0] * (SLOTS - len(self._host)),
                dtype=torch.int64)
        elif self._captured:
            self._captured_end = self._capture_read()

    def kernel_nodes_by_stage(self) -> Optional[Dict[str, int]]:
        """{stage path: kernel nodes} of the graph this clock was captured
        into, the marks' own nodes left out ("other": outside every span);
        None where the clock ran outside a capture."""
        if self._captured_end is None:
            return None
        c = np.asarray(self._captured)
        return {k: int(v) for k, v in by_stage(
            self.spans, c[:, 0], self._captured_end[0], 1).items()}

    def launches_by_stage(self) -> Optional[Dict[str, tuple]]:
        """{stage path: the `counters` launches it made} under the capture
        (as kernel_nodes_by_stage), or None."""
        if self._captured_end is None or len(self._captured_end) == 1:
            return None
        c = np.asarray(self._captured)[:, 1:]
        c0 = c[0]  # the counts before the frame (its first mark is first)
        return {k: tuple(int(x) for x in v) for k, v in by_stage(
            self.spans, c - c0, np.asarray(self._captured_end[1:]) - c0,
            0).items()}


class FrameTracer:
    """The tracer of one pipeline (LIVOPipeline.enable_tracing): a
    StageClock for each frame's device stages (`clock`), and the host
    spans of each frame's poll in `spans`: (trajectory row, name, parent,
    start s, end s) read with time.perf_counter, the clock of the
    benchmark's own spans. Kept in memory; read after the run."""

    def __init__(self, device, counters=None):
        self.device = torch.device(device)
        self.counters = counters
        self.spans: List[tuple] = []
        self.row = -1  # the trajectory row of the frame being run

    def clock(self) -> StageClock:
        return StageClock(self.device, self.counters)

    def host(self, name: str, t0: float):
        """Close the host span `name` that began at perf_counter `t0`,
        inside the frame's own span ("frame", parent None)."""
        self.spans.append((self.row, name, "frame", t0, time.perf_counter()))


class StageTable:
    """Collect named stage durations per frame; render running-average
    tables in the reference's box style."""

    def __init__(self, title: str):
        self.title = title
        self.rows: List[Dict[str, float]] = []
        self._current: Dict[str, float] = {}

    def mark(self, name: str, seconds: float):
        self._current[name] = self._current.get(name, 0.0) + seconds

    def end_frame(self):
        self.rows.append(self._current)
        self._current = {}

    def render(self, last_n: Optional[int] = None) -> str:
        rows = self.rows[-last_n:] if last_n else self.rows
        if not rows:
            return f"[{self.title}] no frames"
        keys = sorted({k for r in rows for k in r})
        width = 63
        bar = "+" + "-" * (width - 2) + "+"
        out = [bar, f"| {self.title:^{width - 4}} |", bar,
               f"| {'Stage':29} | {'avg (ms)':>12} | {'last (ms)':>12} |", bar]
        for k in keys:
            avg = np.mean([r.get(k, 0.0) for r in rows]) * 1e3
            last = rows[-1].get(k, 0.0) * 1e3
            out.append(f"| {k:29} | {avg:12.2f} | {last:12.2f} |")
        total_avg = np.mean([sum(r.values()) for r in rows]) * 1e3
        out += [bar, f"| {'Total':29} | {total_avg:12.2f} | "
                     f"{sum(rows[-1].values()) * 1e3:12.2f} |", bar]
        return "\n".join(out)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile a block with torch.profiler (CPU activity, and CUDA
    activity when a card is available) and write its Chrome trace into
    `log_dir` as trace.json. Yields the profiler, whose key_averages()
    the caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range inside a device trace: a torch.profiler
    record_function, inside an NVTX range when CUDA is available (host
    calls, which record nothing into a CUDA graph), and, while a StageClock
    is active, a span of that clock: its marks are kernels, so a captured
    and replayed frame shows the range too."""
    clock = _ACTIVE.get()
    nvtx = (torch.cuda.nvtx.range(name) if torch.cuda.is_available()
            else contextlib.nullcontext())
    with nvtx, torch.profiler.record_function(name):
        if clock is None:
            yield
        else:
            clock.begin(name)
            yield
            clock.end()

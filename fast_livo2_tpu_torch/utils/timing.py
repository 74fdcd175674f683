"""Per-frame stage timing: `StageClock` times a frame's stages
(tpu.stage_timing) and `StageTable` renders the tables (the PyTorch
port's own copy of `StageTable` from fast_livo2_tpu/utils/timing.py);
`device_trace` and `annotate` are the profiler hooks.

The reference prints per-frame ANSI box tables of stage wall-times
(LIO: DownSample/ICP/updateVoxelMap, LIVMapper.cpp:465-476; VIO stage
table, vio.cpp:1851-1868) with running averages. `StageTable` collects
rows (`mark`, `end_frame`) and renders the same style of table on
demand. The JAX module's `stage` timer and `averages` have no caller
here and are left out. Its `device_trace` and `annotate` wrap
jax.profiler; here they wrap torch.profiler (and NVTX on a card), and
the pipeline's six stages (`STAGES`) run inside `annotate` ranges, so a
trace of a split or staged frame shows them by name.
"""

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

# The staged frame's stages, in order (the JAX package's
# _run_frame_staged, fast_livo2_tpu/core/pipeline.py:561-598).
STAGES = ("propagate", "undistort", "downsample", "lio", "map", "vio")


class StageClock:
    """Times consecutive stages of one frame. On a CUDA device each bound
    is a CUDA event recorded on the current stream, and `read` waits for
    the last one once and returns the device time between bounds: the
    span of the stage's work on the device timeline, gaps while the
    device waits for the host's launches included. On the CPU each bound
    is a perf_counter reading (the ops run as they are called)."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._names: List[str] = []
        self._bounds = [self._now()]

    def _now(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def lap(self, name: str):
        """Close the stage `name` (it began at the previous bound)."""
        self._names.append(name)
        self._bounds.append(self._now())

    def read(self) -> Dict[str, float]:
        """{f"{name}_ms": milliseconds} of every closed stage."""
        b = self._bounds
        if self._cuda:
            b[-1].synchronize()
            ms = [b[i].elapsed_time(b[i + 1]) for i in range(len(b) - 1)]
        else:
            ms = [(b[i + 1] - b[i]) * 1e3 for i in range(len(b) - 1)]
        return {f"{n}_ms": t for n, t in zip(self._names, ms)}


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
    record_function, inside an NVTX range when CUDA is available. Both
    are host calls: inside a CUDA graph capture they record nothing into
    the graph, so a replayed frame shows no stage ranges."""
    nvtx = (torch.cuda.nvtx.range(name) if torch.cuda.is_available()
            else contextlib.nullcontext())
    with nvtx, torch.profiler.record_function(name):
        yield

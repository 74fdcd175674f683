"""Per-frame stage timing tables (the PyTorch port's own copy of
`StageTable` from fast_livo2_tpu/utils/timing.py).

The reference prints per-frame ANSI box tables of stage wall-times
(LIO: DownSample/ICP/updateVoxelMap, LIVMapper.cpp:465-476; VIO stage
table, vio.cpp:1851-1868) with running averages. `StageTable` collects
rows (`mark`, `end_frame`) and renders the same style of table on
demand. The JAX module's `stage` timer and `averages` have no caller
here and are left out; its `device_trace` and `annotate` wrap
jax.profiler, and `torch.profiler` takes their place where a trace is
wanted (chip_smoke.py's profile phases).
"""

from typing import Dict, List, Optional

import numpy as np


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

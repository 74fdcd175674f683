"""Interleaved multi-stream replay (port of
fast_livo2_tpu/parallel/batch.py): B independent sequences on one card,
or placed across cards.

The causal filter cannot batch across time, but a mapping fleet
processes many independent sequences. B LIVOPipelines, each with its own
map, pool and ring, run frames round-robin: the host prepares stream
b+1's frame while the card runs stream b's, since nothing in a frame
waits for the card (a fused pipeline replays its own captured graph).
Device memory is the only per-stream cost.
"""

import time
from typing import List, Optional

import torch

from ..core.pipeline import LIVOPipeline
from ..utils.config import LIVOConfig


class MultiStreamReplay:
    """B independent pipelines; stream b runs on devices[b % len(devices)]
    (default "cuda"), so one list places the fleet on one card or across
    cards."""

    def __init__(self, cfg: LIVOConfig, batch: int, slam_mode: str = "livo",
                 devices: Optional[List] = None):
        devices = [torch.device(d) for d in (devices or ["cuda"])]
        n_cuda = torch.cuda.device_count()
        for d in devices:
            if d.type == "cuda" and (d.index or 0) >= n_cuda:
                raise ValueError(f"stream placement on {d}: this machine has "
                                 f"{n_cuda} CUDA device(s)")
        self.B = batch
        self.cfg = cfg
        self.slam_mode = slam_mode
        self.devices = devices
        self.pipes: List[LIVOPipeline] = [
            LIVOPipeline(cfg, slam_mode=slam_mode,
                         device=devices[b % len(devices)])
            for b in range(batch)]
        self.wall_s = 0.0  # steady-state drain wall time (after the warm round)
        self.n_frames = 0  # frames counted in wall_s

    def _sync(self):
        for d in {p.device for p in self.pipes if p.device.type == "cuda"}:
            torch.cuda.synchronize(d)

    def process(self, seqs: List, max_frames: Optional[int] = None,
                warm_frames: int = 3):
        """Push every sequence, run `warm_frames` frames of each stream
        off the clock (map building, graph captures), then drain
        round-robin one frame a stream. Returns the per-stream
        trajectories [[(t, R, p), ...] x B]; the aggregate steady-state
        throughput is n_frames / wall_s."""
        if len(seqs) != self.B:
            raise ValueError(f"{len(seqs)} sequences for {self.B} streams")
        for p, s in zip(self.pipes, seqs):
            p.push_sequence(s)
        done = [p.poll(max_frames=warm_frames, flush=True) for p in self.pipes]
        self._sync()
        t0 = time.perf_counter()
        n0 = sum(done)
        while True:
            progressed = 0
            for b, p in enumerate(self.pipes):
                if max_frames is not None and done[b] >= max_frames:
                    continue
                k = p.poll(max_frames=1, flush=True)
                done[b] += k
                progressed += k
            if not progressed:
                break
        self._sync()
        self.wall_s = time.perf_counter() - t0
        self.n_frames = sum(done) - n0
        for p in self.pipes:
            p._finalize_host_views()
        return [p.trajectory for p in self.pipes]

"""The fused frame as one captured CUDA graph (tpu.fused_frame on a CUDA
device).

The JAX package runs a fused frame as one jitted program: `_frame_jit`
with use_vio=True in place of the LIO and VIO halves, "one jit per frame
(lowest dispatch)" (fast_livo2_tpu/core/pipeline.py:1073-1094). Its
PyTorch counterpart is a `torch.cuda.CUDAGraph` of the pipeline's
`_fused_frame` (propagate through K1, undistort, downsample, the LIO
device loop, on VIO frames ring insert, depth raster, retrieval, the
photometric device loop through K2 and maintenance, then the map
insert), captured once per frame shape and replayed once a frame: the
frame's thousands of kernel launches become one graph launch.

The map insert is in the same graph. The JAX package keeps the
deferred insert as a tail program so that blocking on the pose does not
wait for it; here nothing blocks on the pose within a frame (the
trajectory is read at the end of the run), so a second graph would only
add a launch. Its order in the frame is the same: after VIO.

What a graph needs, and how this module provides it:
- Static inputs. One device buffer each for the IMU packet (or the
  scalar duration in only_lo), the points packet (whichever wire format
  the pipeline uses), the u8 image and the 0-d int32 frame id, made from
  the first frame's tensors. The pipeline keeps building and shipping
  pinned packets one frame ahead; before each replay they are copied into
  the buffers on the current stream (device to device, no host wait).
- Static state. The graph reads and writes the tensors that held the
  pipeline's state when the first graph was captured: the packed state,
  the voxel map, the IMU noise, and in LIVO the pool and ring.
  `_fused_frame` updates the pool rows and the ring in place and ends
  with a `copy_` of the new packed state, map and pool cursor into them
  (`copy_back_bytes` a frame). Anything that replaces a state tensor
  between frames (map sliding, a checkpoint load, the backend's pose
  delta) is copied into the static buffer before the next replay, and
  the pipeline's attributes are bound back to the buffers (`_bind`).
- Everything else a graph reads by address stays alive as long as the
  graph: the state and inputs above are held here, as is K2's scratch
  for the capture stream (ops/photo_iteration.py replaces it when a
  larger call on that stream needs more); the cached constants of
  voxel_map._const and photo_iteration._camera_columns are never freed.
- Outputs. A replay overwrites its outputs (diag, vdiag, the iteration
  count, the scan points): the pipeline copies what it keeps.
- Warm-up. The first frame of each shape runs `_fused_frame` eagerly on
  a side stream, as torch's capture recipe does; that frame's result is
  the real one. It leaves behind what must not happen under capture: the
  kernels built and loaded (ops/_build.py), K1's shared-memory attribute
  (csrc/cov_scan.cu), K2's scratch and ticket for the stream
  (ops/photo_iteration.py), the cached constants, and the library
  handles and workspaces of the stream. The graph is then captured on
  the same stream and replayed from the next frame on.
- Graph keys. A graph is captured once per static shape of the frame:
  (use_vio, defer_map, raycast). With vio.raycast_en a VIO frame appends
  one raycast candidate per grid cell to the scan's rows inside the
  graph (8192 + 396 rows at full width), read through the pipeline's ray
  table, which lives as long as the pipeline. The scan points are always
  emitted, and the wire format and the IMU packet's shape are fixed per
  pipeline, so a LIVO run captures one graph (a LIVO frame without an
  image would be a second). `summary()` reports the graphs, their capture seconds and the
  memory their pools reserved.
- Library calls. torch.linalg.inv_ex (the 19x19 inverses of both
  filters) runs cuSOLVER's getrf and cuBLAS's batched triangular solves
  on the H100; both capture and neither waits for the host, so the
  filters keep it.
- Launch counts. The kernel wrappers count their launches; a capture
  launches nothing, so the counts the wrappers added during capture are
  taken back and added again at each replay, which launches them.
- No fallback. If capture or replay fails, the error is raised, a
  failed capture naming the source line that broke it; the frame never
  runs eagerly instead.
"""

import os
import time
import traceback
import weakref
from typing import Dict, NamedTuple, Tuple

import torch

from ..ops import cov_scan, ordered_add
from ..ops import photo_iteration as photo_mod
from . import imu as imu_mod
from . import vio as vio_mod
from . import voxel_map as vmap_mod

# the kernel wrappers whose launches a replay repeats
_COUNTED = (cov_scan, photo_mod, ordered_add)
# the pipeline's state attributes a frame reads or writes, with their
# types (None: one tensor); the pool and ring exist in LIVO mode only
_STATE = (("packed", None), ("vmap_state", vmap_mod.VoxelMap),
          ("noise", imu_mod.ImuNoise), ("pool", vio_mod.VisualPool),
          ("ring", vio_mod.FrameRing))


class Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    outputs: tuple  # what `_fused_frame` returned under capture
    launches: Tuple[int, ...]  # kernel launches a replay makes, per _COUNTED
    seconds: float  # capture time (the warm-up frame excluded)
    pool_bytes: int  # device memory reserved by the capture (its pool)
    scratch: tuple  # K2's scratch the graph writes (kept alive with it)


def _capture_error(e: BaseException) -> str:
    """Where capture broke and why: the first error of the chain (ending
    the capture raises again, over it) at the innermost line outside
    torch's own code in its traceback, the op that broke capture."""
    while e.__context__ is not None:
        e = e.__context__
    torch_dir = os.path.dirname(torch.__file__)
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if not f.filename.startswith(torch_dir)]
    f = frames[-1]
    return f"{f.filename}:{f.lineno} ({f.line}): {e}"


class FrameGraphs:
    """The captured fused frames of one LIVOPipeline on a CUDA device, one
    graph per key (use_vio, defer_map, raycast)."""

    def __init__(self, pipe):
        # Held weakly, so that a dropped pipeline is freed at once by
        # reference counting and not by a later garbage collection, which
        # could run inside another stream's capture: freeing the pinned
        # host tensors the pipeline holds records CUDA events on the
        # streams that used them, and that invalidates a capture.
        self._pipe = weakref.ref(pipe)
        self.side = torch.cuda.Stream(pipe.device)
        self.graphs: Dict[tuple, Captured] = {}
        self._state = None  # {attribute: static value} (tensor or tuple)
        self._inputs = [None] * 4  # static imu, pts, image, frame id
        self.copy_back_bytes = 0

    @property
    def pipe(self):
        return self._pipe()

    def _bind(self):
        """Make the pipeline's state the static buffers: adopt the current
        tensors at the first capture; later, copy any tensor that was
        replaced since (map sliding, a checkpoint load) into its buffer and
        bind the pipeline's attributes back to the buffers."""
        p = self.pipe
        cur = {name: getattr(p, name) for name, _ in _STATE
               if getattr(p, name) is not None}
        if self._state is None:
            self._state = cur
            return
        for name, kind in _STATE:
            if name not in cur:
                continue
            bufs, ts = self._state[name], cur[name]
            if kind is None:
                bufs, ts = (bufs,), (ts,)
            for buf, t in zip(bufs, ts):
                if t is not buf:
                    buf.copy_(t)
            setattr(p, name, self._state[name] if kind is None
                    else kind(*bufs))

    def static_tensors(self):
        """Every static state tensor, flat."""
        return [t for v in self._state.values()
                for t in ((v,) if isinstance(v, torch.Tensor) else v)]

    def _load_inputs(self, args):
        """Copy this frame's inputs into the static buffers (made from the
        first tensors seen); returns the buffers."""
        for i, t in enumerate(args):
            if t is None:
                continue
            if self._inputs[i] is None:
                self._inputs[i] = t.clone()
            else:
                self._inputs[i].copy_(t, non_blocking=True)
        return self._inputs

    def run(self, imu_pack, pts_pack, img, fid, use_vio: bool,
            defer_map: bool):
        """One fused frame: a replay of the graph of this frame's key, or
        for a new key the warm-up frame and then the capture. Returns
        `_fused_frame`'s outputs (the graph's buffers after a replay)."""
        self._bind()
        imu_s, pts_s, img_s, fid_s = self._load_inputs(
            (imu_pack, pts_pack, img if use_vio else None, fid))
        key = (use_vio, defer_map,
               use_vio and self.pipe._ray_table is not None)
        g = self.graphs.get(key)
        if g is not None:
            g.graph.replay()
            for mod, n in zip(_COUNTED, g.launches):
                mod.LAUNCHES += n
            return g.outputs

        def frame():
            return self.pipe._fused_frame(imu_s, pts_s, img_s, fid_s,
                                          use_vio, defer_map)

        cur = torch.cuda.current_stream(self.pipe.device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            outputs = frame()  # the warm-up is this frame's real run
        cur.wait_stream(self.side)
        torch.cuda.synchronize(self.pipe.device)
        before = [mod.LAUNCHES for mod in _COUNTED]
        torch.cuda.empty_cache()  # as the capture does first
        reserved = torch.cuda.memory_reserved(self.pipe.device)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=self.side):
                captured = frame()
        except Exception as e:
            raise RuntimeError(
                f"tpu.fused_frame: CUDA graph capture of the {key} frame "
                f"failed at {_capture_error(e)}") from e
        seconds = time.perf_counter() - t0
        launches = tuple(mod.LAUNCHES - b for mod, b in zip(_COUNTED, before))
        for mod, b in zip(_COUNTED, before):
            mod.LAUNCHES = b  # a capture launches nothing
        self.graphs[key] = Captured(
            graph, captured, launches, seconds,
            torch.cuda.memory_reserved(self.pipe.device) - reserved,
            photo_mod._SCRATCH.get((self.side.device.index,
                                    self.side.cuda_stream), ()))
        back = [self._state["packed"], *self._state["vmap_state"]]
        if use_vio:
            back.append(self._state["pool"].alloc)
        self.copy_back_bytes = sum(t.numel() * t.element_size() for t in back)
        return outputs

    def summary(self) -> dict:
        """The captures of this pipeline: count, seconds and reserved bytes
        each, the launches of K1, K2 and ordered_add a replay makes, and
        the bytes a frame copies back into the static state."""
        return {
            "graphs": len(self.graphs),
            "keys": [list(k) for k in self.graphs],
            "capture_seconds": [g.seconds for g in self.graphs.values()],
            "pool_bytes": [g.pool_bytes for g in self.graphs.values()],
            "launches_per_replay": [dict(zip(("cov_scan", "photo_iteration",
                                              "ordered_add"), g.launches))
                                    for g in self.graphs.values()],
            "copy_back_bytes_per_frame": self.copy_back_bytes,
        }

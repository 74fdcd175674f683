"""The LIVO pipeline: measurement sync + per-frame LIO and VIO steps on
the device (port of fast_livo2_tpu/core/pipeline.py: LIVO, ONLY_LIO and
ONLY_LO, in split, fused and staged frames).

Equivalent of LIVMapper (reference src/LIVMapper.cpp): the host owns the
timestamp-driven sync state machine (sync_packages, LIVMapper.cpp:
884-1119) and ragged->fixed batching; every per-frame computation — IMU
propagation (through the CUDA covariance-scan kernel on the GPU),
undistortion, downsample, the iterated LIO ESIKF, the voxel-map insert
and the VIO frame (the photometric iterations through the CUDA kernel of
ops/photo_iteration) — runs as tensor ops on `device` with the state
kept there. LIVO events are camera frames: each runs the LIO update over
the points up to the capture time, then the VIO update at that time
(LIVMapper.cpp:940-1085), in the JAX package's split order: LIO without
the map insert, the VIO half, then the deferred insert. ONLY_LIO cuts at
scan ends; ONLY_LO is LiDAR-only with constant-velocity propagation.
Images ship as uint8 and convert to float32 on the device.

Three frame forms, as in the JAX package (the map-building first frame
is always split):
- split (the default): the LIO half, the VIO half and the deferred
  insert as eager calls with the early-exit loops. Host syncs per frame:
  the LIO loop reads one bool per iteration (core/lio.py, at most
  max_iterations - 1); the photometric loop one per iteration but the
  last of each pyramid level (core/vio.py, at most 16 at the defaults).
- fused (`tpu.fused_frame`): the whole frame in one function with the
  device loops (`_fused_frame`), which on the card is captured once per
  frame shape as a CUDA graph and replayed once a frame
  (core/frame_graph.py); on the CPU it runs eagerly. No host read.
- staged (`tpu.stage_timing`, LIVO and ONLY_LIO): the frame as timed
  stages (`_staged_frame`), the map insert before VIO, the device loops;
  FrameLog rows carry `{stage}_ms` and `print_stage_table` renders them.
With map sliding enabled every form reads one 3-float position every 10
frames. Trajectory and diagnostics stay on the device until
`_finalize_host_views` converts them once, at the end.

Outputs, as in the JAX package: the trajectory; with
`pcd_save.pcd_save_en` each frame's posterior world points (coloured from
the frame image on VIO frames) stay on the device until `save_pcd` /
`save_mesh` read them in one transfer (the mesh is a TSDF integrated on
the device, io/tsdf.py); `publish.pub_effect_point_en` keeps the
plane-matched points (`effect_points`); `evo.pose_output_en` the pre/
post-update states (`save_state_traces`); `uav.imu_rate_odom` fills
`imu_rate_trajectory` between updates (`imu_rate_poses`); `save_images`
dumps the frame ring with tracked points drawn on it; `export_colmap`
writes a COLMAP text model. io/checkpoint.py saves and resumes the run.

The VIO extras run in every frame form: `vio.raycast_en` (the ray
table is built once here, and each VIO frame appends the recovered
candidates to the scan's rows) and `vio.inverse_composition_en` (the
6-dof inverse-compositional update).

The sliding-window backend (parallel/ba.py), as in the JAX package:
with `keyframe_every` set, every keyframe_every-th frame keeps a
keyframe (its time, a copy of the packed posterior state, the frame's
undistorted posterior scan in the body frame, strided to `kf_points`
rows, and with `refine_photo` its photometric factors), and the raw IMU
samples are kept for the links between keyframes. `refine_trajectory`
refines the last keyframes after the run; `enable_online_refine` submits
a window every `stride` keyframes to an OnlineRefiner on its own CUDA
stream, feeds the newest keyframe's pose delta back into the filter
(small-delta gated), and collects `refined_keyframes`. The keyframe block
runs after the frame (after the replay, for a fused frame) and reads
nothing on the host, except one scalar a keyframe (its plane
conditioning) when the submit gate `refine_gate` is on.
"""

import bisect
import os
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..io import export as export_mod
from ..io import tsdf as tsdf_mod
from ..models import camera as cam_mod
from ..models import lidar as lidar_mod
from ..ops import eig3, so3
from ..parallel import sharding as shd
from ..utils.config import LIVOConfig
from ..utils.host_copy import host_copy, host_value
from ..utils.timing import annotate
from . import imu as imu_mod
from . import lio as lio_mod
from . import vio as vio_mod
from . import voxel_map as vmap_mod
from .state import init_cov, init_state, pack_state, unpack_state

# backend feedback gate: a refined delta larger than this is dropped
# (the backend polishes drift, it must never yank the filter)
_MAX_DELTA_DEG, _MAX_DELTA_M = 2.0, 0.5


class ScanPoints(NamedTuple):
    """A frame's posterior scan, as the VIO half and the deferred map
    insert read it (the JAX package's pg_pack columns)."""

    pts_w: torch.Tensor  # (N, 3) world points
    normal: torch.Tensor  # (N, 3) matched plane normal, 0 if unmatched
    var_w6: torch.Tensor  # (N, 6) sym6 world covariances
    valid: torch.Tensor  # (N,)


def _plane_cond(match, valid):
    """Plane-direction conditioning of one LIO update: the smallest
    eigenvalue of the normalized matched-normal second moment, in
    [0, 1/3] (near 0 = translation unobservable along some axis)."""
    use = match.valid & valid
    n = torch.where(use[:, None], match.normal, 0.0)
    nn = n.T @ n
    cnt = torch.clamp(torch.sum(use.to(torch.float32)), min=1.0)
    evals, _ = eig3.eigh3((nn / cnt)[None])
    return evals[0, 0]


class FrameLog:
    """Per-frame diagnostics (the reference's per-stage time tables,
    LIVMapper.cpp:465-476, as data)."""

    def __init__(self):
        self.rows: List[dict] = []

    def add(self, **kw):
        self.rows.append(kw)

    def summary(self):
        if not self.rows:
            return {}
        keys = [k for k, v in self.rows[0].items() if isinstance(v, (int, float))]
        return {k: float(np.mean([r[k] for r in self.rows if k in r])) for k in keys}


class LIVOPipeline:
    # The reference's slam_mode_ enum (LIVMapper.cpp:162): "only_lio" =
    # LiDAR+IMU, no camera; "only_lo" = LiDAR only, constant-velocity
    # propagation (IMU_Processing.cpp:151-234).
    SLAM_MODES = ("livo", "only_lio", "only_lo")

    def __init__(self, cfg: LIVOConfig, slam_mode: str = "livo",
                 device="cuda"):
        if slam_mode not in self.SLAM_MODES:
            raise ValueError(
                f"slam_mode {slam_mode!r} not in {self.SLAM_MODES} "
                "('only_lio' = no camera; 'only_lo' = no camera, no IMU)")
        self.cfg = cfg
        self.slam_mode = slam_mode
        self.device = torch.device(device)
        t = cfg.tpu
        self.map_cfg = vmap_mod.VoxelMapConfig(
            voxel_size=cfg.lio.voxel_size,
            n_layers=cfg.lio.max_layer + 1,
            capacity_log2=t.hash_capacity_log2,
            probes=t.hash_probe_len,
            planner_threshold=cfg.lio.min_eigen_value,
            sigma_num=cfg.lio.sigma_num,
            layer_init_num=tuple(cfg.lio.layer_init_num),
            max_points_num=cfg.lio.max_points_num,
            insert_compact=t.insert_compact,
            descend_compact=t.descend_compact,
            sticky_cut=t.sticky_cut,
            pre_descend_margin=t.pre_descend_margin,
            match_finest=t.match_finest,
        )
        self.cam = cam_mod.make_camera(cfg.camera)
        gs, gnw, gnh = vio_mod.derive_grid(self.cam, cfg.vio.grid_size,
                                           cfg.vio.grid_n_height)
        self.vio_cfg = vio_mod.VIOConfig(
            grid_size=gs, grid_n_width=gnw, grid_n_height=gnh,
            patch_size=cfg.vio.patch_size,
            pyramid_levels=cfg.vio.patch_pyrimid_level,
            max_obs=t.vis_obs_per_point,
            pool_capacity=t.vis_point_capacity,
            frame_ring=t.frame_ring,
            max_iterations=cfg.vio.max_iterations,
            img_point_cov=cfg.vio.img_point_cov,
            outlier_threshold=cfg.vio.outlier_threshold,
            exposure_estimate_en=cfg.vio.exposure_estimate_en,
            normal_en=cfg.vio.normal_en,
            ncc_en=cfg.vio.ncc_en,
            ncc_thre=cfg.vio.ncc_thre,
            raycast_en=cfg.vio.raycast_en,
            inverse_composition_en=cfg.vio.inverse_composition_en,
            true_pyramid=t.true_pyramid,
            pallas_photo=t.pallas_photo,
        )
        ext = cfg.extrin_calib
        ext_R = np.array(ext.extrinsic_R, np.float32).reshape(3, 3)
        ext_T = np.array(ext.extrinsic_T, np.float32)
        self.ext_R = self._put(ext_R)
        self.ext_T = self._put(ext_T)
        # camera-from-IMU = camera-from-lidar o lidar-from-IMU
        # (VIOManager::initializeVIO, vio.cpp:57-58 with Rli = extR^T)
        Rcl = np.array(ext.Rcl, np.float32).reshape(3, 3)
        Pcl = np.array(ext.Pcl, np.float32)
        self.Rci = self._put(Rcl @ ext_R.T)
        self.Pci = self._put(Rcl @ (-ext_R.T @ ext_T) + Pcl)

        # device state: state+cov live packed in one vector between frames
        self.packed = pack_state(init_state(self.device), init_cov(self.device))
        self.vmap_state = vmap_mod.make_map(self.map_cfg, self.device)
        # The visual pool and frame ring exist only where the VIO half
        # runs (at the defaults they hold ~250 MB).
        if slam_mode == "livo":
            self.pool = vio_mod.make_pool(self.vio_cfg, self.device)
            self.ring = vio_mod.make_ring(self.vio_cfg, self.cam, self.device)
        else:
            self.pool = self.ring = None
        self._ray_table = (
            vio_mod.make_ray_table(self.cam, self.vio_cfg, device=self.device)
            if slam_mode == "livo" and cfg.vio.raycast_en else None)

        self.noise: Optional[imu_mod.ImuNoise] = None
        self.imu_inited = False
        self.map_inited = False
        self.last_update_time: Optional[float] = None
        self.frame_id = 0
        self.pending: List[Tuple[np.ndarray, np.ndarray]] = []  # (pts, t_abs)
        # Streaming ingestion state (the push/poll equivalent of the
        # reference's sensor callbacks + sync_packages state machine).
        self._imu_t = np.zeros((0,), np.float64)
        self._imu_gyr = np.zeros((0, 3), np.float64)
        self._imu_acc = np.zeros((0, 3), np.float64)
        # camera frames (t_event, u8 image: numpy until shipped, then a
        # device tensor); in LIVO mode they are the events
        self._img_queue: List[Tuple[float, object]] = []
        self._use_images = slam_mode == "livo"
        self._scan_events: List[float] = []  # scan-end event times
        self._scan_horizon = -np.inf  # latest pushed point timestamp
        # Rejected-input accounting (corrupt/NaN/loop-back/oversized
        # packets; offline we drop and count).
        self.dropped_inputs = {"imu": 0, "lidar_nan": 0,
                               "lidar_oversize": 0, "image_mode": 0}
        self._prefetch = None  # (t_ev, (imu_pack, pts_pack)) one ahead
        self._packet_t0: Optional[float] = None  # packet-prep cursor
        self.trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self.log = FrameLog()
        self.photo_iterations = 0  # photometric iterations run (all frames)
        # IMU-rate poses between updates (uav/imu_rate_odom, the 250 Hz
        # imu_prop_callback, LIVMapper.cpp:576-635): (t, R, p) host rows.
        self.imu_rate_trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        # Pre/post-update packed states (evo/pose_output_en: Log/mat_pre.txt
        # / mat_out.txt, LIVMapper.cpp:284-286, 479-481), on the device
        # until save_state_traces.
        self.trace_pre: List[Tuple[float, torch.Tensor]] = []
        self.trace_post: List[Tuple[float, torch.Tensor]] = []
        # World-cloud accumulation (pcd_save/pcd_save_en, LIVMapper.cpp:
        # 484-532): (pts_w, colors or None, keep, sensor position) per
        # frame, and the plane-matched points (publish_effect_world, :446)
        # as (t, ScanPoints); both on the device until read.
        self._cloud_chunks: List[tuple] = []
        self._effect_chunks: List[Tuple[float, ScanPoints]] = []
        self.mesh_seconds: Optional[dict] = None  # save_mesh's split
        self._last_slide_pos = np.zeros(3)
        self.map_slides = 0  # slide_map calls so far (local_map.map_sliding_en)
        self._pos_snapshot = None  # (host_copy of the position, consumed
        # at the next check)
        # The sliding-window backend (parallel/ba.py). A keyframe is
        # (t, packed state copy, scan4 (kf_points, 4) [body xyz | valid],
        # photo factors or None, the state's host copy in flight).
        self.keyframe_every = 0  # frames between keyframes; 0 = off
        self.kf_points = 4096  # body-scan rows kept per keyframe
        self.kf_use_raw = False  # keep the raw (distorted) packet instead
        # (the distortion-sensitivity comparison of the JAX package)
        self._keyframes: List[tuple] = []
        self._imu_hist: List[tuple] = []  # (stamps, gyr, acc) for the links
        self.online_refine = False
        self.refine_window_size = 16
        self.refine_stride = 8
        self.refine_feedback = True
        self.refine_imu_links = True
        self.refine_photo = False  # capture photometric factors (LIVO)
        self.refine_gate = 0.0  # see enable_online_refine(gate=)
        self._refiner = None
        self._last_refine_k = 0
        self._kf_conds: List[float] = []  # per-keyframe plane_cond
        self.refine_submits = 0  # windows dispatched
        self.refine_gate_skips = 0  # windows skipped as healthy
        self.refined_keyframes = {}  # t -> (R, p), newest refinement wins
        self._refine_deltas: List[tuple] = []  # (t_applied, R_d, p_d)
        # tpu.fused_frame on the card: one captured CUDA graph a frame
        # (on the CPU the same frame function runs eagerly)
        self._frame_graphs = None
        if cfg.tpu.fused_frame and self.device.type == "cuda":
            from .frame_graph import FrameGraphs

            self._frame_graphs = FrameGraphs(self)

    def _put(self, x):
        """Upload a host array (or numpy scalar) to this pipeline's device.
        On CUDA the copy goes through pinned memory and does not block the
        host: a pageable host-to-device copy would wait for every queued
        kernel, i.e. cost one host sync per upload."""
        t = torch.as_tensor(np.asarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @property
    def state(self):
        return unpack_state(self.packed)[0]

    @property
    def cov(self):
        return unpack_state(self.packed)[1]

    # ---------- the per-frame step ----------

    @annotate("propagate")
    def _stage_propagate(self, packed_sc, imu_pack):
        """IMU propagation (K1 inside): (state_prop, cov_prop, poses);
        imu_pack is the (K, 9) packed IMU intervals, or in only_lo mode
        the scalar packet duration (constant-velocity model, poses
        None)."""
        state, cov = unpack_state(packed_sc)
        if self.slam_mode == "only_lo":
            state_prop, cov_prop = imu_mod.propagate_without_imu(
                state, cov, imu_pack, self.noise)
            return state_prop, cov_prop, None
        batch = imu_mod.ImuBatch(
            gyr=imu_pack[:, 0:3], acc=imu_pack[:, 3:6], dt=imu_pack[:, 6],
            offs_end=imu_pack[:, 7], valid=imu_pack[:, 8])
        return imu_mod.propagate(state, cov, batch, self.noise)

    @annotate("undistort")
    def _stage_undistort(self, state_prop, poses, imu_pack, pts_pack):
        """(undistorted points (N, 3), valid (N,)) of the points packet."""
        pts, t_offs, valid = self._unpack_pts(pts_pack)
        if self.slam_mode == "only_lo":
            return imu_mod.undistort_without_imu(pts, t_offs, imu_pack,
                                                 state_prop), valid
        return imu_mod.undistort(pts, t_offs, poses, state_prop, self.ext_R,
                                 self.ext_T), valid

    @annotate("downsample")
    def _stage_downsample(self, und, valid):
        return lio_mod.voxel_downsample(und, valid,
                                        self.cfg.preprocess.filter_size_surf,
                                        self.cfg.tpu.max_points_down)

    @annotate("lio")
    def _stage_lio(self, state_prop, cov_prop, vmap_state, down, down_valid,
                   device_loop: bool):
        """The iterated LIO update: (packed_sc, diag (6,), pg)."""
        cfg = self.cfg
        res = lio_mod.lio_update(
            state_prop, cov_prop, vmap_state, down, down_valid,
            self.ext_R, self.ext_T, self.map_cfg,
            dept_err=cfg.lio.dept_err, beam_err=cfg.lio.beam_err,
            max_iterations=cfg.lio.max_iterations,
            rematch_fresh=cfg.tpu.lio_rematch_fresh,
            fresh_every_iter=cfg.tpu.lio_fresh_every_iter,
            plane_info_cap=cfg.tpu.lio_plane_info_cap,
            device_loop=device_loop,
        )
        var_w6 = vmap_mod.sym6(res.var_w)
        normal = torch.where(res.match.valid[:, None], res.match.normal, 0.0)
        zero = res.mean_residual.new_zeros(())
        diag = torch.stack([
            res.n_effective.to(torch.float32), res.mean_residual,
            zero, zero, zero, _plane_cond(res.match, down_valid),
        ])
        return (pack_state(res.state, res.cov), diag,
                ScanPoints(res.pts_w, normal, var_w6, down_valid))

    @annotate("map")
    def _insert(self, vmap_state, pg: ScanPoints):
        """The frame's map insert (a new map; the input is untouched)."""
        return vmap_mod.update_map(vmap_state, pg.pts_w, pg.var_w6, pg.valid,
                                   self.map_cfg, compact=True)

    def _frame_step(self, packed_sc, vmap_state, imu_pack, pts_pack,
                    first: bool, do_map: bool = True,
                    device_loop: bool = False):
        """One frame's LIO half on the device. imu_pack: (K, 9) packed IMU
        intervals (a scalar packet duration in only_lo mode); pts_pack:
        the points wire packet (see `_unpack_pts`). Returns (packed_sc,
        map, diag (6,), pg) where pg (a ScanPoints) feeds the VIO half and
        the deferred map insert (None on the first frame)."""
        cfg = self.cfg
        state_prop, cov_prop, poses = self._stage_propagate(packed_sc,
                                                            imu_pack)
        und, valid = self._stage_undistort(state_prop, poses, imu_pack,
                                           pts_pack)
        down, down_valid = self._stage_downsample(und, valid)
        if first:
            # BuildVoxelMap with the prior state (LIVMapper.cpp:362-366).
            body_cov = lio_mod.calc_body_cov(down, cfg.lio.dept_err,
                                             cfg.lio.beam_err)
            pts_imu = down @ self.ext_R.T + self.ext_T
            pts_w = pts_imu @ state_prop.rot.T + state_prop.pos
            crossmat = so3.skew(pts_imu)
            R_ext = state_prop.rot @ self.ext_R
            var_w = (torch.einsum("ij,njk,lk->nil", R_ext, body_cov, R_ext)
                     + crossmat @ cov_prop[0:3, 0:3] @ crossmat.transpose(-1, -2)
                     + cov_prop[3:6, 3:6])
            vmap_state = vmap_mod.update_map(vmap_state, pts_w, var_w,
                                             down_valid, self.map_cfg)
            diag = torch.zeros((6,), dtype=torch.float32, device=self.device)
            return pack_state(state_prop, cov_prop), vmap_state, diag, None

        packed_sc, diag, pg = self._stage_lio(state_prop, cov_prop,
                                              vmap_state, down, down_valid,
                                              device_loop)
        if do_map:
            vmap_state = self._insert(vmap_state, pg)
        return packed_sc, vmap_state, diag, pg

    @annotate("vio")
    def _vio_half(self, packed_sc, img, pg: ScanPoints, fid, vmap_state,
                  device_loop: bool = False):
        """The VIO half of a LIVO frame on the u8 image `img` (H, W), frame
        id `fid` (0-d int32 tensor), reading `vmap_state`. Updates the
        pool's rows and the ring in place. Returns (packed_sc, vdiag (3,)
        [n_tracked, n_added, mean_error], photometric iterations that
        took effect, the pool with its new allocation cursor)."""
        state, cov = unpack_state(packed_sc)
        vres = vio_mod.vio_step(
            state, cov, self.pool, self.ring, vmap_state,
            img.to(torch.float32), pg.pts_w, pg.normal, pg.var_w6, pg.valid,
            fid, self.cam, self.Rci, self.Pci, self.vio_cfg, self.map_cfg,
            ray_table=self._ray_table, device_loop=device_loop)
        vdiag = torch.stack([vres.n_tracked.to(torch.float32),
                             vres.n_added.to(torch.float32), vres.mean_error])
        return (pack_state(vres.state, vres.cov), vdiag,
                vres.photo_iterations, vres.pool)

    def _fused_frame(self, imu_pack, pts_pack, img, fid, use_vio: bool,
                     defer_map: bool):
        """A whole non-first frame with the device loops and no host read
        (tpu.fused_frame): the LIO half, on VIO frames the VIO half, and
        the map insert (after VIO when deferred). Reads the pipeline's
        state and writes it back in place (`copy_`) into the same tensors
        (the static buffers of the captured graph, core/frame_graph.py).
        Returns (diag, vdiag or None, iterations or None, pg): fresh
        tensors that a replay overwrites."""
        vmap = self.vmap_state
        packed, vmap, diag, pg = self._frame_step(
            self.packed, vmap, imu_pack, pts_pack, first=False,
            do_map=not defer_map, device_loop=True)
        vdiag = n_it = None
        if use_vio:
            packed, vdiag, n_it, pool = self._vio_half(
                packed, img, pg, fid, vmap, device_loop=True)
            self.pool.alloc.copy_(pool.alloc)
        if defer_map:
            vmap = self._insert(vmap, pg)
        self.packed.copy_(packed)
        for dst, src in zip(self.vmap_state, vmap):
            dst.copy_(src)
        return diag, vdiag, n_it, pg

    def _staged_frame(self, imu_pack, pts_pack, img, fid, use_vio: bool):
        """A non-first frame as timed stages (tpu.stage_timing; the JAX
        package's _run_frame_staged): propagate, undistort, downsample,
        lio, map, vio, built from the same calls as `_frame_step`, the map
        insert before VIO (the deferred_map_insert = False order), the
        device loops. Returns (diag, vdiag or None, iterations or None,
        pg, {stage}_ms): CUDA event time between the stage's bounds on
        the card (read once, at the end), perf_counter on the CPU."""
        from ..utils.timing import StageClock

        clock = StageClock(self.device)
        state_prop, cov_prop, poses = self._stage_propagate(self.packed,
                                                            imu_pack)
        clock.lap("propagate")
        und, valid = self._stage_undistort(state_prop, poses, imu_pack,
                                           pts_pack)
        clock.lap("undistort")
        down, down_valid = self._stage_downsample(und, valid)
        clock.lap("downsample")
        self.packed, diag, pg = self._stage_lio(
            state_prop, cov_prop, self.vmap_state, down, down_valid,
            device_loop=True)
        clock.lap("lio")
        self.vmap_state = self._insert(self.vmap_state, pg)
        clock.lap("map")
        vdiag = n_it = None
        if use_vio:
            self.packed, vdiag, n_it, self.pool = self._vio_half(
                self.packed, img, pg, fid, self.vmap_state, device_loop=True)
            clock.lap("vio")
        return diag, vdiag, n_it, pg, clock.read()

    def _unpack_pts(self, pts_pack):
        """(pts (N, 3), t_offs (N,), valid (N,)) from either wire format:
        f32 (N, 5) [xyz | t_offs | valid], or tpu.wire_q16 — int16 xyz at
        a per-packet scale + uint16 offsets, with (scale, duration, count)
        as float32 bitcast into the last two int16 rows."""
        if self.cfg.tpu.wire_q16:
            q = pts_pack[:-2]
            meta = pts_pack[-2:].contiguous().view(torch.float32).reshape(4)
            pts = q[:, 0:3].to(torch.float32) * meta[0]
            offs_u = q[:, 3].to(torch.int32) & 0xFFFF  # uint16 bitcast
            t_offs = offs_u.to(torch.float32) * (meta[1] / 65535.0)
            valid = (torch.arange(q.shape[0], device=q.device)
                     < meta[2].to(torch.int32))
            return pts, t_offs, valid
        return pts_pack[:, 0:3], pts_pack[:, 3], pts_pack[:, 4] > 0.5

    # ---------- host orchestration ----------

    def _init_imu(self, seq, t_until: float):
        m = seq.imu_stamps <= t_until
        if m.sum() < max(self.cfg.imu.imu_int_frame, 5):
            return False
        grav, mean_norm = imu_mod.static_init(seq.imu_acc[m], seq.imu_gyr[m])
        st, cv = unpack_state(self.packed)
        if self.cfg.uav.gravity_align_en:
            # Align the world frame with gravity (uav/gravity_align_en):
            # choose R0 s.t. R0-rotated gravity is exactly [0,0,-G].
            g = grav / np.linalg.norm(grav)
            tgt = np.array([0.0, 0.0, -1.0])
            axis = np.cross(g, tgt)
            s_n = np.linalg.norm(axis)
            if s_n > 1e-8:
                axis = axis / s_n
                ang = float(np.arctan2(s_n, float(g @ tgt)))
                R0 = so3.exp(torch.as_tensor(axis * ang, dtype=torch.float32)
                             ).numpy()
            else:
                R0 = np.eye(3, dtype=np.float32)
            st = st._replace(rot=self._put(R0.astype(np.float32)),
                             grav=self._put(np.array([0.0, 0.0, -9.81],
                                                     np.float32)))
        else:
            st = st._replace(grav=self._put(grav))
        self.packed = pack_state(st, cv)
        self.noise = imu_mod.make_noise(
            acc_cov=self.cfg.imu.acc_cov, gyr_cov=self.cfg.imu.gyr_cov,
            b_acc_cov=self.cfg.imu.b_acc_cov, b_gyr_cov=self.cfg.imu.b_gyr_cov,
            inv_expo_cov=self.cfg.vio.inv_expo_cov, mean_acc_norm=mean_norm,
            # Estimation toggles (imu/gravity_est_en, imu/ba_bg_est_en,
            # vio/exposure_estimate_en, LIVMapper.cpp:158-160).
            est_bias=self.cfg.imu.ba_bg_est_en,
            est_gravity=self.cfg.imu.gravity_est_en,
            est_exposure=self.cfg.vio.exposure_estimate_en,
            device=self.device,
        )
        self.imu_inited = True
        return True

    def _imu_slice(self, t0: float, t1: float, seq):
        """IMU samples needed for propagation over (t0, t1]: the last
        sample at/before t0 plus everything in (t0, t1] + one beyond."""
        s = seq.imu_stamps
        i0 = int(np.searchsorted(s, t0, side="right")) - 1
        i1 = int(np.searchsorted(s, t1, side="right")) + 1
        i0 = max(i0, 0)
        i1 = min(i1, len(s))
        return s[i0:i1], seq.imu_gyr[i0:i1], seq.imu_acc[i0:i1]

    def _prepare_packet(self, t_end: float, seq):
        """Host-side ragged->fixed batching of one frame's inputs, shipped
        to the device as one IMU packet and one points packet. Advances
        the packet cursor `_packet_t0` (prefetching may run this one event
        ahead of processing)."""
        cfg = self.cfg.tpu
        t0 = (self._packet_t0 if self._packet_t0 is not None
              else self.last_update_time)
        if self.slam_mode == "only_lo":
            imu_pack = self._put(np.float32(t_end - t0))
        else:
            st, gy, ac = self._imu_slice(t0, t_end, seq)
            b = imu_mod.prepare_imu_batch(st, gy, ac, t0, t_end,
                                          cfg.max_imu_per_packet)
            imu_pack = self._put(np.concatenate(
                [b.gyr, b.acc, b.dt[:, None], b.offs_end[:, None],
                 b.valid[:, None]], axis=-1, dtype=np.float32))

        # Chunks are time-sorted (push_scan sorts within a scan, the
        # pending list is kept ordered by first timestamp), so one
        # searchsorted splits each straddling chunk and the scan stops at
        # the first fully-future chunk — O(points consumed) per frame.
        take_p, take_t = [], []
        leftovers = []
        ci = 0
        while ci < len(self.pending):
            pts, t_abs = self.pending[ci]
            if len(t_abs) and t_abs[0] > t_end:
                break
            if not len(t_abs) or t_abs[-1] <= t_end:
                take_p.append(pts)
                take_t.append(t_abs)
            else:
                i = int(np.searchsorted(t_abs, t_end, side="right"))
                take_p.append(pts[:i])
                take_t.append(t_abs[:i])
                leftovers.append((pts[i:], t_abs[i:]))
            ci += 1
        if ci:
            tail = leftovers + self.pending[ci:]
            if len(leftovers) > 1 or (leftovers and self.pending[ci:]):
                tail.sort(key=lambda c: c[1][0] if len(c[1]) else np.inf)
            self.pending = tail
        n = cfg.max_points_per_scan
        if take_p:
            pts = np.concatenate(take_p)
            offs = np.concatenate(take_t) - t0
            if len(pts) > n:
                # Overflow: decimate EVENLY to exactly n points (a
                # head-truncate would keep only the sweep's first wedge).
                idx = (np.arange(n, dtype=np.int64) * len(pts)) // n
                pts = pts[idx]
                offs = offs[idx]
            k = len(pts)
        else:
            pts = np.zeros((0, 3), np.float32)
            offs = np.zeros((0,), np.float32)
            k = 0
        self._packet_t0 = t_end
        if cfg.wire_q16:
            dur = max(float(t_end - t0), 1e-6)
            scale = max(float(np.abs(pts[:k]).max()) if k else 0.0, 1e-3) / 32766.0
            q = np.zeros((n + 2, 4), np.int16)
            q[:k, 0:3] = np.clip(np.round(pts[:k] / scale), -32766, 32766)
            q[:k, 3] = np.clip(np.round(offs[:k] / dur * 65535.0),
                               0, 65535).astype(np.uint16).view(np.int16)
            q[n:] = np.array([scale, dur, k, 0.0],
                             np.float32).view(np.int16).reshape(2, 4)
            return imu_pack, self._put(q)
        pack = np.zeros((n, 5), np.float32)
        pack[:k, 0:3] = pts[:k]
        pack[:k, 3] = offs[:k]
        pack[:k, 4] = 1.0
        return imu_pack, self._put(pack)

    # ---------- streaming ingestion (push/poll) ----------

    def push_imu(self, stamps, gyr, acc):
        """Append IMU samples (imu_cbk, LIVMapper.cpp:769-818). Non-finite
        rows and loop-backs (stamps at/before the newest buffered sample)
        are rejected and counted in `dropped_inputs`."""
        t = np.atleast_1d(np.asarray(stamps, np.float64))
        g = np.atleast_2d(np.asarray(gyr, np.float64))
        a = np.atleast_2d(np.asarray(acc, np.float64))
        if (self.cfg.common.ros_driver_bug_fix and len(t)
                and np.isfinite(self._scan_horizon)):
            # Vendor-driver clock fix (common/ros_driver_bug_fix,
            # LIVMapper.cpp:779-784): round a whole-second offset away.
            t = t + np.round(self._scan_horizon - t)
        ok = (np.isfinite(t) & np.isfinite(g).all(axis=-1)
              & np.isfinite(a).all(axis=-1))
        if len(self._imu_t):
            ok &= t > self._imu_t[-1]
        if not ok.all():
            self.dropped_inputs["imu"] += int((~ok).sum())
            t, g, a = t[ok], g[ok], a[ok]
        self._imu_t = np.concatenate([self._imu_t, t])
        self._imu_gyr = np.concatenate([self._imu_gyr, g])
        self._imu_acc = np.concatenate([self._imu_acc, a])
        if self.keyframe_every:
            # the raw history the backend's IMU links preintegrate; it
            # survives _trim_imu, bounded there to the keyframe horizon
            self._imu_hist.append((t, g, a))

    def push_scan(self, t_begin: float, pts: np.ndarray, offs: np.ndarray):
        """Append one decoded scan (LIVMapper.cpp:703-766), with the
        optional LOAM surf-feature path (feature_extract_enabled)."""
        if len(pts):
            # Corrupt-packet guards: drop non-finite rows; truncate scans
            # beyond 4x the configured pad size.
            finite = np.isfinite(pts).all(axis=-1) & np.isfinite(offs)
            if not finite.all():
                self.dropped_inputs["lidar_nan"] += int((~finite).sum())
                pts, offs = pts[finite], offs[finite]
            cap = 4 * self.cfg.tpu.max_points_per_scan
            if len(pts) > cap:
                self.dropped_inputs["lidar_oversize"] += len(pts) - cap
                pts, offs = pts[:cap], offs[:cap]
        if self.cfg.preprocess.feature_extract_enabled and len(pts):
            keep = lidar_mod.extract_surf_features(
                pts, offs, blind=self.cfg.preprocess.blind)
            pts, offs = pts[keep], offs[keep]
        if len(offs) and np.any(np.diff(offs) < 0):
            # time-sort within the scan: _prepare_packet splits chunks by
            # searchsorted.
            order = np.argsort(offs, kind="stable")
            pts, offs = pts[order], offs[order]
        chunk = (pts, t_begin + offs)
        if (self.pending and len(chunk[1]) and len(self.pending[-1][1])
                and chunk[1][0] < self.pending[-1][1][0]):
            # out-of-order push: keep the pending list ordered by first
            # timestamp (the packet splitter relies on it)
            keys = [c[1][0] if len(c[1]) else np.inf for c in self.pending]
            self.pending.insert(bisect.bisect_right(keys, chunk[1][0]), chunk)
        else:
            self.pending.append(chunk)
        t_end = t_begin + (offs[-1] if len(offs) else 0.0)
        self._scan_horizon = max(self._scan_horizon, t_end)
        if not self._use_images:
            # ordered insert: a late scan must not enqueue a backwards
            # event (the sync cursor is monotonic)
            if self._scan_events and t_end < self._scan_events[-1]:
                bisect.insort(self._scan_events, t_end)
            else:
                self._scan_events.append(t_end)

    def push_image(self, t: float, img: np.ndarray):
        """Append one camera frame (img_cbk, LIVMapper.cpp:829-860). The
        event time is the capture time, stamp + exposure_time_init
        (sync_packages, LIVMapper.cpp:949-1010). Frames queue on the host
        as uint8 and ship to the device a bounded window ahead
        (`_ship_images`). In the camera-less modes frames are dropped and
        counted: those modes cut events at scan ends."""
        if self.slam_mode != "livo":
            self.dropped_inputs["image_mode"] += 1
            return
        self._use_images = True
        if isinstance(img, np.ndarray) and img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        self._img_queue.append(
            (t + self.cfg.time_offset.exposure_time_init, img))
        self._ship_images()

    def _ship_images(self):
        """Upload the first `tpu.img_upload_ahead` queued frames (the
        copies are asynchronous and overlap earlier frames' work)."""
        for i in range(min(self.cfg.tpu.img_upload_ahead,
                           len(self._img_queue))):
            t_i, im = self._img_queue[i]
            if isinstance(im, np.ndarray):
                self._img_queue[i] = (t_i, self._put(im))

    def _event_ready(self, t_ev: float, is_image: bool) -> bool:
        """sync_packages admission: the IMU must extend past the cut time
        and, for an image cut, the LiDAR data must cover the capture time
        (LIVMapper.cpp:949-1010 wait conditions)."""
        if self.slam_mode != "only_lo":
            if not len(self._imu_t) or self._imu_t[-1] <= t_ev:
                return False
        return not is_image or self._scan_horizon >= t_ev

    def _imu_buf(self):
        class _V:
            imu_stamps = self._imu_t
            imu_gyr = self._imu_gyr
            imu_acc = self._imu_acc
        return _V()

    def poll(self, max_frames: Optional[int] = None, progress: bool = False,
             flush: bool = False) -> int:
        """Drain ready events: one full frame update per camera frame
        (LIVO) or per scan end (LIO modes) whose input streams have
        arrived. `flush=True` = end of stream, process the tail regardless
        of coverage. Returns the frames run."""
        n_done = 0
        while max_frames is None or n_done < max_frames:
            if self._use_images:
                if not self._img_queue:
                    break
                t_ev, img = self._img_queue[0]
            else:
                if not self._scan_events:
                    break
                t_ev, img = self._scan_events[0], None
            if not flush and not self._event_ready(t_ev, img is not None):
                break
            (self._img_queue if self._use_images else self._scan_events).pop(0)
            if self._run_event(t_ev, img, progress=progress):
                n_done += 1
        return n_done

    def _prefetch_next(self):
        """Prepare and ship the next queued event's packets now, if its
        input streams are complete (events process in order and sensors
        push monotonically, so the consumed pending state is exactly what
        that event will need)."""
        if self._prefetch is not None or not (self.imu_inited
                                              and self.map_inited):
            return
        q = self._img_queue if self._use_images else self._scan_events
        if not q:
            return
        t_nxt = q[0][0] if self._use_images else q[0]
        if not self._event_ready(t_nxt, self._use_images):
            return
        self._prefetch = (t_nxt, self._prepare_packet(t_nxt, self._imu_buf()))

    def _trim_imu(self):
        """Drop consumed IMU samples, keeping two at or before
        last_update_time (propagation and the prefetch cursor still need
        their interval-start sample)."""
        if self.last_update_time is None or not len(self._imu_t):
            return
        i0 = int(np.searchsorted(self._imu_t, self.last_update_time,
                                 side="right")) - 2
        if i0 > 0:
            self._imu_t = self._imu_t[i0:]
            self._imu_gyr = self._imu_gyr[i0:]
            self._imu_acc = self._imu_acc[i0:]
        # Bound the link history to the refine-window horizon (whole
        # chunks older than the oldest keyframe a next window could use).
        if self._imu_hist and self.keyframe_every:
            kfs = self._keyframes[-self.refine_window_size:]
            lo = (kfs[0][0] if kfs else self.last_update_time) - 2.0
            while (len(self._imu_hist) > 1 and len(self._imu_hist[0][0])
                   and self._imu_hist[0][0][-1] < lo):
                self._imu_hist.pop(0)

    def process(self, seq, max_frames: Optional[int] = None,
                progress: bool = False):
        """Run an offline sequence (io.synthetic.SyntheticSequence or the
        npz reader's equivalent): push every packet, then drain with flush
        semantics. Returns the trajectory [(t, R (3,3) np, p (3,) np)]."""
        self.push_sequence(seq)
        self.poll(max_frames=max_frames, progress=progress, flush=True)
        self._finalize_host_views()
        return self.trajectory

    def push_sequence(self, seq):
        """Push every scan, IMU sample and, in LIVO mode, camera frame of
        an offline sequence (the ingestion half of `process`). A LIVO
        pipeline given a sequence without images cuts at scan ends."""
        self._use_images = self.slam_mode == "livo" and len(seq.images) > 0
        for t_begin, pts, offs in seq.scans:
            self.push_scan(t_begin, pts, offs)
        self.pending.sort(key=lambda x: x[1][0] if len(x[1]) else 1e18)
        self.push_imu(seq.imu_stamps, seq.imu_gyr, seq.imu_acc)
        if self._use_images:
            for t, img in seq.images:
                self.push_image(t, img)

    def _run_event(self, t_ev: float, img=None, progress: bool = False) -> bool:
        """One sync cut: IMU init bootstrap, or a full frame update."""
        if not self.imu_inited:
            if self.slam_mode == "only_lo":
                # No IMU: constant-velocity model from the first scan.
                self.noise = imu_mod.make_noise(
                    acc_cov=self.cfg.imu.acc_cov, gyr_cov=self.cfg.imu.gyr_cov,
                    device=self.device)
                self.imu_inited = True
                self.last_update_time = t_ev
                return False
            if not self._init_imu(self._imu_buf(), t_ev):
                return False
            self.last_update_time = t_ev
            # drop sensor data before init end
            self.pending = [(p[t > t_ev], t[t > t_ev]) for p, t in self.pending]
            return False

        if self.last_update_time is not None and t_ev <= self.last_update_time:
            # A late packet enqueued an event at/behind the sync cursor:
            # dropped and counted (the cursor is monotonic).
            self.dropped_inputs["stale_event"] = (
                self.dropped_inputs.get("stale_event", 0) + 1)
            return False

        t_frame0 = time.perf_counter()
        first = not self.map_inited
        # The fused frames write the state back in place: with them on,
        # what is kept past the next frame is copied.
        fused = self.cfg.tpu.fused_frame and not first
        keep = torch.clone if self.cfg.tpu.fused_frame else (lambda t: t)
        if self.cfg.evo.pose_output_en:
            self.trace_pre.append((t_ev, keep(self.packed)))
        # IMU-rate odometry over the interval this frame closes, from the
        # PREVIOUS posterior, before last_update_time advances.
        if (self.cfg.uav.imu_rate_odom and self.slam_mode != "only_lo"
                and not first):
            self.imu_rate_trajectory.extend(
                (t, R, p) for t, R, p, _ in self.imu_rate_poses(t_until=t_ev))
        if self._prefetch is not None and self._prefetch[0] == t_ev:
            imu_pack, pts_pack = self._prefetch[1]
        else:
            imu_pack, pts_pack = self._prepare_packet(t_ev, self._imu_buf())
        self._prefetch = None
        self.last_update_time = t_ev
        use_vio = self._use_images and img is not None and not first
        # Per-stage timing (the JAX package's condition, pipeline.py:
        # 1064-1065) takes precedence over the fused frame.
        staged = (self.cfg.tpu.stage_timing and not first
                  and self.slam_mode != "only_lo")
        defer_map = (self.cfg.tpu.deferred_map_insert and not first
                     and not staged)
        img_dev = None
        if use_vio:
            # push_image queued it as uint8; _ship_images may not have
            # uploaded it yet (tpu.img_upload_ahead = 0)
            img_dev = img if isinstance(img, torch.Tensor) else self._put(img)
        # the frame id as a device scalar: a graph reads it from a buffer
        fid = self._put(np.int32(self.frame_id)) if use_vio else None
        vdiag = n_it = stage_ms = None
        if staged:
            diag, vdiag, n_it, pg, stage_ms = self._staged_frame(
                imu_pack, pts_pack, img_dev, fid, use_vio)
        elif fused:
            run = (self._frame_graphs.run if self._frame_graphs is not None
                   else self._fused_frame)
            diag, vdiag, n_it, pg = run(imu_pack, pts_pack, img_dev, fid,
                                        use_vio, defer_map)
            # a replay overwrites its outputs: copy what is kept
            diag = diag.clone()
            vdiag = None if vdiag is None else vdiag.clone()
            if (self.cfg.publish.pub_effect_point_en
                    or self.cfg.pcd_save.pcd_save_en):
                pg = ScanPoints(*(t.clone() for t in pg))
        else:
            self.packed, self.vmap_state, diag, pg = self._frame_step(
                self.packed, self.vmap_state, imu_pack, pts_pack,
                first=first, do_map=not defer_map)
            if use_vio:
                # Split mode: the VIO half reads the map as the LIO half
                # left it (without this frame's insert when that is
                # deferred).
                self.packed, vdiag, n_it, self.pool = self._vio_half(
                    self.packed, img_dev, pg, fid, self.vmap_state)
            if defer_map:
                # The insert queues after the pose-producing work; the
                # next frame's match sees the updated map.
                self.vmap_state = self._insert(self.vmap_state, pg)
        if n_it is not None:
            # a device int from the device loops, read at finalize
            self.photo_iterations = self.photo_iterations + n_it
        self.map_inited = True
        if pg is not None:  # every frame but the map-building first
            if self.cfg.publish.pub_effect_point_en:
                self._effect_chunks.append((t_ev, pg))
            if self.cfg.pcd_save.pcd_save_en:
                # The downsampled posterior world points this frame gave
                # the map, coloured from the frame image when VIO ran
                # (XYZRGB), else geometry only (the reference's XYZI path).
                colors, visible = None, pg.valid
                if use_vio:
                    colors, visible = vio_mod.colorize_points(
                        img_dev.to(torch.float32), pg.pts_w, pg.valid,
                        self.state, self.cam, self.Rci, self.Pci,
                        blind=self.cfg.publish.blind_rgb_points)
                self._cloud_chunks.append(
                    (pg.pts_w, colors, visible, keep(self.packed[9:12])))
        # Map sliding: each check consumes the position snapshot taken at
        # the previous check (a 10-frame decision lag, harmless because
        # crossing sliding_thresh takes many frames), a pinned host copy
        # that has long landed when it is read: no host sync.
        if self.cfg.local_map.map_sliding_en and self.frame_id % 10 == 0:
            snap = self._pos_snapshot
            self._pos_snapshot = host_copy(self.packed[9:12])
            if snap is not None:
                pos = host_value(snap)
                if (np.linalg.norm(pos - self._last_slide_pos)
                        > self.cfg.local_map.sliding_thresh):
                    self._last_slide_pos = pos
                    self.map_slides += 1
                    self.vmap_state = vmap_mod.slide_map(
                        self.vmap_state, self._put(pos),
                        self.cfg.local_map.half_map_size, self.map_cfg)
        # One-ahead packet prefetch: the next event's upload overlaps this
        # frame's device work.
        self._prefetch_next()
        self._ship_images()
        self._trim_imu()
        if self.cfg.evo.pose_output_en:
            self.trace_post.append((t_ev, keep(self.packed)))
        is_kf = (bool(self.keyframe_every) and not first
                 and self.frame_id % self.keyframe_every == 0)
        self.frame_id += 1
        # Keep device tensors; converting here would sync every frame.
        self.trajectory.append((t_ev, keep(self.packed)))
        if is_kf:
            self._add_keyframe(t_ev, pts_pack, pg, img_dev, diag)
        t_end = time.perf_counter()
        row = dict(t=t_ev, t_wall=t_end, lio_s=t_end - t_frame0, vio_s=0.0,
                   host_ms=(t_end - t_frame0) * 1e3, diag=diag)
        if vdiag is not None:
            row["vdiag"] = vdiag  # merges into diag[2:5] at finalize
        if stage_ms is not None:
            row.update(stage_ms)
        self.log.add(**row)
        if progress and self.frame_id % 10 == 0:
            print(f"[{self.slam_mode}] frame {self.frame_id} t={t_ev:.2f} "
                  f"pos={self.packed[9:12].cpu().numpy().round(3)}")
        return True

    def _finalize_host_views(self):
        """All device->host conversions of the trajectory and diagnostics
        in one transfer each, at the end of the run (after draining the
        refinement in flight)."""
        if self.online_refine:
            self._consume_refine(force=True)
        if isinstance(self.photo_iterations, torch.Tensor):
            self.photo_iterations = int(self.photo_iterations)
        new_idx = [i for i, row in enumerate(self.trajectory) if len(row) == 2]
        if not new_idx:
            return
        host = torch.stack([self.trajectory[i][1][0:12]
                            for i in new_idx]).cpu().numpy()
        diag_rows = [r for r in self.log.rows if "diag" in r]
        host_diag = (torch.stack([r["diag"] for r in diag_rows]).cpu().numpy()
                     if diag_rows else None)
        vd_rows = [r for r in diag_rows if "vdiag" in r]
        host_vd = (torch.stack([r["vdiag"] for r in vd_rows]).cpu().numpy()
                   if vd_rows else None)
        for j, i in enumerate(new_idx):
            t = self.trajectory[i][0]
            self.trajectory[i] = (t, host[j, 0:9].reshape(3, 3), host[j, 9:12])
        vd_of = {id(r): host_vd[j] for j, r in enumerate(vd_rows)}
        for j, r in enumerate(diag_rows):
            d = host_diag[j]
            vd = vd_of.get(id(r))
            if vd is not None:  # the VIO half's columns
                d = np.concatenate([d[0:2], vd, d[5:6]])
            r.pop("diag")
            r.pop("vdiag", None)
            r.update(n_eff=int(d[0]), mean_res=float(d[1]),
                     n_tracked=int(d[2]), n_added=int(d[3]),
                     vio_err=float(d[4]), plane_cond=float(d[5]))

    def imu_rate_poses(self, t_until: Optional[float] = None):
        """IMU-rate odometry between frame updates: forward-only
        propagation of the last posterior through the buffered IMU samples
        in (last_update_time, t_until] (the 250 Hz imu_prop_callback,
        LIVMapper.cpp:576-635). Returns [(t, R (3,3), p (3,), v (3,)), ...]
        at IMU sample times. One device-to-host read per call, so one per
        frame with uav.imu_rate_odom (off in every shipped config), as in
        the JAX package."""
        if not self.imu_inited or self.last_update_time is None \
                or not len(self._imu_t):
            return []
        t0 = self.last_update_time
        t1 = self._imu_t[-1] if t_until is None else t_until
        if t1 <= t0:
            return []
        st, gy, ac = self._imu_slice(t0, t1, self._imu_buf())
        b = imu_mod.prepare_imu_batch(st, gy, ac, t0, t1,
                                      self.cfg.tpu.max_imu_per_packet)
        offs_end, R, p, v, valid = imu_mod.imu_rate_odometry(
            self.state, imu_mod.ImuBatch(*(self._put(x) for x in b)),
            self.noise)
        host = torch.cat([offs_end[:, None], R.reshape(-1, 9), p, v,
                          valid[:, None]], dim=1).cpu().numpy()
        host = host[host[:, -1] > 0.5]
        return [(t0 + float(r[0]), r[1:10].reshape(3, 3), r[10:13], r[13:16])
                for r in host]

    def effect_points(self):
        """Per-frame effective points: the scan points that matched a map
        plane in the final LIO iteration (publish/pub_effect_point_en ->
        publish_effect_world, LIVMapper.cpp:446). Returns
        [(t, pts_w (M, 3) np)], read from the device in one transfer."""
        if not self._effect_chunks:
            return []
        pts = torch.stack([pg.pts_w for _, pg in self._effect_chunks])
        keep = torch.stack([pg.valid & (pg.normal.abs().sum(dim=1) > 0)
                            for _, pg in self._effect_chunks])
        host = torch.cat([pts, keep[..., None].to(torch.float32)],
                         dim=-1).cpu().numpy()
        return [(t, h[h[:, 3] > 0.5, 0:3])
                for (t, _), h in zip(self._effect_chunks, host)]

    def print_stage_table(self, last_n: Optional[int] = None) -> str:
        """Render the per-frame table of FrameLog rows in the reference's
        box style (LIVMapper.cpp:465-476 / vio.cpp:1851-1868). The stage
        columns (propagate .. vio) and their Total render when
        tpu.stage_timing filled them; otherwise the host rows. Returns
        the string (and prints it)."""
        from ..utils.timing import STAGES, StageTable

        tab = StageTable("LIVO per-frame stages")
        has_stages = any("lio_ms" in r for r in self.log.rows)
        # host_ms contains the timed stages: summing both would count
        # the frame twice
        keys = (tuple(f"{n}_ms" for n in STAGES) if has_stages
                else ("host_ms", "dev_wait_ms"))
        for r in self.log.rows:
            got = False
            for k in keys:
                if k in r:
                    tab.mark(k.replace("_ms", ""), r[k] * 1e-3)
                    got = True
            if got:
                tab.end_frame()
        out = tab.render(last_n=last_n)
        print(out)
        return out

    def save_state_traces(self, pre_path: str, post_path: str):
        """Write pre/post-update state rows (t, euler deg, pos, vel, bg,
        ba, inv_expo) like Log/mat_pre.txt / mat_out.txt, one device
        transfer per file."""
        for path, trace in ((pre_path, self.trace_pre),
                            (post_path, self.trace_post)):
            if not trace:
                continue
            rows = torch.stack([v[0:25] for _, v in trace])
            euler = so3.euler_zyx(rows[:, 0:9].reshape(-1, 3, 3)) * 57.3
            # pos, vel, bias_g, bias_a (9:21) and the inverse exposure (24)
            host = torch.cat([euler, rows[:, 9:21], rows[:, 24:25]],
                             dim=1).cpu().numpy()
            ts = np.array([t for t, _ in trace])
            np.savetxt(path, np.column_stack([ts, host.astype(np.float64)]),
                       fmt="%.6f")

    def save_images(self, out_dir: str, overlay: bool = True):
        """Dump the reference-frame ring as PNGs, optionally with tracked-
        point overlays: each valid visual map point is projected into the
        frame's camera pose and marked green (converged) or red (not yet),
        the reference's plotTrackedPoints diagnostic (vio.cpp:1699-1740).
        Host-side, at the end of the run. Returns the paths written."""
        os.makedirs(out_dir, exist_ok=True)
        if self.ring is None:  # no camera in this mode
            return []
        imgs = self.ring.imgs.cpu().numpy()
        ids = self.ring.ids.cpu().numpy()
        if overlay:
            pv = vio_mod.pool_point_valid(self.pool)
            pw = vio_mod.pool_pos(self.pool)[pv].cpu().numpy()
            conv = vio_mod.pool_converged(self.pool)[pv].cpu().numpy()
            Rci = self.Rci.cpu().numpy()
            Pci = self.Pci.cpu().numpy()
        h, w = imgs.shape[-2:]
        written = []
        for slot in np.argsort(ids):
            fid = int(ids[slot])
            if fid < 0:
                continue
            g = np.clip(imgs[slot], 0, 255)
            rgb = np.repeat(g[:, :, None], 3, axis=-1)
            if overlay and fid < len(self.trajectory) and len(pw):
                t, R, p = self.trajectory[fid]
                Rcw = Rci @ np.asarray(R).T
                pc = (pw - np.asarray(p)) @ Rcw.T + Pci
                front = pc[:, 2] > 0.1
                px = cam_mod.world2cam(
                    self.cam, torch.from_numpy(np.asarray(pc, np.float32))
                ).numpy()
                u = np.round(px[:, 0]).astype(int)
                v = np.round(px[:, 1]).astype(int)
                ok = front & (u >= 2) & (u < w - 2) & (v >= 2) & (v < h - 2)
                for ui, vi, ci in zip(u[ok], v[ok], conv[ok]):
                    color = (0, 255, 0) if ci else (255, 80, 80)
                    rgb[vi - 1:vi + 2, ui - 1:ui + 2] = color
            path = os.path.join(out_dir, f"{fid:05d}.png")
            export_mod.write_png(path, rgb)
            written.append(path)
        return written

    def _collect_cloud(self):
        """The accumulated world cloud, read from the device in one batched
        transfer: (pts (M, 3), rgb (M, 3) uint8 or None, per-chunk sensor
        positions (K, 3), chunk ids (M,))."""
        chunks = self._cloud_chunks
        if not chunks:
            return (np.zeros((0, 3), np.float32), None,
                    np.zeros((0, 3), np.float32), np.zeros(0, np.int32))
        has_color = chunks[0][1] is not None
        cols = [torch.cat([c[0] for c in chunks]),
                torch.cat([c[2] for c in chunks]).to(torch.float32)[:, None]]
        if has_color:
            cols.append(torch.cat([c[1] for c in chunks]))
        host = torch.cat(cols, dim=1).cpu().numpy()
        sensors = torch.stack([c[3] for c in chunks]).cpu().numpy()
        keep = host[:, 3] > 0.5
        n = chunks[0][0].shape[0]
        chunk_id = np.repeat(np.arange(len(chunks), dtype=np.int32), n)
        rgb = None
        if has_color:
            c = host[:, 4:]
            if c.shape[1] == 1:
                c = np.repeat(c, 3, axis=1)
            rgb = np.clip(c, 0, 255).astype(np.uint8)[keep]
        return (np.ascontiguousarray(host[keep, 0:3]), rgb, sensors,
                chunk_id[keep])

    def save_pcd(self, path: str, binary: bool = True):
        """Write the accumulated world cloud (savePCD, LIVMapper.cpp:
        484-532; enable with pcd_save/pcd_save_en). XYZRGB when images
        coloured the run, XYZ otherwise. Returns the point count."""
        pts, rgb, _, _ = self._collect_cloud()
        export_mod.write_pcd(path, pts, colors=rgb, binary=binary)
        return len(pts)

    def save_mesh(self, path: str, grid: int = 256, min_weight: float = 1.0):
        """Dense coloured mesh of the accumulated cloud: TSDF integration
        on the device per frame chunk (sensor origin = that frame's
        posterior position), then on the host marching tetrahedra, vertex
        recolouring and a PLY (the reference's savePCD + scripts/mesh.py
        chain in one call). Returns the face count; `mesh_seconds` holds
        the integration time (synchronized) and the extraction time."""
        pts, rgb, _, chunk_id = self._collect_cloud()
        if not len(pts):
            tsdf_mod.write_ply_mesh(path, np.zeros((0, 3)),
                                    np.zeros((0, 3), np.int32))
            return 0
        t0 = time.perf_counter()
        center = 0.5 * (pts.min(0) + pts.max(0))
        side = float((pts.max(0) - pts.min(0)).max()) * 1.1 + 1e-3
        vol = tsdf_mod.make_volume(center, side, grid=grid, device=self.device)
        # The chunks integrate from where they already lie (the kept
        # points by mask); chunks with no kept point are skipped, as the
        # JAX package skips them.
        for k in np.unique(chunk_id):
            pts_w, _, keep, sensor = self._cloud_chunks[k]
            vol = tsdf_mod.integrate(vol, pts_w, keep, sensor)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        verts, faces = tsdf_mod.extract_mesh(vol, min_weight=min_weight)
        colors = (tsdf_mod.colorize_vertices(verts, pts, rgb)
                  if rgb is not None and len(verts) else None)
        tsdf_mod.write_ply_mesh(path, verts, faces, colors)
        self.mesh_seconds = {"integrate_s": t1 - t0,
                             "extract_s": time.perf_counter() - t1}
        return len(faces)

    def export_colmap(self, out_dir: str):
        """COLMAP sparse-model text export of the camera trajectory and
        the visual map points (reference vio.cpp:128-143, :1762-1784,
        scripts/colmap_output.sh)."""
        Rci = self.Rci.cpu().numpy()
        Pci = self.Pci.cpu().numpy()
        frames = []
        for i, (t, R, p) in enumerate(self.trajectory):
            Rcw = Rci @ R.T
            t_cw = -Rcw @ p + Pci
            # IMAGE_ID is 1-based (COLMAP convention); NAME matches the
            # 0-based frame-id filenames save_images dumps.
            frames.append((i + 1, Rcw, t_cw, f"{i:05d}.png"))
        if self.pool is None:
            pts3d = np.zeros((0, 3), np.float32)
        else:
            pts3d = vio_mod.pool_pos(self.pool)[
                vio_mod.pool_point_valid(self.pool)].cpu().numpy()
        export_mod.write_colmap(out_dir, self.cam, frames, points3d=pts3d)

    # ---------- the sliding-window backend (parallel/ba.py) ----------

    def _add_keyframe(self, t_ev: float, pts_pack, pg: ScanPoints, img_dev,
                      diag):
        """Keep this frame as a keyframe: a copy of the posterior state
        (a fused frame's state is a graph buffer the next replay
        overwrites), the body-frame scan and, with refine_photo on a VIO
        frame, its photometric factors; start the state's host copy (the
        IMU links read its biases); then, with online refinement, collect
        a finished window and submit the next one."""
        packed = self.packed.clone()
        scan4 = (self._kf_scan_raw(pts_pack) if self.kf_use_raw
                 else self._kf_scan(packed, pg))
        photo = None
        if self.refine_photo and img_dev is not None:
            photo = self._capture_photo(packed, img_dev, pg)
        if self.refine_gate > 0.0:
            # the one host read a keyframe: the degeneracy signal the
            # submit gate reads (diag[5] = plane conditioning)
            self._kf_conds.append(float(diag[5]))
        # (the host copy: the state's 25 floats, not its covariance)
        self._keyframes.append((t_ev, packed, scan4, photo,
                                host_copy(packed[0:25])))
        if self.online_refine and self._refiner is not None:
            self._consume_refine()
            k = len(self._keyframes)
            if (k >= self.refine_window_size
                    and k - self._last_refine_k >= self.refine_stride
                    and self._submit_refine()):
                self._last_refine_k = k

    def _kf_strided(self, n: int) -> slice:
        """`kf_points` rows of n, evenly strided (spatially fair)."""
        k = min(self.kf_points, n)
        step = max(1, n // k)
        return slice(0, k * step, step)

    def _kf_scan(self, packed, pg: ScanPoints):
        """(kf_points, 4) [body xyz | valid] of the frame's undistorted
        posterior scan: R^T (p_w - p) of the strided rows."""
        state, _ = unpack_state(packed)
        sl = self._kf_strided(pg.pts_w.shape[0])
        body = (pg.pts_w[sl] - state.pos) @ state.rot
        return torch.cat([body, pg.valid[sl, None].to(torch.float32)], dim=-1)

    def _kf_scan_raw(self, pts_pack):
        """The raw (distorted) packet's strided rows, as _kf_scan's."""
        pts, _, valid = self._unpack_pts(pts_pack)
        sl = self._kf_strided(pts.shape[0])
        return torch.cat([pts[sl], valid[sl, None].to(torch.float32)], dim=-1)

    def _capture_photo(self, packed, img_dev, pg: ScanPoints):
        """A keyframe's photometric factors (LIVO): the frame's retrieval
        re-run at the posterior state (vio.capture_photo_factors).
        Returns (img u8, tau, pos, target, valid, scale) on the device."""
        state, _ = unpack_state(packed)
        pos, tgt, val, scale = vio_mod.capture_photo_factors(
            self.pool, self.ring, img_dev.to(torch.float32), state,
            pg.pts_w, pg.valid, self.cam, self.Rci, self.Pci, self.vio_cfg)
        return (img_dev, state.inv_expo, pos, tgt, val, scale)

    def enable_online_refine(self, keyframe_every: int = 10,
                             window: int = 16, stride: int = 8,
                             outer_iters: int = 2, gn_iters: int = 2,
                             feedback: bool = True, mesh=None,
                             photo: bool = False, gate: float = 0.0):
        """Turn on the online sliding-window backend: a keyframe every
        `keyframe_every` frames, and every `stride` keyframes an
        asynchronous refinement of the last `window` keyframes
        (parallel/ba.OnlineRefiner, on its own CUDA stream on the card).
        When one completes, the refined poses go to `refined_keyframes`
        and, with `feedback`, the newest keyframe's pose delta is applied
        to the live filter state if it is small (< 2 deg, < 0.5 m).
        `photo`: photometric pose factors from each keyframe (LIVO).
        gate: 0 = always on; > 0 = submit a window only when some
        keyframe's plane conditioning (the smallest eigenvalue of the
        normalized matched-normal second moment, FrameLog `plane_cond`,
        in [0, 1/3]) fell below it.
        mesh: a parallel.sharding.Mesh to shard each window's keyframes
        over (ba.refine_window(mesh=)). In this SPMD model every rank runs
        the same frames in its own pipeline and only the refinement is
        sharded: the refiner runs each window eagerly and every rank
        takes the result at the same keyframe (ba.OnlineRefiner), and
        rank 0's gate decision holds on every rank."""
        from ..parallel import ba

        self._refiner = ba.OnlineRefiner(
            self.map_cfg, outer_iters=outer_iters, gn_iters=gn_iters,
            dept_err=self.cfg.lio.dept_err, beam_err=self.cfg.lio.beam_err,
            mesh=mesh, cam=self.cam if photo else None, Rci=self.Rci,
            Pci=self.Pci, patch_size=self.vio_cfg.patch_size,
            photo_weight=1.0 / self.cfg.vio.img_point_cov)
        self.keyframe_every = keyframe_every
        self.online_refine = True
        self.refine_window_size = window
        self.refine_stride = stride
        self.refine_feedback = feedback
        self.refine_photo = photo
        self.refine_gate = gate
        self._kf_conds = []

    def _kf_window(self, kfs):
        from ..parallel import ba

        return ba.Window(
            rot=torch.stack([kf[1][0:9].reshape(3, 3) for kf in kfs]),
            pos=torch.stack([kf[1][9:12] for kf in kfs]),
            scans=torch.stack([kf[2][:, 0:3] for kf in kfs]),
            valid=torch.stack([kf[2][:, 3] > 0.5 for kf in kfs]))

    def _build_photo(self, kfs):
        """The keyframes' captures as ba.PhotoFactors; None unless every
        keyframe of the window carries one."""
        from ..parallel import ba

        if not all(kf[3] is not None for kf in kfs):
            return None
        ph = [kf[3] for kf in kfs]
        return ba.PhotoFactors(
            img=torch.stack([p[0] for p in ph]).to(torch.float32),
            inv_expo=torch.stack([p[1] for p in ph]),
            pts_w=torch.stack([p[2] for p in ph]),
            target=torch.stack([p[3] for p in ph]),
            valid=torch.stack([p[4] for p in ph]),
            scale=torch.stack([p[5] for p in ph]))

    def _build_links(self, kfs):
        """Preintegrated IMU links between consecutive keyframes
        (ba.ImuLinks) from the kept raw IMU history, biased by each
        link's start keyframe's filter biases. Those come from the
        keyframes' host copies: every start keyframe is older than the
        newest, so its copy has landed and reading it waits for nothing
        on the device. Velocities and gravity are gathered on the
        device."""
        from ..parallel import ba

        if not self._imu_hist:
            return None
        K = len(kfs)
        ts = np.array([kf[0] for kf in kfs])
        t_all = np.concatenate([h[0] for h in self._imu_hist])
        g_all = np.concatenate([h[1] for h in self._imu_hist])
        a_all = np.concatenate([h[2] for h in self._imu_hist])
        lo = ts[0] - 2.0  # trim the history below the window
        if len(t_all) and t_all[0] < lo - 10.0:
            keep = t_all >= lo
            self._imu_hist = [(t_all[keep], g_all[keep], a_all[keep])]
        dR = np.tile(np.eye(3), (K, 1, 1))
        dp = np.zeros((K, 3))
        dts = np.full(K, 1e-3)
        valid = np.zeros(K, bool)
        for k in range(K - 1):
            st = _host_state(kfs[k]).astype(np.float64)
            dRk, dpk, dtk = ba.preintegrate(
                t_all, g_all, a_all, st[15:18], st[18:21], ts[k], ts[k + 1])
            dR[k], dp[k], dts[k] = dRk, dpk, max(dtk, 1e-3)
            # a sample-free interval (the dtk == 0 sentinel) must not
            # become an identity link asserting zero relative motion
            valid[k] = dtk > 1e-3
        f32 = np.float32
        return ba.ImuLinks(
            dR=self._put(dR.astype(f32)), dp=self._put(dp.astype(f32)),
            dt=self._put(dts.astype(f32)),
            vel=torch.stack([kf[1][12:15] for kf in kfs]),
            grav=kfs[-1][1][21:24], valid=self._put(valid))

    def _submit_refine(self) -> bool:
        kfs = self._keyframes[-self.refine_window_size:]
        if self.refine_gate > 0.0:
            conds = self._kf_conds[-self.refine_window_size:]
            if shd.agree(bool(conds) and min(conds) >= self.refine_gate,
                         self._refiner.mesh):
                # a healthy window: skip the backend (the check re-runs at
                # every later keyframe, so degeneracy engages within one)
                self.refine_gate_skips += 1
                return False
        links = self._build_links(kfs) if self.refine_imu_links else None
        photo = self._build_photo(kfs) if self.refine_photo else None
        ok = self._refiner.submit(self._kf_window(kfs), meta=kfs,
                                  links=links, photo=photo)
        self.refine_submits += ok
        return ok

    def _consume_refine(self, force: bool = False):
        """Collect a completed refinement (waiting for it only with
        force) and apply the newest keyframe's pose delta to the live
        state. A fused pipeline's next replay reads the new state: its
        graph copies it into the static buffer first (FrameGraphs._bind),
        as after a map slide."""
        if self._refiner is None:
            return
        out = self._refiner.poll(force=force)
        if out is None:
            return
        kfs, rot_r, pos_r = out
        for i, kf in enumerate(kfs):
            self.refined_keyframes[kf[0]] = (rot_r[i], pos_r[i])
        if not self.refine_feedback:
            return
        st0 = _host_state(kfs[-1])
        R_d = rot_r[-1] @ st0[0:9].reshape(3, 3).T
        p_d = pos_r[-1] - R_d @ st0[9:12]
        ang = np.degrees(np.arccos(np.clip((np.trace(R_d) - 1) / 2, -1, 1)))
        if ang < _MAX_DELTA_DEG and np.linalg.norm(p_d) < _MAX_DELTA_M:
            self.packed = self._apply_delta(self.packed, R_d, p_d)
            self._refine_deltas.append((self.last_update_time, R_d, p_d))

    def _apply_delta(self, packed, R_d, p_d):
        """Left (world-frame) SE(3) correction from the backend: T <- D T
        for the pose, v <- R_d v; biases, gravity and covariance
        untouched. Returns a new packed state."""
        state, cov = unpack_state(packed)
        R = self._put(np.asarray(R_d, np.float32))
        p = self._put(np.asarray(p_d, np.float32))
        return pack_state(state._replace(
            rot=so3.normalize_rotation(R @ state.rot), pos=R @ state.pos + p,
            vel=R @ state.vel), cov)

    def refined_keyframe_trajectory(self):
        """[(t, R, p)] of every keyframe, its refined pose where a window
        covered it (the newest refinement wins): the backend's smoothed
        trajectory."""
        out = []
        for kf in self._keyframes:
            if kf[0] in self.refined_keyframes:
                R, p = self.refined_keyframes[kf[0]]
            else:
                v = _host_state(kf)
                R, p = v[0:9].reshape(3, 3), v[9:12]
            out.append((kf[0], R, p))
        return out

    def refine_trajectory(self, outer_iters: int = 2, gn_iters: int = 3,
                          max_keyframes: int = 32, mesh=None,
                          imu_links: bool = True, photo: bool = None):
        """Post-run sliding-window refinement of the last `max_keyframes`
        keyframes (set `keyframe_every` before the run), with the IMU
        links where the history has them and, with `photo` (default
        refine_photo), the photometric factors. Returns [(t, R, p)].
        mesh: a parallel.sharding.Mesh to shard the keyframes over
        (ba.refine_window(mesh=)); every rank, having run the same frames,
        calls this and gets every refined pose back."""
        from ..parallel import ba

        if not self._keyframes:
            raise ValueError("no keyframes: set keyframe_every before the run")
        kfs = self._keyframes[-max_keyframes:]
        use_photo = self.refine_photo if photo is None else photo
        refined, _ = ba.refine_window(
            self._kf_window(kfs), self.map_cfg, outer_iters=outer_iters,
            gn_iters=gn_iters, dept_err=self.cfg.lio.dept_err,
            beam_err=self.cfg.lio.beam_err, mesh=mesh,
            imu_links=self._build_links(kfs) if imu_links else None,
            photo=self._build_photo(kfs) if use_photo else None,
            cam=self.cam, Rci=self.Rci, Pci=self.Pci,
            patch_size=self.vio_cfg.patch_size,
            photo_weight=1.0 / self.cfg.vio.img_point_cov)
        R_np = refined.rot.cpu().numpy()
        p_np = refined.pos.cpu().numpy()
        return [(kf[0], R_np[i], p_np[i]) for i, kf in enumerate(kfs)]


def _host_state(kf) -> np.ndarray:
    """A keyframe's (25,) packed state on the host, from its copy."""
    return host_value(kf[4])

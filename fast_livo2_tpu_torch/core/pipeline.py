"""The LIVO pipeline: measurement sync + per-frame LIO and VIO steps on
the device (port of fast_livo2_tpu/core/pipeline.py: LIVO in split mode,
ONLY_LIO and ONLY_LO).

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

Host syncs per frame: the LIO loop reads one bool per iteration
(core/lio.py, at most max_iterations - 1); the photometric loop reads
one per iteration but the last of each pyramid level (core/vio.py, at
most 16 at the defaults); with map sliding enabled one 3-float position
read every 10 frames. Trajectory and diagnostics stay on the device
until `_finalize_host_views` converts them once, at the end.

Not in this slice (the constructor raises NotImplementedError naming the
ROADMAP.md item): raycast recovery and the inverse-compositional update,
per-stage timing, the fused frame, point-cloud/effect-point/state-trace
outputs, IMU-rate odometry, keyframes and online refinement.
"""

import bisect
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import camera as cam_mod
from ..models import lidar as lidar_mod
from ..ops import eig3, so3
from ..utils.config import LIVOConfig
from . import imu as imu_mod
from . import lio as lio_mod
from . import vio as vio_mod
from . import voxel_map as vmap_mod
from .state import init_cov, init_state, pack_state, unpack_state

# (config predicate, flag name, ROADMAP.md item that ports it)
_UNPORTED_FLAGS = (
    (lambda c: c.tpu.stage_timing, "tpu.stage_timing", "Queue 1 item 17"),
    (lambda c: c.tpu.fused_frame, "tpu.fused_frame", "Queue 1 item 17"),
    (lambda c: c.pcd_save.pcd_save_en, "pcd_save.pcd_save_en",
     "Queue 1 item 13"),
    (lambda c: c.publish.pub_effect_point_en, "publish.pub_effect_point_en",
     "Queue 1 item 13"),
    (lambda c: c.uav.imu_rate_odom, "uav.imu_rate_odom", "Queue 1 item 13"),
    (lambda c: c.evo.pose_output_en, "evo.pose_output_en", "Queue 1 item 13"),
)
# the same, for flags that only the VIO half reads (LIVO mode)
_UNPORTED_VIO_FLAGS = (
    (lambda c: c.vio.raycast_en, "vio.raycast_en", "Queue 1 item 12"),
    (lambda c: c.vio.inverse_composition_en, "vio.inverse_composition_en",
     "Queue 1 item 12"),
)


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
        flags = _UNPORTED_FLAGS + (_UNPORTED_VIO_FLAGS if slam_mode == "livo"
                                   else ())
        for pred, name, item in flags:
            if pred(cfg):
                raise NotImplementedError(
                    f"config flag {name} is not ported yet: ROADMAP.md {item}")
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
        self._last_slide_pos = np.zeros(3)
        self._pos_snapshot = None  # position copy consumed at the next check

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

    def _frame_step(self, packed_sc, vmap_state, imu_pack, pts_pack,
                    first: bool, do_map: bool = True):
        """One frame's LIO half on the device. imu_pack: (K, 9) packed IMU
        intervals (a scalar packet duration in only_lo mode); pts_pack:
        the points wire packet (see `_unpack_pts`). Returns (packed_sc,
        map, diag (6,), pg) where pg (a ScanPoints) feeds the VIO half and
        the deferred map insert (None on the first frame)."""
        cfg = self.cfg
        state, cov = unpack_state(packed_sc)
        pts, t_offs, valid = self._unpack_pts(pts_pack)

        if self.slam_mode == "only_lo":
            dt = imu_pack  # scalar packet duration in this mode
            state_prop, cov_prop = imu_mod.propagate_without_imu(
                state, cov, dt, self.noise)
            und = imu_mod.undistort_without_imu(pts, t_offs, dt, state_prop)
        else:
            batch = imu_mod.ImuBatch(
                gyr=imu_pack[:, 0:3], acc=imu_pack[:, 3:6], dt=imu_pack[:, 6],
                offs_end=imu_pack[:, 7], valid=imu_pack[:, 8])
            state_prop, cov_prop, poses = imu_mod.propagate(
                state, cov, batch, self.noise)
            und = imu_mod.undistort(pts, t_offs, poses, state_prop,
                                    self.ext_R, self.ext_T)
        down, down_valid = lio_mod.voxel_downsample(
            und, valid, cfg.preprocess.filter_size_surf,
            cfg.tpu.max_points_down)
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

        res = lio_mod.lio_update(
            state_prop, cov_prop, vmap_state, down, down_valid,
            self.ext_R, self.ext_T, self.map_cfg,
            dept_err=cfg.lio.dept_err, beam_err=cfg.lio.beam_err,
            max_iterations=cfg.lio.max_iterations,
            rematch_fresh=cfg.tpu.lio_rematch_fresh,
            fresh_every_iter=cfg.tpu.lio_fresh_every_iter,
            plane_info_cap=cfg.tpu.lio_plane_info_cap,
        )
        var_w6 = vmap_mod.sym6(res.var_w)
        normal = torch.where(res.match.valid[:, None], res.match.normal, 0.0)
        if do_map:
            vmap_state = vmap_mod.update_map(
                vmap_state, res.pts_w, var_w6, down_valid, self.map_cfg,
                compact=True)
        zero = res.mean_residual.new_zeros(())
        diag = torch.stack([
            res.n_effective.to(torch.float32), res.mean_residual,
            zero, zero, zero, _plane_cond(res.match, down_valid),
        ])
        return (pack_state(res.state, res.cov), vmap_state, diag,
                ScanPoints(res.pts_w, normal, var_w6, down_valid))

    def _vio_half(self, packed_sc, img, pg: ScanPoints):
        """The VIO half of a LIVO frame (split mode) on the u8 image `img`
        (H, W). Updates the pool and ring in place. Returns (packed_sc,
        vdiag (3,) [n_tracked, n_added, mean_error], photometric
        iterations run)."""
        state, cov = unpack_state(packed_sc)
        vres = vio_mod.vio_step(
            state, cov, self.pool, self.ring, self.vmap_state,
            img.to(torch.float32), pg.pts_w, pg.normal, pg.var_w6, pg.valid,
            self.frame_id, self.cam, self.Rci, self.Pci, self.vio_cfg,
            self.map_cfg)
        self.pool, self.ring = vres.pool, vres.ring
        vdiag = torch.stack([vres.n_tracked.to(torch.float32),
                             vres.n_added.to(torch.float32), vres.mean_error])
        return pack_state(vres.state, vres.cov), vdiag, vres.photo_iterations

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
        if self._prefetch is not None and self._prefetch[0] == t_ev:
            imu_pack, pts_pack = self._prefetch[1]
        else:
            imu_pack, pts_pack = self._prepare_packet(t_ev, self._imu_buf())
        self._prefetch = None
        self.last_update_time = t_ev
        use_vio = self._use_images and img is not None and not first
        defer_map = self.cfg.tpu.deferred_map_insert and not first
        self.packed, self.vmap_state, diag, pg = self._frame_step(
            self.packed, self.vmap_state, imu_pack, pts_pack,
            first=first, do_map=not defer_map)
        vdiag = None
        if use_vio:
            # Split mode: the VIO half reads the map as the LIO half left
            # it (without this frame's insert when that is deferred).
            # push_image queued it as uint8; _ship_images may not have
            # uploaded it yet (tpu.img_upload_ahead = 0)
            img_dev = img if isinstance(img, torch.Tensor) else self._put(img)
            self.packed, vdiag, n_it = self._vio_half(self.packed, img_dev, pg)
            self.photo_iterations += n_it
        if defer_map:
            # The insert queues after the pose-producing work; the next
            # frame's match sees the updated map.
            self.vmap_state = vmap_mod.update_map(
                self.vmap_state, pg.pts_w, pg.var_w6, pg.valid, self.map_cfg,
                compact=True)
        self.map_inited = True
        # Map sliding: each check consumes the position snapshot taken at
        # the previous check (a 10-frame decision lag, harmless because
        # crossing sliding_thresh takes many frames).
        if self.cfg.local_map.map_sliding_en and self.frame_id % 10 == 0:
            snap = self._pos_snapshot
            self._pos_snapshot = self.packed[9:12].clone()
            if snap is not None:
                pos = snap.cpu().numpy()
                if (np.linalg.norm(pos - self._last_slide_pos)
                        > self.cfg.local_map.sliding_thresh):
                    self._last_slide_pos = pos
                    self.vmap_state = vmap_mod.slide_map(
                        self.vmap_state, snap,
                        self.cfg.local_map.half_map_size, self.map_cfg)
        # One-ahead packet prefetch: the next event's upload overlaps this
        # frame's device work.
        self._prefetch_next()
        self._ship_images()
        self._trim_imu()
        t_end = time.perf_counter()
        self.frame_id += 1
        # Keep device tensors; converting here would sync every frame.
        self.trajectory.append((t_ev, self.packed))
        row = dict(t=t_ev, t_wall=t_end, lio_s=t_end - t_frame0, vio_s=0.0,
                   host_ms=(t_end - t_frame0) * 1e3, diag=diag)
        if vdiag is not None:
            row["vdiag"] = vdiag  # merges into diag[2:5] at finalize
        self.log.add(**row)
        if progress and self.frame_id % 10 == 0:
            print(f"[{self.slam_mode}] frame {self.frame_id} t={t_ev:.2f} "
                  f"pos={self.packed[9:12].cpu().numpy().round(3)}")
        return True

    def _finalize_host_views(self):
        """All device->host conversions of the trajectory and diagnostics
        in one transfer each, at the end of the run."""
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

    def enable_online_refine(self, *args, **kwargs):
        raise NotImplementedError(
            "keyframes and online refinement are not ported yet: "
            "ROADMAP.md Queue 1 item 15")

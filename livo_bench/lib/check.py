"""How `correct` is decided: the program's own outputs of the timed path,
judged once the window has closed.

1. Step checks. For a few window frames drawn from the seed, the
   benchmark keeps a pinned host copy of the program's voxel map (keys
   and raw moments) before the frame and after it, and of its visual
   point pool and frame ring before it. The plain reference rebuilds the
   frame's packet from the recording, propagates the program's previous
   posterior (its trajectory row, covariance included), undistorts,
   downsamples, runs the iterated ESIKF against the map before the frame
   and inserts its posterior points (reference/lio.py); then, from its
   own LIO posterior and scan, runs the frame's VIO half against the
   pool and ring before the frame and the frame's image
   (reference/vio.py). Compared:
   - `insert_gap_m`: the program's LIO posterior, through what it
     inserted: in each frame, the median over the voxels both sides
     added the same number of points to of the gap between the mean
     positions of the points each added (metres);
   - `flip_share`: over the checked window frames together, the share
     of the voxels either side touched that got a different number of
     points (decisions parted: a point across a voxel boundary, a plane
     gate, a frozen or claimed voxel); pooled, because late in a run a
     frame adds to a few voxels only (1,200 in the first frames, 4-50
     after two minutes of the room), where one flip reads 0.1-0.25;
   - `vio_state_gap`: the frame's pose out (its trajectory row, after
     the VIO half) against the reference's, as `state_gap`;
   - `vio_cov_gap`: the rotation, position and exposure block of its
     covariance against the reference's, relative to the block's
     largest entry.
   A run reads each of the others at its second-worst frame: one frame in several
   hundred parts a decision (one seen: a hundred points matched
   otherwise, the pose millimetres away) and reads like the control in
   that frame alone, while the control moves every frame; a fault that
   strikes two frames of the sample shows.
2. The start: the map-building first frame's posterior (IMU init and
   propagation through K1, no update) against the reference's, every
   state entry and the covariance relative to its largest entry
   (`start_gap`), and its map insert among the step checks.
3. With a mix that turns the online backend on (lib/refine.py): the
   drawn backend windows against the reference's refinement, and the
   frame after each one's pose delta is fed back, from its prior with
   the delta applied (`apply_delta`).
4. Not compared: every window frame's position against the generator's
   ground truth, in the scene frame the filter starts from, is printed
   on an earlier line (`ground_truth`); it has no control reading, so
   no limit could be set from one. The pool's upkeep after the update
   (new points, observations, reference refinement) is judged only
   through the next checked frames that read it.

The control (`--control`): the reference itself in the program's place,
in float32 with TF32 matrix products, judged the same way.
"""

import numpy as np
import torch

from ..reference import lio as ref
from ..reference import vio as vio_ref


class Snapshots:
    """Pinned host copies of the program's state around sampled frames,
    queued on the current stream after the frame that precedes each:
    the map after each sampled frame and after the one before it (and
    after the first frame), the visual pool and ring before each
    sampled frame."""

    def __init__(self, pipe, n_sampled: int, frame0: bool):
        self.want = set()  # event times of the sampled frames
        self.frame0 = frame0
        self.after = {}  # trajectory row -> (keys, stats) after that frame
        self.before_vio = {}  # trajectory row -> (pool and ring tensors) before it
        self.rows = set()
        pin = pipe.vmap_state.keys.is_cuda

        def buffers(tensors, n):
            return [tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                          for t in tensors) for _ in range(n)]

        vm = pipe.vmap_state
        self.map_bufs = buffers((vm.keys, vm.stats), 2 * n_sampled + 1)
        self.vio_pool = (buffers(self._vio_state(pipe), n_sampled)
                         if pipe.pool is not None else [])

    @staticmethod
    def _vio_state(pipe):
        p, r = pipe.pool, pipe.ring
        return (p.point, p.obs, p.obs_patch, r.imgs, r.ids)

    @staticmethod
    def _copy(bufs, tensors):
        for b, t in zip(bufs, tensors):
            b.copy_(t, non_blocking=True)
        return bufs

    def after_frame(self, pipe, j, next_t=None):
        """Called after trajectory row j ran: copy the map if row j is
        the first frame, a sampled frame, or the frame before one, and
        the pool and ring before a sampled frame."""
        t = float(pipe.trajectory[j][0])
        nxt = next_t is not None and next_t in self.want
        if ((j == 0 and self.frame0) or t in self.want or nxt) and j not in self.after \
                and self.map_bufs:
            self.after[j] = self._copy(self.map_bufs.pop(), (pipe.vmap_state.keys,
                                                         pipe.vmap_state.stats))
        if nxt and self.vio_pool and j + 1 not in self.before_vio:
            self.before_vio[j + 1] = self._copy(self.vio_pool.pop(), self._vio_state(pipe))
        if t in self.want:
            self.rows.add(j)


def frame_inputs(rec, sensor, mcfg, t0, t1):
    gy, ac, dt, off = ref.imu_batch(rec.imu_t, rec.imu_gyr, rec.imu_acc, t0, t1,
                                    mcfg["max_imu"])
    pts, t_off = ref.scan_packet(rec.scans, t0, t1, mcfg["max_scan"])
    return gy, ac, dt, off, pts, t_off


def ref_frame(P, rec, sensor, mcfg, noise, prior_packed, mp, t0, t1, first,
              device):
    """The reference's LIO frame (t0, t1]: (posterior packed, key codes
    and added moments of its insert, n_eff, mean residual, posterior
    scan points in the world)."""
    f = P.dtype
    s, cov = ref.unpack(prior_packed.to(device), f)
    ext_R, ext_T = extrinsics(sensor, f, device)[:2]
    gy, ac, dt, off, pts, t_off = frame_inputs(rec, sensor, mcfg, t0, t1)
    sp, cp, starts = ref.propagate(P, s, cov, gy, ac, dt, noise)
    und = ref.undistort(P, pts, t_off, starts, off, dt, sp, ext_R, ext_T)
    down = ref.downsample(und, mcfg["leaf"], mcfg["max_down"])
    if first:
        bc = ref.body_cov(down, mcfg["dept_err"], mcfg["beam_err"])
        p_imu = P.mm(down, ext_R.T) + ext_T
        pts_w = P.mm(p_imu, sp.rot.T) + sp.pos
        R_e = P.mm(sp.rot, ext_R)
        cross = ref.skew(p_imu)
        var_w = (P.mm(P.mm(R_e, bc), R_e.T)
                 + P.mm(P.mm(cross, cp[0:3, 0:3]), cross.transpose(-1, -2)) + cp[3:6, 3:6])
        codes, delta = ref.insert(mp, pts_w, ref.sym6(var_w), mcfg, full=True)
        return ref.pack(sp, cp), codes, delta, 0, 0.0, pts_w
    post, cpost, pts_w, var6, n_eff, mean_res = ref.lio_update(
        P, sp, cp, mp, down, ext_R, ext_T, mcfg)
    codes, delta = ref.insert(mp, pts_w, var6, mcfg, full=False)
    return ref.pack(post, cpost), codes, delta, n_eff, mean_res, pts_w


def extrinsics(sensor, f, device):
    """(LiDAR-to-IMU R, T; camera-from-IMU R, P) of the sensor yaml."""
    e = sensor["extrin_calib"]
    t = lambda k: torch.tensor(e[k], dtype=f, device=device)  # noqa: E731
    ext_R, ext_T = t("extrinsic_R").reshape(3, 3), t("extrinsic_T")
    Rcl, Pcl = t("Rcl").reshape(3, 3), t("Pcl")
    return ext_R, ext_T, Rcl @ ext_R.T, Rcl @ (-(ext_R.T @ ext_T)) + Pcl


def ref_vio(P, deploy, post_packed, pts_w, pool, img, fid, device):
    """The reference's VIO half from a LIO posterior: (posterior packed,
    points tracked)."""
    c = vio_ref.camera(deploy["camera"])
    cfg = vio_ref.settings(deploy["sensor"], c)
    s, cov = ref.unpack(post_packed.to(device), P.dtype)
    Rci, Pci = extrinsics(deploy["sensor"], P.dtype, device)[2:]
    s, cov, n = vio_ref.vio_frame(P, c, cfg, s, cov, pool, img, fid, pts_w.to(P.dtype),
                                  Rci, Pci)
    return ref.pack(s, cov), n


def apply_delta(packed, R_d, p_d):
    """A packed state with the backend's pose delta applied, as the
    pipeline documents its feedback: a left (world-frame) SE(3)
    correction T <- D T of the pose and v <- R_d v, the biases, gravity,
    exposure and covariance left as they are; in float64."""
    v = packed.to(torch.float64).clone()
    R = torch.as_tensor(np.asarray(R_d, np.float64))
    p = torch.as_tensor(np.asarray(p_d, np.float64))
    v[0:9] = (R @ v[0:9].reshape(3, 3)).reshape(9)
    v[9:12] = R @ v[9:12] + p
    v[12:15] = R @ v[12:15]
    return v


def program_delta(before, after, f, device):
    """Key codes and added moments of the program's insert: every slot
    whose key or moments changed."""
    kb, sb = (x.to(device) for x in before)
    ka, sa = (x.to(device) for x in after)
    occ = ka[..., 0] != ref.EMPTY
    same = torch.all(kb == ka, -1)
    touched = occ & (~same | torch.any(sb != sa, -1))
    layer = torch.arange(ka.shape[0], device=device)[:, None].expand(occ.shape)[touched]
    codes = ref.key_code(layer, ka[touched])
    delta = sa[touched].to(f) - torch.where(same[touched][:, None], sb[touched].to(f), 0.0)
    order = torch.argsort(codes)
    return codes[order], delta[order]


def compare_inserts(pc, pd, rc, rd):
    """(median and widest mean-position gap over the voxels with equal
    added counts, the touched voxels whose counts differ, the voxels
    either side touched)."""
    allc = torch.unique(torch.cat([pc, rc]))
    n = allc.shape[0]
    if n == 0:
        return 0.0, 0.0, 0, 0
    dev, f = pd.device, pd.dtype

    def spread(codes, d):
        out = torch.zeros((n, 16), dtype=f, device=dev)
        out[torch.searchsorted(allc, codes)] = d
        return out

    P, R = spread(pc, pd), spread(rc, rd)
    same = P[:, 0] == R[:, 0]
    live = same & (R[:, 0] > 0)
    gap = torch.linalg.norm(P[:, 1:4] - R[:, 1:4], dim=-1) / torch.clamp(R[:, 0], min=1.0)
    g = gap[live]
    med, worst = ((float(g.median()), float(g.max())) if g.numel() else (0.0, 0.0))
    return med, worst, int((~same).sum()), n


def state_gap(a, b):
    """Widest gap of two packed states: rotation (rad), position, velocity,
    biases, gravity, exposure entries, and the covariance relative to the
    reference's largest entry."""
    sa, ca = ref.unpack(a, torch.float64)
    sb, cb = ref.unpack(b, torch.float64)
    rot = float(torch.linalg.norm(ref.so3_log(sb.rot.T @ sa.rot)))
    vec = float(torch.max(torch.abs(a[9:25].to(torch.float64) - b[9:25].to(torch.float64))))
    cov = float(torch.max(torch.abs(ca - cb)) / torch.max(torch.abs(cb)))
    return max(rot, vec, cov)


def pose_cov_gap(a, b):
    """Gap of the rotation, position and exposure block (7 x 7) of two
    packed states' covariances, relative to the reference's largest
    entry there."""
    ca = ref.unpack(a, torch.float64)[1][0:7, 0:7]
    cb = ref.unpack(b, torch.float64)[1][0:7, 0:7]
    return float(torch.max(torch.abs(ca - cb)) / torch.max(torch.abs(cb)))


def second_worst(values):
    """A run's reading of a per-frame number: its second-largest frame
    (the largest where one frame was checked); None where a frame gave
    none; infinite where a frame read NaN (no decision parts to a NaN)."""
    if not values or any(v is None for v in values):
        return None
    if any(np.isnan(v) for v in values):
        return float("inf")
    v = sorted(values, reverse=True)
    return float(v[1] if len(v) > 1 else v[0])


def gt_error(rec, times, positions):
    """Widest distance of each frame's position, in the scene frame the
    filter starts from (the still start's pose), from the ground truth
    at its stamp."""
    R0, p0 = rec.gt_R[0], rec.gt_p[0]
    idx = np.searchsorted(rec.gt_t, np.asarray(times) - 1e-9)
    idx = np.clip(idx, 0, len(rec.gt_t) - 1)
    est = positions @ R0.T + p0
    return float(np.max(np.linalg.norm(est - rec.gt_p[idx], axis=-1)))


def judge(readings: dict, limits: dict):
    """(correct, [(name, reading, limit)]): every compared reading at or
    under its limit, and none missing."""
    rows = [(k, readings.get(k), limits[k]) for k in sorted(limits)]
    ok = all(v is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows

"""Plain reference of one LIO frame of FAST-LIVO2, for judging the port.

What a fused frame computes before its pose leaves the LIO half, written
out once more from the algorithm (FAST-LIVO2's IMU_Processing.cpp,
voxel_map.cpp and LIVMapper.cpp, as the JAX package and its port
document their batched form), in plain torch at float64 with no kernel,
cache or batching trick, one step at a time:

- the packet: the IMU slice and interval batch of the sync cut (t0, t],
  the scan points stamped in (t0, t], evenly decimated past the pad size;
- IMU propagation: rotation by sequential products, velocity and
  position by sums, the 19 x 19 covariance by P <- F P F^T + Q one
  interval after another (what the cov_scan kernel computes);
- undistortion of each point to the scan end;
- the voxel-grid centroid downsample (the ordered add's first site);
- the iterated point-to-plane ESIKF, with plane records derived from the
  map's raw moments, the containing-voxel chain and the neighbour root
  voxel, the 3-sigma gate, and the rematch / convergence rule of the
  device loop;
- the map insert of the posterior points: layer-0 voxels for every
  point, finer layers for points whose coarser voxel is not a solid
  plane, frozen voxels skipped, as running moments (the ordered add's
  second site).

The map is a dict-like sorted key table here: no hashing, no probing,
no compaction beyond the lane caps the deployment states. Nothing of the
program is imported or read but the state it hands over for a step (its
prior posterior, its map's keys and raw moments) and, to judge it, what
it produced.

`Precision`: float64 (the reference) or the control, float32 with every
matrix product's inputs rounded to TF32's 10-bit mantissa.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

GRAVITY = 9.81
DIM = 19
EMPTY = 0x7FFFFFFF

# Keys the deployment's yaml may leave out, at the engine's documented
# defaults (upstream FAST-LIVO2 for sigma_num and the estimation
# toggles; the tpu section's capacities and lane caps).
DEFAULTS = {
    "lio.sigma_num": 3.0, "imu.gravity_est_en": True, "imu.ba_bg_est_en": True,
    "vio.exposure_estimate_en": True, "vio.inv_expo_cov": 0.1,
    "time_offset.exposure_time_init": 0.0,
    "tpu.max_imu_per_packet": 64, "tpu.max_points_per_scan": 32768,
    "tpu.max_points_down": 8192, "tpu.descend_compact": 4096,
    "tpu.insert_compact": 2048, "tpu.pre_descend_margin": 0.5,
    "tpu.lio_rematch_fresh": True, "tpu.lio_fresh_every_iter": False,
    "vio.grid_size": 5, "vio.grid_n_height": 17, "vio.patch_size": 8,
    "vio.patch_pyrimid_level": 4, "vio.max_iterations": 5, "vio.img_point_cov": 100.0,
    "vio.outlier_threshold": 1000.0, "vio.normal_en": True, "vio.ncc_en": False,
    "vio.raycast_en": False, "vio.inverse_composition_en": False,
    "tpu.vis_obs_per_point": 8, "tpu.frame_ring": 64, "tpu.pallas_photo": True,
    "tpu.true_pyramid": False,
}


def setting(sensor: dict, key: str):
    sec, name = key.split(".")
    return sensor.get(sec, {}).get(name, DEFAULTS.get(key))


class Precision:
    """The arithmetic the reference runs in."""

    def __init__(self, control: bool = False):
        self.control = control
        self.dtype = torch.float32 if control else torch.float64

    def mm(self, a, b):
        """a @ b; the control rounds both inputs to TF32 first."""
        if self.control:
            a, b = tf32(a), tf32(b)
        return a @ b


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits, nearest even)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    low = i & 0x1FFF
    half = 0x1000
    up = (low > half) | ((low == half) & ((i & 0x2000) != 0))
    r = (i & ~0x1FFF) + up.to(torch.int32) * 0x2000
    return r.view(torch.float32)


# ------------------------------------------------------------------ SO(3)

def skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def so3_exp(w):
    th2 = torch.sum(w * w, -1)
    th = torch.sqrt(th2)
    small = th < 1e-7
    ths = torch.where(small, 1.0, th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R):
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    th = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.sin(th)
    scale = torch.where(th < 1e-7, 0.5 + th * th / 12.0,
                        th / (2.0 * torch.where(s.abs() < 1e-12, 1e-12, s)))
    return w * scale[..., None]


class State(NamedTuple):
    rot: torch.Tensor
    pos: torch.Tensor
    vel: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    grav: torch.Tensor
    expo: torch.Tensor


def unpack(v, dtype):
    """The filter's packed vector (rot 9, pos, vel, bias_g, bias_a, grav,
    inv_expo, cov 19 x 19), as both packages lay it out."""
    v = v.to(dtype)
    s = State(v[0:9].reshape(3, 3), v[9:12], v[12:15], v[15:18], v[18:21],
              v[21:24], v[24])
    return s, v[25:25 + DIM * DIM].reshape(DIM, DIM)


def pack(s: State, cov):
    return torch.cat([s.rot.reshape(9), s.pos, s.vel, s.bg, s.ba, s.grav,
                      s.expo.reshape(1), cov.reshape(-1)])


def boxplus(s: State, d):
    return State(s.rot @ so3_exp(d[0:3]), s.pos + d[3:6], s.vel + d[7:10],
                 s.bg + d[10:13], s.ba + d[13:16], s.grav + d[16:19],
                 s.expo + d[6])


def boxminus(a: State, b: State):
    return torch.cat([so3_log(b.rot.T @ a.rot), a.pos - b.pos,
                      (a.expo - b.expo).reshape(1), a.vel - b.vel, a.bg - b.bg,
                      a.ba - b.ba, a.grav - b.grav])


# ------------------------------------------------------- start and packet

def imu_init(imu_t, imu_acc, event_times, need):
    """IMU static initialization: the first event with `need` samples at
    or before it; gravity from the mean specific force. Returns (t_init,
    gravity (3,) float32, |mean acc| float32)."""
    for t in event_times:
        m = imu_t <= t
        if m.sum() >= need:
            mean = np.mean(np.asarray(imu_acc[m], np.float64), axis=0)
            norm = float(np.linalg.norm(mean))
            return t, (-mean / norm * GRAVITY).astype(np.float32), np.float32(norm)
    raise ValueError("the recording has too few IMU samples to initialize")


def init_state(grav, device, dtype):
    z = torch.zeros(3, dtype=dtype, device=device)
    s = State(torch.eye(3, dtype=dtype, device=device), z, z, z, z,
              torch.as_tensor(grav, device=device).to(dtype),
              torch.tensor(1.0, dtype=dtype, device=device))
    cov = torch.eye(DIM, dtype=dtype, device=device) * 0.01
    cov[6, 6] = 1e-5
    cov[10:19, 10:19] = torch.eye(9, dtype=dtype, device=device) * 1e-5
    return s, cov


def imu_batch(imu_t, gyr, acc, t0, t1, max_k):
    """The IMU intervals that propagate over (t0, t1]: the last sample at
    or before t0, every sample in (t0, t1] and one beyond; the first
    interval clipped to start at t0, the last to end at t1."""
    i0 = max(int(np.searchsorted(imu_t, t0, side="right")) - 1, 0)
    i1 = min(int(np.searchsorted(imu_t, t1, side="right")) + 1, len(imu_t))
    st, g, a = imu_t[i0:i1], gyr[i0:i1], acc[i0:i1]
    rows = []
    n = len(st) - 1
    for i in range(n):
        th, tt = st[i], st[i + 1]
        if tt < t0:
            continue
        if len(rows) >= max_k:
            break
        if th < t0:
            d, o = tt - t0, tt - t0
        elif i != n - 1:
            d, o = tt - th, tt - t0
        else:
            d, o = t1 - th, t1 - t0
        rows.append((0.5 * (g[i] + g[i + 1]), 0.5 * (a[i] + a[i + 1]),
                     max(d, 0.0), o))
    # float32, as the packet carries them
    gy = np.array([r[0] for r in rows], np.float32).reshape(-1, 3)
    ac = np.array([r[1] for r in rows], np.float32).reshape(-1, 3)
    dt = np.array([r[2] for r in rows], np.float32)
    off = np.array([r[3] for r in rows], np.float32)
    return gy, ac, dt, off


def scan_packet(scans, t0, t1, cap):
    """The points of a sync cut: each scan's points time-sorted (stable)
    and stamped t_begin + offset, those in (t0, t1], evenly decimated to
    `cap`; offsets from t0 as float32."""
    pts, ts = [], []
    for tb, p, o in scans:
        if not len(o):
            continue
        order = np.argsort(o, kind="stable")
        t_abs = tb + o[order]
        m = (t_abs > t0) & (t_abs <= t1)
        if m.any():
            pts.append(p[order][m])
            ts.append(t_abs[m])
    if not pts:
        return np.zeros((0, 3), np.float32), np.zeros(0, np.float32)
    pts, ts = np.concatenate(pts), np.concatenate(ts)
    if len(pts) > cap:
        idx = (np.arange(cap, dtype=np.int64) * len(pts)) // cap
        pts, ts = pts[idx], ts[idx]
    return pts.astype(np.float32), (ts - t0).astype(np.float32)


# ------------------------------------------------------ propagate, undistort

def propagate(P: Precision, s: State, cov, gy, ac, dt, noise):
    """Forward propagation over the intervals, one after another."""
    dev, f = cov.device, P.dtype
    gy, ac, dt = (torch.as_tensor(x, device=dev).to(f) for x in (gy, ac, dt))
    R, v, p = s.rot, s.vel, s.pos
    a_scale = GRAVITY / noise["mean_acc_norm"]
    starts = []
    eye3 = torch.eye(3, dtype=f, device=dev)
    for i in range(dt.shape[0]):
        w = gy[i] - s.bg
        a = ac[i] * a_scale - s.ba
        d = dt[i]
        R_start = R
        dExp = so3_exp(w * d)
        R = P.mm(R, dExp)
        acc_w = P.mm(R, a[:, None])[:, 0] + s.grav
        starts.append((R_start, p, v, acc_w, w))
        p = p + v * d + 0.5 * acc_w * d * d
        v = v + acc_w * d
        F = torch.eye(DIM, dtype=f, device=dev)
        F[0:3, 0:3] = dExp.T
        F[0:3, 10:13] = -eye3 * d * noise["est_bias"]
        F[3:6, 7:10] = eye3 * d
        F[7:10, 0:3] = -P.mm(R_start, skew(a)) * d
        F[7:10, 13:16] = -R_start * d * noise["est_bias"]
        F[7:10, 16:19] = eye3 * d * noise["est_gravity"]
        Q = torch.zeros((DIM, DIM), dtype=f, device=dev)
        d2 = d * d
        Q[6, 6] = noise["inv_expo_cov"] * d2 * noise["est_exposure"]
        Q[0:3, 0:3] = eye3 * noise["gyr_cov"] * d2
        Q[7:10, 7:10] = P.mm(R_start * noise["acc_cov"], R_start.T) * d2
        Q[10:13, 10:13] = eye3 * noise["b_gyr_cov"] * d2
        Q[13:16, 13:16] = eye3 * noise["b_acc_cov"] * d2
        cov = P.mm(P.mm(F, cov), F.T) + Q
    R = P.mm(R, 1.5 * eye3 - 0.5 * P.mm(R.T, R))
    return s._replace(rot=R, pos=p, vel=v), cov, starts


def undistort(P: Precision, pts, t_off, starts, off_end, dt, s_end, ext_R, ext_T):
    """Each point moved to the scan-end IMU frame and back to the LiDAR
    frame, through the interval it falls in."""
    dev, f = ext_R.device, P.dtype
    K = len(starts)
    off_end = torch.as_tensor(off_end, device=dev).to(f)
    off_start = off_end - torch.as_tensor(dt, device=dev).to(f)
    t = torch.as_tensor(t_off, device=dev).to(f)
    idx = torch.clamp(torch.sum(off_end[None, :] < t[:, None], 1), 0, K - 1)
    Rh = torch.stack([x[0] for x in starts])[idx]
    ph = torch.stack([x[1] for x in starts])[idx]
    vh = torch.stack([x[2] for x in starts])[idx]
    ah = torch.stack([x[3] for x in starts])[idx]
    wh = torch.stack([x[4] for x in starts])[idx]
    d = torch.clamp(t - off_start[idx], min=0.0)[:, None]
    Ri = P.mm(Rh, so3_exp(wh * d))
    T = ph + vh * d + 0.5 * ah * d * d - s_end.pos
    p_imu = P.mm(torch.as_tensor(pts, device=dev).to(f), ext_R.T) + ext_T
    rel = P.mm(Ri, p_imu[:, :, None])[:, :, 0] + T
    return P.mm(P.mm(rel, s_end.rot) - ext_T, ext_R)


def downsample(pts, leaf, cap):
    """Voxel-grid centroids, voxels in (x, y, z) key order, the first
    `cap` voxels kept."""
    keys = torch.floor(pts / leaf).to(torch.int64)
    uk, inv = torch.unique(keys, dim=0, return_inverse=True)  # lexicographic
    n = uk.shape[0]
    sums = torch.zeros((n, 3), dtype=pts.dtype, device=pts.device).index_add_(0, inv, pts)
    cnt = torch.zeros(n, dtype=pts.dtype, device=pts.device).index_add_(
        0, inv, torch.ones_like(pts[:, 0]))
    out = sums / cnt[:, None]
    return out[:cap]


def body_cov(pts, range_inc, degree_inc):
    """Per-point covariance from range and bearing noise (calcBodyCov)."""
    z = pts[:, 2]
    pts = torch.cat([pts[:, :2], torch.where(z == 0.0, 1e-4, z)[:, None]], -1)
    rang = torch.linalg.norm(pts, dim=-1)
    d = pts / rang[:, None]
    tan_var = math.sin(math.radians(degree_inc)) ** 2
    b1 = torch.stack([torch.ones_like(d[:, 0]), torch.ones_like(d[:, 0]),
                      -(d[:, 0] + d[:, 1]) / d[:, 2]], -1)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = torch.linalg.cross(b1, d, dim=-1)
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    A = rang[:, None, None] * (skew(d) @ torch.stack([b1, b2], -1))
    return (range_inc ** 2 * d[:, :, None] * d[:, None, :]
            + tan_var * (A @ A.transpose(-1, -2)))


# --------------------------------------------------------------------- map

SYM = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def sym6(m):
    return torch.stack([m[..., i, j] for i, j in SYM], -1)


def sym_mat(s):
    r = [[0, 1, 2], [1, 3, 4], [2, 4, 5]]
    return torch.stack([torch.stack([s[..., r[i][j]] for j in range(3)], -1)
                        for i in range(3)], -2)


def key_code(layer, keys):
    """One int64 per (layer, voxel key), keys within +-2^19."""
    k = keys.to(torch.int64) + (1 << 19)
    return (((torch.as_tensor(layer).to(torch.int64) << 20 | k[..., 0]) << 20
             | k[..., 1]) << 20) | k[..., 2]


class Map:
    """The voxel layers as one table sorted by key code, rows of raw
    moments [count | sum p | sum p p^T sym6 | sum C sym6] in voxel-local
    coordinates."""

    def __init__(self, codes, keys, layer, stats):
        order = torch.argsort(codes)
        self.codes, self.keys = codes[order], keys[order]
        self.layer, self.stats = layer[order], stats[order]

    @classmethod
    def from_tables(cls, keys_tab, stats_tab, dtype):
        """From (L, C, 3) int32 key tables (EMPTY-marked) and their
        (L, C, 16) moments."""
        occ = keys_tab[..., 0] != EMPTY
        layer = torch.arange(keys_tab.shape[0], device=keys_tab.device)[:, None].expand(
            occ.shape)[occ]
        keys = keys_tab[occ]
        return cls(key_code(layer, keys), keys, layer, stats_tab[occ].to(dtype))

    def find(self, layer, keys):
        """(found, moments row, zero where absent) of each query."""
        q = key_code(layer, keys)
        if self.codes.numel() == 0:
            return (torch.zeros(q.shape, dtype=torch.bool, device=q.device),
                    self.stats.new_zeros(q.shape + (16,)))
        i = torch.clamp(torch.searchsorted(self.codes, q), max=self.codes.numel() - 1)
        found = self.codes[i] == q
        return found, torch.where(found[:, None], self.stats[i], 0.0)


def eigh(cov, rows=8192):
    """torch.linalg.eigh of (n, 3, 3) matrices, in blocks of `rows` (on
    the card, cuSOLVER's batched solver refuses a batch of 32,768)."""
    if cov.shape[0] <= rows:
        return torch.linalg.eigh(cov)
    parts = [torch.linalg.eigh(cov[i:i + rows]) for i in range(0, cov.shape[0], rows)]
    return torch.cat([x[0] for x in parts]), torch.cat([x[1] for x in parts])


def plane_records(st, keys, vsize, init_num, has_kids, cfg):
    """Plane fit of each voxel from its moments (init_plane): (is_plane in
    {1, 0.75, 0}, normal, d, center, radius, cov_nn sym6, cov_qq sym6,
    count)."""
    n = st[..., 0]
    ns = torch.clamp(n, min=1.0)
    mean = st[..., 1:4] / ns[..., None]
    cov = sym_mat(st[..., 4:10] / ns[..., None]) - mean[..., :, None] * mean[..., None, :]
    cov = cov + 1e-9 * torch.eye(3, dtype=st.dtype, device=st.device)
    lam, vec = eigh(cov)
    enough = n > init_num
    fits = lam[..., 0] < cfg["planner_threshold"]
    marginal = (fits & (lam[..., 0] > cfg["planner_threshold"] * cfg["margin"])
                & (has_kids > 0.5)) if cfg["margin"] < 1.0 else torch.zeros_like(fits)
    is_pl = torch.where(fits & enough, torch.where(marginal, 0.75, 1.0), 0.0)
    q = (keys.to(st.dtype) + 0.5) * vsize + mean
    nrm = vec[..., :, 0]
    d = -torch.sum(nrm * q, -1)
    radius = torch.sqrt(torch.clamp(lam[..., 2], min=0.0))
    cb = st[..., 10:16] / ns[..., None]
    sigma2 = (cb[..., 0] + cb[..., 3] + cb[..., 5]) / 3.0
    d1 = (lam[..., 1] + lam[..., 0]) / (ns * torch.clamp((lam[..., 0] - lam[..., 1]) ** 2, min=1e-6))
    d2 = (lam[..., 2] + lam[..., 0]) / (ns * torch.clamp((lam[..., 0] - lam[..., 2]) ** 2, min=1e-6))
    u1, u2 = vec[..., :, 1], vec[..., :, 2]
    cov_nn = sym6((sigma2 * d1)[..., None, None] * u1[..., :, None] * u1[..., None, :]
                  + (sigma2 * d2)[..., None, None] * u2[..., :, None] * u2[..., None, :])
    cov_qq = cb / ns[..., None]
    return is_pl, nrm, d, q, radius, cov_nn, cov_qq, n


def quad6(s, v):
    return torch.einsum("...i,...ij,...j->...", v, sym_mat(s), v)


def match_planes(mp: Map, pts_w, var_w6, cfg):
    """Plane correspondences (BuildResidualListOMP): the containing voxel
    chain, coarse to fine, a layer open while every coarser voxel exists
    and is no plane; the layer-0 neighbour root voxel only when the own
    chain gives nothing; among gated candidates the most probable."""
    L, f = cfg["layers"], pts_w.dtype
    cands = []
    for li in range(L):
        vs = cfg["voxel"] / (1 << li)
        cands.append((li, torch.floor(pts_w / vs).to(torch.int32), vs))
    k0 = cands[0][1]
    c0 = (k0.to(f) + 0.5) * cfg["voxel"]
    off = pts_w - c0
    q = cfg["voxel"] / 4.0
    shift = torch.where(off > q, 1, torch.where(off < -q, -1, 0)).to(torch.int32)
    cands.append((0, k0 + shift, cfg["voxel"]))
    probs, fields, exists_l, ispl_l = [], [], [], []
    for li, keys, vs in cands:
        found, st = mp.find(li, keys)
        is_pl, nrm, d, c, radius, cnn, cqq, _ = plane_records(
            st, keys, vs, cfg["init_num"][li], float(li < L - 1), cfg)
        is_pl = (is_pl > 0.5) & found
        dist = torch.sum(nrm * pts_w, -1) + d
        a = pts_w - c
        rd2 = torch.clamp(torch.sum(a * a, -1) - dist * dist, min=0.0)
        sig_pl = quad6(cnn, a) + quad6(cqq, nrm)
        sig_l = torch.clamp(sig_pl + quad6(var_w6, nrm), min=1e-12)
        ok = is_pl & (rd2 <= (3.0 * radius) ** 2) & (dist.abs() < cfg["sigma_num"] * torch.sqrt(sig_l))
        probs.append(torch.where(ok, torch.rsqrt(sig_l) * torch.exp(-0.5 * dist * dist / sig_l), -1.0))
        fields.append((nrm, d, c, dist, sig_pl, cnn, cqq))
        exists_l.append(found)
        ispl_l.append(is_pl)
    n = pts_w.shape[0]
    open_ = torch.ones(n, dtype=torch.bool, device=pts_w.device)
    active, any_own = [], torch.zeros_like(open_)
    for li in range(L):
        a = open_ & (probs[li] > -1.0)
        active.append(a)
        any_own |= a
        open_ = open_ & exists_l[li] & ~ispl_l[li]
    active.append((probs[L] > -1.0) & ~any_own)
    pr = torch.stack([torch.where(a, p, -1.0) for a, p in zip(active, probs)])
    best = torch.argmax(pr, 0)
    valid = torch.amax(pr, 0) > 0
    pick = [torch.stack([fl[j] for fl in fields]) for j in range(7)]
    sel = [torch.gather(x, 0, best.reshape(1, -1, *([1] * (x.dim() - 2))).expand(
        1, *x.shape[1:]))[0] for x in pick]
    return dict(valid=valid, normal=sel[0], d=sel[1], center=sel[2], dist=sel[3],
                sigma_plane=sel[4], cov_nn=sel[5], cov_qq=sel[6])


# --------------------------------------------------------------------- LIO

def lio_update(P: Precision, prop: State, cov_prop, mp: Map, pts_body,
               ext_R, ext_T, cfg):
    """The iterated ESIKF of StateEstimation in the device loop's form:
    every iteration runs, masked after the stop; a fresh search on the
    first iteration and on the rematch round after convergence, a
    re-gate of the carried planes otherwise."""
    f, dev = P.dtype, cov_prop.device
    bc = body_cov(pts_body, cfg["dept_err"], cfg["beam_err"])
    p_imu = P.mm(pts_body, ext_R.T) + ext_T
    cross = skew(p_imu)
    cs = 0.5 * (cov_prop + cov_prop.T)
    P_inv = torch.linalg.inv(cs)
    R_pe = P.mm(prop.rot, ext_R)
    var_rot = P.mm(P.mm(R_pe, bc), R_pe.T)
    pw_prop = P.mm(p_imu, prop.rot.T) + prop.pos
    rot_var, t_var = cov_prop[0:3, 0:3], cov_prop[3:6, 3:6]

    def search(s, pw):
        var_w = P.mm(P.mm(s.rot, bc), s.rot.T) + P.mm(P.mm(cross, rot_var), cross.transpose(-1, -2)) + t_var
        return match_planes(mp, pw, sym6(var_w), cfg)

    def regate(m, pw):
        n = m["normal"]
        dist = torch.sum(n * pw, -1) + m["d"]
        sig = m["sigma_plane"] + torch.einsum("ni,nij,nj->n", n, var_rot, n)
        ok = m["valid"] & (dist.abs() < cfg["sigma_num"] * torch.sqrt(torch.clamp(sig, min=1e-12)))
        return {**m, "dist": dist, "valid": ok}

    s, match, G_keep = prop, None, None
    stop, rematch, fresh = False, 0, True
    eye = torch.eye(DIM, dtype=f, device=dev)
    its = cfg["max_iterations"]
    for it in range(its):
        pw = P.mm(p_imu, s.rot.T) + s.pos
        if it == 0 or cfg["fresh_every_iter"] or (cfg["rematch_fresh"] and fresh):
            m_it = search(s, pw)
        else:
            m_it = regate(match, pw)
        n, use = m_it["normal"], m_it["valid"]
        A = P.mm(P.mm(cross, s.rot.T), n[:, :, None])[:, :, 0]
        H = torch.cat([A, n], -1)
        z = -m_it["dist"]
        sig = (quad6(m_it["cov_nn"], pw_prop - m_it["center"]) + quad6(m_it["cov_qq"], n)
               + torch.einsum("ni,nij,nj->n", n, var_rot, n))
        r_inv = torch.where(use, 1.0 / (1e-3 + sig), 0.0)
        HR = H * r_inv[:, None]
        HTH6, HTz6 = P.mm(HR.T, H), P.mm(HR.T, z[:, None])[:, 0]
        HTH = torch.zeros((DIM, DIM), dtype=f, device=dev)
        HTH[0:6, 0:6] = HTH6
        K1 = torch.linalg.inv(HTH + P_inv)
        G = torch.zeros((DIM, DIM), dtype=f, device=dev)
        G[:, 0:6] = P.mm(K1[:, 0:6], HTH6)
        vec = boxminus(prop, s)
        sol = P.mm(K1[:, 0:6], HTz6[:, None])[:, 0] + vec - P.mm(G[:, 0:6], vec[0:6, None])[:, 0]
        if not stop:
            s, G_keep, match = boxplus(s, sol), G, m_it
        if it == its - 1:
            break
        conv = (float(torch.linalg.norm(sol[0:3])) * 57.3 < 0.01
                and float(torch.linalg.norm(sol[3:6])) * 100.0 < 0.015)
        if it == its - 2:
            conv = conv or rematch == 0
        inc = (not stop) and conv
        rematch += int(inc)
        stop = stop or rematch >= 2
        fresh = inc
    cov_post = P.mm(eye - G_keep, cov_prop)
    pts_w = P.mm(p_imu, s.rot.T) + s.pos
    R_e = P.mm(s.rot, ext_R)
    var_w = (P.mm(P.mm(R_e, bc), R_e.T)
             + P.mm(P.mm(cross, cov_post[0:3, 0:3]), cross.transpose(-1, -2)) + cov_post[3:6, 3:6])
    use = match["valid"]
    n_eff = int(use.sum())
    mean_res = float(torch.where(use, match["dist"].abs(), 0.0).sum()) / max(n_eff, 1)
    return s, cov_post, pts_w, sym6(var_w), n_eff, mean_res


# ------------------------------------------------------------------ insert

def insert(mp: Map, pts_w, var6, cfg, full: bool):
    """The moments a frame adds: {key code: (layer, key, delta row)}, as
    one tensor of codes and one of (16,) rows. `full`: the map-building
    first frame (every layer on every lane, no lane caps); otherwise
    layer 0 on every lane, finer layers on the first `descend` lanes
    whose coarser voxel exists, has more than its init count and is no
    solid plane, and at most `claim` lanes a layer may open new voxels."""
    L, f, dev = cfg["layers"], pts_w.dtype, pts_w.device
    n = pts_w.shape[0]
    out_codes, out_rows = [], []
    sub = torch.ones(n, dtype=torch.bool, device=dev)
    for li in range(L):
        vs = cfg["voxel"] / (1 << li)
        keys = torch.floor(pts_w / vs).to(torch.int32)
        found, st = mp.find(li, keys)
        is_pl, *_, cnt = plane_records(st, keys, vs, cfg["init_num"][li],
                                       float(li < L - 1), cfg)
        take = sub.clone()
        if not full and li == 1:
            take &= torch.cumsum(take.to(torch.int64), 0) <= cfg["descend"]
        new = take & ~found
        if not full:
            first = torch.cumsum(new.to(torch.int64), 0) <= cfg["claim"]
            take &= found | first
        ok = take & ~(found & (cnt >= cfg["max_points"]))
        c = (keys.to(f) + 0.5) * vs
        pl = pts_w - c
        contrib = torch.cat([torch.ones_like(pl[:, :1]), pl,
                             sym6(pl[:, :, None] * pl[:, None, :]), var6], -1)
        codes = key_code(li, keys)
        out_codes.append(codes[ok])
        out_rows.append(contrib[ok])
        # descent into the next layer (pre-insert state of this one)
        sub = take & found & (cnt > cfg["init_num"][li]) & (is_pl < 0.9)
    codes = torch.cat(out_codes)
    rows = torch.cat(out_rows)
    uc, inv = torch.unique(codes, return_inverse=True)
    delta = torch.zeros((uc.shape[0], 16), dtype=f, device=dev).index_add_(0, inv, rows)
    return uc, delta


def map_cfg(sensor: dict) -> dict:
    """The map and LIO settings of a deployment's sensor yaml."""
    lio = sensor["lio"]
    return dict(
        voxel=float(lio["voxel_size"]), layers=int(lio["max_layer"]) + 1,
        planner_threshold=float(lio["min_eigen_value"]),
        sigma_num=float(setting(sensor, "lio.sigma_num")),
        init_num=[float(x) for x in lio["layer_init_num"]] + [5.0] * 8,
        max_points=float(lio["max_points_num"]),
        margin=float(setting(sensor, "tpu.pre_descend_margin")),
        dept_err=float(lio["dept_err"]), beam_err=float(lio["beam_err"]),
        max_iterations=int(lio["max_iterations"]),
        rematch_fresh=bool(setting(sensor, "tpu.lio_rematch_fresh")),
        fresh_every_iter=bool(setting(sensor, "tpu.lio_fresh_every_iter")),
        descend=int(setting(sensor, "tpu.descend_compact")),
        claim=int(setting(sensor, "tpu.insert_compact")),
        leaf=float(sensor["preprocess"]["filter_size_surf"]),
        max_down=int(setting(sensor, "tpu.max_points_down")),
        max_scan=int(setting(sensor, "tpu.max_points_per_scan")),
        max_imu=int(setting(sensor, "tpu.max_imu_per_packet")),
    )


def noise_cfg(sensor: dict, mean_acc_norm) -> dict:
    imu = sensor["imu"]
    return dict(
        mean_acc_norm=float(mean_acc_norm), acc_cov=float(imu["acc_cov"]),
        gyr_cov=float(imu["gyr_cov"]), b_acc_cov=float(imu["b_acc_cov"]),
        b_gyr_cov=float(imu["b_gyr_cov"]),
        inv_expo_cov=float(setting(sensor, "vio.inv_expo_cov")),
        est_bias=float(bool(setting(sensor, "imu.ba_bg_est_en"))),
        est_gravity=float(bool(setting(sensor, "imu.gravity_est_en"))),
        est_exposure=float(bool(setting(sensor, "vio.exposure_estimate_en"))))

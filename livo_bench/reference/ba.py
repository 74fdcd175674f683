"""Plain reference of the online backend's window refinement, for judging
the port.

What one window of the sliding-window backend computes, written out
once more from the algorithm the port's parallel/ba.py documents, in
plain torch at float64, one keyframe at a time, for `outer_iters`
rounds of:

- a map rebuild: every keyframe's valid scan points, put in the world
  by its current pose, inserted into a fresh voxel plane map (the LIO
  reference's `Map` and `insert`); a fresh map's points all land in
  layer 0, since a finer layer opens only under an existing coarser
  voxel of the state before the insert;
- Gauss-Newton steps of each keyframe's 6-DoF pose against that map,
  under the left (world-frame) perturbation R <- Exp(d theta) R,
  p <- p + d p: the point-to-plane terms (the LIO reference's
  `match_planes`, each point weighted 1 / (1e-3 + sigma_plane +
  n^T C_body n)), 1e-6 on the diagonal, the IMU-link terms against the
  two neighbours' poses held fixed for each sweep, and the photometric
  terms; with links, `LINK_SWEEPS` sweeps of `gn_iters` steps, else
  `gn_iters` steps; then every rotation re-projected by one
  second-order step R (3 I - R^T R) / 2.

The IMU links are worked out again here from the recording's raw
samples and each link's start keyframe's biases: the samples in
(t_k, t_k+1], each sub-interval (the first from t_k, the tail to
t_k+1) integrated with the sample that closes it (the last held over
the tail), the rotation by the exact exponential; a link with no sample
is not used. Velocities are each keyframe's, gravity the newest
keyframe's, as the program's filter had them at the keyframes.

The photometric factors are taken as the program captured them (the
keyframe image, its inverse exposure, the tracked points' world
positions, the exposure-normalised reference patches, their validity and
sampling stride), as the VIO reference takes the program's pool and
ring: they are the program's state at the keyframes, not outputs of the
refinement. The residual of a pixel is tau_k I_k(pi(Rcw (p_w - p) +
Pcw)) - target, sampled by the VIO reference's strided patch sampling
with every tap clipped, with the pinhole projection's Jacobian.

Departures from the port's equations: one of arithmetic. A factor the
refinement does not use (invalid, behind the camera or off the image)
has its terms zeroed here before any product; the port multiplies a
zero weight in after forming them in float32, which turns the window to
NaN where such a factor's terms overflow. The port's `preintegrate`
calls itself a midpoint integration; it holds each sub-interval's
closing sample, and so does this reference, since that is what a link
means in the program under test.

Nothing of the program is imported. `Precision` selects float64 (the
reference) or the control (float32 with TF32-rounded matrix products).
"""

import numpy as np
import torch

from . import lio as ref
from . import vio as vio_ref

# The refiner's settings the program fixes (parallel/ba.refine_window's
# defaults, which OnlineRefiner does not change).
LINK_SWEEPS = 4
IMU_ROT_SIGMA, IMU_POS_SIGMA = 0.01, 0.05  # 1 sigma at dt = 1 s
DAMPING = 1e-6
PHOTO_BORDER = 8  # pixels: a projection nearer the edge is not used
MIN_DT = 1e-3


# ------------------------------------------------------------ IMU links

def _exp(v):
    th = np.linalg.norm(v)
    if th < 1e-12:
        return np.eye(3)
    k = v / th
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def preintegrate(imu_t, gyr, acc, bg, ba, t0, t1):
    """(dR, dp, dt, used) of the raw samples over (t0, t1], in float64."""
    m = (imu_t > t0) & (imu_t <= t1)
    w = np.asarray(gyr, np.float64)[m] - bg
    a = np.asarray(acc, np.float64)[m] - ba
    if len(w) == 0:
        return np.eye(3), np.zeros(3), 0.0, False
    ts = np.concatenate([[t0], imu_t[m], [t1]])
    dR, dv, dp = np.eye(3), np.zeros(3), np.zeros(3)
    for k in range(len(ts) - 1):
        h = ts[k + 1] - ts[k]
        j = min(k, len(w) - 1)
        ak = dR @ a[j]
        dp = dp + dv * h + 0.5 * ak * h * h
        dv = dv + ak * h
        dR = dR @ _exp(w[j] * h)
    return dR, dp, t1 - t0, t1 - t0 > MIN_DT


def links(imu_t, gyr, acc, stamps, states):
    """The links of a window: row k joins keyframe k to k + 1 (the last
    row unused). `states` (K, 25): each keyframe's filter state (rot,
    pos, vel, bias_g, bias_a, grav, inv_expo)."""
    K = len(stamps)
    imu_t = np.asarray(imu_t, np.float64)
    dR, dp = np.tile(np.eye(3), (K, 1, 1)), np.zeros((K, 3))
    dt, ok = np.full(K, MIN_DT), np.zeros(K, bool)
    for k in range(K - 1):
        st = np.asarray(states[k], np.float64)
        dR[k], dp[k], d, ok[k] = preintegrate(imu_t, gyr, acc, st[15:18], st[18:21],
                                              stamps[k], stamps[k + 1])
        dt[k] = max(d, MIN_DT)
    st = np.asarray(states, np.float64)
    return dict(dR=dR, dp=dp, dt=dt, ok=ok, vel=st[:, 12:15], grav=st[-1, 21:24])


# ------------------------------------------------------------- the terms

def rebuild_map(P, rot, pos, scans, valid, body6, cfg):
    """A fresh plane map of the window's points at the given poses."""
    f, dev = P.dtype, rot.device
    pts_w = torch.cat([P.mm(scans[k][valid[k]], rot[k].T) + pos[k]
                       for k in range(rot.shape[0])])
    var6 = torch.cat([body6[k][valid[k]] for k in range(rot.shape[0])])
    empty = ref.Map(torch.zeros(0, dtype=torch.int64, device=dev),
                    torch.zeros((0, 3), dtype=torch.int32, device=dev),
                    torch.zeros(0, dtype=torch.int64, device=dev),
                    torch.zeros((0, 16), dtype=f, device=dev))
    codes, stats = ref.insert(empty, pts_w, var6, cfg, full=True)
    mask = (1 << 20) - 1
    keys = torch.stack([(codes >> s) & mask for s in (40, 20, 0)], -1) - (1 << 19)
    return ref.Map(codes, keys.to(torch.int32), codes >> 60, stats)


def plane_terms(P, mp, cfg, R, p, scan, valid, body6):
    """(H (6, 6), g (6,)) of one keyframe's point-to-plane residuals."""
    rel = P.mm(scan, R.T)
    m = ref.match_planes(mp, rel + p, body6, cfg)
    use = m["valid"] & valid
    n = m["normal"]
    J = torch.cat([torch.linalg.cross(rel, n, dim=-1), n], -1)
    w = torch.where(use, 1.0 / (1e-3 + m["sigma_plane"] + ref.quad6(body6, n)), 0.0)
    return P.mm(J.T, J * w[:, None]), -P.mm(J.T, (w * m["dist"])[:, None])[:, 0]


def link_terms(P, k, R, p, nbr_R, nbr_p, lk, w_rot, w_pos):
    """(H, g) of keyframe k's links to its neighbours, whose poses
    (nbr_R, nbr_p: the sweep's snapshot) are held fixed."""
    K, f = nbr_R.shape[0], R.dtype
    Z = torch.zeros((3, 3), dtype=f, device=R.device)
    g_w = lk["grav"]
    H = torch.zeros((6, 6), dtype=f, device=R.device)
    g = torch.zeros(6, dtype=f, device=R.device)
    terms = []
    if k > 0 and lk["ok"][k - 1]:  # link k-1 -> k
        Rp, pp, h = nbr_R[k - 1], nbr_p[k - 1], lk["dt"][k - 1]
        r = ref.so3_log(P.mm(P.mm(lk["dR"][k - 1].T, Rp.T), R))
        terms.append((torch.cat([R.T, Z], -1), r, w_rot))
        u = p - pp - lk["vel"][k - 1] * h - 0.5 * g_w * h * h
        terms.append((torch.cat([Z, Rp.T], -1), P.mm(Rp.T, u[:, None])[:, 0] - lk["dp"][k - 1],
                      w_pos))
    if k < K - 1 and lk["ok"][k]:  # link k -> k+1
        Rn, pn, h = nbr_R[k + 1], nbr_p[k + 1], lk["dt"][k]
        r = ref.so3_log(P.mm(P.mm(lk["dR"][k].T, R.T), Rn))
        terms.append((torch.cat([-Rn.T, Z], -1), r, w_rot))
        u = pn - p - lk["vel"][k] * h - 0.5 * g_w * h * h
        terms.append((torch.cat([P.mm(R.T, ref.skew(u)), -R.T], -1),
                      P.mm(R.T, u[:, None])[:, 0] - lk["dp"][k], w_pos))
    for J, r, w in terms:
        H = H + w * P.mm(J.T, J)
        g = g - w * P.mm(J.T, r[:, None])[:, 0]
    return H, g


def photo_terms(P, c, R, p, ph, Rci, Pci, ps, weight):
    """(H, g) of one keyframe's photometric factors: ph = (image, inverse
    exposure, world points, targets, valid, stride) as captured."""
    img, tau, pts_w, target, valid, scale = ph
    Rcw = P.mm(Rci, R.T)
    Pcw = Pci - P.mm(Rcw, p[:, None])[:, 0]
    pf = P.mm(pts_w, Rcw.T) + Pcw
    px = vio_ref.world2cam(c, pf)
    ok = valid & (pf[:, 2] > 1e-6) & vio_ref.in_frame(c, px, PHOTO_BORDER)
    stride = scale.to(R.dtype)
    val, du, dv = vio_ref._strided(img, px, stride, ps, lo=-(ps // 2) - 1, size=ps + 4,
                                   per_tap=True)
    r = tau * val - target  # (M, ps^2)
    x, y = pf[:, 0], pf[:, 1]
    zi = 1.0 / torch.where(pf[:, 2].abs() < 1e-9, 1e-9, pf[:, 2])
    o = torch.zeros_like(zi)
    Jpi = torch.stack([torch.stack([c["fx"] * zi, o, -c["fx"] * x * zi * zi], -1),
                       torch.stack([o, c["fy"] * zi, -c["fy"] * y * zi * zi], -1)], -2)
    Jimg = torch.stack([du, dv], -1) * (tau / stride)[:, None, None]  # (M, ps^2, 2)
    Jpix = Jimg @ Jpi  # (M, ps^2, 3)
    Jth = Jpix @ (Rcw @ ref.skew(pts_w - p))
    Jt = -(Jpix @ Rcw)
    # an unused factor adds nothing: its terms are zeroed before any
    # product (far off the image they are not finite in float32)
    J = torch.where(ok[:, None, None], torch.cat([Jth, Jt], -1), 0.0).reshape(-1, 6)
    r = torch.where(ok[:, None], r, 0.0).reshape(-1)
    return weight * P.mm(J.T, J), -weight * P.mm(J.T, r[:, None])[:, 0]


# --------------------------------------------------------------- a window

def refine_window(P, win, cfg, backend, cam=None, Rci=None, Pci=None, photo_cfg=None):
    """The refined (rot (K, 3, 3), pos (K, 3)) of one window.

    win: rot, pos, scans (K, N, 3) body-frame points, valid (K, N), and
    optionally `links` (links()'s dict) and `photo` (the captured
    factors, each (K, ...)); cfg: the LIO reference's map settings
    (`map_cfg`); backend: outer_iters, gn_iters; photo_cfg: patch size
    and per-pixel weight."""
    f = P.dtype
    dev = win["rot"].device
    rot, pos = win["rot"].to(f), win["pos"].to(f)
    scans, valid = win["scans"].to(f), win["valid"]
    K = rot.shape[0]
    body6 = torch.stack([ref.sym6(ref.body_cov(scans[k], cfg["dept_err"], cfg["beam_err"]))
                         for k in range(K)])
    lk = None
    if win.get("links") is not None:
        lk = {k: (torch.as_tensor(v, device=dev).to(f) if k != "ok" else v)
              for k, v in win["links"].items()}
        w_k = [(1.0 / (IMU_ROT_SIGMA ** 2 * float(lk["dt"][k])),
                1.0 / (IMU_POS_SIGMA ** 2 * float(lk["dt"][k]))) for k in range(K)]
        # one weight pair serves both of a keyframe's links: its
        # incoming link's where that exists, else its outgoing one's
        w_kf = [w_k[k - 1] if k > 0 and lk["ok"][k - 1] else w_k[k] for k in range(K)]
    ph = None
    if win.get("photo") is not None:
        ph = [tuple(torch.as_tensor(x[k], device=dev) for x in win["photo"])
              for k in range(K)]
        ph = [(img.to(f), tau.to(f), pw.to(f), tg.to(f), ok.bool(), sc)
              for img, tau, pw, tg, ok, sc in ph]
    eye = torch.eye(6, dtype=f, device=dev) * DAMPING
    sweeps = LINK_SWEEPS if lk is not None else 1
    for _ in range(backend["outer_iters"]):
        mp = rebuild_map(P, rot, pos, scans, valid, body6, cfg)
        for _ in range(sweeps):
            nbr_R, nbr_p = rot.clone(), pos.clone()
            for _ in range(backend["gn_iters"]):
                new_R, new_p = [], []
                for k in range(K):
                    H, g = plane_terms(P, mp, cfg, rot[k], pos[k], scans[k], valid[k],
                                       body6[k])
                    H = H + eye
                    if lk is not None:
                        Hl, gl = link_terms(P, k, rot[k], pos[k], nbr_R, nbr_p, lk, *w_kf[k])
                        H, g = H + Hl, g + gl
                    if ph is not None:
                        Hp, gp = photo_terms(P, cam, rot[k], pos[k], ph[k], Rci, Pci,
                                             photo_cfg["patch_size"], photo_cfg["weight"])
                        H, g = H + Hp, g + gp
                    d = torch.linalg.solve(H, g)
                    new_R.append(P.mm(ref.so3_exp(d[0:3]), rot[k]))
                    new_p.append(pos[k] + d[3:6])
                rot, pos = torch.stack(new_R), torch.stack(new_p)
        eye3 = torch.eye(3, dtype=f, device=dev)
        rot = torch.stack([P.mm(R, 1.5 * eye3 - 0.5 * P.mm(R.T, R)) for R in rot])
    return rot, pos


def keyframe_gaps(rot, pos, want_rot, want_pos):
    """Each keyframe's (rotation gap (rad), position gap (m)); infinite
    where a pose is not finite."""
    rot, want_rot = (torch.as_tensor(x, dtype=torch.float64) for x in (rot, want_rot))
    pos, want_pos = (torch.as_tensor(x, dtype=torch.float64) for x in (pos, want_pos))
    dr = torch.linalg.norm(ref.so3_log(want_rot.transpose(-1, -2) @ rot), dim=-1)
    dp = torch.linalg.norm(pos - want_pos, dim=-1)
    bad = ~(torch.isfinite(rot).all((-1, -2)) & torch.isfinite(pos).all(-1))
    return (torch.where(bad, float("inf"), dr).tolist(),
            torch.where(bad, float("inf"), dp).tolist())


def gaps(rot, pos, want_rot, want_pos):
    """(widest rotation gap (rad), widest position gap (m)) over the
    window's keyframes."""
    dr, dp = keyframe_gaps(rot, pos, want_rot, want_pos)
    return max(dr), max(dp)

"""Sliding-window map/pose refinement (port of
fast_livo2_tpu/parallel/ba.py).

A window of K keyframes (pose + downsampled undistorted body-frame scan)
is refined by alternating
  (1) a map rebuild: every keyframe's world points inserted into a fresh
      voxel plane map (one update_map over the flattened window);
  (2) pose refinement: per-keyframe 6-DoF Gauss-Newton against that
      shared map, optionally with preintegrated IMU links to the two
      neighbouring keyframes (ImuLinks; Jacobi: the neighbours' poses are
      held fixed per sweep) and photometric pose factors (PhotoFactors).

The JAX package vmaps the per-keyframe Gauss-Newton. Here the K keyframes
run as one batch: the K x N window points go through ONE match_planes
call on the shared map (matching is per point), the per-keyframe 6 x 6
normal equations are formed by reshaping to (K, N, ...) and summing, and
the K systems are solved by one batched torch.linalg.solve_ex (no host
read on an error). The IMU links' neighbours are torch.roll along K, as
in the JAX package; the photometric terms sample each keyframe's own
image of a (K, H, W) stack through `img_idx`.

`OnlineRefiner` runs refine_window behind the causal front end: on the
card on its own CUDA stream, one captured CUDA graph per variant
(plain / links / photo / links + photo) at the window's static shapes,
with completion marked by an event; on the CPU eagerly.

Keyframe sharding (`mesh=`, parallel/sharding.py): every rank passes the
whole window and runs Gauss-Newton on its contiguous slice of the K
keyframes. Each map rebuild inserts every rank's world points (gathered
by update_map(mesh=)); the IMU links' neighbour poses come from the full
pose arrays, gathered after every sweep; photometric factors stay with
their keyframe; the refined poses and n_used are gathered, so every rank
returns the whole window. The map-sharded variant, which splits the map
instead of the keyframes, is parallel/map_shard.py.
"""

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.lio import calc_body_cov
from ..core.voxel_map import (VoxelMapConfig, _const, make_map, match_planes,
                              quad6, sym6, update_map)
from ..models import camera as cam_mod
from ..ops import image as img_ops
from ..ops import so3
from . import sharding as shd


class Window(NamedTuple):
    """K keyframes with fixed-size downsampled scans."""

    rot: torch.Tensor  # (K, 3, 3) world-from-body
    pos: torch.Tensor  # (K, 3)
    scans: torch.Tensor  # (K, N, 3) body-frame points
    valid: torch.Tensor  # (K, N) bool


class ImuLinks(NamedTuple):
    """Preintegrated IMU links between consecutive keyframes: row k links
    keyframe k -> k+1 (the last row is a placeholder gated by `valid`).
    They keep the window observable where the plane map is degenerate
    (corridors): the map constrains only the directions its normals
    span. Velocities and gravity come from the filter and are held
    fixed (pose-only refinement)."""

    dR: torch.Tensor  # (K, 3, 3) gyro preintegration R_k_from_k+1
    dp: torch.Tensor  # (K, 3) accel double integral, in keyframe-k frame
    dt: torch.Tensor  # (K,) link duration
    vel: torch.Tensor  # (K, 3) filter velocity at keyframe k
    grav: torch.Tensor  # (3,) world gravity
    valid: torch.Tensor  # (K,) bool, link k -> k+1 exists


def preintegrate(stamps, gyr, acc, bg, ba_, t0, t1):
    """Midpoint preintegration of raw IMU over (t0, t1] (host, f64):
    returns (dR (3,3), dp (3,), dt). Mirrors the forward-propagation
    integrator (core/imu.propagate; reference IMU_Processing.cpp:322-439)
    without covariance — the backend weights links by noise-scaled
    scalars instead."""
    stamps = np.asarray(stamps, np.float64)
    m = (stamps > t0) & (stamps <= t1)
    ts = np.concatenate([[t0], stamps[m], [t1]])
    w = np.asarray(gyr, np.float64)[m] - bg
    a = np.asarray(acc, np.float64)[m] - ba_
    if len(w) == 0:
        # No samples in the interval: an identity link would wrongly
        # assert zero relative motion — callers must treat dt=0 links
        # as invalid (pipeline._build_links gates on n_samples).
        return np.eye(3), np.zeros(3), 0.0
    def _exp(v):
        th = np.linalg.norm(v)
        if th < 1e-12:
            return np.eye(3)
        k = v / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)

    dR = np.eye(3)
    dv = np.zeros(3)
    dp = np.zeros(3)
    # Integrate ALL len(ts)-1 sub-intervals, including the tail
    # [last sample, t1], holding the nearest sample over it (zero-order
    # hold). With keyframe times not aligned to IMU stamps the tail is
    # up to one IMU period; dropping it would bias each position link by
    # ~|dv|*imu_period.
    for k in range(len(ts) - 1):
        dt_k = ts[k + 1] - ts[k]
        j = min(k, len(w) - 1)
        ak = dR @ a[j]
        dp = dp + dv * dt_k + 0.5 * ak * dt_k * dt_k
        dv = dv + ak * dt_k
        dR = dR @ _exp(w[j] * dt_k)
    return dR, dp, t1 - t0


class PhotoFactors(NamedTuple):
    """Per-keyframe photometric pose factors: the reference's exposure-
    normalized sparse-direct measurement model (vio.cpp:1520-1688) with
    the world points, targets and exposure fixed and only the keyframe
    pose free,

        r = tau_k * I_k(pi(Rcw (p_w - p_k))) - tau_ref * I_ref,

    captured at keyframe time by core/vio.capture_photo_factors. They
    close the null space that plane + IMU factors leave in texture-rich,
    geometry-poor places (corridors)."""

    img: torch.Tensor  # (K, H, W) float keyframe grayscale images
    inv_expo: torch.Tensor  # (K,) tau_k at capture
    pts_w: torch.Tensor  # (K, M, 3) tracked point world positions
    target: torch.Tensor  # (K, M, ps²) tau_ref * I_ref
    valid: torch.Tensor  # (K, M) bool
    scale: torch.Tensor  # (K, M) int32 sampling stride (search level)


def _photo_terms(rot, pos, ph: PhotoFactors, cam, Rci, Pci, ps: int,
                 w_photo: float, unused=None):
    """Every keyframe's photometric contribution to its (HtH (K, 6, 6),
    Htz (K, 6)) under the plane term's left/world-frame perturbation.

    A factor slot that is not used (`valid` false, behind the camera, or
    off the image at the 8 px border) is sampled and differentiated at
    the camera-frame point (0, 0, 1), and its residual and Jacobian are
    then set to exactly 0: an unused slot may hold a stale point near a
    keyframe camera's plane, whose float32 terms overflow (a projection
    of ~1e13 px), and a weight of 0 times inf would be NaN. `unused`: a
    0-d int64 tensor that receives the count of unused slots."""
    K, M = ph.valid.shape
    f = rot.dtype
    dev = str(rot.device)
    Rcw = Rci @ rot.transpose(-1, -2)  # (K, 3, 3)
    Pcw = Pci - torch.einsum("kij,kj->ki", Rcw, pos)
    pf = torch.einsum("kij,kmj->kmi", Rcw, ph.pts_w) + Pcw[:, None, :]
    pf_flat = pf.reshape(K * M, 3)
    px = cam_mod.world2cam(cam, pf_flat)
    ok = (ph.valid.reshape(-1) & (pf_flat[:, 2] > 1e-6)
          & cam_mod.in_frame(cam, px, 8))
    if unused is not None:
        unused.copy_(torch.sum(~ok))
    # the safe point (0, 0, 1) projects to the principal point
    pf_flat = torch.where(ok[:, None], pf_flat, _const((0.0, 0.0, 1.0), f, dev))
    px = torch.where(ok[:, None], px, _const((cam.cx, cam.cy), f, dev))
    kf = torch.arange(K, device=rot.device).repeat_interleave(M)
    val, du, dv = img_ops.sample_patches_with_grad(
        ph.img, px, ph.scale.reshape(-1), ps, img_idx=kf)
    P2 = ps * ps
    tau = ph.inv_expo[:, None, None]
    okk = ok.reshape(K, M)
    r = torch.where(okk[..., None], tau * val.reshape(K, M, P2) - ph.target,
                    0.0)  # (K, M, ps²)
    inv_scale = 1.0 / ph.scale.to(f)
    Jimg = (torch.stack([du, dv], dim=-1).reshape(K, M, P2, 2)
            * (tau * inv_scale[..., None])[..., None])
    Jdpi = cam_mod.projection_jacobian(cam, pf_flat).reshape(K, M, 2, 3)
    Jpix = torch.einsum("kmpi,kmij->kmpj", Jimg, Jdpi)  # (K, M, ps², 3)
    # pf = Rcw (p_w - pos) + Pci: d pf/dδθ = Rcw skew(p_w - pos),
    # d pf/dδt = -Rcw (left/world-frame perturbation, as the plane term)
    A = torch.einsum("kjl,kmlc->kmjc", Rcw,
                     so3.skew(ph.pts_w - pos[:, None, :]))
    Jth = torch.einsum("kmpj,kmjc->kmpc", Jpix, A)
    Jt = torch.einsum("kmpj,kjc->kmpc", Jpix, -Rcw)
    J6 = torch.where(okk[..., None, None], torch.cat([Jth, Jt], dim=-1),
                     0.0)  # (K, M, ps², 6)
    w = torch.full((K, M), w_photo, dtype=f, device=rot.device)
    HtH = torch.einsum("kmpi,km,kmpj->kij", J6, w, J6)
    Htz = -torch.einsum("kmpi,km,kmp->ki", J6, w, r)
    return HtH, Htz


def _link_terms(rot, pos, nbr):
    """The four IMU-link residuals of every keyframe against its fixed
    neighbours (link k-1 -> k and link k -> k+1, rotation and position
    each): their (HtH (K, 6, 6), Htz (K, 6)) contributions."""
    (r_p, p_p, dR_p, dp_p, dt_p, v_p, ok_p, r_n, p_n, dR_n, dp_n, dt_n,
     v_k, ok_n, grav, w_rot, w_pos) = nbr
    f = rot.dtype
    okp = ok_p.to(f)
    okn = ok_n.to(f)
    rT = rot.transpose(-1, -2)
    Z = torch.zeros_like(rot)

    def mv(A, x):
        return (A @ x[..., None])[..., 0]

    # link (k-1 -> k), neighbour k-1 fixed
    # rotation: r = Log(dR^T R_prev^T R), dr/dδθ ≈ R^T (left pert)
    rR_p = so3.log(dR_p.transpose(-1, -2) @ r_p.transpose(-1, -2) @ rot)
    J_rp = torch.cat([rT, Z], dim=-1)  # (K, 3, 6)
    # position: r = R_prev^T (p - p_prev - v_prev dt - ½ g dt²) - dp
    dtp = dt_p[:, None]
    u_p = pos - p_p - v_p * dtp - 0.5 * grav * dtp * dtp
    rp_p = mv(r_p.transpose(-1, -2), u_p) - dp_p
    J_pp = torch.cat([Z, r_p.transpose(-1, -2)], dim=-1)
    # link (k -> k+1), neighbour k+1 fixed
    # rotation: r = Log(dR^T R^T R_next), dr/dδθ ≈ -R_next^T
    rR_n = so3.log(dR_n.transpose(-1, -2) @ rT @ r_n)
    J_rn = torch.cat([-r_n.transpose(-1, -2), Z], dim=-1)
    # position: r = R^T (p_next - p - v_k dt - ½ g dt²) - dp
    dtn = dt_n[:, None]
    u_n = p_n - pos - v_k * dtn - 0.5 * grav * dtn * dtn
    rp_n = mv(rT, u_n) - dp_n
    J_pn = torch.cat([rT @ so3.skew(u_n), -rT], dim=-1)
    HtH = Htz = 0.0
    for J, r_, wgt in ((J_rp, rR_p, w_rot * okp), (J_pp, rp_p, w_pos * okp),
                       (J_rn, rR_n, w_rot * okn), (J_pn, rp_n, w_pos * okn)):
        JT = J.transpose(-1, -2)
        HtH = HtH + (wgt[:, None, None] * JT) @ J
        Htz = Htz - mv(wgt[:, None, None] * JT, r_)
    return HtH, Htz


def _plane_terms(pts_w, pos, valid, body6, vmap_state,
                 map_cfg: VoxelMapConfig):
    """Every keyframe's point-to-plane normal equations against the plane
    map: (HtH (K, 6, 6), Htz (K, 6), use (K, N)) of the world points
    pts_w (K, N, 3) of poses with positions pos (K, 3); one match_planes
    over the K x N points."""
    K, N = valid.shape
    valid_f = valid.reshape(K * N)
    rel = (pts_w - pos[:, None, :]).reshape(K * N, 3)  # R p
    pts_w = pts_w.reshape(K * N, 3)
    # pose-uncertainty-free weighting for the batch pass
    match = match_planes(vmap_state, pts_w, body6, valid_f, map_cfg)
    use = match.valid & valid_f
    n = match.normal
    # r = n·(Exp(δθ) R p + t + δt) + d: dr/dδθ = ((R p) × n),
    # dr/dδt = n (left/world-frame perturbation).
    Jr = torch.cross(rel, n, dim=-1)
    H = torch.cat([Jr, n], dim=-1).reshape(K, N, 6)
    w = torch.where(use, 1.0 / (1e-3 + match.sigma_plane
                                + quad6(body6, n)), 0.0).reshape(K, N)
    HtH = torch.einsum("kni,kn,knj->kij", H, w, H)
    Htz = torch.einsum("kni,kn,kn->ki", H, w, -match.dist.reshape(K, N))
    return HtH, Htz, use.reshape(K, N)


def _refine_poses(rot, pos, scans, valid, body6, vmap_state,
                  map_cfg: VoxelMapConfig, iters: int, nbr=None, photo=None,
                  photo_ctx=None):
    """`iters` Gauss-Newton steps of every keyframe's pose against the
    shared plane map (the JAX package's vmapped _refine_pose_one),
    batched over K: one match_planes over the K x N points per step and
    one batched 6 x 6 solve. nbr: the IMU-link neighbour coupling
    (_link_terms) with the neighbours held fixed. Returns (rot, pos,
    n_used (K,) of the last step)."""
    eye6 = torch.eye(6, dtype=rot.dtype, device=rot.device) * 1e-6
    n_used = None
    for _ in range(iters):
        pts_w = scans @ rot.transpose(-1, -2) + pos[:, None, :]  # (K, N, 3)
        HtH, Htz, use = _plane_terms(pts_w, pos, valid, body6, vmap_state,
                                     map_cfg)
        HtH = HtH + eye6
        if nbr is not None:
            HtH_l, Htz_l = _link_terms(rot, pos, nbr)
            HtH = HtH + HtH_l
            Htz = Htz + Htz_l
        if photo is not None:
            HtH_p, Htz_p = _photo_terms(rot, pos, photo, *photo_ctx)
            HtH = HtH + HtH_p
            Htz = Htz + Htz_p
        sol = torch.linalg.solve_ex(HtH, Htz[..., None]).result[..., 0]
        rot = so3.exp(sol[:, 0:3]) @ rot  # left perturbation (world frame)
        pos = pos + sol[:, 3:6]
        n_used = torch.sum(use.to(torch.int32), dim=1)
    return rot, pos, n_used


def refine_window(window: Window, map_cfg: VoxelMapConfig,
                  outer_iters: int = 2, gn_iters: int = 3,
                  dept_err: float = 0.02, beam_err: float = 0.05,
                  mesh=None, imu_links: Optional[ImuLinks] = None,
                  imu_rot_sigma: float = 0.01, imu_pos_sigma: float = 0.05,
                  link_sweeps: int = 4,
                  photo: Optional[PhotoFactors] = None, cam=None,
                  Rci=None, Pci=None, patch_size: int = 8,
                  photo_weight: float = 0.01,
                  photo_unused: Optional[torch.Tensor] = None):
    """Alternate map rebuild / pose refinement. Returns (window, n_used
    (K,) int32).

    imu_links: preintegrated IMU factors between consecutive keyframes;
    each keyframe then also anchors to its two neighbours' poses, held
    fixed for a sweep (Jacobi), `link_sweeps` sweeps per map rebuild.
    imu_rot_sigma / imu_pos_sigma: 1σ of a link's rotation (rad) and
    position (m) residual at dt = 1 s; weights scale as 1/(σ²·dt).
    photo: photometric pose factors (needs cam / Rci / Pci); photo_weight
    the per-pixel information (the VIO convention 1/img_point_cov).
    photo_unused: a 0-d int64 tensor to which the count of factor slots
    left unused at the last Gauss-Newton step is added (with a mesh,
    those of the rank's keyframes); an unused factor adds nothing.
    mesh: a sharding.Mesh; every rank passes the whole window (and links
    and factors) and gets the whole refined window back, having refined
    its slice of the keyframes (K must divide by the mesh size; see the
    module docstring).
    Without a mesh there is no host read: the whole call can be captured
    as one CUDA graph."""
    K, N, _ = window.scans.shape
    dev = window.pos.device
    sl = shd.shard_rows(K, mesh) if mesh is not None else slice(None)
    scans, valid = window.scans[sl], window.valid[sl]
    Kl = scans.shape[0]
    body6 = sym6(calc_body_cov(scans.reshape(Kl * N, 3), dept_err, beam_err))
    valid_f = valid.reshape(Kl * N)
    last_unused = None
    if photo is not None:
        photo = PhotoFactors(*(x[sl] for x in photo))
        if photo_unused is not None:
            last_unused = torch.zeros((), dtype=torch.int64, device=dev)
    photo_ctx = ((cam, Rci, Pci, patch_size, photo_weight, last_unused)
                 if photo is not None else None)

    def whole(rot_l, pos_l):
        """The full pose arrays from every rank's refined slice."""
        if mesh is None:
            return rot_l, pos_l
        rp = shd.all_gather_rows(
            torch.cat([rot_l.reshape(Kl, 9), pos_l], dim=-1), mesh)
        return rp[:, 0:9].reshape(K, 3, 3), rp[:, 9:12]

    rot, pos = window.rot, window.pos
    n_used = torch.zeros((Kl,), dtype=torch.int32, device=dev)
    for _ in range(outer_iters):
        pts_w = (scans @ rot[sl].transpose(-1, -2)
                 + pos[sl][:, None, :]).reshape(Kl * N, 3)
        m = update_map(make_map(map_cfg, dev), pts_w, body6, valid_f, map_cfg,
                       mesh=mesh)
        if imu_links is None:
            rot_l, pos_l, n_used = _refine_poses(
                rot[sl], pos[sl], scans, valid, body6, m, map_cfg, gn_iters,
                photo=photo, photo_ctx=photo_ctx)
            rot, pos = whole(rot_l, pos_l)
        else:
            L = imu_links
            dt_s = torch.clamp(L.dt, min=1e-3)
            w_rot_k = 1.0 / (imu_rot_sigma ** 2 * dt_s)  # (K,) link k->k+1
            w_pos_k = 1.0 / (imu_pos_sigma ** 2 * dt_s)
            idx = torch.arange(K, device=dev)
            ok_p = torch.roll(L.valid, 1, 0) & (idx > 0)  # link (k-1 -> k)
            ok_n = L.valid & (idx < K - 1)  # link (k -> k+1)
            # One (w_rot, w_pos) pair serves both edges: the previous
            # edge's where it exists, else the next one's (adjacent links
            # have similar dt), as in the JAX package.
            w_rot = torch.where(ok_p, torch.roll(w_rot_k, 1, 0), w_rot_k)
            w_pos = torch.where(ok_p, torch.roll(w_pos_k, 1, 0), w_pos_k)
            for _ in range(link_sweeps):
                # neighbour snapshots refresh each sweep, from the whole
                # window's poses; each rank takes its keyframes' rows
                nbr = [x[sl] for x in (
                    torch.roll(rot, 1, 0), torch.roll(pos, 1, 0),
                    torch.roll(L.dR, 1, 0), torch.roll(L.dp, 1, 0),
                    torch.roll(dt_s, 1, 0), torch.roll(L.vel, 1, 0), ok_p,
                    torch.roll(rot, -1, 0), torch.roll(pos, -1, 0),
                    L.dR, L.dp, dt_s, L.vel, ok_n)]
                nbr += [L.grav, w_rot[sl], w_pos[sl]]
                rot_l, pos_l, n_used = _refine_poses(
                    rot[sl], pos[sl], scans, valid, body6, m, map_cfg,
                    gn_iters, nbr=tuple(nbr), photo=photo,
                    photo_ctx=photo_ctx)
                rot, pos = whole(rot_l, pos_l)
        rot = so3.normalize_rotation(rot)
    if mesh is not None:
        n_used = shd.all_gather_rows(n_used, mesh)
    if last_unused is not None:
        photo_unused.add_(last_unused)
    return window._replace(rot=rot, pos=pos), n_used


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: list  # the static input tensors the graph reads
    outputs: tuple  # (rot, pos) that a replay overwrites
    seconds: float  # capture time (the warm-up excluded)
    pool_bytes: int  # device memory reserved by the capture (its pool)


def _flatten(window, links, photo):
    return [*window, *(links or ()), *(photo or ())]


def _unflatten(flat, has_links: bool, has_photo: bool):
    window = Window(*flat[0:4])
    i = 4
    links = photo = None
    if has_links:
        links, i = ImuLinks(*flat[i:i + 6]), i + 6
    if has_photo:
        photo = PhotoFactors(*flat[i:i + 6])
    return window, links, photo


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of a device tensor, queued on the current stream."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class OnlineRefiner:
    """Sliding-window refinement running behind the causal front end
    (the JAX package's OnlineRefiner).

    Contract: one dispatch per `submit`, which never waits for the
    device; a second submit while one is pending (in flight, or done but
    not yet polled) is refused (returns False: the next stride covers
    those keyframes); `poll()` hands back (meta, rot (K, 3, 3), pos
    (K, 3)) as numpy once the refinement has completed, else None;
    `poll(force=True)` waits for it.

    On the card the refinement runs on the refiner's own CUDA stream,
    which first waits for the submitting stream's queued work, and an
    event after it marks completion (poll: `event.query()`, force:
    `event.synchronize()`). The first submit of each variant (plain /
    links / photo / links + photo, at its shapes) runs refine_window
    eagerly on that stream, its result the real one, and then captures
    it as a CUDA graph in a private memory pool (torch's capture
    synchronizes the device once); every later submit copies the window
    into the graph's static inputs and replays it, with 0 host syncs.
    The refined poses come back through pinned host buffers copied on
    the refiner's stream. The submitted tensors are held until poll
    returns them, so that no stream reuses their memory while the other
    reads it. On the CPU refine_window runs eagerly in submit.

    With a `mesh` (keyframe sharding; every rank submits the same
    windows in the same order) the refinement runs eagerly on the
    refiner's stream at every submit, never captured: gloo's collectives
    cannot be captured in a CUDA graph, and under gloo each collective
    waits on the host, so submit returns once the window is refined.
    poll then waits for the refiner's stream, so that every rank takes
    the result at the same poll and submits the next window at the same
    keyframe."""

    def __init__(self, map_cfg: VoxelMapConfig, outer_iters: int = 2,
                 gn_iters: int = 2, dept_err: float = 0.02,
                 beam_err: float = 0.05, mesh=None, cam=None, Rci=None,
                 Pci=None, patch_size: int = 8, photo_weight: float = 0.01):
        self.map_cfg = map_cfg
        self.outer_iters = outer_iters
        self.gn_iters = gn_iters
        self.dept_err = dept_err
        self.beam_err = beam_err
        self.mesh = mesh
        self.photo_ctx = (dict(cam=cam, Rci=Rci, Pci=Pci,
                               patch_size=patch_size,
                               photo_weight=photo_weight)
                          if cam is not None else None)
        self._pending = None
        self._stream = None
        self._graphs = {}
        # photometric factor slots left unused, summed on the device by
        # every window with factors (refine_window(photo_unused=)), and
        # the sum as of the last window polled back (from its host copy)
        self._photo_unused = None
        self._unused_polled = None
        self.submit_ms = []  # host ms of each submit
        self.device_ms = []  # refiner-stream ms of each completed window

    @property
    def busy(self) -> bool:
        return self._pending is not None

    def _refine(self, window, links, photo):
        kw = {}
        if photo is not None:
            if self._photo_unused is None:
                self._photo_unused = torch.zeros(
                    (), dtype=torch.int64, device=window.pos.device)
            kw = dict(self.photo_ctx, photo_unused=self._photo_unused)
        refined, _ = refine_window(
            window, self.map_cfg, outer_iters=self.outer_iters,
            gn_iters=self.gn_iters, dept_err=self.dept_err,
            beam_err=self.beam_err, mesh=self.mesh, imu_links=links,
            photo=photo, **kw)
        return refined.rot, refined.pos

    def submit(self, window: Window, meta=None, links=None,
               photo=None) -> bool:
        """Dispatch one window refinement; False while one is pending.
        `links`: ImuLinks; `photo`: PhotoFactors (needs the camera
        context given at construction)."""
        if self._pending is not None:
            return False
        if photo is not None and self.photo_ctx is None:
            raise ValueError("photometric factors need the camera context "
                             "(cam, Rci, Pci) at construction")
        t0 = time.perf_counter()
        if window.pos.device.type == "cuda":
            self._pending = (meta, *self._dispatch(window, links, photo))
        else:
            rot, pos = self._refine(window, links, photo)
            unused = None if photo is None else self._photo_unused.clone()
            self._pending = (meta, rot, pos, unused, None, None, None)
        self.submit_ms.append((time.perf_counter() - t0) * 1e3)
        return True

    def _dispatch(self, window, links, photo):
        """Queue the refinement on the refiner's stream: (host rot, host
        pos, host unused-slot sum or None, done event, (start, end)
        events, the tensors held)."""
        dev = window.pos.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        flat = _flatten(window, links, photo)
        variant = (links is not None, photo is not None)
        key = variant + tuple(tuple(t.shape) for t in flat)
        g = self._graphs.get(key) if self.mesh is None else None
        start, end, done = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event())
        with torch.cuda.stream(stream):
            start.record(stream)
            if g is None:
                rot, pos = self._refine(window, links, photo)  # warm-up
            else:
                for s, t in zip(g.inputs, flat):
                    s.copy_(t, non_blocking=True)
                g.graph.replay()
                rot, pos = g.outputs
            end.record(stream)
            host = (_pinned_copy(rot), _pinned_copy(pos),
                    None if photo is None else _pinned_copy(self._photo_unused))
            done.record(stream)
        held = (flat, rot, pos)
        if g is None and self.mesh is None:
            self._capture(key, variant, flat)
        return (*host, done, (start, end), held)

    def _capture(self, key, variant, flat):
        """Capture refine_window on the refiner's stream, reading static
        copies of this window's tensors."""
        from ..core.frame_graph import _capture_error

        stream = self._stream
        dev = stream.device
        with torch.cuda.stream(stream):
            static = [t.clone() for t in flat]
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as the capture does first
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=stream):
                outputs = self._refine(*_unflatten(static, *variant))
        except Exception as e:
            raise RuntimeError(
                "OnlineRefiner: CUDA graph capture of refine_window failed "
                f"at {_capture_error(e)}") from e
        self._graphs[key] = _Captured(
            graph, static, outputs, time.perf_counter() - t0,
            torch.cuda.memory_reserved(dev) - reserved)

    def poll(self, force: bool = False):
        """(meta, rot (K, 3, 3) np, pos (K, 3) np) once the refinement
        has completed; None while it runs (or when idle). force=True
        waits for it (end of stream), as does every poll with a mesh."""
        if self._pending is None:
            return None
        meta, rot, pos, unused, done, events, _ = self._pending
        if done is not None:
            if force or self.mesh is not None:
                done.synchronize()
            elif not done.query():
                return None
            self.device_ms.append(events[0].elapsed_time(events[1]))
        if unused is not None:
            self._unused_polled = int(unused)
        self._pending = None
        return meta, rot.numpy(), pos.numpy()

    def summary(self) -> dict:
        """The captured variants: their keys (links, photo), capture
        seconds and reserved pool bytes; and `photo_unused_slots`, the
        photometric factor slots left unused at each window's last
        Gauss-Newton step, summed on the device over the windows with
        factors up to the last one polled back (None before it). Nothing
        here waits for the device."""
        return {"graphs": len(self._graphs),
                "variants": [list(k[:2]) for k in self._graphs],
                "capture_seconds": [g.seconds for g in self._graphs.values()],
                "pool_bytes": [g.pool_bytes for g in self._graphs.values()],
                "photo_unused_slots": self._unused_polled}

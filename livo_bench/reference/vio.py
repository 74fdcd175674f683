"""Plain reference of one VIO frame of FAST-LIVO2, for judging the port.

What a fused frame computes after its LIO half and before its pose is
out, written out once more from the algorithm (FAST-LIVO2's vio.cpp, as
the JAX package and its port document their batched form), in plain
torch at float64, one step at a time:

- the frame's ring insert: the image into slot `id % F`, observations
  that referenced the evicted frame dropped, points left with none
  dropped, a cached reference observation that died forgotten;
- the depth raster of the frame's posterior scan: the nearest depth at
  each pixel;
- retrieval: every live pool point projected; in each image grid cell
  the point nearest the camera (ties to the later slot); the depth
  continuity test over a 9 x 9 window; the reference observation (the
  cached one while it lives, else the one whose patch differs least
  from the others'); the plane-normal homography warp of its patch at
  every pyramid level from its ring frame, with the search level; the
  outlier gate on the exposure-normalised level-0 error;
- the coarse-to-fine iterated photometric ESIKF over the rotation,
  position and exposure columns, in the device loop's form: every
  iteration of a level runs; one whose error grew rolls back and ends
  the level, as does a step under 1e-3 deg and 1e-3 cm; the covariance
  from the last gain that took effect.

Sampling follows the deployment: on a pinhole camera with 8 x 8 patches
and `tpu.pallas_photo`, the fused iteration's rule (the stride exponent
capped so that a 12-tap window fits the width, the window's columns
clipped as one block, its rows each on its own; above 448 tracked
points every tap on its own and no cap); otherwise every tap clipped on
its own, with no cap.

Nothing of the program is imported. What it hands over for a step is
its state: the visual point pool and the frame ring before the frame,
read in the program's layout (below). The LIO posterior the update
starts from, and the scan the depth raster is made of, are the LIO
reference's own.
"""

import torch

from .lio import DIM, Precision, State, boxminus, boxplus, setting, skew

# The program's pool layout: a point row (19) and K observation rows (20)
# a slot, and K level-0 patches.
P_POS, P_NRM = slice(0, 3), slice(3, 6)
P_VALID, P_HASREF, P_REF = 15, 17, 18
O_VALID, O_PX, O_R, O_T = 0, slice(1, 3), slice(3, 12), slice(12, 15)
O_EXPO, O_SLOT, O_FID = 15, 16, 17

KERNEL_MAX_POINTS = 448  # above it the fused iteration clips every tap
WIN = 12  # taps a side of the sampled window (8 + 4)
BIG = 3e38


# ------------------------------------------------------------ the camera

def camera(cam: dict) -> dict:
    """The camera yaml at its processing scale: pinhole with radtan
    (k1, k2, p1, p2) or equidistant fisheye (k1 .. k4)."""
    s = float(cam.get("scale", 1.0))
    s = s if s > 0 else 1.0
    model = str(cam["cam_model"]).lower()
    fish = model.startswith("equi") or model.startswith("fish")
    keys = ("k1", "k2", "k3", "k4") if fish else ("cam_d0", "cam_d1", "cam_d2", "cam_d3")
    d = tuple(float(cam.get(k, 0.0)) for k in keys)
    return dict(fish=fish, w=int(round(cam["cam_width"] * s)),
                h=int(round(cam["cam_height"] * s)), fx=cam["cam_fx"] * s,
                fy=cam["cam_fy"] * s, cx=cam["cam_cx"] * s, cy=cam["cam_cy"] * s,
                d=d, dist=any(abs(x) > 1e-12 for x in d))


def world2cam(c, pc):
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z = torch.where(z.abs() < 1e-9, 1e-9, z)
    if c["fish"]:
        k1, k2, k3, k4 = c["d"]
        r = torch.sqrt(x * x + y * y)
        r = torch.where(r < 1e-9, 1e-9, r)
        th = torch.atan2(r, z)
        t2 = th * th
        thd = th * (1 + k1 * t2 + k2 * t2 ** 2 + k3 * t2 ** 3 + k4 * t2 ** 4)
        u, v = thd * x / r, thd * y / r
    else:
        u, v = x / z, y / z
        if c["dist"]:
            k1, k2, p1, p2 = c["d"]
            r2 = u * u + v * v
            rad = 1.0 + k1 * r2 + k2 * r2 * r2
            u, v = (u * rad + 2 * p1 * u * v + p2 * (r2 + 2 * u * u),
                    v * rad + p1 * (r2 + 2 * v * v) + 2 * p2 * u * v)
    return torch.stack([c["fx"] * u + c["cx"], c["fy"] * v + c["cy"]], -1)


def cam2world(c, px, iters=5):
    """Unit bearing of a pixel; the distortion undone by fixed-point
    iterations."""
    u = (px[..., 0] - c["cx"]) / c["fx"]
    v = (px[..., 1] - c["cy"]) / c["fy"]
    if c["fish"]:
        k1, k2, k3, k4 = c["d"]
        thd = torch.sqrt(u * u + v * v)
        th = thd
        for _ in range(iters):
            t2 = th * th
            th = thd / (1 + k1 * t2 + k2 * t2 ** 2 + k3 * t2 ** 3 + k4 * t2 ** 4)
        s = torch.where(thd < 1e-9, 1.0, torch.tan(th) / thd)
        f = torch.stack([u * s, v * s, torch.ones_like(u)], -1)
    else:
        if c["dist"]:
            k1, k2, p1, p2 = c["d"]
            ud, vd = u, v
            for _ in range(iters):
                r2 = u * u + v * v
                rad = 1.0 + k1 * r2 + k2 * r2 * r2
                u, v = ((ud - 2 * p1 * u * v - p2 * (r2 + 2 * u * u)) / rad,
                        (vd - p1 * (r2 + 2 * v * v) - 2 * p2 * u * v) / rad)
        f = torch.stack([u, v, torch.ones_like(u)], -1)
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


def in_frame(c, px, border):
    return ((px[..., 0] >= border) & (px[..., 0] < c["w"] - border)
            & (px[..., 1] >= border) & (px[..., 1] < c["h"] - border))


def settings(sensor: dict, c: dict) -> dict:
    """The VIO settings of a deployment's sensor yaml, with the grid of
    image cells derived from the camera."""
    for key, want in (("vio.normal_en", True), ("vio.ncc_en", False),
                      ("vio.raycast_en", False), ("vio.inverse_composition_en", False),
                      ("tpu.true_pyramid", False)):
        if bool(setting(sensor, key)) != want:
            raise NotImplementedError(f"the VIO reference has no {key} = {not want}")
    gs = int(setting(sensor, "vio.grid_size"))
    if gs <= 10:
        gs = c["h"] // int(setting(sensor, "vio.grid_n_height"))
    gw, gh = -(-c["w"] // gs), -(-c["h"] // gs)
    ps, L = int(setting(sensor, "vio.patch_size")), int(setting(sensor, "vio.patch_pyrimid_level"))
    window = bool(setting(sensor, "tpu.pallas_photo")) and not c["fish"] and ps == 8
    cap = 4
    while (1 << cap) * WIN > c["w"] and cap > 0:
        cap -= 1
    return dict(gs=gs, gw=gw, gh=gh, ps=ps, levels=L,
                border=(ps // 2 + 1) * (1 << L), K=int(setting(sensor, "tpu.vis_obs_per_point")),
                F=int(setting(sensor, "tpu.frame_ring")),
                iterations=int(setting(sensor, "vio.max_iterations")),
                point_cov=float(setting(sensor, "vio.img_point_cov")),
                outlier=float(setting(sensor, "vio.outlier_threshold")),
                expo=1.0 if bool(setting(sensor, "vio.exposure_estimate_en")) else 0.0,
                window=window, per_tap=(not window) or gw * gh > KERNEL_MAX_POINTS,
                cap=cap if (window and gw * gh <= KERNEL_MAX_POINTS) else 30)


def camera_pose(P: Precision, s: State, Rci, Pci):
    Rcw = P.mm(Rci, s.rot.T)
    return Rcw, Pci - P.mm(Rcw, s.pos[:, None])[:, 0]


def offsets(n, dev):
    """(n*n,) column and row offsets of an n x n patch, row by row, from
    -n//2."""
    a = torch.arange(n, device=dev) - n // 2
    dy, dx = torch.meshgrid(a, a, indexing="ij")
    return dx.reshape(-1), dy.reshape(-1)


# ------------------------------------------------------------- the steps

def ring_insert(point, obs, imgs, ids, img, fid, cfg):
    """(point, obs, imgs, ids, slot) after the frame's ring insert."""
    K, F = cfg["K"], cfg["F"]
    slot = fid % F
    imgs, ids = imgs.clone(), ids.clone()
    imgs[slot], ids[slot] = img, fid
    obs, point = obs.clone(), point.clone()
    live = obs[..., O_VALID] > 0.5
    gone = (obs[..., O_SLOT].long() == slot) & (obs[..., O_FID].long() != fid)
    live = live & ~gone
    obs[..., O_VALID] = live.to(obs.dtype)
    ref = point[:, P_REF].long()
    inr = (ref >= 0) & (ref < K)
    ref_alive = inr & torch.gather(live, 1, ref.clamp(0, K - 1)[:, None])[:, 0]
    point[:, P_HASREF] *= ref_alive.to(point.dtype)
    point[:, P_VALID] *= live.any(-1).to(point.dtype)
    return point, obs, imgs, ids


def depth_raster(P, c, Rcw, Pcw, pts_w, border):
    """The nearest camera depth of the scan at each pixel (0: none)."""
    pc = P.mm(pts_w, Rcw.T) + Pcw
    px = world2cam(c, pc)
    ok = (pc[:, 2] > 0) & in_frame(c, px, border)
    col = px[ok, 0].long().clamp(0, c["w"] - 1)
    row = px[ok, 1].long().clamp(0, c["h"] - 1)
    d = torch.full((c["h"] * c["w"],), float("inf"), dtype=pc.dtype, device=pc.device)
    d = d.scatter_reduce(0, row * c["w"] + col, pc[ok, 2], reduce="amin")
    return torch.where(torch.isinf(d), 0.0, d).reshape(c["h"], c["w"])


def retrieve(P, c, cfg, point, obs, patches, imgs, ids, img, depth, s, Rci, Pci):
    """The frame's tracked points: dict of pos (m, 3), warp (m, L, ps²),
    search (m,), ref_expo (m,), the pool slot of each and the outlier
    gate's errors; only the cells that keep a point."""
    dev, f = point.device, P.dtype
    ps, L, K = cfg["ps"], cfg["levels"], cfg["K"]
    Rcw, Pcw = camera_pose(P, s, Rci, Pci)
    cam_pos = -(Rcw.T @ Pcw)
    pos = point[:, P_POS]
    pc = P.mm(pos, Rcw.T) + Pcw
    px = world2cam(c, pc)
    cand = (point[:, P_VALID] > 0.5) & (pc[:, 2] > 0) & in_frame(c, px, cfg["border"])
    idx = torch.nonzero(cand)[:, 0]
    row = (px[idx, 1].long() // cfg["gs"]).clamp(0, cfg["gh"] - 1)
    col = (px[idx, 0].long() // cfg["gs"]).clamp(0, cfg["gw"] - 1)
    cell = row * cfg["gw"] + col
    dist = torch.linalg.norm(pos[idx] - cam_pos, dim=-1)
    # nearest in each cell, the later slot on a tie: sort by slot
    # (descending), then distance, then cell, each stable
    o = torch.argsort(-idx, stable=True)
    o = o[torch.argsort(dist[o], stable=True)]
    o = o[torch.argsort(cell[o], stable=True)]
    first = torch.ones_like(o, dtype=torch.bool)
    first[1:] = cell[o][1:] != cell[o][:-1]
    win = idx[o[first]]
    pos, pcw, pxw = pos[win], pc[win], px[win]
    pt, ob, pa = point[win], obs[win], patches[win]

    # depth continuity over the 9 x 9 window around the pixel
    dx, dy = offsets(ps + 1, dev)
    cx = (pxw[:, 0].long()[:, None] + dx).clamp(0, c["w"] - 1)
    cy = (pxw[:, 1].long()[:, None] + dy).clamp(0, c["h"] - 1)
    dp = depth[cy, cx]
    keep = ~torch.any((dp > 0) & ((pcw[:, 2:3] - dp).abs() > 0.5), 1)

    # the reference observation
    live = ob[:, :, O_VALID] > 0.5
    diff = pa[:, :, None, :] - pa[:, None, :, :]
    perr = torch.sum(diff * diff, -1)
    pair = live[:, :, None] & live[:, None, :] & ~torch.eye(K, dtype=torch.bool, device=dev)
    mean = torch.where(live, torch.where(pair, perr, 0.0).sum(-1)
                       / pair.sum(-1).clamp(min=1), BIG)
    best = torch.argmin(mean, -1)
    only = torch.argmax(live.to(torch.int32), -1)
    prev = pt[:, P_REF].long().clamp(0, K - 1)
    cached = (pt[:, P_HASREF] > 0.5) & torch.gather(live, 1, prev[:, None])[:, 0]
    k = torch.where(cached, prev, torch.where(live.sum(-1) == 1, only, best))
    ro = torch.gather(ob, 1, k[:, None, None].expand(-1, 1, ob.shape[-1]))[:, 0]

    # the plane-normal homography warp of the reference patch
    R_ref = ro[:, O_R].reshape(-1, 3, 3)
    t_ref, px_ref = ro[:, O_T], ro[:, O_PX]
    pf = torch.einsum("mij,mj->mi", R_ref, pos) + t_ref
    n = torch.einsum("mij,mj->mi", R_ref, pt[:, P_NRM])
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-9)
    R_cr = Rcw @ R_ref.transpose(-1, -2)
    t_cr = Pcw - torch.einsum("mij,mj->mi", R_cr, t_ref)
    t_inv = -torch.einsum("mji,mj->mi", R_cr, t_cr)
    nd = torch.sum(n * pf, -1)
    eye = torch.eye(3, dtype=f, device=dev)
    Hm = R_cr @ (nd[:, None, None] * eye - t_inv[:, :, None] * n[:, None, :])

    def moved(du, dv):
        q = px_ref + torch.tensor([du, dv], dtype=f, device=dev)
        return world2cam(c, torch.einsum("mij,mj->mi", Hm, cam2world(c, q)))

    p0 = moved(0.0, 0.0)
    A = torch.stack([(moved(4.0, 0.0) - p0) / 4.0, (moved(0.0, 4.0) - p0) / 4.0], -1)
    D = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    search = torch.zeros_like(k)
    Dw = D
    for _ in range(2):
        up = Dw > 3.0
        search = search + up.long()
        Dw = torch.where(up, Dw * 0.25, Dw)
    ok = D.abs() > 1e-8
    Ainv = torch.stack([torch.stack([A[:, 1, 1], -A[:, 0, 1]], -1),
                        torch.stack([-A[:, 1, 0], A[:, 0, 0]], -1)], -2) / torch.where(
                            ok, D, 1.0)[:, None, None]
    slot, fid = ro[:, O_SLOT].long(), ro[:, O_FID].long()
    ok = ok & (slot >= 0) & (ids[slot.clamp(0, cfg["F"] - 1)].long() == fid)
    ring = slot.clamp(0, cfg["F"] - 1)[:, None]
    ox, oy = offsets(ps, dev)
    off = torch.stack([ox, oy], -1).to(f)
    h, w = imgs.shape[-2:]
    warp = []
    for lvl in range(L):
        sc = (2.0 ** (lvl + search.to(f)))[:, None, None]
        q = torch.einsum("mij,mpj->mpi", Ainv, off[None] * sc) + px_ref[:, None, :]
        u, v = q[..., 0], q[..., 1]
        inside = (u >= 0) & (v >= 0) & (u < w - 1) & (v < h - 1)
        x0 = torch.floor(u).clamp(0, w - 2)
        y0 = torch.floor(v).clamp(0, h - 2)
        su, sv = u - x0, v - y0
        x0, y0 = x0.long(), y0.long()
        val = ((1 - su) * (1 - sv) * imgs[ring, y0, x0] + su * (1 - sv) * imgs[ring, y0, x0 + 1]
               + (1 - su) * sv * imgs[ring, y0 + 1, x0] + su * sv * imgs[ring, y0 + 1, x0 + 1])
        warp.append(torch.where(inside, val, 0.0))
    warp = torch.stack(warp, 1)

    # the outlier gate on the level-0 patch at the prior
    cur = _strided(img, pxw, torch.ones_like(k, dtype=f), ps, lo=-(ps // 2), size=ps + 1,
                   per_tap=True)[0]
    e = ro[:, O_EXPO, None] * warp[:, 0, :] - s.expo * cur
    err0 = torch.sum(e * e, -1)
    keep = keep & ok & (err0 <= cfg["outlier"] * ps * ps)
    return dict(pos=pos[keep], warp=warp[keep], search=search[keep],
                ref_expo=ro[keep, O_EXPO], slots=win[keep], err0=err0[keep])


def _strided(img, px, stride, ps, lo, size, per_tap):
    """The bilinear ps x ps patch at px on the grid of step `stride`
    (value, and with size ps + 4 the central differences du, dv): taps at
    floor(px / s) * s + (i + lo) s. `per_tap`: each tap clipped to the
    image; else the fused iteration's window: columns as one block,
    rows each on its own."""
    h, w = img.shape
    s = stride[:, None]
    ui = torch.floor(px[:, 0:1] / s) * s
    vi = torch.floor(px[:, 1:2] / s) * s
    su = ((px[:, 0:1] - ui) / s)[:, :, None]
    sv = ((px[:, 1:2] - vi) / s)[:, :, None]
    taps = torch.arange(size, device=img.device) + lo
    x = ui.long() + taps * s.long()
    y = vi.long() + taps * s.long()
    if per_tap:
        x = x.clamp(0, w - 1)
    else:
        x0 = (ui.long() + lo * s.long()).clamp(min=0)
        x0 = torch.minimum(x0, w - WIN * s.long())
        x = x0 + (taps - lo) * s.long()
    y = y.clamp(0, h - 1)
    sp = img[y[:, :, None], x[:, None, :]]

    def bil(r0, c0):
        b = sp[:, r0:r0 + ps + 1, c0:c0 + ps + 1]
        return ((1 - su) * (1 - sv) * b[:, :ps, :ps] + su * (1 - sv) * b[:, :ps, 1:]
                + (1 - su) * sv * b[:, 1:, :ps] + su * sv * b[:, 1:, 1:]).reshape(-1, ps * ps)

    if size == ps + 1:
        return (bil(0, 0),)
    return bil(1, 1), 0.5 * (bil(1, 2) - bil(1, 0)), 0.5 * (bil(2, 1) - bil(0, 1))


def normal_equations(P, c, cfg, s, sub, lvl, img, Rci, Pci, n_meas):
    """(H^T H (7, 7), H^T r (7,), mean squared error) of the tracked
    points at state s, pyramid level lvl."""
    ps = cfg["ps"]
    Rcw, Pcw = camera_pose(P, s, Rci, Pci)
    pf = P.mm(sub["pos"], Rcw.T) + Pcw
    px = world2cam(c, pf)
    use = (pf[:, 2] > 1e-6).to(P.dtype)
    slog = (lvl + sub["search"]).clamp(0, cfg["cap"])
    stride = (2.0 ** slog).to(P.dtype)
    val, du, dv = _strided(img, px, stride, ps, lo=-(ps // 2) - 1, size=ps + 4,
                           per_tap=cfg["per_tap"])
    tau = s.expo
    g = (tau / stride)[:, None, None]
    x, y = pf[:, 0], pf[:, 1]
    zi = 1.0 / torch.where(pf[:, 2].abs() < 1e-9, 1e-9, pf[:, 2])
    o = torch.zeros_like(zi)
    Jpi = torch.stack([torch.stack([c["fx"] * zi, o, -c["fx"] * x * zi * zi], -1),
                       torch.stack([o, c["fy"] * zi, -c["fy"] * y * zi * zi], -1)], -2)
    Jimg = torch.stack([du, dv], -1) * g  # (m, ps², 2)
    Jc = torch.einsum("mpi,mij->mpj", Jimg, Jpi)  # d r / d p_cam
    Pic = -(Rci.T @ Pci)
    JdR = (torch.einsum("mpi,mij->mpj", Jc, skew(pf)) @ Rci + Jc @ (Rci @ skew(Pic)))
    Jdt = -(Jc @ Rcw)
    ref = sub["ref_expo"][:, None] * sub["warp"][:, lvl, :]
    res = tau * val - ref
    H = torch.cat([JdR, Jdt, (val * cfg["expo"])[..., None]], -1) * use[:, None, None]
    Hf, rf = H.reshape(-1, 7), (res * use[:, None]).reshape(-1, 1)
    return (P.mm(Hf.T, Hf), P.mm(Hf.T, rf)[:, 0],
            torch.sum(use[:, None] * res * res) / n_meas)


def photometric(P, c, cfg, prior: State, cov, sub, img, Rci, Pci, n_valid):
    """The coarse-to-fine iterated photometric ESIKF: (state, cov)."""
    f, dev = P.dtype, cov.device
    Pinv = torch.linalg.inv(0.5 * (cov + cov.T) / cfg["point_cov"])
    n_meas = float(max(n_valid * cfg["ps"] ** 2, 1))
    s, G_keep = prior, torch.zeros((DIM, DIM), dtype=f, device=dev)
    for lvl in reversed(range(cfg["levels"])):
        back, last = s, float("inf")
        for _ in range(cfg["iterations"]):
            HTH7, HTz7, err = normal_equations(P, c, cfg, s, sub, lvl, img, Rci, Pci, n_meas)
            HTH = torch.zeros((DIM, DIM), dtype=f, device=dev)
            HTH[0:7, 0:7] = HTH7
            K1 = torch.linalg.inv(HTH + Pinv)
            G = torch.zeros((DIM, DIM), dtype=f, device=dev)
            G[:, 0:7] = P.mm(K1[:, 0:7], HTH7)
            vec = boxminus(prior, s)
            sol = (-P.mm(K1[:, 0:7], HTz7[:, None])[:, 0] + vec
                   - P.mm(G[:, 0:7], vec[0:7, None])[:, 0])
            if float(err) > last:  # the error grew: roll back, end the level
                s = back
                break
            back, s, last, G_keep = s, boxplus(s, sol), float(err), G
            if (float(torch.linalg.norm(sol[0:3])) * 57.3 < 0.001
                    and float(torch.linalg.norm(sol[3:6])) * 100.0 < 0.001):
                break
    return s, cov - P.mm(G_keep, cov)


def vio_frame(P, c, cfg, prior: State, cov, pool, img, fid, pts_w, Rci, Pci):
    """The frame's VIO half from the LIO posterior (prior, cov), the pool
    and ring before the frame, the frame's image and posterior scan:
    (state, cov, points tracked)."""
    f = P.dtype
    point, obs, patches, imgs, ids = (x.to(cov.device) for x in pool)
    point, obs, patches, imgs = (x.to(f) for x in (point[:-1], obs[:-1], patches[:-1], imgs))
    img = torch.as_tensor(img, device=cov.device).to(f)
    point, obs, imgs, ids = ring_insert(point, obs, imgs, ids.long(), img, fid, cfg)
    Rcw, Pcw = camera_pose(P, prior, Rci, Pci)
    depth = depth_raster(P, c, Rcw, Pcw, pts_w, cfg["border"])
    sub = retrieve(P, c, cfg, point, obs, patches, imgs, ids, img, depth, prior, Rci, Pci)
    n = int(sub["pos"].shape[0])
    s, cov_post = photometric(P, c, cfg, prior, cov, sub, img, Rci, Pci, n)
    return s, cov_post, n

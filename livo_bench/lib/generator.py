"""The benchmark's recording generator: a rig's IMU, LiDAR and camera
streams through a textured box room, made on the card from the seed.

A copy of the port's `io/synthetic` scene (default_room, Trajectory with
its still start and C1 ramp, texture, imu_stream, lidar_scan,
degrade_image, render_image) and of chip_smoke.py's rig assembly (RIGS,
rig_extrinsics, rig_frames: scans written in the rig's LiDAR frame, the
decoder's blind filter), rewritten as batched torch so that a minute of
recording takes seconds on the card instead of minutes of host numpy.
The scene and the motion are fixed; the seed draws the noise (IMU white
noise, LiDAR range noise, dropout and outliers, image photon and read
noise), so every seed gets the same sizes and arrivals.

Nothing here imports the program: the camera model and the texture are
written out below, as the plain reference needs them too.
"""

import math
import time
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

GRAVITY = 9.81
STILL_S = 0.6  # io/synthetic.make_sequence: stationary start for IMU init
RAMP_S = 1.0  # its C1 time warp into unit rate
IMU_HZ = 200.0
LIDAR_HZ = 10.0
SCAN_T0 = 0.05  # first scan start (io/synthetic.make_sequence)
IMG_T0 = 0.1  # first image stamp
# scans and images made a batch at a time on the device (memory, not
# results, depends on these)
BATCH_SCANS, BATCH_IMAGES = 25, 8


@dataclass
class Recording:
    """A rig's recording on the host, as a sensor hands it over: IMU
    samples, decoded scans (t_begin, points in the LiDAR frame, float32
    offsets from t_begin), images as the pipeline ingests them (uint8 at
    the processed camera size) and ground truth (IMU pose in the scene
    frame) at every image stamp."""

    imu_t: np.ndarray
    imu_gyr: np.ndarray
    imu_acc: np.ndarray
    scans: List[Tuple[float, np.ndarray, np.ndarray]]
    images: List[Tuple[float, np.ndarray]]
    gt_t: np.ndarray
    gt_R: np.ndarray
    gt_p: np.ndarray
    seconds: dict = None  # host seconds of each part of the making


# ---------------------------------------------------------------- scene

def room_planes(half=6.0, height=3.0):
    """io/synthetic.default_room: (point, normal, u_axis, v_axis, tex_seed)
    of the six infinite planes."""
    z0, z1 = -1.5, height - 1.5
    e = np.eye(3)
    return [
        (np.array([0, 0, z0]), e[2], e[0], e[1], 1),
        (np.array([0, 0, z1]), -e[2], e[0], e[1], 2),
        (np.array([half, 0, 0]), -e[0], e[1], e[2], 3),
        (np.array([-half, 0, 0]), e[0], e[1], e[2], 4),
        (np.array([0, half, 0]), -e[1], e[0], e[2], 5),
        (np.array([0, -half, 0]), e[1], e[0], e[2], 6),
    ]


def texture_params(seed: int) -> np.ndarray:
    """io/synthetic.texture's six octaves (fu, fv, ph_u, ph_v, amp), drawn
    as it draws them from its per-plane seed."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(6):
        fu, fv = rng.uniform(0.3, 3.0, 2)
        ph_u, ph_v = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(0.3, 1.0)
        rows.append([fu, fv, ph_u, ph_v, amp])
    return np.array(rows)


class Scene:
    """The room's planes and textures as tensors on `device`."""

    def __init__(self, device):
        planes = room_planes()
        f64 = dict(dtype=torch.float64, device=device)
        self.point = torch.tensor(np.stack([p[0] for p in planes]), **f64)
        self.normal = torch.tensor(np.stack([p[1] for p in planes]), **f64)
        self.u = torch.tensor(np.stack([p[2] for p in planes]), **f64)
        self.v = torch.tensor(np.stack([p[3] for p in planes]), **f64)
        self.tex = torch.tensor(np.stack([texture_params(p[4]) for p in planes]),
                                **f64)

    def hit(self, o, d):
        """Nearest front-face hit of rays o + t d (N, 3): (t, plane index,
        hit mask), io/synthetic.Plane.intersect and ray_hits."""
        denom = d @ self.normal.T  # (N, P)
        num = torch.sum((self.point[None] - o[:, None]) * self.normal[None], -1)
        t = num / torch.where(denom.abs() > 0, denom, 1.0)
        ok = (denom < -1e-9) & (t > 0.05)
        t = torch.where(ok, t, math.inf)
        best, idx = torch.min(t, dim=1)
        hit = torch.isfinite(best)
        return torch.where(hit, best, 0.0), idx, hit

    def shade(self, pts, idx):
        """io/synthetic.texture at world points on planes `idx`."""
        rel = pts - self.point[idx]
        u = torch.sum(rel * self.u[idx], -1)
        v = torch.sum(rel * self.v[idx], -1)
        p = self.tex[idx]  # (N, 6, 5)
        val = torch.sum(p[..., 4] * torch.sin(p[..., 0] * u[:, None] * 2 * math.pi + p[..., 2])
                        * torch.sin(p[..., 1] * v[:, None] * 2 * math.pi + p[..., 3]), -1)
        return 128.0 + 40.0 * val / 2.2


# ----------------------------------------------------------- trajectory

def _rotz(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _exp(w):
    """Rodrigues (..., 3) -> (..., 3, 3), io/synthetic._exp."""
    th = torch.linalg.norm(w, dim=-1)[..., None, None]
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    ths = torch.where(th < 1e-12, 1.0, th)
    a = torch.where(th < 1e-12, 1.0, torch.sin(ths) / ths)
    b = torch.where(th < 1e-12, 0.0, (1 - torch.cos(ths)) / ths ** 2)
    return eye + a * K + b * (K @ K)


def _warp(t):
    """make_sequence's time warp: frozen, then a quadratic ramp."""
    dt = t - STILL_S
    return torch.where(dt <= 0, torch.zeros_like(t),
                       torch.where(dt < RAMP_S, dt * dt / (2 * RAMP_S),
                                   dt - RAMP_S / 2))


def pose(t):
    """io/synthetic.Trajectory (defaults) under the warp: (R (..., 3, 3),
    p (..., 3)) of the IMU in the scene frame, float64."""
    s = _warp(t)
    amp = torch.tensor([1.5, 1.2, 0.3], dtype=t.dtype, device=t.device)
    w = 2 * math.pi * torch.tensor([0.25, 0.17, 0.4], dtype=t.dtype, device=t.device)
    p = amp * torch.sin(w * s[..., None])
    yaw = 0.25 * s + 0.2 * torch.sin(0.7 * s)
    roll = 0.06 * torch.sin(1.1 * s)
    pitch = 0.06 * torch.sin(0.9 * s + 1.0)
    R = _rotz(yaw) @ _exp(torch.stack([roll, pitch, torch.zeros_like(s)], -1))
    return R, p


def imu_stream(t, gen, gyr_noise=1e-3, acc_noise=1e-2):
    """io/synthetic.imu_stream: body rate and specific force by central
    differences (eps 1e-4), with white noise drawn from `gen`."""
    eps = 1e-4
    R, _ = pose(t)
    Rm, _ = pose(t - eps)
    Rp, _ = pose(t + eps)
    dR = R.transpose(-1, -2) @ (Rp - Rm) / (2 * eps)
    w = torch.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0],
                     dR[:, 1, 0] - dR[:, 0, 1]], -1) / 2

    def vel(x):
        return (pose(x + eps)[1] - pose(x - eps)[1]) / (2 * eps)

    a_w = (vel(t + eps) - vel(t - eps)) / (2 * eps)
    g_w = torch.tensor([0.0, 0.0, -GRAVITY], dtype=t.dtype, device=t.device)
    f_b = torch.einsum("nji,nj->ni", R, a_w - g_w)
    n = t.shape[0]
    gyr = w + torch.randn((n, 3), generator=gen, dtype=t.dtype, device=t.device) * gyr_noise
    acc = f_b + torch.randn((n, 3), generator=gen, dtype=t.dtype, device=t.device) * acc_noise
    return gyr, acc


# --------------------------------------------------------------- camera

def unproject(cam, px):
    """Pixel (N, 2) -> unit bearing (N, 3): the pinhole-radtan or
    equidistant model inverted by fixed-point iteration."""
    u = (px[:, 0] - cam["cx"]) / cam["fx"]
    v = (px[:, 1] - cam["cy"]) / cam["fy"]
    k = cam["d"]
    if cam["model"] == "pinhole":
        ud, vd = u, v
        for _ in range(20):
            r2 = u * u + v * v
            radial = 1.0 + k[0] * r2 + k[1] * r2 * r2
            du = 2 * k[2] * u * v + k[3] * (r2 + 2 * u * u)
            dv = k[2] * (r2 + 2 * v * v) + 2 * k[3] * u * v
            u, v = (ud - du) / radial, (vd - dv) / radial
        f = torch.stack([u, v, torch.ones_like(u)], -1)
    else:
        theta_d = torch.sqrt(u * u + v * v)
        theta = theta_d
        for _ in range(20):
            t2 = theta * theta
            theta = theta_d / (1 + k[0] * t2 + k[1] * t2 ** 2 + k[2] * t2 ** 3
                               + k[3] * t2 ** 4)
        scale = torch.where(theta_d < 1e-9, 1.0, torch.tan(theta) / theta_d)
        f = torch.stack([u * scale, v * scale, torch.ones_like(u)], -1)
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


def camera_model(cam_yaml: dict, scale: float = 1.0) -> dict:
    """The camera yaml as a dict of floats, at `scale`."""
    model = str(cam_yaml.get("cam_model", "Pinhole")).lower()
    fish = model.startswith("equi") or model.startswith("fish")
    d = ([cam_yaml.get(k, 0.0) for k in ("k1", "k2", "k3", "k4")] if fish
         else [cam_yaml.get(k, 0.0) for k in ("cam_d0", "cam_d1", "cam_d2", "cam_d3")])
    return dict(model="equidistant" if fish else "pinhole",
                width=int(round(cam_yaml["cam_width"] * scale)),
                height=int(round(cam_yaml["cam_height"] * scale)),
                fx=cam_yaml["cam_fx"] * scale, fy=cam_yaml["cam_fy"] * scale,
                cx=cam_yaml["cam_cx"] * scale, cy=cam_yaml["cam_cy"] * scale,
                d=[float(x) for x in d])


def extrinsics(sensor: dict):
    """chip_smoke.rig_extrinsics: (R, T) LiDAR to IMU and (R_ci, P_ci)
    the camera from the IMU, float64 numpy."""
    e = sensor["extrin_calib"]
    R = np.array(e["extrinsic_R"], np.float64).reshape(3, 3)
    T = np.array(e["extrinsic_T"], np.float64)
    Rcl = np.array(e["Rcl"], np.float64).reshape(3, 3)
    Pcl = np.array(e["Pcl"], np.float64)
    return R, T, Rcl @ R.T, Pcl - Rcl @ R.T @ T


def _blur_rows(img, k, r):
    pad = torch.nn.functional.pad(img[:, None], (0, 0, r, r), mode="replicate")[:, 0]
    return sum(k[i] * pad[:, i:i + img.shape[1]] for i in range(2 * r + 1))


def degrade(img, gen, photon_noise, read_noise, blur_px):
    """io/synthetic.degrade_image on a batch (B, H, W)."""
    out = img
    if blur_px > 0.0:
        r = max(1, int(math.ceil(2.0 * blur_px)))
        x = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
        k = torch.exp(-0.5 * (x / blur_px) ** 2)
        k = k / k.sum()
        out = _blur_rows(out, k, r)
        out = _blur_rows(out.transpose(1, 2), k, r).transpose(1, 2)
    if photon_noise > 0.0:
        out = out + torch.randn(out.shape, generator=gen, dtype=out.dtype,
                                device=out.device) * torch.sqrt(
            torch.clamp(out, min=0.0) * photon_noise)
    if read_noise > 0.0:
        out = out + torch.randn(out.shape, generator=gen, dtype=out.dtype,
                                device=out.device) * read_noise
    return torch.clamp(out, 0, 255)


def render(scene, t, cam, R_ci, P_ci):
    """io/synthetic.render_image for stamps t (B,): (B, H, W) float64."""
    R_wi, p_wi = pose(t)
    dev = t.device
    Rci = torch.tensor(R_ci, dtype=torch.float64, device=dev)
    Pci = torch.tensor(P_ci, dtype=torch.float64, device=dev)
    R_wc = R_wi @ Rci.T  # (R_ci R_wi^T)^T
    origin = p_wi - torch.einsum("bij,j->bi", R_wc, Pci)
    ys, xs = torch.meshgrid(torch.arange(cam["height"], device=dev),
                            torch.arange(cam["width"], device=dev), indexing="ij")
    px = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float64)
    d_cam = unproject(cam, px)
    d_w = torch.einsum("bij,nj->bni", R_wc, d_cam).reshape(-1, 3)
    o = origin[:, None, :].expand(-1, d_cam.shape[0], -1).reshape(-1, 3)
    tt, idx, hit = scene.hit(o, d_w)
    img = torch.where(hit, scene.shade(o + d_w * tt[:, None], idx), 90.0)
    return torch.clamp(img, 0, 255).reshape(t.shape[0], cam["height"], cam["width"])


def resize_half(img, times):
    """io/dataset.resize_half on (B, H, W): the yaml's camera scale."""
    for _ in range(times):
        h, w = img.shape[1] // 2 * 2, img.shape[2] // 2 * 2
        img = img[:, :h, :w]
        img = 0.25 * (img[:, 0::2, 0::2] + img[:, 1::2, 0::2]
                      + img[:, 0::2, 1::2] + img[:, 1::2, 1::2])
    return img


# ---------------------------------------------------------------- LiDAR

def scan_pattern(rig: dict, dtype, device):
    """lidar_scan's ray pattern in firing order: (body directions
    (n_per, lines, 3): each instant's lasers, line by line; fraction of
    the period of each instant (n_per,))."""
    n_lines, n_per = rig["lines"], rig["per_line"]
    frac = torch.arange(n_per, dtype=dtype, device=device) / n_per
    az = (frac - 0.5) * math.radians(rig["fov_deg"])
    el = torch.linspace(-0.35, 0.35, n_lines, dtype=dtype, device=device)
    d = torch.stack([torch.cos(el)[None] * torch.cos(az)[:, None],
                     torch.cos(el)[None] * torch.sin(az)[:, None],
                     torch.sin(el)[None].expand(n_per, n_lines)], -1)
    return d, frac


def scans(scene, t_begin, rig, gen, R_lidar, T_lidar, blind, rebase):
    """One batch of motion-distorted scans starting at t_begin (B,):
    [(t_begin, points in the LiDAR frame float32, offsets float32)] in
    firing (time) order, as the sensor emits them; the decoder's blind
    filter applied and, for decoders that stamp each point absolutely
    (`rebase`), offsets rebased to the scan's first."""
    dev, f64 = t_begin.device, torch.float64
    d_body, frac = scan_pattern(rig, f64, dev)
    period = 1.0 / LIDAR_HZ
    B, n_per, n_lines = t_begin.shape[0], rig["per_line"], rig["lines"]
    # one pose per firing instant, as lidar_scan evaluates one per offset
    R, p = pose((t_begin[:, None] + frac[None] * period).reshape(-1))
    dirs = torch.einsum("bkij,klj->bkli", R.reshape(B, n_per, 3, 3), d_body).reshape(-1, 3)
    o = p.reshape(B, n_per, 1, 3).expand(B, n_per, n_lines, 3).reshape(-1, 3)
    tt, _, hit = scene.hit(o, dirs)
    shape = tt.shape
    hit &= torch.rand(shape, generator=gen, dtype=f64, device=dev) >= rig["dropout"]
    r = tt + torch.randn(shape, generator=gen, dtype=f64, device=dev) * rig["range_noise"]
    out = torch.rand(shape, generator=gen, dtype=f64, device=dev) < rig["outlier_frac"]
    short = tt * (0.2 + 0.78 * torch.rand(shape, generator=gen, dtype=f64, device=dev))
    r = torch.where(out, short, r)
    pts_i = d_body.reshape(1, -1, 3) * r.reshape(B, -1, 1)
    Rl = torch.tensor(R_lidar, dtype=f64, device=dev)
    Tl = torch.tensor(T_lidar, dtype=f64, device=dev)
    pts_l = ((pts_i - Tl) @ Rl).to(torch.float32)  # p_L = R^T (p_I - T)
    keep = hit.reshape(B, -1) & (torch.sum(pts_l.to(f64) ** 2, -1) > blind * blind)
    offs = (frac * period).to(torch.float32).repeat_interleave(n_lines)
    # the kept points of the whole batch in one copy, split per scan on
    # the host (views)
    counts = keep.sum(1).cpu().numpy()
    pts_k = pts_l[keep].cpu().numpy()
    offs_k = offs.expand(B, -1)[keep].cpu().numpy()
    cut = np.cumsum(counts)[:-1]
    res = []
    for tb, p, o in zip(t_begin.tolist(), np.split(pts_k, cut), np.split(offs_k, cut)):
        if rebase and len(o):
            tb, o = tb + float(o.min()), (o - o.min()).astype(np.float32)
        res.append((tb, p, o))
    return res


# ------------------------------------------------------------- assembly

def make_recording(deploy: dict, seconds: float, seed: int, device) -> Recording:
    """The deployment's recording of `seconds`, drawn from `seed` on
    `device` in batches, copied to the host, and the device memory freed
    (nothing of the generator stays on the card)."""
    rig, sensor = deploy["rig"], deploy["sensor"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    scene = Scene(device)
    f64 = dict(dtype=torch.float64, device=device)

    t_imu = time.perf_counter()
    imu_t = torch.arange(0.0, seconds, 1.0 / IMU_HZ, **f64)
    gyr, acc = imu_stream(imu_t, gen)
    R_l, T_l, R_ci, P_ci = extrinsics(sensor)
    blind = float(sensor["preprocess"]["blind"])
    rebase = int(sensor["preprocess"]["lidar_type"]) != 1  # Livox: offsets

    t_scans = time.perf_counter()
    starts = np.arange(SCAN_T0, seconds - 1.0 / LIDAR_HZ, 1.0 / LIDAR_HZ)
    all_scans = []
    for i in range(0, len(starts), BATCH_SCANS):
        tb = torch.tensor(starts[i:i + BATCH_SCANS], **f64)
        all_scans += scans(scene, tb, rig, gen, R_l, T_l, blind, rebase)

    t_images = time.perf_counter()
    images = []
    cam_full = camera_model(deploy["camera"], 1.0)
    halves = {1.0: 0, 0.5: 1, 0.25: 2}[round(float(deploy["camera"].get("scale", 1.0)), 2)]
    # An image decimation at ingestion (preprocess.hilti_en keeps 1 in 4):
    # only the kept frames are made.
    stride = rig.get("img_keep_every", 1)
    stamps = np.arange(IMG_T0, seconds, 1.0 / rig["img_hz"])[::stride]
    deg = rig.get("degrade") or {}
    for i in range(0, len(stamps), BATCH_IMAGES):
        t = torch.tensor(stamps[i:i + BATCH_IMAGES], **f64)
        img = render(scene, t, cam_full, R_ci, P_ci)
        if deg:
            img = degrade(img, gen, deg["photon_noise"], deg["read_noise"], deg["blur_px"])
        # to_gray keeps float32; the resize and push_image's clip + uint8
        img = resize_half(img.to(torch.float32), halves)
        u8 = torch.clamp(img, 0, 255).to(torch.uint8).cpu().numpy()
        images += [(float(s), u8[j]) for j, s in enumerate(stamps[i:i + BATCH_IMAGES])]

    t_end = time.perf_counter()
    gt_R, gt_p = pose(torch.tensor(stamps, **f64))
    rec = Recording(imu_t=imu_t.cpu().numpy(), imu_gyr=gyr.cpu().numpy(),
                    imu_acc=acc.cpu().numpy(), scans=all_scans, images=images,
                    gt_t=stamps, gt_R=gt_R.cpu().numpy(), gt_p=gt_p.cpu().numpy(),
                    seconds={"imu_s": t_scans - t_imu, "scans_s": t_images - t_scans,
                             "images_s": t_end - t_images})
    del scene, gen
    return rec

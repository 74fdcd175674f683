"""Camera models: pinhole (radtan distortion) and equidistant fisheye
(port of fast_livo2_tpu/models/camera.py).

Replaces the vikit camera classes the reference links
(vk::PinholeCamera / vk::EquidistantCamera, LIVMapper.cpp:128). Every
projection is a batched function over (..., 3) / (..., 2) tensors. The
model name and the distortion coefficients stay Python values on the
`Camera` tuple, so a branch on them never reads the device.

The `scale` parameter mirrors the reference's half/quarter-resolution
processing (camera yaml `scale`, vio.cpp:49): intrinsics are pre-scaled
here and images are resized by the host reader.
"""

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    model: str  # "pinhole" | "equidistant"
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    # pinhole: radtan (k1, k2, p1, p2); equidistant: (k1, k2, k3, k4)
    d: tuple


def make_camera(cfg) -> Camera:
    """Build from utils.config.CameraConfig, applying `scale`."""
    s = cfg.scale if cfg.scale > 0 else 1.0
    model = cfg.cam_model.lower()
    if model.startswith("equi") or model.startswith("fish"):
        d = (cfg.k1, cfg.k2, cfg.k3, cfg.k4)
        model = "equidistant"
    else:
        d = (cfg.cam_d0, cfg.cam_d1, cfg.cam_d2, cfg.cam_d3)
        model = "pinhole"
    return Camera(
        model=model,
        width=int(round(cfg.cam_width * s)),
        height=int(round(cfg.cam_height * s)),
        fx=cfg.cam_fx * s,
        fy=cfg.cam_fy * s,
        cx=cfg.cam_cx * s,
        cy=cfg.cam_cy * s,
        d=tuple(float(x) for x in d),
    )


def has_distortion(cam: Camera) -> bool:
    return any(abs(x) > 1e-12 for x in cam.d)


def world2cam(cam: Camera, pts_c: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D point (..., 3) -> pixel (..., 2)."""
    x, y, z = pts_c[..., 0], pts_c[..., 1], pts_c[..., 2]
    z = torch.where(z.abs() < 1e-9, 1e-9, z)
    if cam.model == "pinhole":
        u = x / z
        v = y / z
        if has_distortion(cam):
            k1, k2, p1, p2 = cam.d
            r2 = u * u + v * v
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            ud = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
            vd = v * radial + p1 * (r2 + 2 * v * v) + 2 * p2 * u * v
            u, v = ud, vd
    else:  # equidistant
        k1, k2, k3, k4 = cam.d
        r = torch.sqrt(x * x + y * y)
        r = torch.where(r < 1e-9, 1e-9, r)
        theta = torch.atan2(r, z)
        t2 = theta * theta
        theta_d = theta * (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
        u = theta_d * x / r
        v = theta_d * y / r
    return torch.stack([cam.fx * u + cam.cx, cam.fy * v + cam.cy], dim=-1)


def cam2world(cam: Camera, px: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Pixel (..., 2) -> unit-norm bearing (..., 3). Distortion is
    inverted by `iters` fixed-point iterations."""
    u = (px[..., 0] - cam.cx) / cam.fx
    v = (px[..., 1] - cam.cy) / cam.fy
    if cam.model == "pinhole":
        if has_distortion(cam):
            k1, k2, p1, p2 = cam.d
            ud, vd = u, v
            for _ in range(iters):
                r2 = u * u + v * v
                radial = 1.0 + k1 * r2 + k2 * r2 * r2
                du = 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
                dv = p1 * (r2 + 2 * v * v) + 2 * p2 * u * v
                u = (ud - du) / radial
                v = (vd - dv) / radial
        f = torch.stack([u, v, torch.ones_like(u)], dim=-1)
    else:
        k1, k2, k3, k4 = cam.d
        theta_d = torch.sqrt(u * u + v * v)
        theta = theta_d
        for _ in range(iters):
            t2 = theta * theta
            theta = theta_d / (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
        scale = torch.where(theta_d < 1e-9, 1.0, torch.tan(theta) / theta_d)
        f = torch.stack([u * scale, v * scale, torch.ones_like(u)], dim=-1)
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


def in_frame(cam: Camera, px: torch.Tensor, border: int) -> torch.Tensor:
    """vk::AbstractCamera::isInFrame with a pixel border."""
    return (
        (px[..., 0] >= border)
        & (px[..., 0] < cam.width - border)
        & (px[..., 1] >= border)
        & (px[..., 1] < cam.height - border)
    )


def projection_jacobian(cam: Camera, pts_c: torch.Tensor) -> torch.Tensor:
    """d px / d p_cam (..., 2, 3) for the undistorted pinhole part
    (reference computeProjectionJacobian, vio.cpp:189-201, which ignores
    distortion: patches are small)."""
    x, y, z = pts_c[..., 0], pts_c[..., 1], pts_c[..., 2]
    zi = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row0 = torch.stack([cam.fx * zi, zero, -cam.fx * x * zi2], dim=-1)
    row1 = torch.stack([zero, cam.fy * zi, -cam.fy * y * zi2], dim=-1)
    return torch.stack([row0, row1], dim=-2)

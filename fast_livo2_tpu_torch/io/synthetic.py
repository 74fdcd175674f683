"""Synthetic LIVO sequence generator (host-side numpy).

Stands in for the reference's rosbag replay datasets (SURVEY.md §4:
verification there is dataset replay + trajectory ATE; no bags ship with
this environment). Generates a textured box room, an analytic smooth
trajectory through it, and exact sensor streams:

- IMU: exact angular rate / specific force from the trajectory derivative
  (finite differences at high rate), plus bias + white noise;
- LiDAR: ray-plane intersections from poses interpolated *within* each
  scan (so motion distortion is real and undistortion is exercised), with
  range noise;
- Camera: ray-traced plane intersections shaded by a smooth procedural
  texture, with per-frame exposure variation if requested.

Ground-truth poses come back alongside for ATE computation.

The PyTorch port's own copy of fast_livo2_tpu/io/synthetic.py: the
generators are identical (same seed -> same arrays); `render_image`
casts its rays through the port's camera model (models/camera.py).
"""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import camera as cam_mod


@dataclass
class Plane:
    point: np.ndarray  # a point on the plane
    normal: np.ndarray  # unit normal (pointing into the room)
    u_axis: np.ndarray  # texture axes
    v_axis: np.ndarray
    tex_seed: int = 0
    hf_amp: float = 0.0  # high-frequency texture octaves (A/B imaging)
    # Finite extents along u_axis/v_axis (None = infinite). Bounded
    # rectangles compose boxes/ramps for the hard (non-planar, occluded)
    # benchmark scene.
    u_extent: Optional[Tuple[float, float]] = None
    v_extent: Optional[Tuple[float, float]] = None

    def intersect(self, origins: np.ndarray, dirs: np.ndarray):
        """Ray hit distances (inf where missed). Front-face only."""
        denom = dirs @ self.normal
        num = (self.point - origins) @ self.normal
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num / denom
        ok = (denom < -1e-9) & (t > 0.05)
        if self.u_extent is not None or self.v_extent is not None:
            t_safe = np.where(ok, t, 0.0)
            rel = origins + dirs * t_safe[:, None] - self.point
            if self.u_extent is not None:
                u = rel @ self.u_axis
                ok &= (u >= self.u_extent[0]) & (u <= self.u_extent[1])
            if self.v_extent is not None:
                v = rel @ self.v_axis
                ok &= (v >= self.v_extent[0]) & (v <= self.v_extent[1])
        return np.where(ok, t, np.inf)

    def shade(self, pts: np.ndarray) -> np.ndarray:
        rel = pts - self.point
        return texture(rel @ self.u_axis, rel @ self.v_axis, self.tex_seed,
                       hf_amp=self.hf_amp)


@dataclass
class Cylinder:
    """Finite vertical-axis cylinder (curved shell only): the canonical
    non-planar clutter primitive — its voxels never fit one plane, which
    exercises the octree-layer subdivision the planar room cannot."""

    center: np.ndarray  # base center
    axis: np.ndarray  # unit axis
    radius: float
    height: float
    tex_seed: int = 0
    hf_amp: float = 0.0

    def intersect(self, origins: np.ndarray, dirs: np.ndarray):
        a_ = self.axis
        oc = origins - self.center
        d_perp = dirs - np.outer(dirs @ a_, a_)
        o_perp = oc - np.outer(oc @ a_, a_)
        A = np.sum(d_perp * d_perp, axis=-1)
        B = 2 * np.sum(o_perp * d_perp, axis=-1)
        C = np.sum(o_perp * o_perp, axis=-1) - self.radius**2
        disc = B * B - 4 * A * C
        with np.errstate(divide="ignore", invalid="ignore"):
            sq = np.sqrt(np.maximum(disc, 0.0))
            t0 = (-B - sq) / (2 * A)
            t1 = (-B + sq) / (2 * A)
        t = np.where(t0 > 0.05, t0, t1)  # nearest entering hit (outside view)
        h = (oc + dirs * t[:, None]) @ a_
        ok = (disc > 0) & (A > 1e-12) & (t > 0.05) & (h >= 0) & (h <= self.height)
        return np.where(ok, t, np.inf)

    def shade(self, pts: np.ndarray) -> np.ndarray:
        a_ = self.axis
        rel = pts - self.center
        h = rel @ a_
        r = rel - np.outer(h, a_)
        # texture by unrolled surface coords (arc length, height)
        ref = np.array([1.0, 0.0, 0.0])
        ref = ref - (ref @ a_) * a_
        ref /= np.linalg.norm(ref)
        ref2 = np.cross(a_, ref)
        th = np.arctan2(r @ ref2, r @ ref)
        return texture(th * self.radius, h, self.tex_seed,
                       hf_amp=self.hf_amp)


def make_box(center, size, tex_seed=10) -> List[Plane]:
    """Axis-aligned box as 6 outward-facing bounded rectangles."""
    cx, cy, cz = center
    hx, hy, hz = np.asarray(size) / 2.0
    e = np.eye(3)
    out = []
    for k, (ax, h_ax) in enumerate(((0, hx), (1, hy), (2, hz))):
        u, v = e[(ax + 1) % 3], e[(ax + 2) % 3]
        hu = (hy, hz, hx)[ax]
        hv = (hz, hx, hy)[ax]
        for sgn in (1.0, -1.0):
            p = np.array(center) + sgn * h_ax * e[ax]
            out.append(Plane(p, sgn * e[ax], u, v, tex_seed + k * 2 + (sgn < 0),
                             u_extent=(-hu, hu), v_extent=(-hv, hv)))
    return out


def make_ramp(base_center, width, length, height, yaw=0.0, tex_seed=20) -> Plane:
    """Inclined rectangle rising along its local +x over `length`."""
    Rz = _rotz(yaw)
    slope = np.array([length, 0.0, height])
    slope = slope / np.linalg.norm(slope)
    u = Rz @ slope
    v = Rz @ np.array([0.0, 1.0, 0.0])
    n = np.cross(u, v)
    n = n / np.linalg.norm(n)
    if n[2] < 0:
        n = -n
    L = np.hypot(length, height)
    return Plane(np.asarray(base_center, float), n, u, v, tex_seed,
                 u_extent=(0.0, L), v_extent=(-width / 2, width / 2))


def default_room(half: float = 6.0, height: float = 3.0) -> List[Plane]:
    z0, z1 = -1.5, height - 1.5
    e = np.eye(3)
    return [
        Plane(np.array([0, 0, z0]), e[2], e[0], e[1], 1),     # floor
        Plane(np.array([0, 0, z1]), -e[2], e[0], e[1], 2),    # ceiling
        Plane(np.array([half, 0, 0]), -e[0], e[1], e[2], 3),  # +x wall
        Plane(np.array([-half, 0, 0]), e[0], e[1], e[2], 4),  # -x wall
        Plane(np.array([0, half, 0]), -e[1], e[0], e[2], 5),  # +y wall
        Plane(np.array([0, -half, 0]), e[1], e[0], e[2], 6),  # -y wall
    ]


def hard_scene(half: float = 6.0, height: float = 3.0):
    """Hard benchmark scene (round-2 accuracy gate): the planar room plus
    non-planar clutter — boxes (occluders → depth discontinuities at
    their silhouettes), cylinders (voxels that never fit one plane →
    octree subdivision), and a ramp (oblique plane). A planar box room is
    the best case for a plane-matching LIO; this scene is built to
    discriminate (VERDICT round 1, item 1b)."""
    s = default_room(half, height)
    z0 = -1.5
    s += make_box((2.6, 1.6, z0 + 0.6), (1.2, 1.0, 1.2), tex_seed=30)
    s += make_box((-2.2, -2.6, z0 + 0.5), (1.6, 0.8, 1.0), tex_seed=40)
    s += make_box((0.5, -3.6, z0 + 0.75), (0.8, 0.8, 1.5), tex_seed=50)
    up = np.array([0.0, 0.0, 1.0])
    s.append(Cylinder(np.array([3.6, -2.0, z0]), up, 0.45, height, 60))
    s.append(Cylinder(np.array([-3.0, 2.6, z0]), up, 0.60, height, 61))
    s.append(Cylinder(np.array([1.0, 4.0, z0]), up, 0.35, height, 62))
    s.append(make_ramp((-1.0, 0.6, z0), width=1.5, length=2.5, height=1.0,
                       yaw=2.0, tex_seed=70))
    return s


def hard_trajectory() -> "Trajectory":
    """Aggressive motion for the hard benchmark: ~3.5 m/s peak velocity,
    ~8 m/s² peak acceleration, fast yaw sweep with 0.15 rad roll/pitch
    oscillation — far beyond the handheld pace of the reference's
    datasets."""
    return Trajectory(
        pos_amp=np.array([1.6, 1.4, 0.35]),
        pos_freq=np.array([0.35, 0.28, 0.5]),
        yaw_rate=0.6,
        rp_amp=0.15,
    )


def wall_with_opening(p0, u_axis, v_axis, normal, u_range, v_range,
                      door_u, door_top, tex_seed=0) -> List[Plane]:
    """A wall rectangle with a door hole, composed of 3 bounded
    rectangles (left-of-door, right-of-door, above-door). `p0` is the
    wall's reference point; u is along-wall, v is up."""
    u0, u1 = u_range
    v0, v1 = v_range
    du0, du1 = door_u
    out = []
    if du0 > u0:
        out.append(Plane(np.asarray(p0, float), np.asarray(normal, float),
                         np.asarray(u_axis, float), np.asarray(v_axis, float),
                         tex_seed, u_extent=(u0, du0), v_extent=(v0, v1)))
    if u1 > du1:
        out.append(Plane(np.asarray(p0, float), np.asarray(normal, float),
                         np.asarray(u_axis, float), np.asarray(v_axis, float),
                         tex_seed + 1, u_extent=(du1, u1), v_extent=(v0, v1)))
    if v1 > door_top:
        out.append(Plane(np.asarray(p0, float), np.asarray(normal, float),
                         np.asarray(u_axis, float), np.asarray(v_axis, float),
                         tex_seed + 2, u_extent=(du0, du1),
                         v_extent=(door_top, v1)))
    return out


class WaypointTrajectory:
    """C² trajectory through waypoints: natural cubic splines for x/y/z
    (knot times proportional to segment length → roughly constant speed)
    plus a splined heading with a small sinusoidal dither, and a small
    roll/pitch oscillation. The minutes-scale benchmark worlds
    (multi-room + corridor + revisits, outdoor sweeps) need paths a
    global sinusoid cannot express."""

    def __init__(self, waypoints, duration: float, yaw_dither: float = 0.15,
                 rp_amp: float = 0.05, headings=None):
        wp = np.asarray(waypoints, float)
        assert len(wp) >= 3
        seg = np.linalg.norm(np.diff(wp, axis=0), axis=-1)
        cum = np.concatenate([[0.0], np.cumsum(seg)])
        self.length = float(cum[-1])
        self.knots = cum / cum[-1] * duration
        self.duration = duration
        self.wp = wp
        self.yaw_dither = yaw_dither
        self.rp_amp = rp_amp
        self._coefs = [self._spline(self.knots, wp[:, k]) for k in range(3)]
        if headings is None:
            # heading at knot i = incoming segment direction (splined ->
            # smooth yaw through corners)
            d = np.diff(wp[:, :2], axis=0)
            seg_yaw = np.arctan2(d[:, 1], d[:, 0])
            headings = np.unwrap(np.concatenate([[seg_yaw[0]], seg_yaw]))
        else:
            headings = np.unwrap(np.asarray(headings, float))
        self._yaw_coefs = self._spline(self.knots, headings)

    @staticmethod
    def _spline(t, y):
        """Natural cubic spline second derivatives (tridiagonal solve).
        Returns (t, y, M) for evaluation."""
        n = len(t)
        h = np.diff(t)
        h = np.where(h <= 0, 1e-9, h)
        A = np.zeros((n, n))
        b = np.zeros(n)
        A[0, 0] = A[-1, -1] = 1.0
        for i in range(1, n - 1):
            A[i, i - 1] = h[i - 1]
            A[i, i] = 2 * (h[i - 1] + h[i])
            A[i, i + 1] = h[i]
            b[i] = 6 * ((y[i + 1] - y[i]) / h[i] - (y[i] - y[i - 1]) / h[i - 1])
        M = np.linalg.solve(A, b)
        return t, y, M

    @staticmethod
    def _eval(coefs, t):
        tk, y, M = coefs
        t = np.clip(t, tk[0], tk[-1])
        i = int(np.clip(np.searchsorted(tk, t) - 1, 0, len(tk) - 2))
        h = max(tk[i + 1] - tk[i], 1e-9)
        a = (tk[i + 1] - t) / h
        b = (t - tk[i]) / h
        return (a * y[i] + b * y[i + 1]
                + ((a**3 - a) * M[i] + (b**3 - b) * M[i + 1]) * h * h / 6.0)

    def pose(self, t: float):
        p = np.array([self._eval(c, t) for c in self._coefs])
        yaw = (self._eval(self._yaw_coefs, t)
               + self.yaw_dither * np.sin(0.9 * t))
        roll = self.rp_amp * np.sin(1.1 * t)
        pitch = self.rp_amp * np.sin(0.9 * t + 1.0)
        R = _rotz(yaw) @ _exp(np.array([roll, pitch, 0.0]))
        return R, p

    def vel(self, t: float, eps=1e-4):
        _, p0 = self.pose(t - eps)
        _, p1 = self.pose(t + eps)
        return (p1 - p0) / (2 * eps)


def long_indoor_scene(tex_seed=100):
    """Minutes-scale indoor world (VERDICT r2 item 1): Room A (12x12 m,
    cluttered) — 20 m near-degenerate corridor (2 m wide, sparse clutter)
    — Room B (12x12 m, cluttered). One floor and ceiling span the world;
    the rooms open into the corridor through door holes. Revisit-friendly:
    the benchmark path loops A→B→A."""
    e = np.eye(3)
    z0, z1 = -1.5, 1.5
    s: List = [
        # floor + ceiling spanning rooms and corridor
        Plane(np.array([16.0, 0.0, z0]), e[2], e[0], e[1], tex_seed,
              u_extent=(-22.0, 22.0), v_extent=(-6.0, 6.0)),
        Plane(np.array([16.0, 0.0, z1]), -e[2], e[0], e[1], tex_seed + 1,
              u_extent=(-22.0, 22.0), v_extent=(-6.0, 6.0)),
    ]
    door = (-1.0, 1.0)  # door y-range in both connecting walls
    top = 1.2
    # Room A: x in [-6, 6], y in [-6, 6]
    s.append(Plane(np.array([-6.0, 0, 0]), e[0], e[1], e[2], tex_seed + 2,
                   u_extent=(-6, 6), v_extent=(z0, z1)))  # west
    s.append(Plane(np.array([0.0, 6.0, 0]), -e[1], e[0], e[2], tex_seed + 3,
                   u_extent=(-6, 6), v_extent=(z0, z1)))  # north
    s.append(Plane(np.array([0.0, -6.0, 0]), e[1], e[0], e[2], tex_seed + 4,
                   u_extent=(-6, 6), v_extent=(z0, z1)))  # south
    # east wall with door to corridor
    s += wall_with_opening(np.array([6.0, 0, 0]), e[1], e[2], -e[0],
                           (-6, 6), (z0, z1), door, top, tex_seed + 5)
    # Corridor: x in [6, 26], walls at y = +-1
    s.append(Plane(np.array([16.0, 1.0, 0]), -e[1], e[0], e[2], tex_seed + 10,
                   u_extent=(-10, 10), v_extent=(z0, z1)))
    s.append(Plane(np.array([16.0, -1.0, 0]), e[1], e[0], e[2], tex_seed + 11,
                   u_extent=(-10, 10), v_extent=(z0, z1)))
    # sparse corridor clutter (keeps it NEAR-degenerate, not fully)
    s += make_box((11.0, 0.75, z0 + 0.25), (0.5, 0.4, 0.5), tex_seed + 12)
    s += make_box((20.0, -0.75, z0 + 0.3), (0.6, 0.4, 0.6), tex_seed + 13)
    # Room B: x in [26, 38], y in [-6, 6]
    s += wall_with_opening(np.array([26.0, 0, 0]), e[1], e[2], e[0],
                           (-6, 6), (z0, z1), door, top, tex_seed + 20)
    s.append(Plane(np.array([38.0, 0, 0]), -e[0], e[1], e[2], tex_seed + 21,
                   u_extent=(-6, 6), v_extent=(z0, z1)))
    s.append(Plane(np.array([32.0, 6.0, 0]), -e[1], e[0], e[2], tex_seed + 22,
                   u_extent=(-6, 6), v_extent=(z0, z1)))
    s.append(Plane(np.array([32.0, -6.0, 0]), e[1], e[0], e[2], tex_seed + 23,
                   u_extent=(-6, 6), v_extent=(z0, z1)))
    # clutter
    up = e[2]
    s += make_box((3.0, 3.2, z0 + 0.6), (1.2, 1.0, 1.2), tex_seed + 30)
    s += make_box((-3.0, -3.0, z0 + 0.5), (1.6, 0.8, 1.0), tex_seed + 31)
    s.append(Cylinder(np.array([-4.7, 4.7, z0]), up, 0.5, 3.0, tex_seed + 32))
    s += make_box((30.0, 3.4, z0 + 0.5), (1.0, 1.2, 1.0), tex_seed + 33)
    s += make_box((34.5, -3.2, z0 + 0.5), (1.4, 0.9, 1.0), tex_seed + 34)
    s.append(Cylinder(np.array([31.5, -5.0, z0]), up, 0.45, 3.0, tex_seed + 35))
    s.append(make_ramp((31.0, 1.0, z0), width=1.4, length=2.2, height=0.9,
                       yaw=1.2, tex_seed=tex_seed + 36))
    return s


def long_indoor_waypoints(loops: int = 1):
    """A->corridor->B->loop B->corridor->A->loop A (revisit), repeated
    `loops` times. ~115 m per loop."""
    roomA = [(-3.5, -3.5), (-3.5, 3.8), (3.6, 4.0), (4.2, -3.8), (0.0, -2.0)]
    roomB = [(29.0, -3.8), (35.5, -3.5), (35.8, 3.6), (28.8, 3.8)]
    path = [(0.0, 0.0)]
    for _ in range(loops):
        path += [(3.0, 0.0), (8.0, 0.0), (16.0, 0.0), (24.0, 0.0),
                 (28.0, 0.0)]
        path += roomB
        path += [(28.0, 0.0), (24.0, 0.3), (16.0, -0.3), (8.0, 0.0),
                 (3.0, 0.0)]
        path += roomA
        path += [(0.0, 0.0)]
    return np.array([[x, y, 0.15 * np.sin(0.7 * i)]
                     for i, (x, y) in enumerate(path)])


def long_outdoor_scene(seed=5, n_buildings=24, extent=260.0, half_width=45.0):
    """MARS-LVIG-style outdoor world: a ground plane with large box
    'buildings' scattered along a flight lane. Scale fits the 2 m voxel
    + map-sliding configuration (config/MARS_LVIG.yaml)."""
    rng = np.random.default_rng(seed)
    e = np.eye(3)
    s: List = [Plane(np.array([extent / 2, 0.0, 0.0]), e[2], e[0], e[1], 900,
                     u_extent=(-extent / 2 - 40, extent / 2 + 40),
                     v_extent=(-half_width - 20, half_width + 20))]
    for i in range(n_buildings):
        x = rng.uniform(5.0, extent - 5.0)
        y = rng.uniform(-half_width, half_width)
        if abs(y) < 6.0:  # keep the flight lane clear
            y = np.sign(y or 1.0) * rng.uniform(8.0, half_width)
        w = rng.uniform(6.0, 14.0)
        d = rng.uniform(6.0, 14.0)
        h = rng.uniform(6.0, 18.0)
        s += make_box((x, y, h / 2), (w, d, h), tex_seed=910 + 7 * i)
    return s


def long_outdoor_waypoints(extent=260.0, alt=8.0):
    """S-curve flight along the lane at ~constant altitude."""
    xs = np.linspace(0.0, extent - 40.0, 12)
    ys = 4.0 * np.sin(np.linspace(0, 3.0 * np.pi, 12))
    zs = alt + 1.5 * np.sin(np.linspace(0, 2.0 * np.pi, 12))
    return np.stack([xs, ys, zs], axis=-1)


def texture(u: np.ndarray, v: np.ndarray, seed: int,
            hf_amp: float = 0.0) -> np.ndarray:
    """Smooth procedural intensity in [30, 225]; band-limited so bilinear
    sampling and image gradients behave like a natural image.

    hf_amp > 0 adds high-frequency octaves (5-25 cycles/unit ≈ 3-20 px
    period at typical viewing distance) — aliasing-prone content for the
    strided-vs-pyramid sampling A/B (VERDICT r3 item 3)."""
    rng = np.random.default_rng(seed)
    val = np.zeros_like(u)
    for k in range(6):
        fu, fv = rng.uniform(0.3, 3.0, 2)
        ph_u, ph_v = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(0.3, 1.0)
        val = val + amp * np.sin(fu * u * 2 * np.pi + ph_u) * np.sin(fv * v * 2 * np.pi + ph_v)
    out = 128.0 + 40.0 * val / 2.2
    if hf_amp > 0.0:
        hf = np.zeros_like(u)
        for k in range(4):
            fu, fv = rng.uniform(5.0, 25.0, 2)
            ph_u, ph_v = rng.uniform(0, 2 * np.pi, 2)
            hf = hf + np.sin(fu * u * 2 * np.pi + ph_u) * np.sin(
                fv * v * 2 * np.pi + ph_v)
        out = out + hf_amp * 10.0 * hf
    return out


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _exp(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * (K @ K)


@dataclass
class Trajectory:
    """Smooth analytic trajectory: sinusoidal translation + yaw sweep with
    small roll/pitch oscillation."""

    pos_amp: np.ndarray = field(default_factory=lambda: np.array([1.5, 1.2, 0.3]))
    pos_freq: np.ndarray = field(default_factory=lambda: np.array([0.25, 0.17, 0.4]))
    yaw_rate: float = 0.25  # rad/s mean yaw sweep
    rp_amp: float = 0.06

    def pose(self, t: float):
        w = 2 * np.pi * self.pos_freq
        p = self.pos_amp * np.sin(w * t)
        yaw = self.yaw_rate * t + 0.2 * np.sin(0.7 * t)
        roll = self.rp_amp * np.sin(1.1 * t)
        pitch = self.rp_amp * np.sin(0.9 * t + 1.0)
        R = _rotz(yaw) @ _exp(np.array([roll, pitch, 0.0]))
        return R, p

    def vel(self, t: float, eps=1e-4):
        _, p0 = self.pose(t - eps)
        _, p1 = self.pose(t + eps)
        return (p1 - p0) / (2 * eps)


GRAVITY = 9.81


def imu_stream(traj: Trajectory, t0: float, t1: float, hz: float, rng,
               gyr_noise=1e-3, acc_noise=1e-2, bias_g=None, bias_a=None):
    """Exact IMU from trajectory finite differences (body frame)."""
    bias_g = np.zeros(3) if bias_g is None else bias_g
    bias_a = np.zeros(3) if bias_a is None else bias_a
    stamps = np.arange(t0, t1, 1.0 / hz)
    eps = 1e-4
    gyr, acc = [], []
    g_w = np.array([0, 0, -GRAVITY])
    for t in stamps:
        R, _ = self_pose = traj.pose(t)
        Rm, _ = traj.pose(t - eps)
        Rp, _ = traj.pose(t + eps)
        dR = R.T @ (Rp - Rm) / (2 * eps)  # R^T Ṙ = [w]_x
        w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2
        a_w = (traj.vel(t + eps) - traj.vel(t - eps)) / (2 * eps)
        f_b = R.T @ (a_w - g_w)
        gyr.append(w + bias_g + rng.normal(size=3) * gyr_noise)
        acc.append(f_b + bias_a + rng.normal(size=3) * acc_noise)
    return stamps, np.array(gyr), np.array(acc)


def _bounding_sphere(s):
    """(center, radius) of a surface, or None if unbounded."""
    if isinstance(s, Cylinder):
        c = s.center + s.axis * (s.height / 2.0)
        return c, float(np.hypot(s.height / 2.0, s.radius))
    if isinstance(s, Plane):
        if s.u_extent is None or s.v_extent is None:
            return None
        mu = 0.5 * (s.u_extent[0] + s.u_extent[1])
        mv = 0.5 * (s.v_extent[0] + s.v_extent[1])
        c = s.point + mu * s.u_axis + mv * s.v_axis
        r = float(np.hypot((s.u_extent[1] - s.u_extent[0]) / 2,
                           (s.v_extent[1] - s.v_extent[0]) / 2))
        return c, r
    return None


def cull_surfaces(surfaces, origin, max_range):
    """Drop surfaces whose bounding sphere lies beyond max_range of the
    origin (generation-speed aid for the minutes-scale worlds: a frame
    only intersects nearby geometry). Unbounded surfaces are kept."""
    out = []
    for s in surfaces:
        bs = _bounding_sphere(s)
        if bs is None or np.linalg.norm(bs[0] - origin) - bs[1] <= max_range:
            out.append(s)
    return out


def ray_hits(origins: np.ndarray, dirs: np.ndarray, surfaces):
    """Nearest positive ray-surface hit. origins/dirs (N, 3). Returns
    (t (N,), surface_idx (N,), hit mask). Surfaces expose
    intersect(origins, dirs) -> t (inf = miss); nearest-hit selection
    gives occlusion for free."""
    n = origins.shape[0]
    best_t = np.full(n, np.inf)
    best_i = np.full(n, -1, np.int32)
    for i, s in enumerate(surfaces):
        t = s.intersect(origins, dirs)
        ok = t < best_t
        best_t = np.where(ok, t, best_t)
        best_i = np.where(ok, i, best_i)
    hit = best_i >= 0
    return np.where(hit, best_t, 0.0), best_i, hit


def lidar_scan(traj: Trajectory, planes, t_begin: float, period: float,
               n_lines: int, n_per_line: int, rng, range_noise=0.01,
               fov_deg=70.0, max_range=None, dropout=0.0,
               outlier_frac=0.0):
    """One motion-distorted scan: ray directions sweep azimuth over the
    scan period from poses at each point's own timestamp. Returns
    (points_body (N, 3), t_offs (N,) seconds from t_begin). `max_range`
    drops hits beyond the sensor range (and culls far surfaces — the
    minutes-scale outdoor worlds have ~150 surfaces of which a frame
    sees a handful)."""
    n = n_lines * n_per_line
    frac = np.tile(np.linspace(0, 1, n_per_line, endpoint=False), n_lines)
    az = (frac - 0.5) * np.deg2rad(fov_deg)
    el = np.repeat(np.linspace(-0.35, 0.35, n_lines), n_per_line)
    d_body = np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1
    )
    t_offs = frac * period
    if max_range is not None:
        _, p0 = traj.pose(t_begin)
        planes = cull_surfaces(planes, p0, max_range + 10.0)
    # Per-point poses (one pose eval per unique offset), then ONE
    # vectorized intersection over all rays x surfaces — the per-offset
    # chunk loop was O(n_per_line * n_surfaces) numpy calls per scan,
    # minutes per 600-frame world.
    uniq, inv = np.unique(t_offs, return_inverse=True)
    Rs = np.empty((len(uniq), 3, 3))
    ps = np.empty((len(uniq), 3))
    for i, f in enumerate(uniq):
        Rs[i], ps[i] = traj.pose(t_begin + f)
    origins = ps[inv]
    dirs = np.einsum("nij,nj->ni", Rs[inv], d_body)
    t, pi, hit = ray_hits(origins, dirs, planes)
    if max_range is not None:
        hit &= t <= max_range
    if dropout > 0.0:
        # No-return dropout (dark/specular surfaces, sun glare): drops
        # a random fraction of hits — VERDICT r4 item 2's LiDAR realism.
        hit &= rng.random(size=hit.shape) >= dropout
    r = t + rng.normal(size=t.shape) * range_noise
    if outlier_frac > 0.0:
        # Off-plane clutter returns (dust / multipath): a small fraction
        # of ranges land uniformly short of the true surface.
        out = rng.random(size=r.shape) < outlier_frac
        r = np.where(out, t * rng.uniform(0.2, 0.98, size=r.shape), r)
    pts_body = d_body * r[:, None]
    return pts_body[hit].astype(np.float32), t_offs[hit].astype(np.float32)


def degrade_image(img: np.ndarray, rng, photon_noise: float = 0.0,
                  read_noise: float = 0.0, blur_px: float = 0.0):
    """Sensor-realistic degradation (VERDICT r3 item 3): slight optical
    blur, signal-dependent photon (shot) noise — Gaussian approximation
    of Poisson, sigma = sqrt(I * photon_noise) — and additive Gaussian
    read noise. Applied in DN units on the [0, 255] render."""
    out = img.astype(np.float64)
    if blur_px > 0.0:
        r = max(1, int(np.ceil(2.0 * blur_px)))
        x = np.arange(-r, r + 1)
        k = np.exp(-0.5 * (x / blur_px) ** 2)
        k /= k.sum()
        pad = np.pad(out, ((r, r), (0, 0)), mode="edge")
        out = sum(k[i] * pad[i:i + out.shape[0]] for i in range(2 * r + 1))
        pad = np.pad(out, ((0, 0), (r, r)), mode="edge")
        out = sum(k[i] * pad[:, i:i + out.shape[1]] for i in range(2 * r + 1))
    if photon_noise > 0.0:
        out = out + rng.standard_normal(out.shape) * np.sqrt(
            np.maximum(out, 0.0) * photon_noise)
    if read_noise > 0.0:
        out = out + rng.standard_normal(out.shape) * read_noise
    return np.clip(out, 0, 255).astype(np.float32)


def render_image(traj: Trajectory, planes, t: float, cam, exposure: float = 1.0,
                 R_ci=None, P_ci=None, cull_range=None):
    """Ray-traced grayscale image (H, W) float32 from the camera pose at
    time t (camera extrinsics R_ci/P_ci: x_cam = R_ci x_imu + P_ci)."""
    R_ci = np.eye(3) if R_ci is None else R_ci
    P_ci = np.zeros(3) if P_ci is None else P_ci
    R_wi, p_wi = traj.pose(t)
    # camera-from-world: x_c = R_ci (R_wi^T (x_w - p)) + P_ci
    R_cw = R_ci @ R_wi.T
    t_cw = -R_cw @ p_wi + P_ci
    R_wc = R_cw.T
    cam_origin = -R_wc @ t_cw
    if cull_range is not None:  # generation-speed aid for big worlds;
        # None (default) renders everything: the camera has no range
        planes = cull_surfaces(planes, cam_origin, cull_range)

    # Per-pixel ray directions through the camera model (pinhole with
    # distortion, or equidistant fisheye), in float32 as the JAX
    # package computes them, so sequences render through the same model
    # the VIO projects with.
    ys, xs = np.meshgrid(np.arange(cam.height), np.arange(cam.width), indexing="ij")
    px = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)
    d_cam = cam_mod.cam2world(cam, torch.from_numpy(px)).numpy().astype(np.float64)
    d_w = d_cam @ R_wc.T
    o = np.broadcast_to(cam_origin, d_w.shape)
    tt, pi, hit = ray_hits(o, d_w, planes)
    pw = o + d_w * tt[:, None]
    img = np.full(d_w.shape[0], 90.0)
    for i, pl in enumerate(planes):
        m = hit & (pi == i)
        if not m.any():
            continue
        img[m] = pl.shade(pw[m])
    img = img * exposure
    return np.clip(img, 0, 255).reshape(cam.height, cam.width).astype(np.float32)


@dataclass
class SyntheticSequence:
    imu_stamps: np.ndarray
    imu_gyr: np.ndarray
    imu_acc: np.ndarray
    scans: List[Tuple[float, np.ndarray, np.ndarray]]  # (t_begin, pts, offs)
    images: List[Tuple[float, np.ndarray]]  # (t, img)
    gt: List[Tuple[float, np.ndarray, np.ndarray]]  # (t, R, p)


# Forward-looking camera mount (camera z = body x, x = -body y,
# y = -body z), the standard optical-frame convention the avia config's
# Rcl approximates (config/avia.yaml Rcl).
R_CI_FORWARD = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


def make_sequence(duration=5.0, lidar_hz=10.0, img_hz=10.0, imu_hz=200.0,
                  cam=None, seed=0, n_lines=16, n_per_line=800,
                  still_time=0.6, planes=None, traj=None,
                  render=True, fov_deg=70.0, R_ci=None,
                  P_ci=None, exposure_fn=None,
                  max_range=None, gyr_noise=1e-3, acc_noise=1e-2,
                  bias_g=None, bias_a=None,
                  range_noise=0.01, img_photon_noise=0.0,
                  img_read_noise=0.0, img_blur_px=0.0,
                  lidar_dropout=0.0, lidar_outlier_frac=0.0) -> SyntheticSequence:
    """Build a full synthetic LIVO sequence. The first `still_time`
    seconds are stationary for IMU static initialization (the reference
    requires imu_int_frame frames of static data, IMU_Processing.cpp:104).
    `bias_g`/`bias_a`: constant IMU biases (3,) — the minutes-scale
    benchmarks set realistic ones so the 19-dim state's bias blocks are
    actually exercised over the run."""
    rng = np.random.default_rng(seed)
    planes = default_room() if planes is None else planes
    traj = Trajectory() if traj is None else traj

    class _Shifted:
        """Trajectory re-parameterized by a C¹ time warp: frozen before
        `still_time`, then a quadratic ramp into unit time rate (so
        velocity is continuous at motion onset — a hard jump would be an
        unbounded acceleration spike that no IMU stream can represent)."""

        RAMP = 1.0

        def _warp(self, t):
            dt = t - still_time
            if dt <= 0:
                return 0.0
            if dt < self.RAMP:
                return dt * dt / (2 * self.RAMP)
            return dt - self.RAMP / 2

        def pose(self, t):
            return traj.pose(self._warp(t))

        def vel(self, t, eps=1e-4):
            _, p0 = self.pose(t - eps)
            _, p1 = self.pose(t + eps)
            return (p1 - p0) / (2 * eps)

    sh = _Shifted()
    stamps, gyr, acc = imu_stream(sh, 0.0, duration, imu_hz, rng,
                                  gyr_noise=gyr_noise, acc_noise=acc_noise,
                                  bias_g=bias_g, bias_a=bias_a)
    # The reference scales raw acc by G/|mean_acc| — emit acc in m/s^2 so
    # mean_acc_norm ≈ G and the scaling is identity.

    scans = []
    t = 0.05
    while t + 1.0 / lidar_hz < duration:
        pts, offs = lidar_scan(sh, planes, t, 1.0 / lidar_hz, n_lines,
                               n_per_line, rng, fov_deg=fov_deg,
                               max_range=max_range, range_noise=range_noise,
                               dropout=lidar_dropout,
                               outlier_frac=lidar_outlier_frac)
        scans.append((t, pts, offs))
        t += 1.0 / lidar_hz

    images = []
    if render and cam is not None:
        R_ci_ = R_CI_FORWARD if R_ci is None else R_ci
        P_ci_ = np.zeros(3) if P_ci is None else P_ci
        t = 0.1
        while t < duration:
            expo = exposure_fn(t) if exposure_fn is not None else 1.0
            # camera culls far beyond the LiDAR range (it can see
            # farther than the ranging sensor, but not unboundedly for
            # generation cost); None = no culling
            cr = None if max_range is None else max(4.0 * max_range, 160.0)
            im = render_image(sh, planes, t, cam, exposure=expo,
                              R_ci=R_ci_, P_ci=P_ci_, cull_range=cr)
            if img_photon_noise > 0 or img_read_noise > 0 or img_blur_px > 0:
                im = degrade_image(im, rng, photon_noise=img_photon_noise,
                                   read_noise=img_read_noise,
                                   blur_px=img_blur_px)
            images.append((t, im))
            t += 1.0 / img_hz

    gt = []
    for t in np.arange(0.0, duration, 0.02):
        R, p = sh.pose(t)
        gt.append((t, R, p))
    return SyntheticSequence(
        imu_stamps=stamps, imu_gyr=gyr, imu_acc=acc, scans=scans,
        images=images, gt=gt,
    )


def ate_rmse(est: List[Tuple[float, np.ndarray]], gt: List[Tuple[float, np.ndarray, np.ndarray]],
             align: bool = True):
    """ATE RMSE (m) of estimated positions vs interpolated ground truth,
    after SE(3) Umeyama alignment (the evo_ape `-a` convention, the
    reference's metric of record — Log/result/ntu_viral/README.md).

    Alignment is NOT optional in principle: the estimator's world frame
    is its initial BODY frame, which differs from the generator's world
    frame by pose(0) (e.g. Trajectory's initial pitch rp_amp*sin(1.0) ≈
    2.9°) — an unobservable global transform that every trajectory
    benchmark quotients out. `align=False` measures the raw frame
    difference instead."""
    gt_t = np.array([g[0] for g in gt])
    gt_p = np.array([g[2] for g in gt])
    P_est, P_gt = [], []
    for t, p in est:
        i = np.clip(np.searchsorted(gt_t, t), 1, len(gt_t) - 1)
        w = (t - gt_t[i - 1]) / max(gt_t[i] - gt_t[i - 1], 1e-9)
        P_est.append(p)
        P_gt.append(gt_p[i - 1] * (1 - w) + gt_p[i] * w)
    P_est = np.array(P_est)
    P_gt = np.array(P_gt)
    if align and len(P_est) >= 3:
        mu_s, mu_d = P_est.mean(0), P_gt.mean(0)
        xs, xd = P_est - mu_s, P_gt - mu_d
        U, _, Vt = np.linalg.svd(xd.T @ xs / len(xs))
        S = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        P_est = (R @ P_est.T).T + (mu_d - R @ mu_s)
    errs = P_est - P_gt
    return float(np.sqrt(np.mean(np.sum(errs**2, axis=-1))))

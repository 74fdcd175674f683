"""TSDF fusion + surface extraction (the PyTorch port of
fast_livo2_tpu/io/tsdf.py).

Parity surface for the reference's offline mesh pipeline
(scripts/mesh.py: VDBFusion TSDF integration over saved PCDs + marching
cubes). The integration runs on the volume's device: each frame's
world-frame cloud updates a dense (G^3) voxel grid of (tsdf, weight) with
one batched scatter-add of its N x 7 ray samples (projective truncated
signed distance, the KinectFusion-style weighted update). As in the JAX
package, `integrate` is functional: it returns a new volume and builds
the chunk's two weight/distance sums in fresh (G^3 + 1) buffers, whose
last slot is the sink for samples outside the grid (the JAX scatter's
`mode="drop"`). On CUDA the float scatter-adds run in no fixed order, so
tsdf values differ from a CPU run at rounding.

Surface points + normals (zero-crossing voxels) and the triangle mesh
(marching tetrahedra) are extracted on the host in numpy, from one copy
of the volume to the host; vertex recolouring uses scipy's cKDTree
(the JAX module's brute-force fallback for a missing scipy is left out).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..ops import ordered_add


class TSDFVolume(NamedTuple):
    tsdf: torch.Tensor  # (G, G, G) float32 in [-1, 1]
    weight: torch.Tensor  # (G, G, G) float32
    origin: torch.Tensor  # (3,) world position of voxel (0,0,0)
    voxel: float  # voxel edge length
    trunc: float  # truncation distance


def make_volume(center, side: float, grid: int = 256,
                trunc_voxels: float = 3.0, device="cuda") -> TSDFVolume:
    voxel = side / grid
    origin = torch.as_tensor(np.asarray(center, np.float32) - np.float32(side / 2.0),
                             device=device)
    return TSDFVolume(
        tsdf=torch.ones((grid, grid, grid), dtype=torch.float32, device=device),
        weight=torch.zeros((grid, grid, grid), dtype=torch.float32,
                           device=device),
        origin=origin,
        voxel=float(voxel),
        trunc=float(trunc_voxels * voxel),
    )


def _ray_offsets(trunc: float, n_samp: int) -> np.ndarray:
    """n_samp float32 offsets from -trunc to +trunc, computed as
    jnp.linspace computes them (start (1 - s) + stop s, s = i / div, the
    stop appended exactly)."""
    div = n_samp - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    lo, hi = np.float32(-trunc), np.float32(trunc)
    return np.append(lo * (np.float32(1.0) - step) + hi * step, hi).astype(np.float32)


def ray_samples(vol: TSDFVolume, pts_w: torch.Tensor,
                sensor_pos: torch.Tensor, n_samp: int):
    """Each point's n_samp samples along its ray within +-trunc of the
    surface: (their positions in voxel units from the volume's origin
    (N, n_samp, 3), their projective SDF (N, n_samp))."""
    ray = pts_w - sensor_pos
    dist = torch.sqrt(torch.sum(ray * ray, dim=-1, keepdim=True))
    dirn = ray / torch.clamp(dist, min=1e-6)
    # sample offsets along the ray in [-trunc, +trunc] (behind the surface
    # = inside = negative sdf)
    offs = torch.from_numpy(_ray_offsets(vol.trunc, n_samp)).to(pts_w.device)
    samp = pts_w[:, None, :] + dirn[:, None, :] * offs[None, :, None]
    sdf = -offs / vol.trunc  # +1 in front (towards sensor), -1 behind
    return (samp - vol.origin) / vol.voxel, sdf[None, :].expand(samp.shape[:2])


def integrate(vol: TSDFVolume, pts_w: torch.Tensor, valid: torch.Tensor,
              sensor_pos: torch.Tensor, samples_inside: int = 3,
              samples_outside: int = 3) -> TSDFVolume:
    """Fuse one cloud: for each point, update voxels along the ray within
    +-trunc of the surface with the projective SDF (distance along the ray
    to the measured point), weight-averaged (KinectFusion rule), the
    weight capped at 64. A sample lands in the voxel floor(its position in
    voxel units)."""
    grid = vol.tsdf.shape[0]
    dev = vol.tsdf.device
    u, sdf = ray_samples(vol, pts_w, sensor_pos,
                         samples_inside + samples_outside + 1)
    idx = torch.floor(u).to(torch.int32)
    inb = torch.all((idx >= 0) & (idx < grid), dim=-1) & valid[:, None]
    g3 = grid * grid * grid
    flat = torch.where(
        inb, (idx[..., 0] * grid + idx[..., 1]) * grid + idx[..., 2], g3,
    ).reshape(-1).long()
    w_new = inb.reshape(-1).to(torch.float32)
    wsum = torch.zeros((g3 + 1,), dtype=torch.float32, device=dev)
    ssum = torch.zeros((g3 + 1,), dtype=torch.float32, device=dev)
    wsum.index_add_(0, flat, w_new)  # 1.0s and 0.0s: exact in any order
    ordered_add.ordered_index_add_(ssum[:, None], flat,
                                   (sdf.reshape(-1) * w_new)[:, None], drop=g3)
    wsum = wsum[:g3].reshape(vol.tsdf.shape)
    ssum = ssum[:g3].reshape(vol.tsdf.shape)
    w_old = vol.weight
    w_tot = w_old + wsum
    tsdf = torch.where(
        w_tot > 0, (vol.tsdf * w_old + ssum) / torch.clamp(w_tot, min=1e-6),
        vol.tsdf)
    return vol._replace(tsdf=tsdf, weight=torch.clamp(w_tot, max=64.0))


def _to_host(vol: TSDFVolume):
    """(tsdf, weight, origin) as numpy: the one device-to-host copy of the
    volume an extraction makes."""
    return (vol.tsdf.cpu().numpy(), vol.weight.cpu().numpy(),
            vol.origin.cpu().numpy())


def extract_surface(vol: TSDFVolume, min_weight: float = 1.0):
    """Zero-crossing voxels -> surfel cloud (points + normals), host-side
    numpy return. A voxel is on the surface when its TSDF changes sign
    against any +axis neighbor; the point is linearly interpolated."""
    t, w, origin = _to_host(vol)
    pts, nrms = [], []
    grid = t.shape[0]
    ok = w >= min_weight
    for ax in range(3):
        t2 = np.roll(t, -1, axis=ax)
        ok2 = np.roll(ok, -1, axis=ax)
        cross = ok & ok2 & (np.sign(t) != np.sign(t2)) & (np.abs(t - t2) > 1e-6)
        ii = np.argwhere(cross)
        if not len(ii):
            continue
        a = t[cross]
        b = t2[cross]
        frac = a / (a - b)
        p = (ii + 0.5).astype(np.float64)
        p[:, ax] += frac
        pts.append(origin + p * vol.voxel)
        # normal from central differences of the tsdf
        g = np.stack(np.gradient(t), axis=-1)
        n = g[cross]
        nn = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        nrms.append(nn)
    if not pts:
        return np.zeros((0, 3)), np.zeros((0, 3))
    return np.concatenate(pts), np.concatenate(nrms)


# --- Triangle mesh extraction (marching tetrahedra) ---------------------
#
# Parity with the reference's mesh output (scripts/mesh.py:1-115:
# VDBFusion extract_triangle_mesh + Open3D; neither ships here). Each
# grid cube splits into 6 tetrahedra around the 0-7 diagonal; every tet
# emits 0-2 triangles from its sign pattern. Far fewer special cases
# than cube-based marching cubes (no 256-entry tables, no ambiguous
# saddle configurations) at the cost of ~2x triangles — a good fit for a
# dependency-free vectorized numpy implementation. Winding is fixed
# afterwards against the TSDF gradient (outward normals), so the
# per-case vertex order below does not need to be orientation-consistent.

# cube corner n = dx + 2*dy + 4*dz; tets share the 0-7 diagonal, the
# middle corners walk the Hamiltonian cycle 1-3-2-6-4-5.
_TETS = [(0, 7, 1, 3), (0, 7, 3, 2), (0, 7, 2, 6),
         (0, 7, 6, 4), (0, 7, 4, 5), (0, 7, 5, 1)]
_CORNER = np.array([[n & 1, (n >> 1) & 1, (n >> 2) & 1] for n in range(8)])
# tet edges by local vertex pair
_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_E01, _E02, _E03, _E12, _E13, _E23 = range(6)
# case (bitmask of vertices with value < iso) -> triangles as edge triples
_TRI_TABLE = {
    0b0001: [(_E01, _E02, _E03)],
    0b0010: [(_E01, _E12, _E13)],
    0b0100: [(_E02, _E12, _E23)],
    0b1000: [(_E03, _E13, _E23)],
    0b0011: [(_E02, _E12, _E13), (_E02, _E13, _E03)],
    0b0101: [(_E01, _E12, _E23), (_E01, _E23, _E03)],
    0b1001: [(_E01, _E02, _E23), (_E01, _E23, _E13)],
    0b0110: [(_E01, _E02, _E23), (_E01, _E23, _E13)],
    0b1010: [(_E01, _E12, _E23), (_E01, _E23, _E03)],
    0b1100: [(_E02, _E12, _E13), (_E02, _E13, _E03)],
    0b1110: [(_E01, _E02, _E03)],
    0b1101: [(_E01, _E12, _E13)],
    0b1011: [(_E02, _E12, _E23)],
    0b0111: [(_E03, _E13, _E23)],
}


def extract_mesh(vol: TSDFVolume, min_weight: float = 1.0):
    """TSDF -> triangle mesh via vectorized marching tetrahedra.

    Returns (vertices (V, 3) float64 world coords, triangles (T, 3)
    int32 indices) with deduplicated vertices and outward-consistent
    winding (normal along +grad TSDF = toward free space)."""
    t, w, origin = _to_host(vol)
    t = t.astype(np.float64)
    origin = origin.astype(np.float64)
    g = t.shape[0]
    ok = w >= min_weight

    # active cubes: all 8 corners observed and signs differ
    c_ok = ok[:-1, :-1, :-1]
    c_min = t[:-1, :-1, :-1].copy()
    c_max = c_min.copy()
    for n in range(1, 8):
        dx, dy, dz = _CORNER[n]
        sl = t[dx:g - 1 + dx, dy:g - 1 + dy, dz:g - 1 + dz]
        c_ok = c_ok & ok[dx:g - 1 + dx, dy:g - 1 + dy, dz:g - 1 + dz]
        c_min = np.minimum(c_min, sl)
        c_max = np.maximum(c_max, sl)
    active = np.argwhere(c_ok & (c_min < 0) & (c_max >= 0))  # (N, 3) ijk
    if not len(active):
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)

    vals = np.stack([
        t[active[:, 0] + _CORNER[n, 0], active[:, 1] + _CORNER[n, 1],
          active[:, 2] + _CORNER[n, 2]] for n in range(8)
    ], axis=1)  # (N, 8)

    tri_pts = []
    base = active.astype(np.float64)  # (N, 3)
    for tet in _TETS:
        tv = vals[:, tet]  # (N, 4)
        tp = base[:, None, :] + _CORNER[list(tet)][None, :, :]  # (N, 4, 3)
        case = ((tv[:, 0] < 0) * 1 + (tv[:, 1] < 0) * 2
                + (tv[:, 2] < 0) * 4 + (tv[:, 3] < 0) * 8)
        for c, tris in _TRI_TABLE.items():
            m = case == c
            if not m.any():
                continue
            v_m, p_m = tv[m], tp[m]
            for e1, e2, e3 in tris:
                corners = []
                for e in (e1, e2, e3):
                    a, b = _EDGES[e]
                    va, vb = v_m[:, a], v_m[:, b]
                    frac = (va / (va - vb))[:, None]
                    corners.append(p_m[:, a] + frac * (p_m[:, b] - p_m[:, a]))
                tri_pts.append(np.stack(corners, axis=1))  # (n, 3, 3)
    tri = np.concatenate(tri_pts)  # (T, 3, 3) in voxel coords

    # Deduplicate vertices: crossing points live on lattice edges, so the
    # same point is emitted by every incident tet with identical coords
    # up to fp rounding.
    flat = tri.reshape(-1, 3)
    key = np.round(flat * 4096.0).astype(np.int64)
    _, first, inv = np.unique(
        key.view([("x", np.int64), ("y", np.int64), ("z", np.int64)]).ravel(),
        return_index=True, return_inverse=True)
    verts_vox = flat[first]
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate triangles (two corners on the same lattice point)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    faces = faces[good]

    # Outward winding: flip faces whose geometric normal opposes the TSDF
    # gradient (gradient points from inside (-) to free space (+)).
    grad = np.stack(np.gradient(t), axis=-1)
    v0, v1, v2 = (verts_vox[faces[:, k]] for k in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    cen = np.clip(((v0 + v1 + v2) / 3.0).round().astype(np.int64), 0, g - 1)
    gc = grad[cen[:, 0], cen[:, 1], cen[:, 2]]
    flip = np.sum(fn * gc, axis=-1) < 0
    faces[flip] = faces[flip][:, ::-1]

    verts = origin + (verts_vox + 0.5) * vol.voxel
    return verts, faces


def colorize_vertices(verts: np.ndarray, cloud_pts: np.ndarray,
                      cloud_rgb: np.ndarray):
    """Vertex colors from the nearest colored cloud point (the
    reference's KDTree recoloring, scripts/mesh.py:90-100)."""
    from scipy.spatial import cKDTree

    _, idx = cKDTree(cloud_pts).query(verts, workers=-1)
    return cloud_rgb[idx]


def write_ply_mesh(path: str, verts: np.ndarray, faces: np.ndarray,
                   colors: np.ndarray = None):
    """ASCII PLY triangle mesh (+ optional uint8 vertex colors)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for i in range(len(verts)):
            row = f"{verts[i, 0]:.5f} {verts[i, 1]:.5f} {verts[i, 2]:.5f}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")
        for tr in faces:
            f.write(f"3 {tr[0]} {tr[1]} {tr[2]}\n")


def write_ply(path: str, pts: np.ndarray, normals: np.ndarray = None):
    """ASCII PLY surfel cloud (meshable with any downstream tool)."""
    n = len(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{pts[i,0]:.5f} {pts[i,1]:.5f} {pts[i,2]:.5f}"
            if normals is not None:
                row += f" {normals[i,0]:.4f} {normals[i,1]:.4f} {normals[i,2]:.4f}"
            f.write(row + "\n")

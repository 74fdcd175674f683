"""Dense coloured-mesh reconstruction from saved PCD clouds (port of
scripts/mesh.py).

The reference's offline pipeline (its scripts/mesh.py: VDBFusion TSDF
integration over a folder of PCDs -> extract_triangle_mesh -> KDTree
vertex recolouring -> coloured PLY) in the port's own modules: the TSDF
integrates on the device (io/tsdf.integrate, one batched scatter-add a
cloud), and marching tetrahedra, nearest-point vertex colours and the
PLY writer run on the host.

    python -m fast_livo2_tpu_torch.mesh <dir-with-pcds-or-pcd-file>
        [-o mesh.ply] [--voxel 0.05] [--grid 256] [--min-weight 1.0]
        [--sensor x y z] [--device cuda|cpu]

--sensor is each cloud's sensor origin (default: the cloud's mean pulled
2 m up, fine for room-scale scans).
"""

import argparse
import glob
import os
import sys

import numpy as np
import torch


def pcd_files(src: str):
    """The .pcd files of a directory (sorted), or the one file given."""
    if os.path.isdir(src):
        return sorted(glob.glob(os.path.join(src, "*.pcd")))
    return [src]


def integrate_clouds(clouds, voxel: float = 0.05, grid: int = 256,
                     sensor=None, device="cuda"):
    """A TSDF volume over every cloud [(points, colours, intensity)]: a
    grid^3 cube around their bounds (side max(1.1 x the largest extent,
    voxel x grid)), each cloud integrated from `sensor` or its mean
    pulled 2 m up. Returns the volume on `device`."""
    from .io import tsdf as tsdf_mod

    all_pts = np.concatenate([c[0] for c in clouds])
    center = 0.5 * (all_pts.min(0) + all_pts.max(0))
    side = max(float((all_pts.max(0) - all_pts.min(0)).max()) * 1.1,
               voxel * grid)
    vol = tsdf_mod.make_volume(center, side, grid=grid, device=device)
    for pts, _, _ in clouds:
        vol = tsdf_mod.integrate(
            vol, torch.from_numpy(np.array(pts, np.float32)).to(device),
            torch.ones(len(pts), dtype=torch.bool, device=device),
            torch.as_tensor(cloud_sensor(pts, sensor), device=device))
    return vol


def cloud_sensor(pts, sensor=None) -> np.ndarray:
    """A cloud's sensor origin (float32 (3,)): `sensor`, or the cloud's
    mean pulled 2 m up."""
    origin = (np.asarray(sensor) if sensor is not None
              else pts.mean(0) + np.array([0.0, 0.0, 2.0]))
    return np.asarray(origin, np.float32)


def mesh_volume(vol, clouds, min_weight: float = 1.0):
    """The triangle mesh of a TSDF volume and, where the clouds carry
    colours, each vertex's nearest coloured point's colour. Returns
    (verts, faces, colours or None)."""
    from .io import tsdf as tsdf_mod

    verts, faces = tsdf_mod.extract_mesh(vol, min_weight=min_weight)
    colors = None
    coloured = [c for c in clouds if c[1] is not None]
    if coloured and len(verts):
        colors = tsdf_mod.colorize_vertices(
            verts, np.concatenate([c[0] for c in coloured]),
            np.concatenate([c[1] for c in coloured]))
    return verts, faces, colors


def main(argv=None):
    from .io import tsdf as tsdf_mod
    from .io.export import read_pcd

    ap = argparse.ArgumentParser(prog="python -m fast_livo2_tpu_torch.mesh")
    ap.add_argument("src", help="PCD file or directory of PCD files")
    ap.add_argument("-o", "--out", default="mesh.ply")
    ap.add_argument("--voxel", type=float, default=0.05)
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--min-weight", type=float, default=1.0)
    ap.add_argument("--sensor", nargs=3, type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the TSDF (default cuda)")
    args = ap.parse_args(argv)

    files = pcd_files(args.src)
    if not files:
        sys.exit(f"no .pcd files under {args.src}")
    clouds = [read_pcd(f) for f in files]
    vol = integrate_clouds(clouds, args.voxel, args.grid, args.sensor,
                           args.device)
    verts, faces, colors = mesh_volume(vol, clouds, args.min_weight)
    print(f"[mesh] volume: {args.grid}^3 voxels of {vol.voxel:.3f} m on "
          f"{vol.tsdf.device} over {len(files)} cloud(s), "
          f"{sum(len(c[0]) for c in clouds)} points")
    print(f"[mesh] extracted {len(verts)} vertices / {len(faces)} triangles")
    tsdf_mod.write_ply_mesh(args.out, verts, faces, colors)
    print(f"[mesh] wrote {args.out}")
    return len(verts), len(faces)


if __name__ == "__main__":
    main()

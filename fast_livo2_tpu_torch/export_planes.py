"""Export the fitted voxel plane map as a PLY of oriented disks (port of
scripts/export_planes.py).

The reference publishes its plane map to rviz as coloured surfels
(pubVoxelMap / pubSinglePlane, voxel_map.cpp:788-878: one marker per
converged plane, coloured by the trace of the plane covariance). Without
ROS the equivalent is a PLY disk cloud: each fitted plane becomes a
small triangulated disk at the plane centre, oriented by the fitted
normal, sized by the fitted in-plane radius, coloured by the normal
covariance's magnitude (red = uncertain, green = tight).

    from fast_livo2_tpu_torch.export_planes import export_plane_ply
    export_plane_ply(pipe.vmap_state, pipe.map_cfg, "planes.ply")

or from a checkpoint of the run CLI (--checkpoint), with the config it
ran with:

    python -m fast_livo2_tpu_torch.export_planes ck.npz \\
        --config configs/avia.yaml [--camera cam.yaml] [-o planes.ply] \\
        [--device cuda|cpu]
"""

import argparse

import numpy as np


def write_plane_ply(keys: np.ndarray, rec: np.ndarray, path: str,
                    segments: int = 8, max_planes: int = 200000) -> int:
    """Write the plane records rec (L, C, 22) of the occupied slots of
    keys (L, C, 3) as coloured disks of `segments` triangles, at most
    `max_planes` of them. Returns the planes written."""
    from .core import voxel_map as vm

    verts, faces, cols = [], [], []
    n_off = 0
    for layer in range(keys.shape[0]):
        used = (keys[layer] != vm.EMPTY).all(-1)
        r = rec[layer]
        idx = np.where((r[:, vm._ISPL] > 0.5) & used)[0]
        if len(idx) == 0:
            continue
        n = r[idx, 1:4]
        c = r[idx, 5:8]
        radius = np.maximum(r[idx, 8], 0.05)
        # normal uncertainty = trace of cov_nn (sym6 diagonal at 9, 12, 14)
        tr = r[idx, 9] + r[idx, 12] + r[idx, 14]
        # orthonormal in-plane axes
        a = np.where(np.abs(n[:, 2:3]) < 0.9,
                     np.tile([0.0, 0.0, 1.0], (len(idx), 1)),
                     np.tile([1.0, 0.0, 0.0], (len(idx), 1)))
        u = np.cross(n, a)
        u /= np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-9)
        v = np.cross(n, u)
        # colour: green (tight) -> red (uncertain), log-scaled
        t = np.clip((np.log10(np.maximum(tr, 1e-12)) + 8) / 6, 0, 1)
        col = np.stack([255 * t, 255 * (1 - t), np.zeros_like(t)], -1)

        ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
        ring = (np.cos(ang)[None, :, None] * u[:, None, :]
                + np.sin(ang)[None, :, None] * v[:, None, :])
        ring = c[:, None, :] + 0.5 * radius[:, None, None] * ring
        for i in range(len(idx)):
            if n_off // (segments + 1) >= max_planes:
                break
            verts.append(c[i])
            verts.extend(ring[i])
            cols.extend([col[i]] * (segments + 1))
            for s in range(segments):
                faces.append((n_off, n_off + 1 + s,
                              n_off + 1 + (s + 1) % segments))
            n_off += segments + 1

    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    cols = np.asarray(cols, np.uint8).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for p, cl in zip(verts, cols):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                    f"{int(cl[0])} {int(cl[1])} {int(cl[2])}\n")
        for a3, b3, c3 in faces:
            f.write(f"3 {a3} {b3} {c3}\n")
    return len(faces) // segments


def export_plane_ply(vmap_state, map_cfg, path: str, segments: int = 8,
                     max_planes: int = 200000) -> int:
    """Write the fitted planes of every layer of a voxel map as coloured
    oriented disks: derive_rec on the map's device, one copy of the keys
    and records to the host, then `write_plane_ply`. Returns the planes
    written."""
    from .core import voxel_map as vm

    rec = vm.derive_rec(vmap_state, map_cfg).cpu().numpy()
    return write_plane_ply(vmap_state.keys.cpu().numpy(), rec, path,
                           segments, max_planes)


def main(argv=None):
    from .core.pipeline import LIVOPipeline
    from .io import checkpoint
    from .utils.config import load_config

    ap = argparse.ArgumentParser(
        prog="python -m fast_livo2_tpu_torch.export_planes")
    ap.add_argument("checkpoint", help="a checkpoint of the run CLI")
    ap.add_argument("--config", required=True,
                    help="the sensor yaml the run used")
    ap.add_argument("--camera", default=None, help="its camera yaml")
    ap.add_argument("-o", "--out", default="planes.ply")
    ap.add_argument("--device", default="cuda",
                    help="torch device to derive the planes on "
                         "(default cuda)")
    args = ap.parse_args(argv)
    meta, _ = checkpoint.read(args.checkpoint)
    pipe = LIVOPipeline(load_config(args.config, args.camera),
                        slam_mode=meta["slam_mode"], device=args.device)
    checkpoint.load(args.checkpoint, pipe)
    n = export_plane_ply(pipe.vmap_state, pipe.map_cfg, args.out)
    print(f"wrote {n} planes -> {args.out}")
    return n


if __name__ == "__main__":
    main()

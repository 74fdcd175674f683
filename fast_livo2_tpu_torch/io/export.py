"""Trajectory / point-cloud / COLMAP / PNG exporters (the PyTorch port's
own copy of fast_livo2_tpu/io/export.py; it writes byte-identical files).

Replaces the reference's terminal export surface: TUM-format pose logs
(LIVMapper.cpp:384-405), PCD save (savePCD, LIVMapper.cpp:484-532), and
COLMAP sparse-model text files (vio.cpp:128-143, :1762-1784 +
scripts/colmap_output.sh). Pure host-side writers over numpy arrays. The
quaternion helpers `_quat_xyzw` / `_quat_to_R` are the port's one copy
(io/dataset.py imports them from here).
"""

import os
from typing import List, Sequence, Tuple

import numpy as np


def _quat_xyzw(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), robust branch."""
    q = np.empty(4)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q[:] = [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                (R[1, 0] - R[0, 1]) / s, 0.25 * s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        v = np.empty(3)
        v[i] = 0.25 * s
        v[j] = (R[j, i] + R[i, j]) / s
        v[k] = (R[k, i] + R[i, k]) / s
        q[:3] = v
        q[3] = (R[k, j] - R[j, k]) / s
    return q / np.linalg.norm(q)


def write_tum(path: str, traj: List[Tuple[float, np.ndarray, np.ndarray]]):
    """TUM format: `t x y z qx qy qz qw` per line (the evo_ape input the
    reference emits at LIVMapper.cpp:400-404)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for t, R, p in traj:
            q = _quat_xyzw(np.asarray(R))
            f.write(
                f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def write_pcd(path: str, points: np.ndarray, colors: np.ndarray = None,
              intensity: np.ndarray = None, binary: bool = True):
    """Minimal PCD writer (pcl::PCDWriter equivalent for the fields the
    reference saves: XYZRGB or XYZI, LIVMapper.cpp:490-527)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(points)
    points = np.asarray(points, np.float32)
    if colors is not None:
        rgb = np.asarray(colors, np.uint32)
        packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
        packed_f = packed.view(np.float32) if packed.dtype == np.uint32 else packed
        fields = "x y z rgb"
        types = "F F F F"
        data = np.concatenate([points, packed_f[:, None].astype(np.float32)], axis=1)
    elif intensity is not None:
        fields = "x y z intensity"
        types = "F F F F"
        data = np.concatenate(
            [points, np.asarray(intensity, np.float32)[:, None]], axis=1
        )
    else:
        fields = "x y z"
        types = "F F F"
        data = points
    ncols = data.shape[1]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {' '.join(['4'] * ncols)}\n"
        f"TYPE {types}\n"
        f"COUNT {' '.join(['1'] * ncols)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(data, np.float32).tobytes())
        elif colors is not None:
            # ascii rgb: write the packed integer itself — the binary
            # float32 bit-pattern view is a denormal that "%.6f" would
            # flatten to 0. (Every packed value <= 0xFFFFFF < 2^24 is
            # exactly representable in float32, so the column round-trips.)
            np.savetxt(f, np.column_stack([points, packed]),
                       fmt=["%.6f"] * 3 + ["%d"])
        else:
            np.savetxt(f, data, fmt="%.6f")


def read_pcd(path: str):
    """Read a PCD file written by write_pcd (binary or ascii, 4-byte
    float fields). Returns (points (N, 3), colors (N, 3) uint8 or None,
    intensity (N,) or None) — the loader side of the reference's
    offline mesh pipeline (scripts/mesh.py reads saved PCDs back)."""
    with open(path, "rb") as f:
        fields, n, binary = None, 0, True
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("POINTS"):
                n = int(line.split()[1])
            elif line.startswith("DATA"):
                binary = line.split()[1] == "binary"
                break
        ncols = len(fields)
        if binary:
            data = np.frombuffer(f.read(4 * n * ncols), np.float32).reshape(n, ncols)
        else:
            data = np.loadtxt(f, np.float32).reshape(n, ncols)
    pts = data[:, 0:3]
    colors = intensity = None
    if "rgb" in fields:
        col = data[:, fields.index("rgb")]
        # binary: float32 bit-pattern view; ascii: the packed integer value
        packed = col.view(np.uint32) if binary else col.astype(np.uint32)
        colors = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                           packed & 0xFF], axis=-1).astype(np.uint8)
    if "intensity" in fields:
        intensity = data[:, fields.index("intensity")]
    return pts, colors, intensity


def write_colmap(out_dir: str, cam, frames: Sequence[Tuple[int, np.ndarray, np.ndarray, str]],
                 points3d: np.ndarray = None, colors: np.ndarray = None):
    """COLMAP sparse text model: cameras.txt / images.txt / points3D.txt
    (reference writes these at vio.cpp:128-143, :1762-1784,
    LIVMapper.cpp:508-523). `frames` rows: (image_id, R_cw, t_cw, name)."""
    sparse = os.path.join(out_dir, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(
            f"1 PINHOLE {cam.width} {cam.height} "
            f"{cam.fx:.6f} {cam.fy:.6f} {cam.cx:.6f} {cam.cy:.6f}\n"
        )
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for img_id, R_cw, t_cw, name in frames:
            q = _quat_xyzw(np.asarray(R_cw))
            f.write(
                f"{img_id} {q[3]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} "
                f"{t_cw[0]:.6f} {t_cw[1]:.6f} {t_cw[2]:.6f} 1 {name}\n"
            )
            f.write("0.0 0.0 -1\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]\n")
        if points3d is not None:
            cols = (
                np.asarray(colors, np.uint8)
                if colors is not None
                else np.full((len(points3d), 3), 128, np.uint8)
            )
            for i, (p, c) in enumerate(zip(points3d, cols)):
                f.write(
                    f"{i + 1} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{c[0]} {c[1]} {c[2]} 0 \n"
                )


def read_tum(path: str):
    """Read a TUM trajectory file -> list[(t, R, p)] (for the evaluation
    harness mirroring Log/result/ntu_viral/evaluate_viral.py)."""
    rows = np.loadtxt(path)
    out = []
    for r in np.atleast_2d(rows):
        t, x, y, z, qx, qy, qz, qw = r[:8]
        R = _quat_to_R(np.array([qx, qy, qz, qw]))
        out.append((float(t), R, np.array([x, y, z])))
    return out


def _quat_to_R(q_xyzw: np.ndarray) -> np.ndarray:
    x, y, z, w = q_xyzw
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def write_png(path: str, img: np.ndarray):
    """Minimal dependency-free PNG writer (the image-dump parity path —
    the reference shells out to cv::imwrite; neither OpenCV nor PIL ship
    in this image). `img`: (H, W) grayscale or (H, W, 3) RGB, uint8 or
    float in [0, 255]."""
    import struct
    import zlib

    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        color_type, nchan = 0, 1
        a = a[:, :, None]
    else:
        color_type, nchan = 2, 3
    h, w = a.shape[:2]
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))

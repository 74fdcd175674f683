"""Offline dataset format + readers.

The reference consumes live ROS topics from rosbag replay
(LIVMapper.cpp:194-198). This engine runs ROS-free: sequences live in a
directory of npz files (one-time conversion from rosbags via
scripts/convert_rosbag.py, which needs the pure-python `rosbags` package
— not bundled here; any producer of this layout works):

    <seq>/imu.npz         stamps (N,), gyr (N,3), acc (N,3)
    <seq>/scans.npz       offsets into flat arrays:
                          t_begin (S,), start (S+1,),
                          points (P, 3) float32 body frame,
                          t_offs (P,) float32 seconds from scan begin
    <seq>/images.npz      stamps (M,), key per frame: img_00000 ... each
                          (H, W) uint8 grayscale (or (H, W, 3) BGR)
    <seq>/gt.npz          optional: stamps (G,), pos (G,3), quat_xyzw (G,4)

The reader applies the reference's time-offset knobs
(imu_time_offset / img_time_offset / lidar_time_offset,
LIVMapper.cpp:71-75) and image scale resize, and exposes the same
duck-typed interface as io.synthetic.SyntheticSequence.

The PyTorch port's own copy of fast_livo2_tpu/io/dataset.py; its
quaternion helpers come from the port's io/export.py.
"""

import os
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from .export import _quat_to_R, _quat_xyzw


def resize_half(img: np.ndarray, times: int) -> np.ndarray:
    """2x box-filter downscale `times` times (the camera yaml `scale` of
    0.5/0.25 used by the reference configs)."""
    out = img.astype(np.float32)
    for _ in range(times):
        h, w = out.shape[:2]
        out = out[: h // 2 * 2, : w // 2 * 2]
        out = 0.25 * (out[0::2, 0::2] + out[1::2, 0::2] + out[0::2, 1::2] + out[1::2, 1::2])
    return out


def to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img.astype(np.float32)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return (0.114 * b + 0.587 * g + 0.299 * r).astype(np.float32)


@dataclass
class NpzSequence:
    imu_stamps: np.ndarray
    imu_gyr: np.ndarray
    imu_acc: np.ndarray
    scans: List[Tuple[float, np.ndarray, np.ndarray]]
    images: List[Tuple[float, np.ndarray]]
    gt: List[Tuple[float, np.ndarray, np.ndarray]] = field(default_factory=list)


def load_sequence(path: str, imu_time_offset=0.0, img_time_offset=0.0,
                  lidar_time_offset=0.0, image_scale=1.0,
                  img_decimate: int = 1, cfg=None) -> NpzSequence:
    if cfg is not None:
        # Pull the ingestion knobs from a LIVOConfig: the time_offset
        # section (LIVMapper.cpp:71-75; applied at the sensor callbacks,
        # :708/:776/:847 — exposure_time_init is applied later, at the
        # sync cut, by LIVOPipeline.process), the camera scale, and the
        # hilti_en 40->10 Hz image decimation (:841-845).
        imu_time_offset = cfg.time_offset.imu_time_offset
        img_time_offset = cfg.time_offset.img_time_offset
        lidar_time_offset = cfg.time_offset.lidar_time_offset
        image_scale = cfg.camera.scale
        img_decimate = 4 if cfg.preprocess.hilti_en else img_decimate
    imu = np.load(os.path.join(path, "imu.npz"))
    imu_stamps = imu["stamps"].astype(np.float64) - imu_time_offset

    sc = np.load(os.path.join(path, "scans.npz"))
    scans = []
    start = sc["start"]
    # Hoist the big arrays OUT of the loop: NpzFile re-inflates the whole
    # compressed member on EVERY [] access, so `sc["points"][s:e]` inside
    # the loop was O(n_scans x total_bytes) — a 200 MB / 750-scan cache
    # took ~25 min to "load" (r4 bench hang) vs ~2 s hoisted.
    points = sc["points"]
    t_offs = sc["t_offs"]
    for i, tb in enumerate(sc["t_begin"]):
        s, e = int(start[i]), int(start[i + 1])
        scans.append((
            float(tb) + lidar_time_offset,
            points[s:e].astype(np.float32),
            t_offs[s:e].astype(np.float32),
        ))

    images = []
    img_path = os.path.join(path, "images.npz")
    if os.path.exists(img_path):
        im = np.load(img_path)
        n_half = {1.0: 0, 0.5: 1, 0.25: 2}.get(round(image_scale, 2))
        # hilti_en-style decimation (LIVMapper.cpp:841-845): keep 1-in-N
        for i, ts in enumerate(im["stamps"]):
            if img_decimate > 1 and i % img_decimate:
                continue
            img = to_gray(im[f"img_{i:05d}"])
            if n_half:
                img = resize_half(img, n_half)
            images.append((float(ts) + img_time_offset, img))

    gt = []
    gt_path = os.path.join(path, "gt.npz")
    if os.path.exists(gt_path):
        g = np.load(gt_path)
        for ts, p, q in zip(g["stamps"], g["pos"], g["quat_xyzw"]):
            gt.append((float(ts), _quat_to_R(q), p.astype(np.float64)))
    return NpzSequence(
        imu_stamps=imu_stamps, imu_gyr=imu["gyr"], imu_acc=imu["acc"],
        scans=scans, images=images, gt=gt,
    )


def save_sequence(path: str, seq) -> None:
    """Write any duck-typed sequence (e.g. synthetic) to the npz layout."""
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(
        os.path.join(path, "imu.npz"), stamps=seq.imu_stamps,
        gyr=seq.imu_gyr, acc=seq.imu_acc,
    )
    t_begin = np.array([s[0] for s in seq.scans])
    start = np.cumsum([0] + [len(s[1]) for s in seq.scans])
    np.savez_compressed(
        os.path.join(path, "scans.npz"), t_begin=t_begin, start=start,
        points=np.concatenate([s[1] for s in seq.scans]) if seq.scans else np.zeros((0, 3), np.float32),
        t_offs=np.concatenate([s[2] for s in seq.scans]) if seq.scans else np.zeros(0, np.float32),
    )
    if seq.images:
        imgs = {f"img_{i:05d}": img.astype(np.uint8) for i, (_, img) in enumerate(seq.images)}
        np.savez_compressed(
            os.path.join(path, "images.npz"),
            stamps=np.array([t for t, _ in seq.images]), **imgs,
        )
    if getattr(seq, "gt", None):
        np.savez_compressed(
            os.path.join(path, "gt.npz"),
            stamps=np.array([g[0] for g in seq.gt]),
            pos=np.array([g[2] for g in seq.gt]),
            quat_xyzw=np.array([_quat_xyzw(g[1]) for g in seq.gt]),
        )

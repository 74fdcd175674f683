"""Checkpoint / resume of the port's pipeline (port of
fast_livo2_tpu/io/checkpoint.py, in the port's own format).

A checkpoint is one compressed npz: the device state as named numpy
arrays (packed state + covariance, the voxel map's keys/stats/rec, the
visual pool and frame ring where the mode has them, the IMU noise), the
host scalars in a JSON manifest, and the streaming state: the in-flight
prefetch packet (the one-ahead prefetch has already consumed `pending`
for the next event, so resume without it would run that event on an
empty scan), the IMU buffer, the queued scan events and the pending scan
chunks. As in the JAX package, queued camera frames are not persisted:
re-push them after resume. Outputs gathered during the run (trajectory,
clouds, traces, IMU-rate poses) are not state and are not saved.

Version 2 adds the sliding-window backend's history, in the JAX
package's array names: the keyframes (time, packed state, body scan),
the refined keyframe poses and the keyframe count at the last submit, so
that a resumed pipeline's online refinement goes on with its history;
and the raw IMU history its links preintegrate (`kf_imu_*`, which the
JAX package does not keep: without it the first windows after a resume
would refine without links, and the resumed run would part from the
uninterrupted one). As in the JAX package, photometric captures are not
saved (resumed keyframes carry none) and a refinement in flight at save
time is lost (the next stride submits its keyframes again). Version 1
files load.

The pool's sink row (row P, core/vio.py) is not saved: the pool is
stored as the JAX package holds it, and `load` rebuilds the sink with
io/convert.pool_from_numpy. No reader looks at the sink, so resume is
exact: on the CPU a pipeline loaded after k frames runs the rest of the
sequence bit for bit as the uninterrupted run does.

A checkpoint of the JAX package loads with io/convert.load_jax_checkpoint.
"""

import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import imu as imu_mod
from ..core.voxel_map import VoxelMap
from ..utils.host_copy import host_value, landed_copy
from . import convert

FORMAT = "fast_livo2_tpu_torch"
VERSION = 2
READS = (1, 2)  # the versions `load` reads


def save(path: str, pipeline) -> None:
    """Snapshot a LIVOPipeline's device state, host scalars and stream."""
    packed, keys, stats, rec = convert.state_to_numpy(pipeline.packed,
                                                      pipeline.vmap_state)
    arrays = {"packed": packed, "vmap_keys": keys, "vmap_stats": stats,
              "vmap_rec": rec}
    if pipeline.pool is not None:
        for name, a in zip(("point", "obs", "obs_patch", "alloc"),
                           convert.pool_to_numpy(pipeline.pool)):
            arrays[f"pool_{name}"] = a
        arrays["ring_imgs"], arrays["ring_ids"] = convert.ring_to_numpy(
            pipeline.ring)
    if pipeline.noise is not None:
        for name, t in zip(imu_mod.ImuNoise._fields, pipeline.noise):
            arrays[f"noise_{name}"] = t.cpu().numpy()
    meta = {
        "format": FORMAT,
        "version": VERSION,
        "slam_mode": pipeline.slam_mode,
        "frame_id": int(pipeline.frame_id),
        "last_update_time": (None if pipeline.last_update_time is None
                             else float(pipeline.last_update_time)),
        "imu_inited": bool(pipeline.imu_inited),
        "map_inited": bool(pipeline.map_inited),
        "n_pending": len(pipeline.pending),
        "packet_t0": (None if pipeline._packet_t0 is None
                      else float(pipeline._packet_t0)),
        "prefetch_t": (None if pipeline._prefetch is None
                       else float(pipeline._prefetch[0])),
        "use_images": bool(pipeline._use_images),
        "scan_horizon": float(pipeline._scan_horizon),
    }
    if pipeline._prefetch is not None:
        imu_pack, pts_pack = pipeline._prefetch[1]
        arrays["prefetch_imu"] = imu_pack.cpu().numpy()
        arrays["prefetch_pts"] = pts_pack.cpu().numpy()
    # map sliding's decision state (the snapshot lags one check)
    arrays["last_slide_pos"] = np.asarray(pipeline._last_slide_pos)
    if pipeline._pos_snapshot is not None:
        arrays["pos_snapshot"] = host_value(pipeline._pos_snapshot)
    # the streaming ingestion state, in the JAX package's array names
    arrays.update(stream_imu_t=pipeline._imu_t,
                  stream_imu_gyr=pipeline._imu_gyr,
                  stream_imu_acc=pipeline._imu_acc,
                  stream_scan_events=np.asarray(pipeline._scan_events,
                                                np.float64))
    for i, (pts, t_abs) in enumerate(pipeline.pending):
        arrays[f"pend_pts_{i}"] = pts
        arrays[f"pend_t_{i}"] = t_abs
    kfs = pipeline._keyframes
    if kfs:
        arrays["kf_t"] = np.array([kf[0] for kf in kfs])
        arrays["kf_packed"] = torch.stack([kf[1] for kf in kfs]).cpu().numpy()
        arrays["kf_scan"] = torch.stack([kf[2] for kf in kfs]).cpu().numpy()
        meta["last_refine_k"] = int(pipeline._last_refine_k)
    if pipeline._imu_hist:
        for i, name in enumerate(("t", "gyr", "acc")):
            arrays[f"kf_imu_{name}"] = np.concatenate(
                [h[i] for h in pipeline._imu_hist])
    if pipeline.refined_keyframes:
        rts = sorted(pipeline.refined_keyframes)
        arrays["refined_t"] = np.array(rts)
        arrays["refined_R"] = np.stack([pipeline.refined_keyframes[t][0]
                                        for t in rts])
        arrays["refined_p"] = np.stack([pipeline.refined_keyframes[t][1]
                                        for t in rts])
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def read(path: str):
    """(meta, {name: array}) of a checkpoint file."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    return meta, arrays


def load(path: str, pipeline) -> None:
    """Restore a snapshot written by `save` into a freshly constructed
    LIVOPipeline of the same configuration and mode (shapes must match)."""
    meta, a = read(path)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this package (a "
                         "JAX package checkpoint loads with "
                         "io.convert.load_jax_checkpoint)")
    if meta["version"] not in READS:
        raise ValueError(f"checkpoint version {meta['version']}, this "
                         f"package reads {READS}")
    has_pool = "pool_point" in a
    noise = ([a[f"noise_{n}"] for n in imu_mod.ImuNoise._fields]
             if "noise_cov_gyr" in a else None)
    restore(pipeline, meta, a, packed=a["packed"],
            vmap=(a["vmap_keys"], a["vmap_stats"], a["vmap_rec"]),
            pool=([a[f"pool_{n}"] for n in ("point", "obs", "obs_patch",
                                             "alloc")] if has_pool else None),
            ring=(a["ring_imgs"], a["ring_ids"]) if has_pool else None,
            noise=noise)


def _check_same(name, new, old):
    if tuple(new.shape) != tuple(old.shape):
        raise ValueError(f"checkpoint {name} has shape {tuple(new.shape)}, the "
                         f"pipeline {tuple(old.shape)} (config changed?)")


def restore(pipeline, meta: dict, a: dict, packed, vmap: Sequence,
            pool: Optional[Sequence], ring: Optional[Sequence],
            noise: Optional[Sequence]) -> None:
    """Set a pipeline's device state from numpy arrays and its host state
    from `meta` and the stream arrays of `a` (the JAX package's names).
    Shared by `load` and io/convert.load_jax_checkpoint. The pool and
    ring are set where the pipeline has them (LIVO mode)."""
    dev = pipeline.device
    new_packed, new_map = convert.state_from_numpy(packed, *vmap, device=dev)
    _check_same("packed", new_packed, pipeline.packed)
    for f in VoxelMap._fields:
        _check_same(f"map {f}", getattr(new_map, f),
                    getattr(pipeline.vmap_state, f))
    if pipeline.pool is not None:
        if pool is None:
            raise ValueError("the checkpoint holds no visual pool, the "
                             f"{pipeline.slam_mode} pipeline needs one")
        new_pool = convert.pool_from_numpy(*pool, device=dev)
        new_ring = convert.ring_from_numpy(*ring, device=dev)
        for name, new, old in (("pool", new_pool, pipeline.pool),
                               ("ring", new_ring, pipeline.ring)):
            for f in type(old)._fields:
                _check_same(f"{name} {f}", getattr(new, f), getattr(old, f))
        pipeline.pool, pipeline.ring = new_pool, new_ring
    pipeline.packed, pipeline.vmap_state = new_packed, new_map
    pipeline.noise = (None if noise is None else imu_mod.ImuNoise(
        *(torch.from_numpy(np.array(x, np.float32)).to(dev) for x in noise)))

    pipeline.frame_id = meta["frame_id"]
    pipeline.last_update_time = meta["last_update_time"]
    pipeline.imu_inited = meta["imu_inited"]
    pipeline.map_inited = meta["map_inited"]
    pipeline._packet_t0 = meta.get("packet_t0")
    pipeline._prefetch = None
    if meta.get("prefetch_t") is not None:
        pipeline._prefetch = (meta["prefetch_t"],
                              (pipeline._put(a["prefetch_imu"]),
                               pipeline._put(a["prefetch_pts"])))
    pipeline._imu_t = a["stream_imu_t"]
    pipeline._imu_gyr = a["stream_imu_gyr"]
    pipeline._imu_acc = a["stream_imu_acc"]
    pipeline._scan_events = [float(t) for t in a["stream_scan_events"]]
    pipeline.pending = [(a[f"pend_pts_{i}"], a[f"pend_t_{i}"])
                        for i in range(meta.get("n_pending", 0))]
    if "use_images" in meta:
        pipeline._use_images = meta["use_images"]
    if "scan_horizon" in meta:
        pipeline._scan_horizon = meta["scan_horizon"]
    if "last_slide_pos" in a:
        pipeline._last_slide_pos = a["last_slide_pos"]
    if "pos_snapshot" in a:
        pipeline._pos_snapshot = landed_copy(a["pos_snapshot"])
    if "kf_t" in a:
        # (t, packed, scan4, no photo, the host copy of the state)
        pipeline._keyframes = [
            (float(t), convert._put(p, dev), convert._put(sc, dev), None,
             landed_copy(np.array(p[0:25], np.float32)))
            for t, p, sc in zip(a["kf_t"], a["kf_packed"], a["kf_scan"])]
        pipeline._last_refine_k = int(meta.get("last_refine_k", 0))
    if "kf_imu_t" in a:
        pipeline._imu_hist = [(a["kf_imu_t"], a["kf_imu_gyr"],
                               a["kf_imu_acc"])]
    if "refined_t" in a:
        pipeline.refined_keyframes = {
            float(t): (R, p) for t, R, p in zip(
                a["refined_t"], a["refined_R"], a["refined_p"])}

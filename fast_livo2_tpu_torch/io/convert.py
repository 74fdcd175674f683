"""State carried between the JAX package and this port.

The system has no learned weights: its state is the packed NavState +
covariance vector (core/state.pack_state, the JAX package's layout
element for element), the voxel map (keys (L, C, 3) int32, stats
(L, C, 16) f32, rec (L, C, 22) f32), the visual point pool (point
(P, 19), obs (P, K, 20), obs_patch (P, K, ps²), alloc ()) and the frame
ring (imgs (F, H, W) f32, ids (F,) int32). Both packages exchange them
as numpy arrays, so a module of each can start from the same state. The
port's pool tensors carry one extra sink row (core/vio.py), added here
and stripped on the way back.

The sliding-window backend's inputs (parallel/ba.py: Window, ImuLinks,
PhotoFactors) cross the same way (`window_from_numpy`,
`links_from_numpy`, `photo_from_numpy`).

`load_jax_checkpoint` resumes a run of the JAX package in the port: it
reads a checkpoint written by fast_livo2_tpu.io.checkpoint.save (format
v5, with the backend's keyframes where it has them) as numpy arrays,
without JAX.
"""

import numpy as np
import torch

from ..core.state import PACKED_LEN
from ..core.vio import OBS_W, POINT_W, FrameRing, VisualPool
from ..core.voxel_map import REC_W, STATS_W, VoxelMap
from ..parallel.ba import ImuLinks, PhotoFactors, Window


def state_from_numpy(packed, keys, stats, rec, device="cuda"):
    """numpy (packed (PACKED_LEN,), keys, stats, rec) -> (packed tensor,
    VoxelMap) on `device`, validated against the port's layout."""
    packed = np.asarray(packed, np.float32)
    keys = np.asarray(keys, np.int32)
    stats = np.asarray(stats, np.float32)
    rec = np.asarray(rec, np.float32)
    if packed.shape != (PACKED_LEN,):
        raise ValueError(f"packed state has shape {packed.shape}, "
                         f"expected ({PACKED_LEN},)")
    L, C = keys.shape[:2]
    for name, a, w in (("keys", keys, 3), ("stats", stats, STATS_W),
                       ("rec", rec, REC_W)):
        if a.shape != (L, C, w):
            raise ValueError(f"map {name} has shape {a.shape}, "
                             f"expected {(L, C, w)}")

    return (_put(packed, device),
            VoxelMap(keys=_put(keys, device), stats=_put(stats, device),
                     rec=_put(rec, device)))


def _put(a, device):
    """A C-ordered copy on `device`: the caller's arrays may be read-only
    views, and the port may write its state in place."""
    return torch.from_numpy(np.array(a, order="C")).to(device)


def state_to_numpy(packed: torch.Tensor, vmap_state: VoxelMap):
    """(packed tensor, VoxelMap) -> numpy (packed, keys, stats, rec), the
    arrays the JAX package's state takes."""
    return (packed.detach().cpu().numpy(),
            vmap_state.keys.cpu().numpy(),
            vmap_state.stats.cpu().numpy(),
            vmap_state.rec.cpu().numpy())


def pool_from_numpy(point, obs, obs_patch, alloc, device="cuda") -> VisualPool:
    """The JAX package's VisualPool arrays -> the port's VisualPool on
    `device`, with the zero sink row appended to each pool tensor."""
    point = np.asarray(point, np.float32)
    obs = np.asarray(obs, np.float32)
    obs_patch = np.asarray(obs_patch, np.float32)
    P, K = obs.shape[:2]
    for name, a, shape in (("point", point, (P, POINT_W)),
                           ("obs", obs, (P, K, OBS_W)),
                           ("obs_patch", obs_patch, (P, K, obs_patch.shape[-1]))):
        if a.shape != shape:
            raise ValueError(f"pool {name} has shape {a.shape}, expected {shape}")

    def with_sink(a):
        return np.concatenate([a, np.zeros((1,) + a.shape[1:], np.float32)])

    return VisualPool(point=_put(with_sink(point), device),
                      obs=_put(with_sink(obs), device),
                      obs_patch=_put(with_sink(obs_patch), device),
                      alloc=_put(np.float32(alloc), device))


def pool_to_numpy(pool: VisualPool):
    """The port's VisualPool -> numpy (point, obs, obs_patch, alloc) as
    the JAX package holds them (the sink row dropped)."""
    return (pool.point[:-1].cpu().numpy(), pool.obs[:-1].cpu().numpy(),
            pool.obs_patch[:-1].cpu().numpy(), pool.alloc.cpu().numpy())


def ring_from_numpy(imgs, ids, device="cuda") -> FrameRing:
    """The JAX package's FrameRing arrays -> the port's on `device`."""
    imgs = np.asarray(imgs, np.float32)
    ids = np.asarray(ids, np.int32)
    if imgs.ndim != 3 or ids.shape != imgs.shape[:1]:
        raise ValueError(f"ring imgs {imgs.shape} and ids {ids.shape} do not "
                         "match (F, H, W) and (F,)")
    return FrameRing(imgs=_put(imgs, device), ids=_put(ids, device))


def ring_to_numpy(ring: FrameRing):
    return ring.imgs.cpu().numpy(), ring.ids.cpu().numpy()


def window_from_numpy(rot, pos, scans, valid, device="cuda") -> Window:
    """numpy (rot (K, 3, 3), pos (K, 3), scans (K, N, 3), valid (K, N))
    -> ba.Window on `device`."""
    return Window(rot=_put(np.asarray(rot, np.float32), device),
                  pos=_put(np.asarray(pos, np.float32), device),
                  scans=_put(np.asarray(scans, np.float32), device),
                  valid=_put(np.asarray(valid, bool), device))


def links_from_numpy(dR, dp, dt, vel, grav, valid, device="cuda") -> ImuLinks:
    """numpy ImuLinks fields -> ba.ImuLinks on `device`."""
    f = [_put(np.asarray(a, np.float32), device) for a in (dR, dp, dt, vel,
                                                           grav)]
    return ImuLinks(*f, valid=_put(np.asarray(valid, bool), device))


def photo_from_numpy(img, inv_expo, pts_w, target, valid, scale,
                     device="cuda") -> PhotoFactors:
    """numpy PhotoFactors fields -> ba.PhotoFactors on `device`."""
    f = [_put(np.asarray(a, np.float32), device)
         for a in (img, inv_expo, pts_w, target)]
    return PhotoFactors(*f, valid=_put(np.asarray(valid, bool), device),
                        scale=_put(np.asarray(scale, np.int32), device))


# The JAX checkpoint flattens the dict {"noise", "packed", "pool", "ring",
# "vmap"} in sorted-key order, NamedTuple fields in field order, into
# leaf_0, leaf_1, ...: (name, leaf count). `noise` has no leaves when it
# was still None (saved before the IMU initialised).
_JAX_LEAVES = (("noise", 9), ("packed", 1), ("pool", 4), ("ring", 2),
               ("vmap", 3))


def load_jax_checkpoint(path: str, pipeline) -> None:
    """Restore a checkpoint of the JAX package's LIVOPipeline (format v5)
    into a freshly constructed port pipeline of the same configuration:
    device state, host scalars, the in-flight prefetch packet (the two
    packages' wire formats are the same bytes) and the streaming state.
    The pool and ring are taken where the port's mode has them (LIVO),
    and the backend's keyframes, refined poses and last submit count
    (v4 and later) where the checkpoint carries them."""
    from . import checkpoint

    meta, a = checkpoint.read(path)
    if meta.get("version", 1) < 5:
        raise ValueError(f"{path}: JAX checkpoint version "
                         f"{meta.get('version', 1)} predates the v5 voxel-map "
                         "layout (keys, stats, rec)")
    n_leaves = sum(k.startswith("leaf_") for k in a)
    names = _JAX_LEAVES if n_leaves == 19 else _JAX_LEAVES[1:]
    if n_leaves != sum(n for _, n in names):
        raise ValueError(f"{path}: {n_leaves} state leaves, expected 19 "
                         "(or 10 before the IMU initialised)")
    leaves, i = {}, 0
    for name, n in names:
        leaves[name] = [a[f"leaf_{i + j}"] for j in range(n)]
        i += n
    checkpoint.restore(pipeline, meta, a, packed=leaves["packed"][0],
                       vmap=leaves["vmap"], pool=leaves["pool"],
                       ring=leaves["ring"], noise=leaves.get("noise"))

"""IMU forward propagation + covariance, and batched scan undistortion
(port of fast_livo2_tpu/core/imu.py).

- Forward propagation (reference IMU_Processing.cpp:322-439) over a
  fixed-size padded batch of IMU intervals, evaluated as prefixes: the
  rotation chain is a log-step doubling scan of 3x3 products, velocity
  and position are cumulative sums, and the 19x19 covariance recursion
  P <- F_i P F_i^T + Q_i goes to `ops.cov_scan.propagate_cov` — the
  hand-written CUDA kernel on the GPU, its plain sequential version on
  the CPU. Device placement alone picks between them.
- Backward per-point undistortion (reference :494-539) is one batched
  interval lookup (a one-hot matmul over the K <= 64 pose rows) plus the
  closed-form segment transform.

Deviation from the reference, inherited from the JAX package: a point in
interval i uses interval i's own midpoint rates (the reference reads the
previous interval's rates stored at the interval-start pose).

`prepare_imu_batch` (the ragged->fixed batching of one packet) is host
numpy. `imu_rate_odometry` comes with ROADMAP.md Queue 1 item 13.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..ops import cov_scan, so3
from .state import DIM_STATE, GRAVITY, NavState


class ImuNoise(NamedTuple):
    """Continuous-time noise densities and estimation toggles (0/1
    floats, as in the JAX package)."""

    cov_gyr: torch.Tensor  # (3,)
    cov_acc: torch.Tensor  # (3,)
    cov_bias_gyr: torch.Tensor  # (3,)
    cov_bias_acc: torch.Tensor  # (3,)
    cov_inv_expo: torch.Tensor  # ()
    mean_acc_norm: torch.Tensor  # () |mean static acc|, scales raw acc
    est_bias: torch.Tensor  # () 1.0 if ba/bg estimated
    est_gravity: torch.Tensor  # () 1.0 if gravity estimated
    est_exposure: torch.Tensor  # () 1.0 if exposure estimated


def make_noise(acc_cov=0.5, gyr_cov=0.3, b_acc_cov=1e-4, b_gyr_cov=1e-4,
               inv_expo_cov=0.1, mean_acc_norm=GRAVITY,
               est_bias=True, est_gravity=True, est_exposure=True,
               device="cuda") -> ImuNoise:
    def full3(v):
        return torch.full((3,), float(v), dtype=torch.float32, device=device)

    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float32, device=device)

    return ImuNoise(
        cov_gyr=full3(gyr_cov), cov_acc=full3(acc_cov),
        cov_bias_gyr=full3(b_gyr_cov), cov_bias_acc=full3(b_acc_cov),
        cov_inv_expo=scalar(inv_expo_cov),
        mean_acc_norm=scalar(np.float32(mean_acc_norm)),
        est_bias=scalar(1.0 if est_bias else 0.0),
        est_gravity=scalar(1.0 if est_gravity else 0.0),
        est_exposure=scalar(1.0 if est_exposure else 0.0),
    )


class ImuBatch(NamedTuple):
    """Fixed-size padded batch of IMU integration intervals for one
    propagation span [prop_beg, prop_end]."""

    gyr: torch.Tensor  # (K, 3) midpoint angular velocity (raw, rad/s)
    acc: torch.Tensor  # (K, 3) midpoint specific force (raw units)
    dt: torch.Tensor  # (K,) integration step, 0 for padding
    offs_end: torch.Tensor  # (K,) interval end time relative to prop_beg
    valid: torch.Tensor  # (K,) 1.0 for real intervals


class ImuPoses(NamedTuple):
    """Per-interval start poses from propagation, consumed by
    undistortion: row i is the state at the START of interval i plus that
    interval's world-frame rates."""

    offs_start: torch.Tensor  # (K,)
    offs_end: torch.Tensor  # (K,)
    rot: torch.Tensor  # (K, 3, 3)
    pos: torch.Tensor  # (K, 3)
    vel: torch.Tensor  # (K, 3)
    acc_w: torch.Tensor  # (K, 3) world-frame acceleration over interval i
    gyr_unbiased: torch.Tensor  # (K, 3)
    valid: torch.Tensor  # (K,)


def prepare_imu_batch(stamps: np.ndarray, gyr: np.ndarray, acc: np.ndarray,
                      prop_beg: float, prop_end: float, max_k: int):
    """Host-side ragged->fixed batching of one packet's IMU samples
    (numpy fields; callers upload).

    `stamps/gyr/acc` include the last sample of the previous packet at
    the front (the reference pushes `last_imu`, IMU_Processing.cpp:245).
    The dt/offset cut rules mirror :355-372: the first interval is
    clipped to start at prop_beg and the last to end at prop_end."""
    stamps = np.asarray(stamps, np.float64)
    n = len(stamps) - 1
    g = np.zeros((max_k, 3), np.float32)
    a = np.zeros((max_k, 3), np.float32)
    dt = np.zeros(max_k, np.float32)
    offs = np.zeros(max_k, np.float32)
    valid = np.zeros(max_k, np.float32)
    k = 0
    for i in range(n):
        t_head, t_tail = stamps[i], stamps[i + 1]
        if t_tail < prop_beg:
            continue
        if k >= max_k:
            break
        g[k] = 0.5 * (gyr[i] + gyr[i + 1])
        a[k] = 0.5 * (acc[i] + acc[i + 1])
        if t_head < prop_beg:
            d = t_tail - prop_beg
            o = t_tail - prop_beg
        elif i != n - 1:
            d = t_tail - t_head
            o = t_tail - prop_beg
        else:
            d = prop_end - t_head
            o = prop_end - prop_beg
        dt[k] = max(d, 0.0)
        offs[k] = o
        valid[k] = 1.0
        k += 1
    # Pad offsets past the end so the interval lookup sends no point out
    # of range.
    if k > 0:
        offs[k:] = offs[k - 1] + 1e6
    else:
        offs[:] = 1e6
    return ImuBatch(gyr=g, acc=a, dt=dt, offs_end=offs, valid=valid)


def batch_to_device(batch: ImuBatch, device) -> ImuBatch:
    return ImuBatch(*(torch.as_tensor(x, device=device) for x in batch))


def _prefix_products(M: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products M[0] M[1] ... M[i] over the leading axis
    as a log-step doubling scan: ceil(log2 K) batched matmuls instead of
    K sequential ones (the JAX package uses lax.associative_scan; the
    association differs, so rounding differs at float32 ulp level)."""
    out = M
    d = 1
    while d < M.shape[0]:
        out = torch.cat([out[:d], out[:-d] @ out[d:]], dim=0)
        d *= 2
    return out


def propagate(state: NavState, cov: torch.Tensor, batch: ImuBatch,
              noise: ImuNoise):
    """Forward-propagate state + covariance through one IMU batch
    (IMU_Processing.cpp:327-431). Returns (state_prop, cov_prop,
    ImuPoses). Padding intervals have dt=0 and are exact no-ops
    (Exp=I, F=I, Q=0)."""
    f32 = cov.dtype
    dev = cov.device
    K = batch.dt.shape[0]
    dt = batch.dt
    dt2 = dt * dt
    w = batch.gyr - state.bias_g  # (K, 3)
    a = batch.acc * (GRAVITY / noise.mean_acc_norm) - state.bias_a

    # Rotation prefix: R_incl[i] = R_0 Exp_0 ... Exp_i (post-step i).
    dExp = so3.exp(w * dt[:, None])  # (K, 3, 3)
    prod = _prefix_products(dExp)
    R_incl = torch.einsum("ij,kjl->kil", state.rot, prod)
    R_start = torch.cat([state.rot[None], R_incl[:-1]], dim=0)

    # Velocity / position prefixes (post-step R for acc_w, :412-415).
    acc_w = torch.einsum("kij,kj->ki", R_incl, a) + state.grav
    dv = acc_w * dt[:, None]
    v_start = state.vel + torch.cumsum(dv, dim=0) - dv
    dp = v_start * dt[:, None] + 0.5 * acc_w * dt2[:, None]
    p_start = state.pos + torch.cumsum(dp, dim=0) - dp
    v_end = v_start[-1] + dv[-1]
    p_end = p_start[-1] + dp[-1]
    R_end = R_incl[-1]

    # Batched F_i / Q_i blocks (IMU_Processing.cpp:377-431).
    I3dt = torch.eye(3, dtype=f32, device=dev)[None] * dt[:, None, None]
    F = torch.eye(DIM_STATE, dtype=f32, device=dev).repeat(K, 1, 1)
    F[:, 0:3, 0:3] = dExp.transpose(-1, -2)  # Exp(w, -dt)
    F[:, 0:3, 10:13] = -I3dt * noise.est_bias
    F[:, 3:6, 7:10] = I3dt
    F[:, 7:10, 0:3] = -(R_start @ so3.skew(a)) * dt[:, None, None]
    F[:, 7:10, 13:16] = -R_start * dt[:, None, None] * noise.est_bias
    F[:, 7:10, 16:19] = I3dt * noise.est_gravity

    Q = torch.zeros((K, DIM_STATE, DIM_STATE), dtype=f32, device=dev)
    Q[:, 6, 6] = noise.cov_inv_expo * dt2 * noise.est_exposure
    Q[:, 0:3, 0:3] = torch.diag(noise.cov_gyr)[None] * dt2[:, None, None]
    Racc = (R_start * noise.cov_acc[None, None, :]) @ R_start.transpose(-1, -2)
    Q[:, 7:10, 7:10] = Racc * dt2[:, None, None]
    Q[:, 10:13, 10:13] = torch.diag(noise.cov_bias_gyr)[None] * dt2[:, None, None]
    Q[:, 13:16, 13:16] = torch.diag(noise.cov_bias_acc)[None] * dt2[:, None, None]

    P_e = cov_scan.propagate_cov(F, Q, cov.contiguous())

    state_out = state._replace(rot=so3.normalize_rotation(R_end), pos=p_end,
                               vel=v_end)
    imu_poses = ImuPoses(offs_start=batch.offs_end - dt,
                         offs_end=batch.offs_end, rot=R_start, pos=p_start,
                         vel=v_start, acc_w=acc_w, gyr_unbiased=w,
                         valid=batch.valid)
    return state_out, P_e, imu_poses


def undistort(points: torch.Tensor, t_offs: torch.Tensor, poses: ImuPoses,
              state_end: NavState, ext_R: torch.Tensor, ext_T: torch.Tensor):
    """Motion-compensate LiDAR points (N, 3) to the scan-end IMU frame;
    t_offs (N,) seconds from the propagation start:

        P_comp = extR^T ( R_end^T ( R_i (extR P + extT) + T_ei ) - extT )
        R_i  = R_head Exp(w_i dt),  dt = t - offs_start_i
        T_ei = p_head + v_head dt + 0.5 a_i dt^2 - p_end
    """
    K = poses.offs_end.shape[0]
    idx = torch.sum(poses.offs_end[None, :] < t_offs[:, None], dim=1)
    idx = torch.clamp(idx, 0, K - 1)
    onehot = (idx[:, None] == torch.arange(K, device=points.device)[None, :]
              ).to(points.dtype)
    table = torch.cat(
        [poses.offs_start[:, None], poses.rot.reshape(K, 9), poses.pos,
         poses.vel, poses.acc_w, poses.gyr_unbiased], dim=-1,
    )  # (K, 22)
    g = onehot @ table  # (N, 22)
    R_h = g[:, 1:10].reshape(-1, 3, 3)
    p_h = g[:, 10:13]
    v_h = g[:, 13:16]
    a_h = g[:, 16:19]
    w_h = g[:, 19:22]
    dt = torch.clamp(t_offs - g[:, 0], min=0.0)

    R_i = R_h @ so3.exp(w_h * dt[:, None])
    T_ei = p_h + v_h * dt[:, None] + 0.5 * a_h * dt[:, None] ** 2 - state_end.pos

    p_imu = points @ ext_R.T + ext_T  # body -> IMU frame at sample time
    p_world_rel = torch.einsum("nij,nj->ni", R_i, p_imu) + T_ei
    p_end_imu = p_world_rel @ state_end.rot  # R_end^T applied from the right
    return (p_end_imu - ext_T) @ ext_R


def static_init(acc_samples: np.ndarray, gyr_samples: np.ndarray):
    """IMU static initialization (reference IMU_init, :104-149): gravity
    from the mean specific force; returns (gravity_vec (3,) float32,
    mean_acc_norm). Host-side numpy."""
    mean_acc = np.mean(np.asarray(acc_samples, np.float64), axis=0)
    norm = float(np.linalg.norm(mean_acc))
    gravity = -mean_acc / norm * GRAVITY
    return gravity.astype(np.float32), np.float32(norm)


def propagate_without_imu(state: NavState, cov: torch.Tensor, dt,
                          noise: ImuNoise):
    """Constant-velocity propagation for IMU-less (LO) operation
    (Forward_without_imu, IMU_Processing.cpp:151-234); the gyro-bias
    block doubles as the constant angular-velocity estimate (:183-188)."""
    f32 = cov.dtype
    dev = cov.device
    eye3 = torch.eye(3, dtype=f32, device=dev)
    F = torch.eye(DIM_STATE, dtype=f32, device=dev)
    F[0:3, 0:3] = so3.exp(state.bias_g, -dt)
    F[0:3, 10:13] = eye3 * dt
    F[3:6, 7:10] = eye3 * dt
    Q = torch.zeros((DIM_STATE, DIM_STATE), dtype=f32, device=dev)
    Q[10:13, 10:13] = torch.diag(noise.cov_gyr) * dt * dt
    Q[7:10, 7:10] = torch.diag(noise.cov_acc) * dt * dt
    cov_new = F @ cov @ F.T + Q
    state_new = state._replace(
        rot=state.rot @ so3.exp(state.bias_g, dt),
        pos=state.pos + state.vel * dt,
    )
    return state_new, cov_new


def undistort_without_imu(points: torch.Tensor, t_offs: torch.Tensor,
                          t_end_offset, state: NavState):
    """Constant-velocity backward undistortion (Forward_without_imu,
    IMU_Processing.cpp:215-233): rotate by Exp(w, -dt_j) and shift by
    -R^T v dt_j, dt_j = time from the point to scan end."""
    dt_j = torch.clamp(t_end_offset - t_offs, min=0.0)
    R_jk = so3.exp(-state.bias_g[None, :] * dt_j[:, None])
    p_jk = -(state.rot.T @ state.vel)[None, :] * dt_j[:, None]
    return torch.einsum("nij,nj->ni", R_jk, points) + p_jk

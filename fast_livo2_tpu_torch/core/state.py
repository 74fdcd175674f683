"""The 19-dim filter state (port of fast_livo2_tpu/core/state.py).

Mirrors the reference StatesGroup (include/common_lib.h:126-223); the
error state is ordered

    [ rot(0:3)  pos(3:6)  inv_expo(6)  vel(7:10)  bias_g(10:13)
      bias_a(13:16)  gravity(16:19) ]

with the rotation on SO(3) (a 3x3 matrix) and everything else in R^n.
`boxplus` / `boxminus` are the manifold retraction pair
(common_lib.h:167-206). The packed vector layout of `pack_state` is the
JAX package's, element for element, so state moves between the two
packages as one array (io/convert.py).
"""

from typing import NamedTuple

import torch

from ..ops import so3

DIM_STATE = 19
GRAVITY = 9.81  # common_lib.h:29
INIT_COV = 0.01  # common_lib.h:31
PACKED_LEN = 25 + DIM_STATE * DIM_STATE


class NavState(NamedTuple):
    """Nominal state. All float32; rot is a 3x3 rotation matrix."""

    rot: torch.Tensor  # (3, 3) R_world_from_imu at scan/frame end
    pos: torch.Tensor  # (3,)
    vel: torch.Tensor  # (3,)
    bias_g: torch.Tensor  # (3,)
    bias_a: torch.Tensor  # (3,)
    grav: torch.Tensor  # (3,)
    inv_expo: torch.Tensor  # () inverse exposure time


def init_state(device="cuda", dtype=torch.float32) -> NavState:
    z = torch.zeros(3, dtype=dtype, device=device)
    return NavState(
        rot=torch.eye(3, dtype=dtype, device=device),
        pos=z, vel=z.clone(), bias_g=z.clone(), bias_a=z.clone(),
        grav=z.clone(),
        inv_expo=torch.tensor(1.0, dtype=dtype, device=device),
    )


def init_cov(device="cuda", dtype=torch.float32) -> torch.Tensor:
    """Initial covariance (common_lib.h:137-139): 0.01 I, except
    var(inv_expo)=1e-5 and var(biases+gravity)=1e-5."""
    cov = torch.eye(DIM_STATE, dtype=dtype, device=device) * INIT_COV
    cov[6, 6] = 1e-5
    cov[10:19, 10:19] = torch.eye(9, dtype=dtype, device=device) * 1e-5
    return cov


def boxplus(s: NavState, delta: torch.Tensor) -> NavState:
    """State ⊞ 19-vector (common_lib.h:167-180); rotation retracted on
    the right: R <- R Exp(delta[0:3])."""
    return NavState(
        rot=s.rot @ so3.exp(delta[0:3]),
        pos=s.pos + delta[3:6],
        inv_expo=s.inv_expo + delta[6],
        vel=s.vel + delta[7:10],
        bias_g=s.bias_g + delta[10:13],
        bias_a=s.bias_a + delta[13:16],
        grav=s.grav + delta[16:19],
    )


def boxminus(a: NavState, b: NavState) -> torch.Tensor:
    """a ⊟ b -> 19-vector (common_lib.h:194-206): Log(b.R^T a.R) for the
    rotation block, plain differences elsewhere."""
    return torch.cat([
        so3.log(b.rot.T @ a.rot),
        a.pos - b.pos,
        (a.inv_expo - b.inv_expo).reshape(1),
        a.vel - b.vel,
        a.bias_g - b.bias_g,
        a.bias_a - b.bias_a,
        a.grav - b.grav,
    ])


def select(c: torch.Tensor, a, b):
    """`a` where the 0-d bool `c` holds, else `b`, field by field, for
    NamedTuples of tensors (NavState, PlaneMatch): the masked update of
    the device loops (core/lio.py, core/vio.py)."""
    return type(a)(*(torch.where(c, x, y) for x, y in zip(a, b)))


def pack_state(s: NavState, cov: torch.Tensor) -> torch.Tensor:
    """State + covariance as ONE (PACKED_LEN,) vector — the JAX
    package's layout: rot(9) pos vel bias_g bias_a grav inv_expo cov."""
    return torch.cat([
        s.rot.reshape(9), s.pos, s.vel, s.bias_g, s.bias_a, s.grav,
        s.inv_expo.reshape(1), cov.reshape(DIM_STATE * DIM_STATE),
    ])


def unpack_state(v: torch.Tensor):
    s = NavState(
        rot=v[0:9].reshape(3, 3), pos=v[9:12], vel=v[12:15],
        bias_g=v[15:18], bias_a=v[18:21], grav=v[21:24], inv_expo=v[24],
    )
    cov = v[25:PACKED_LEN].reshape(DIM_STATE, DIM_STATE)
    return s, cov

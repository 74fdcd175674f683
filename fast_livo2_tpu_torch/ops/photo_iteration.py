"""One photometric ESIKF iteration over M tracked points, fused (port of
TPU kernel K2, fast_livo2_tpu/ops/pallas_photo.py:photo_iteration).

`photo_iteration` is the wrapper `core/vio.photometric_update` calls
once per iteration (up to pyramid levels x max_iterations a frame). It
computes, per point: the pinhole (+radtan) projection, a 12 x 12
superpatch of the level-0 image at stride s = 2^clip(slog, 0,
max_scale_log2), bilinear val/du/dv on the 8 x 8 patch, the residual
tau * val - ref, ten patch sums and from them, in closed form, one row
[HTH (49) | HTz (7) | err | cnt] (H_c = a_c du + b_c dv for c < 6,
H_6 = expo * val); then the rows summed over points.

On CUDA tensors it launches the hand-written kernel
`csrc/photo_iteration.cu` (one launch: one warp per point, eight points
a block, the sum over blocks by the last block to finish, in a fixed
order; the source says what bounds it) or raises: there is no fallback.
The call takes the shared launch path of ops/_launch.py; its scratch
(the blocks' partial rows and the last-block ticket) is allocated once
per device and stream and grows with M, so a call allocates only its
64-float output and never waits for the device. On CPU tensors it runs
`photo_iteration_plain`, the same function in PyTorch ops. `LAUNCHES`
counts calls that launched the kernel, never plain-version calls.

Semantics kept from the TPU kernel, and not those of the torch-op path
in core/vio.py (which samples through ops/image):
- the stride exponent is clamped to max_scale_log2 (4 by default,
  lowered on the host while 12 * 2^s > W), so pyramid level 3 + search
  level 2 samples at stride 16, not 32;
- the window base is clipped as the TPU kernel clips it: each of the 12
  rows to [0, H-1] on its own, the 12 columns as one block
  (x0 = clip(x0, 0, W - 12 s)), where the torch-op sampler clips every
  tap on its own;
- okf = ok & (z > 1e-6); z is guarded at 1e-9; radtan is applied only
  when has_dist > 0.5; cnt = okf * 64.
One addition: the window base floor(u / s) * s is clamped to +-2^30
before the integer conversion, so that a point projecting out of
int32 range reads a clipped window on both devices (the conversion of
such a value is undefined in C++ and differs between CPU and GPU).
"""

import ctypes
import functools

import torch

from . import _launch

# pts_meta layout (per point): pos(0:3) | scale_log2(3) | ok(4); pad 8.
META_W = 8
# params layout: Rcw(0:9) | Pcw(9:12) | tau(12) | Jdphi_dR(13:22) |
# Jdp_dR(22:31) | fx fy cx cy (31:35) | k1 k2 p1 p2 (35:39) |
# expo_flag(39) | has_dist(40); padded to 64.
PAR_W = 64
OUT_W = 64  # HTH(49) | HTz(7) | err(56) | cnt(57) | pad

WIN = 12  # superpatch rows/cols (ps + 4 at ps = 8)
PS = 8
_FLOOR_CLAMP = float(1 << 30)

BLOCK_POINTS = 8  # points a block of the kernel (one warp each)
_F32 = torch.float32
_PAR_SHAPE = (1, PAR_W)

LAUNCHES = 0

_fn = None
# (device, raw stream) -> (partials (blocks, OUT_W) f32, ticket (1,) int32)
_SCRATCH = {}


def clamp_scale_log2(width: int, max_scale_log2: int = 4) -> int:
    """The largest stride exponent whose 12-tap window fits the width
    (pallas_photo.py:214-218)."""
    while (1 << max_scale_log2) * WIN > width and max_scale_log2 > 0:
        max_scale_log2 -= 1
    return max_scale_log2


def pack_points(pos, ref_patch, scale_log2, ok, ps: int = 8):
    """((M, META_W), (M, ps, ps)) point inputs of photo_iteration."""
    M = pos.shape[0]
    cols = [pos.to(torch.float32), scale_log2.to(torch.float32)[:, None],
            ok.to(torch.float32)[:, None],
            pos.new_zeros((M, META_W - 5), dtype=torch.float32)]
    return (torch.cat(cols, dim=-1),
            ref_patch.reshape(M, ps, ps).to(torch.float32).contiguous())


def pack_params(Rcw, Pcw, tau, Jdphi_dR, Jdp_dR, fx, fy, cx, cy, dist,
                expo_flag: float, has_dist: float):
    """(1, PAR_W) parameter row of photo_iteration, on the device of Rcw.
    The camera columns (fx .. has_dist, Python floats) are uploaded once
    per camera and device, so a call makes no host-to-device copy."""
    f = torch.float32
    tail = _camera_columns(
        (float(fx), float(fy), float(cx), float(cy))
        + tuple(float(x) for x in tuple(dist)[:4])
        + (float(expo_flag), float(has_dist)), str(Rcw.device))
    row = torch.cat([
        Rcw.reshape(9).to(f), Pcw.reshape(3).to(f), tau.reshape(1).to(f),
        Jdphi_dR.reshape(9).to(f), Jdp_dR.reshape(9).to(f), tail])
    return row[None, :]


@functools.lru_cache(maxsize=16)
def _camera_columns(values: tuple, device: str) -> torch.Tensor:
    """Columns 31:64 of the parameter row (the camera, the flags and the
    zero padding) as one device tensor; callers never write to it."""
    return torch.tensor(values + (0.0,) * (PAR_W - 41), dtype=torch.float32,
                        device=device)


def _project(pts_meta, params):
    """Per-point projection scalars of the TPU kernel: (pf (x, y, z),
    guarded z, u, v, okf)."""
    P = params[0]
    Rcw = [[P[3 * r + c] for c in range(3)] for r in range(3)]
    Pcw = [P[9], P[10], P[11]]
    fx, fy, cx, cy = P[31], P[32], P[33], P[34]
    k1, k2, p1, p2 = P[35], P[36], P[37], P[38]
    has_dist = P[40]
    pos = [pts_meta[:, 0], pts_meta[:, 1], pts_meta[:, 2]]
    ok0 = pts_meta[:, 4] > 0.5

    pfx = Rcw[0][0] * pos[0] + Rcw[0][1] * pos[1] + Rcw[0][2] * pos[2] + Pcw[0]
    pfy = Rcw[1][0] * pos[0] + Rcw[1][1] * pos[1] + Rcw[1][2] * pos[2] + Pcw[1]
    pfz = Rcw[2][0] * pos[0] + Rcw[2][1] * pos[1] + Rcw[2][2] * pos[2] + Pcw[2]
    z_ok = pfz > 1e-6
    z = torch.where(pfz.abs() < 1e-9, 1e-9, pfz)
    un = pfx / z
    vn = pfy / z
    r2 = un * un + vn * vn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    ud = un * radial + 2 * p1 * un * vn + p2 * (r2 + 2 * un * un)
    vd = vn * radial + p1 * (r2 + 2 * vn * vn) + 2 * p2 * un * vn
    uu = torch.where(has_dist > 0.5, ud, un)
    vv = torch.where(has_dist > 0.5, vd, vn)
    u = fx * uu + cx
    v = fy * vv + cy
    okf = torch.where(ok0 & z_ok, 1.0, 0.0)
    return (pfx, pfy, pfz), z, u, v, okf


def _window(H, W, u, v, slog, max_scale_log2: int):
    """The clamped stride sd (M,) and the clipped 12 x 12 window: row and
    column indices (M, 12) each."""
    lo = -(PS // 2) - 1  # superpatch base offset
    sd = torch.ones_like(slog) << torch.clamp(slog, 0, max_scale_log2)
    sf = sd.to(torch.float32)
    ui = torch.clamp(torch.floor(u / sf) * sf, -_FLOOR_CLAMP, _FLOOR_CLAMP)
    vi = torch.clamp(torch.floor(v / sf) * sf, -_FLOOR_CLAMP, _FLOOR_CLAMP)
    x0 = ui.to(torch.int32) + lo * sd
    y0 = vi.to(torch.int32) + lo * sd
    x0 = torch.minimum(torch.clamp(x0, min=0), W - WIN * sd)
    taps = torch.arange(WIN, dtype=torch.int32, device=u.device)
    rows = torch.clamp(y0[:, None] + taps[None, :] * sd[:, None], 0, H - 1)
    cols = x0[:, None] + taps[None, :] * sd[:, None]
    return sd, rows, cols


def window_taps(img_shape, pts_meta, params, max_scale_log2: int = 4):
    """(M, 144) flat image indices the iteration reads: the clipped
    windows of every point (for counting the bytes a call needs)."""
    H, W = img_shape
    _, _, u, v, _ = _project(pts_meta, params)
    msl = clamp_scale_log2(W, max_scale_log2)
    _, rows, cols = _window(H, W, u, v, pts_meta[:, 3].to(torch.int32), msl)
    return (rows.long()[:, :, None] * W + cols.long()[:, None, :]).reshape(
        rows.shape[0], -1)


def _point_rows_plain(img, pts_meta, ref_patch, params, max_scale_log2: int):
    """(M, OUT_W) per-point rows, the TPU kernel's arithmetic over a
    batch of points."""
    H, W = img.shape
    M = pts_meta.shape[0]
    P = params[0]
    Rcw = [[P[3 * r + c] for c in range(3)] for r in range(3)]
    tau = P[12]
    JdphiR = [[P[13 + 3 * r + c] for c in range(3)] for r in range(3)]
    JdpR = [[P[22 + 3 * r + c] for c in range(3)] for r in range(3)]
    fx, fy = P[31], P[32]
    expo_flag = P[39]

    (pfx, pfy, pfz), z, u, v, okf = _project(pts_meta, params)
    sd, rows, cols = _window(H, W, u, v, pts_meta[:, 3].to(torch.int32),
                             max_scale_log2)
    sf = sd.to(torch.float32)
    sp = img[rows.long()[:, :, None], cols.long()[:, None, :]]  # (M, 12, 12)

    su = ((u - torch.floor(u / sf) * sf) / sf)[:, None, None]
    sv = ((v - torch.floor(v / sf) * sf) / sf)[:, None, None]
    w_tl = (1 - su) * (1 - sv)
    w_tr = su * (1 - sv)
    w_bl = (1 - su) * sv
    w_br = su * sv

    def bil(r0, c0):
        blk = sp[:, r0:r0 + PS + 1, c0:c0 + PS + 1]
        return (w_tl * blk[:, :PS, :PS] + w_tr * blk[:, :PS, 1:]
                + w_bl * blk[:, 1:, :PS] + w_br * blk[:, 1:, 1:])

    val = bil(1, 1)
    du = 0.5 * (bil(1, 2) - bil(1, 0))
    dv = 0.5 * (bil(2, 1) - bil(0, 1))
    res = tau * val - ref_patch

    # H_c = a[c] du + b[c] dv for c in 0..5; H_6 = expo * val.
    zi = 1.0 / z
    zi2 = zi * zi
    g = tau / sf
    zero = zi * 0.0
    A = [fx * zi, zero, -fx * pfx * zi2]   # Jdpi row 0
    B = [zero, fy * zi, -fy * pfy * zi2]   # Jdpi row 1
    ph = [[zero, -pfz, pfy],
          [pfz, zero, -pfx],
          [-pfy, pfx, zero]]               # skew(pf)
    PA = [A[0] * ph[0][c] + A[1] * ph[1][c] + A[2] * ph[2][c] for c in range(3)]
    PB = [B[0] * ph[0][c] + B[1] * ph[1][c] + B[2] * ph[2][c] for c in range(3)]

    def dot3(x, m, c):
        return x[0] * m[0][c] + x[1] * m[1][c] + x[2] * m[2][c]

    a = [g * (dot3(PA, JdphiR, c) - dot3(A, JdpR, c)) for c in range(3)]
    b = [g * (dot3(PB, JdphiR, c) - dot3(B, JdpR, c)) for c in range(3)]
    a += [-g * dot3(A, Rcw, c) for c in range(3)]
    b += [-g * dot3(B, Rcw, c) for c in range(3)]

    def S(x, y):
        return okf * torch.sum(x * y, dim=(1, 2))

    S_uu, S_uv, S_vv = S(du, du), S(du, dv), S(dv, dv)
    S_uval, S_vval, S_valval = S(du, val), S(dv, val), S(val, val)
    S_ures, S_vres, S_valres = S(du, res), S(dv, res), S(val, res)
    S_resres = S(res, res)

    hth = []
    for c in range(7):
        for d in range(7):
            if c < 6 and d < 6:
                e = (a[c] * a[d] * S_uu + (a[c] * b[d] + b[c] * a[d]) * S_uv
                     + b[c] * b[d] * S_vv)
            elif c < 6:
                e = expo_flag * (a[c] * S_uval + b[c] * S_vval)
            elif d < 6:
                e = expo_flag * (a[d] * S_uval + b[d] * S_vval)
            else:
                e = expo_flag * expo_flag * S_valval
            hth.append(e)
    htz = [a[c] * S_ures + b[c] * S_vres for c in range(6)]
    htz.append(expo_flag * S_valres)
    cols_out = hth + htz + [S_resres, okf * (PS * PS)]
    out = torch.stack(cols_out, dim=-1)
    return torch.cat([out, out.new_zeros((M, OUT_W - out.shape[1]))], dim=-1)


def _unpack(tot):
    return tot[0:49].reshape(7, 7), tot[49:56], tot[56], tot[57]


def photo_iteration_plain(img, pts_meta, ref_patch, params, ps: int = 8,
                          max_scale_log2: int = 4):
    """The fused iteration in PyTorch ops, with the kernel's clamp and
    window clipping. Returns (HTH7 (7, 7), HTz7 (7,), err_sum (), cnt ())."""
    msl = clamp_scale_log2(img.shape[-1], max_scale_log2)
    rows = _point_rows_plain(img, pts_meta, ref_patch, params, msl)
    return _unpack(torch.sum(rows, dim=0))


def _kernel():
    global _fn
    if _fn is None:
        # img, meta, ref, par, partials, ticket, out, H, W, M,
        # max_scale_log2, device, stream
        _fn = _launch.load("photo_iteration", "photo_iteration_launch",
                           [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
    return _fn


def _scratch(img, dev: int, stream: int, blocks: int):
    """The kernel's scratch for this device and stream: partial rows for
    at least `blocks` blocks, and the ticket, zeroed once here (every
    launch leaves it at 0). Kernels on one stream run in order, so they
    can share it; another stream gets its own."""
    s = _SCRATCH.get((dev, stream))
    if s is None or s[0].shape[0] < blocks:
        ticket = img.new_zeros((1,), dtype=torch.int32) if s is None else s[1]
        s = _SCRATCH[(dev, stream)] = (img.new_empty((blocks, OUT_W)), ticket)
    return s


def _diagnose(img, pts_meta, ref_patch, params, ps):
    """The wrapper's checks one by one (its slow path): raises for the
    first that fails."""
    if ps != PS:
        raise ValueError(f"photo_iteration: the kernel takes ps = {PS}, got {ps}")
    if img.dim() != 2:
        raise ValueError(f"photo_iteration: img must be (H, W), got "
                         f"{tuple(img.shape)}")
    H, W = img.shape
    M = pts_meta.shape[0]
    if W < WIN:
        raise ValueError(f"photo_iteration: image width {W} < {WIN}")
    _launch.diagnose("photo_iteration", "img", img, (
        ("img", img, (H, W), _F32), ("pts_meta", pts_meta, (M, META_W), _F32),
        ("ref_patch", ref_patch, (M, PS, PS), _F32),
        ("params", params, _PAR_SHAPE, _F32)))


def photo_iteration(img, pts_meta, ref_patch, params, ps: int = 8,
                    max_scale_log2: int = 4):
    """One fused photometric iteration.

    img: (H, W) f32; pts_meta: (M, META_W); ref_patch: (M, ps, ps);
    params: (1, PAR_W). Returns (HTH7 (7, 7), HTz7 (7,), err_sum (),
    cnt ()). CPU tensors run the plain version; CUDA tensors launch the
    kernel."""
    dev = img.get_device()
    if not (dev >= 0 and img.is_cuda and ps == PS
            and pts_meta.get_device() == dev
            and ref_patch.get_device() == dev and params.get_device() == dev
            and img.dtype == _F32 and pts_meta.dtype == _F32
            and ref_patch.dtype == _F32 and params.dtype == _F32
            and img.dim() == 2 and img.shape[1] >= WIN
            and pts_meta.dim() == 2 and pts_meta.shape[1] == META_W
            and ref_patch.shape == (pts_meta.shape[0], PS, PS)
            and params.shape == _PAR_SHAPE and img.is_contiguous()
            and pts_meta.is_contiguous() and ref_patch.is_contiguous()
            and params.is_contiguous()):
        if _launch.on_cpu("photo_iteration", img):
            return photo_iteration_plain(img, pts_meta, ref_patch, params, ps,
                                         max_scale_log2)
        _diagnose(img, pts_meta, ref_patch, params, ps)
    H, W = img.shape
    M = pts_meta.shape[0]
    stream = _launch.raw_stream(dev)
    partials, ticket = _scratch(img, dev, stream,
                                max(1, -(-M // BLOCK_POINTS)))
    tot = img.new_empty((OUT_W,))
    err = (_fn or _kernel())(img.data_ptr(), pts_meta.data_ptr(),
                             ref_patch.data_ptr(), params.data_ptr(),
                             partials.data_ptr(), ticket.data_ptr(),
                             tot.data_ptr(), H, W, M, max_scale_log2, dev,
                             stream)
    if err:
        _launch.fail("photo_iteration", err)
    global LAUNCHES
    LAUNCHES += 1
    return _unpack(tot)

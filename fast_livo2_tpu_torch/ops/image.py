"""Batched image sampling for the sparse-direct VIO (port of
fast_livo2_tpu/ops/image.py).

Replaces the reference's pointer-striding patch loops (getImagePatch
vio.cpp:203-225, the gradient/residual sampling of updateState
vio.cpp:1580-1630, vk::shiTomasiScore, vk::interpolateMat_8u) with
gathers over (N, patch²) index tensors.

Sampling convention (the reference's): a patch at "scale" s
(s = 2^(pyramid+search level)) reads the level-0 image at s-strided
offsets around floor(px/s)*s, bilinearly weighted by the sub-pixel
fraction of px/s, i.e. bilinear interpolation on the s-decimated grid.
Every tap is clipped to the image on its own (the fused kernel of
ops/photo_iteration clips its window differently; see there).
"""

import torch
import torch.nn.functional as F


def _gather(img: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """img (H, W), integer coords clamped to the image; xi=column, yi=row."""
    h, w = img.shape
    xi = torch.clamp(xi, 0, w - 1).long()
    yi = torch.clamp(yi, 0, h - 1).long()
    return img[yi, xi]


def patch_offsets(patch_size: int, device="cuda"):
    """(patch²,) integer column and row offsets, row-major like the
    reference patch layout (vio.cpp:216-224)."""
    half = patch_size // 2
    a = torch.arange(patch_size, dtype=torch.int32, device=device) - half
    dy, dx = torch.meshgrid(a, a, indexing="ij")
    return dx.reshape(-1), dy.reshape(-1)  # column, row offsets


def sample_patches(img: torch.Tensor, px: torch.Tensor, scale: torch.Tensor,
                   patch_size: int):
    """(N, patch²) strided patches at centers px (N, 2); scale (N,) int32
    stride (1 << level). Mirrors getImagePatch (vio.cpp:203-225)."""
    ps, half = patch_size, patch_size // 2
    sp, su, sv = _superpatch(img, px, scale, ps + 1, lo=-half)
    w_tl = ((1 - su) * (1 - sv))[:, None, None]
    w_tr = (su * (1 - sv))[:, None, None]
    w_bl = ((1 - su) * sv)[:, None, None]
    w_br = (su * sv)[:, None, None]
    return (
        w_tl * sp[:, :ps, :ps] + w_tr * sp[:, :ps, 1:]
        + w_bl * sp[:, 1:, :ps] + w_br * sp[:, 1:, 1:]
    ).reshape(px.shape[0], ps * ps)


def _superpatch(img: torch.Tensor, px: torch.Tensor, scale: torch.Tensor,
                size: int, lo: int, img_idx=None):
    """One gather of an s-strided (size x size) neighborhood per point:
    SP[n, l, k] = img(y0 + (l+lo)*s, x0 + (k+lo)*s), each tap clipped.
    img may be a stack (F, H, W) with per-point indices `img_idx` (N,).
    Returns (SP (N, size, size), su (N,), sv (N,))."""
    u, v = px[:, 0], px[:, 1]
    s = scale.to(torch.float32)
    ui = (torch.floor(u / s) * s).to(torch.int32)
    vi = (torch.floor(v / s) * s).to(torch.int32)
    su = (u.to(torch.float32) - ui) / s
    sv = (v.to(torch.float32) - vi) / s
    rng = ((torch.arange(size, dtype=torch.int32, device=px.device) + lo)[None, :]
           * scale.to(torch.int32)[:, None])
    h, w = img.shape[-2:]
    xi = torch.clamp(ui[:, None] + rng, 0, w - 1).long()  # (N, size)
    yi = torch.clamp(vi[:, None] + rng, 0, h - 1).long()
    if img_idx is None:
        sp = img[yi[:, :, None], xi[:, None, :]]  # (N, size, size)
    else:
        sp = img[img_idx.long()[:, None, None], yi[:, :, None], xi[:, None, :]]
    return sp, su, sv


def sample_patches_with_grad(img: torch.Tensor, px: torch.Tensor,
                             scale: torch.Tensor, patch_size: int, img_idx=None):
    """Patch values + strided central-difference gradients (du, dv), the
    sampling of updateState (vio.cpp:1595-1620). Returns three (N,
    patch²) tensors; gradients are in scaled pixel units (the caller's
    Jacobian chain applies 1/scale, :1613)."""
    ps, half = patch_size, patch_size // 2
    size = ps + 4  # offsets -half-1 .. half+2 relative to the base corner
    sp, su, sv = _superpatch(img, px, scale, size, lo=-half - 1, img_idx=img_idx)
    w_tl = ((1 - su) * (1 - sv))[:, None, None]
    w_tr = (su * (1 - sv))[:, None, None]
    w_bl = ((1 - su) * sv)[:, None, None]
    w_br = (su * sv)[:, None, None]

    def bil(r0, c0):
        """Bilinear values of the ps x ps patch whose top-left corner is
        superpatch row r0, column c0."""
        block = sp[:, r0:r0 + ps + 1, c0:c0 + ps + 1]
        return (
            w_tl * block[:, :ps, :ps] + w_tr * block[:, :ps, 1:]
            + w_bl * block[:, 1:, :ps] + w_br * block[:, 1:, 1:]
        ).reshape(px.shape[0], ps * ps)

    val = bil(1, 1)
    du = 0.5 * (bil(1, 2) - bil(1, 0))
    dv = 0.5 * (bil(2, 1) - bil(0, 1))
    return val, du, dv


def bilinear(img: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at float pixel coords (..., 2)
    (vk::interpolateMat_8u)."""
    u, v = px[..., 0], px[..., 1]
    x0 = torch.floor(u).to(torch.int32)
    y0 = torch.floor(v).to(torch.int32)
    su = u - x0
    sv = v - y0
    tl = _gather(img, x0, y0)
    tr = _gather(img, x0 + 1, y0)
    bl = _gather(img, x0, y0 + 1)
    br = _gather(img, x0 + 1, y0 + 1)
    return (1 - su) * (1 - sv) * tl + su * (1 - sv) * tr + (1 - su) * sv * bl + su * sv * br


def box_stack(img: torch.Tensor, n_levels: int) -> torch.Tensor:
    """(L, H, W) stack of aligned box means: level l pixel (y, x) is the
    mean of img over [y, y+2^l) x [x, x+2^l). Gathering level l at the
    s = 2^l strided taps reproduces bilinear interpolation on a
    vk::halfSample pyramid (the `true_pyramid` option)."""
    lvls = [img]
    for l in range(1, n_levels):
        s_ = 1 << l
        lvls.append(_box_sum(img, 0, s_ - 1) / float(s_ * s_))
    return torch.stack(lvls)


def _box_sum(a: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """S[y, x] = sum of a over [y+lo, y+hi] x [x+lo, x+hi] (inclusive),
    with edge-replicated out-of-range taps, via integral images."""
    pl, ph = -lo, hi
    ap = F.pad(a[None, None], (pl, ph, pl, ph), mode="replicate")[0, 0]
    ii = torch.cumsum(torch.cumsum(ap, dim=0), dim=1)
    ii = F.pad(ii, (1, 0, 1, 0))
    w = hi - lo + 1
    h_, w_ = a.shape
    # window for pixel p covers padded rows [p, p+w-1] -> ii[p+w] - ii[p]
    return (
        ii[w:w + h_, w:w + w_] - ii[:h_, w:w + w_]
        - ii[w:w + h_, :w_] + ii[:h_, :w_]
    )


def shi_tomasi_image(img: torch.Tensor, halfbox: int = 4) -> torch.Tensor:
    """Dense Shi-Tomasi score image: min eigenvalue of the averaged
    gradient structure tensor over a (2*halfbox)² box at every pixel."""
    imgp = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    dx = 0.5 * (imgp[1:-1, 2:] - imgp[1:-1, :-2])
    dy = 0.5 * (imgp[2:, 1:-1] - imgp[:-2, 1:-1])
    box = 2 * halfbox
    npix = box * box
    # patch_offsets(box) spans [-halfbox, halfbox-1] in both dims.
    dxx = _box_sum(dx * dx, -halfbox, halfbox - 1) / npix
    dyy = _box_sum(dy * dy, -halfbox, halfbox - 1) / npix
    dxy = _box_sum(dx * dy, -halfbox, halfbox - 1) / npix
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    return 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))


def shi_tomasi(img: torch.Tensor, px: torch.Tensor, halfbox: int = 4) -> torch.Tensor:
    """Shi-Tomasi corner score at (N, 2) pixel locations (vk::shiTomasiScore
    as used at vio.cpp:822): one gather from the dense score image."""
    score = shi_tomasi_image(img, halfbox)
    return _gather(score, px[:, 0].to(torch.int32), px[:, 1].to(torch.int32))

"""The launch path the three kernel wrappers share (ops/_launch.py), on the
CPU. A wrapper tests its inputs in one boolean expression; only when that
is false does its slow path (`_launch.on_cpu`, then the wrapper's
`_diagnose`) route a CPU call to the plain version or find the failed
check and raise. The card tests (tests/test_torch_cuda.py,
`*_rejects_bad_input`) see these exceptions through the wrappers; here
each wrapper's `_diagnose` is held to the exact type and message for a
wrong dtype, a non-contiguous input, a shape mismatch and mixed devices
(CPU and meta tensors), and the wrappers are held to route CPU tensors to
their plain versions without counting a launch."""

import re

import numpy as np
import pytest
import torch

from fast_livo2_tpu_torch.ops import _launch, cov_scan, gather
from fast_livo2_tpu_torch.ops import photo_iteration as photo


def _cov(K=8, D=19):
    rng = np.random.default_rng(0)
    F = torch.from_numpy(rng.normal(size=(K, D, D)).astype(np.float32))
    Q = torch.from_numpy(rng.normal(size=(K, D, D)).astype(np.float32))
    return F, Q, torch.eye(D)


def _photo(M=9, H=64, W=96):
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32))
    pos = torch.from_numpy(np.stack([rng.uniform(-0.5, 0.5, M),
                                     rng.uniform(-0.5, 0.5, M),
                                     np.full(M, 3.0)], -1).astype(np.float32))
    meta, ref = photo.pack_points(
        pos, torch.from_numpy(rng.uniform(0, 255, (M, 64)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 3, M).astype(np.int32)),
        torch.ones(M, dtype=torch.bool))
    eye = torch.eye(3)
    par = photo.pack_params(eye, torch.zeros(3), torch.tensor(1.0), eye,
                            0.1 * eye, 60.0, 60.0, W / 2, H / 2, [0.0] * 4,
                            1.0, 0.0)
    return img, meta, ref, par


def _gather():
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    return table, torch.from_numpy(rng.integers(0, 64, 128).astype(np.int32))


def _meta(t):
    return t.to("meta")


# (case, call of the wrapper's slow-path checks, exception, message)
CASES = [
    ("cov_dtype", lambda F, Q, P0: cov_scan._diagnose(F.double(), Q, P0),
     TypeError, "propagate_cov: F must be float32, got torch.float64"),
    ("cov_noncontig", lambda F, Q, P0: cov_scan._diagnose(F.transpose(1, 2), Q, P0),
     ValueError, "propagate_cov: F must be contiguous"),
    ("cov_shape", lambda F, Q, P0: cov_scan._diagnose(F, Q[:-1], P0),
     ValueError, "propagate_cov: Q has shape (7, 19, 19), expected (8, 19, 19)"),
    ("cov_device", lambda F, Q, P0: cov_scan._diagnose(F, _meta(Q), P0),
     ValueError, "propagate_cov: Q on meta, P0 on cpu"),
    ("cov_too_wide", lambda F, Q, P0: cov_scan._diagnose(
        *(t.contiguous() for t in _cov(2, 33))),
     ValueError, "propagate_cov: D=33 exceeds the kernel's 32"),
]
PHOTO_CASES = [
    ("photo_dtype", lambda i, m, r, p: photo._diagnose(i.double(), m, r, p, 8),
     TypeError, "photo_iteration: img must be float32, got torch.float64"),
    ("photo_noncontig", lambda i, m, r, p: photo._diagnose(i.t(), m, r, p, 8),
     ValueError, "photo_iteration: img must be contiguous"),
    ("photo_shape", lambda i, m, r, p: photo._diagnose(i, m, r[:-1], p, 8),
     ValueError, "photo_iteration: ref_patch has shape (8, 8, 8), expected (9, 8, 8)"),
    ("photo_device", lambda i, m, r, p: photo._diagnose(i, _meta(m), r, p, 8),
     ValueError, "photo_iteration: pts_meta on meta, img on cpu"),
    ("photo_ps", lambda i, m, r, p: photo._diagnose(i, m, r, p, 4),
     ValueError, "photo_iteration: the kernel takes ps = 8, got 4"),
    ("photo_narrow", lambda i, m, r, p: photo._diagnose(
        i[:, :11].contiguous(), m, r, p, 8),
     ValueError, "photo_iteration: image width 11 < 12"),
]
GATHER_CASES = [
    ("gather_dtype", lambda t, i: gather._diagnose(t, i.long()),
     TypeError, "gather_rows: idx must be int32, got torch.int64"),
    ("gather_noncontig", lambda t, i: gather._diagnose(t.t(), i),
     ValueError, "gather_rows: table must be contiguous"),
    ("gather_device", lambda t, i: gather._diagnose(t, _meta(i)),
     ValueError, "gather_rows: idx on meta, table on cpu"),
]


@pytest.mark.parametrize(
    "inputs,call,exc,msg",
    [(_cov, c, e, m) for _, c, e, m in CASES]
    + [(_photo, c, e, m) for _, c, e, m in PHOTO_CASES]
    + [(_gather, c, e, m) for _, c, e, m in GATHER_CASES],
    ids=[c[0] for c in CASES + PHOTO_CASES + GATHER_CASES])
def test_slow_path_names_the_failed_check(inputs, call, exc, msg):
    with pytest.raises(exc, match=f"^{re.escape(msg)}$"):
        call(*inputs())


def test_slow_path_passes_good_inputs():
    """Inputs the kernels take pass every check (the wrapper then
    launches)."""
    assert cov_scan._diagnose(*_cov()) is None
    assert photo._diagnose(*_photo(), 8) is None
    assert gather._diagnose(*_gather()) is None


def test_on_cpu_routes_and_rejects_other_devices():
    assert _launch.on_cpu("op", torch.zeros(1))
    with pytest.raises(ValueError, match="^op: unsupported device meta$"):
        _launch.on_cpu("op", torch.zeros(1, device="meta"))


def test_wrappers_route_cpu_tensors_to_plain_versions():
    counts = (cov_scan.LAUNCHES, photo.LAUNCHES, gather.LAUNCHES)
    F, Q, P0 = _cov()
    torch.testing.assert_close(cov_scan.propagate_cov(F, Q, P0),
                               cov_scan.propagate_cov_plain(F, Q, P0),
                               rtol=0, atol=0)
    args = _photo()
    for got, want in zip(photo.photo_iteration(*args),
                         photo.photo_iteration_plain(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    table, idx = _gather()
    assert torch.equal(gather.gather_rows(table, idx), table[idx.long()])
    assert (cov_scan.LAUNCHES, photo.LAUNCHES, gather.LAUNCHES) == counts

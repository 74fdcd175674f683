"""The ordered segment add (fast_livo2_tpu_torch/ops/ordered_add.py) on the
CPU, where it runs its plain version, `base.index_add_(0, dst, src)`.

- The plain version sums each row lane by lane in index order: bit for
  bit a Python loop that does so, with heavy duplicates and a sink.
- At the map insert's, the downsample's and the TSDF's shapes
  (chip_smoke.ORDERED_ADD_SHAPES, the card's cases) it equals
  the JAX package's `.at[].add(..., mode="drop")` on the CPU bit for bit
  on every row but the sink (XLA's CPU scatter adds in update order; the
  JAX sites drop the sink's lanes, the port's sum them into a row no
  caller reads).
- The CUDA kernel's algorithm (stable sort, one walk per run of equal
  keys, the sink skipped), emulated in numpy, gives the plain version's
  bits on every row but the sink; put in the wrapper's place, it leaves
  `voxel_downsample`, `update_map` (full, compacted and sticky-cut
  inserts) and `tsdf.integrate` bit for bit as they are with
  `index_add_`. That holds the call sites' sinks (`drop`) and the
  downsample's `dst_sorted` promise.
The kernel itself is held to the CPU's `index_add_` bit for bit on the
card (tests/test_torch_cuda.py, chip_smoke.py's kernel_ordered_add).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as cs
from fast_livo2_tpu_torch.core import lio as tlio
from fast_livo2_tpu_torch.core import voxel_map as tvm
from fast_livo2_tpu_torch.io import tsdf as ttsdf
from fast_livo2_tpu_torch.ops import ordered_add
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _case(name, seed=0):
    """chip_smoke.ordered_add_case as tensors: (base, dst, src, sink)."""
    base, dst, src, sink = cs.ordered_add_case(name, seed)
    return (torch.from_numpy(base), torch.from_numpy(dst),
            torch.from_numpy(src), sink)


def _lane_loop(base, dst, src):
    """Row by row in float32, lane by lane in index order."""
    b = base.numpy().copy()
    s = src.numpy()
    for i, r in enumerate(dst.numpy()):
        b[r] = b[r] + s[i]
    return b


def kernel_emulation(base, dst, src, drop=None, dst_sorted=False):
    """csrc/ordered_add.cu's algorithm in numpy, in place: a stable sort of
    dst (none where the caller says it is sorted, which is asserted),
    then for each run of equal keys but the `drop` row, the row read
    once, the run's lanes added in sorted order, the row written once."""
    d = dst.numpy()
    if dst_sorted:
        assert np.all(np.diff(d) >= 0), "dst_sorted, but dst is not sorted"
        keys, perm = d, np.arange(len(d))
    else:
        perm = np.argsort(d, kind="stable")
        keys = d[perm]
    b, s = base.numpy(), src.numpy()
    assert base.is_contiguous() and b.dtype == np.float32
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    for j, end in zip(starts, np.r_[starts[1:], len(keys)]):
        row = keys[j]
        if row == drop:
            continue
        acc = b[row].copy()
        for k in range(j, end):
            acc = acc + s[perm[k]]
        b[row] = acc
    return base


@pytest.mark.parametrize("W", [16, 3, 1])
def test_plain_equals_lane_loop(W):
    """Heavy duplicates (2,000 lanes into 40 rows) and a sink row."""
    rng = np.random.default_rng(W)
    base = torch.from_numpy(rng.normal(size=(41, W)).astype(np.float32) * 1e3)
    dst = torch.from_numpy(rng.integers(0, 41, 2000))
    dst[torch.from_numpy(rng.random(2000) < 0.3)] = 40
    src = torch.from_numpy(rng.normal(size=(2000, W)).astype(np.float32))
    want = _lane_loop(base, dst, src)
    before = ordered_add.LAUNCHES
    got = ordered_add.ordered_index_add_(base.clone(), dst, src, drop=40)
    assert ordered_add.LAUNCHES == before  # the plain version launches nothing
    np.testing.assert_array_equal(got.numpy(), want)  # the sink too


@pytest.mark.parametrize("name", ["map_insert", "downsample", "tsdf"])
def test_plain_matches_jax_scatter(name):
    base, dst, src, sink = _case(name)
    got = ordered_add.ordered_index_add_(base.clone(), dst, src, drop=sink)
    want = jnp.asarray(base.numpy()[:sink]).at[jnp.asarray(dst.numpy())].add(
        jnp.asarray(src.numpy()), mode="drop")
    np.testing.assert_array_equal(got.numpy()[:sink], np.asarray(want))


@pytest.mark.parametrize("name", ["map_insert", "downsample", "tsdf"])
def test_kernel_algorithm_equals_plain(name):
    base, dst, src, sink = _case(name)
    want = ordered_add.ordered_index_add_plain(base.clone(), dst, src)
    got = kernel_emulation(base.clone(), dst, src, drop=sink,
                           dst_sorted=name == "downsample")
    np.testing.assert_array_equal(got.numpy()[:sink], want.numpy()[:sink])
    # the sink row is left as it was
    np.testing.assert_array_equal(got.numpy()[sink], base.numpy()[sink])


def _downsample(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, (6000, 3)).astype(np.float32)
    pts[:2000] = pts[:2000] * 0.1  # a dense core: long runs per leaf
    valid = rng.random(6000) > 0.2
    return (lambda: tlio.voxel_downsample(torch.from_numpy(pts),
                                          torch.from_numpy(valid), 0.3, 512))


def _update_map(name):
    kw = dict(voxel_size=1.0, n_layers=3, capacity_log2=11,
              layer_init_num=(4, 4, 4), planner_threshold=0.0025,
              max_points_num=60)
    kw.update({"full": {},
               "compact": dict(insert_compact=128, descend_compact=256),
               "sticky": dict(sticky_cut=True, pre_descend_margin=0.5)}[name])
    cfg = tvm.VoxelMapConfig(**kw)
    rng = np.random.default_rng(21)
    frames = []
    for f in range(3):
        pts = rng.uniform(-5, 5, (600, 3)).astype(np.float32)
        pts[:300, 2] = -1.3 + 0.01 * rng.standard_normal(300)
        pts[450:] = rng.uniform(-1, 1, (150, 3))
        pts += np.float32(0.3 * f)
        a = rng.normal(size=(600, 3, 3)) * 1e-2
        var = (np.einsum("nij,nkj->nik", a, a) + np.eye(3) * 1e-4).astype(np.float32)
        valid = np.ones(600, bool)
        valid[-37:] = False
        frames.append((pts, var, valid))

    def run():
        m = tvm.make_map(cfg, device="cpu")
        out = []
        for i, (pts, var, valid) in enumerate(frames):
            m = tvm.update_map(m, torch.from_numpy(pts), torch.from_numpy(var),
                               torch.from_numpy(valid), cfg,
                               compact=name == "compact" and i > 0)
            out.extend(m)
        return out
    return run


def _tsdf():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, (3000, 3)).astype(np.float32)
    pts[:, 2] = (0.3 * np.sin(pts[:, 0]) + 0.2 * np.cos(pts[:, 1])).astype(np.float32)
    sensor = torch.tensor([0.1, -0.2, 1.5])
    valid = torch.from_numpy(rng.random(len(pts)) > 0.1)

    def run():
        v = ttsdf.make_volume(np.zeros(3, np.float32), 5.0, grid=64, device="cpu")
        for _ in range(2):
            v = ttsdf.integrate(v, torch.from_numpy(pts), valid, sensor)
        return [v.tsdf, v.weight]
    return run


SITES = {"downsample": lambda: _downsample(3),
         "update_map_full": lambda: _update_map("full"),
         "update_map_compact": lambda: _update_map("compact"),
         "update_map_sticky": lambda: _update_map("sticky"),
         "tsdf": _tsdf}


@pytest.mark.parametrize("site", list(SITES))
def test_sites_same_bits_with_kernel_algorithm(site, monkeypatch):
    """Each call site with the kernel's algorithm in the wrapper's place
    gives index_add_'s bits (its outputs never read the sink)."""
    run = SITES[site]()
    want = run()
    calls = []

    def emulated(base, dst, src, drop=None, dst_sorted=False):
        calls.append((drop, dst_sorted))
        assert drop == base.shape[0] - 1  # every site names its sink
        return kernel_emulation(base, dst, src, drop, dst_sorted)

    monkeypatch.setattr(ordered_add, "ordered_index_add_", emulated)
    got = run()
    assert calls and all(s == (site == "downsample") for _, s in calls)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_checks_on_cpu():
    base = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="must be"):
        ordered_add.ordered_index_add_(base, torch.zeros((2, 1), dtype=torch.int64),
                                       torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="unsupported device"):
        ordered_add.ordered_index_add_(base.to("meta"),
                                       torch.zeros(2, dtype=torch.int64, device="meta"),
                                       torch.zeros((2, 2), device="meta"))
    out = ordered_add.ordered_index_add_(base, torch.tensor([3, 3]),
                                         torch.ones((2, 2)), drop=3)
    assert out is base and base[3].tolist() == [2.0, 2.0]  # the plain sums it

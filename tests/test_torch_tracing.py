"""The port's frame tracer (LIVOPipeline.enable_tracing, utils/timing.py).

On the CPU a stage mark is a perf_counter_ns reading, so a fused frame
run eagerly gives the columns a replayed graph gives on the card: the
tests hold the columns, the spans' nesting, the host spans and the
trajectories (tracing changes no bit of them). The card test replays a
captured LIVO graph and holds its marks and its kernel nodes by stage.
This file imports nothing of JAX, so on a machine with a card it runs
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import copy
import types

import numpy as np
import pytest
import torch

from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline
from fast_livo2_tpu_torch.ops import _build
from fast_livo2_tpu_torch.utils import timing
from test_torch_cuda import _need_card, _small_livo  # tests/ is on the path

# the top-level stages of a fused LIVO frame, in order
TOP = ("propagate", "undistort", "downsample", "lio", "vio", "map",
       "copy_back")
VIO_SUB = ("vio.ring_insert", "vio.raster", "vio.retrieve",
           "vio.photometric", "vio.maintain")
FRAMES = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Thousands of small ops a frame: with the suite's parallel workers
    each holding a full intra-op thread pool, the pools oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    """tests/test_torch_cuda.py's small LIVO configuration and sequence."""
    return _small_livo()


def _run(small, traced, **tpu):
    cfg, seq = copy.deepcopy(small[0]), small[1]
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    pipe = LIVOPipeline(cfg, "livo", device="cpu")
    if traced:
        pipe.enable_tracing()
    return pipe.process(seq, max_frames=FRAMES), pipe


@pytest.fixture(scope="module")
def fused_runs(small):
    """A fused LIVO run without tracing and one with it."""
    return _run(small, False, fused_frame=True), _run(small, True,
                                                       fused_frame=True)


def test_tracing_off_records_nothing(fused_runs):
    (_, pipe), _ = fused_runs
    assert pipe.tracing is None
    for r in pipe.log.rows:
        assert "marks" not in r and "stage_spans" not in r
        assert not [k for k in r if k.endswith("_ms") and k != "host_ms"], r
    assert "stage_mark" not in _build._LOADED


def test_traced_rows_have_nested_stage_spans(fused_runs):
    """Every frame after the first has the top-level stage columns, its
    top-level spans follow one another in TOP's order, and each
    sub-stage lies inside its parent."""
    _, (traj, pipe) = fused_runs
    assert len(traj) == FRAMES and "stage_spans" not in pipe.log.rows[0]
    for r in pipe.log.rows[1:]:
        assert "marks" not in r  # converted at finalize
        spans = r["stage_spans"]
        top = [s for s in spans if s[1] < 0]
        assert tuple(s[0] for s in top) == TOP
        assert all(r[f"{n}_ms"] > 0.0 for n in TOP + VIO_SUB)
        for a, b in zip(top, top[1:]):
            assert a[5] <= b[4]
        for name, parent, b0, b1, t0, t1 in spans:
            assert b0 < b1 and t0 <= t1
            if parent >= 0:
                p = spans[parent]
                assert p[2] < b0 and b1 < p[3]
                assert p[4] <= t0 and t1 <= p[5]
        assert [s[0] for s in spans if s[1] >= 0] == list(VIO_SUB)
        # the sub-stages tile most of the VIO half, the stages the frame
        assert sum(r[f"{n}_ms"] for n in VIO_SUB) <= r["vio_ms"]
        assert sum(r[f"{n}_ms"] for n in TOP) <= top[-1][5]
    table = pipe.print_stage_table(last_n=3)
    assert "lio" in table and "host_ms" not in table


def test_host_spans_lie_inside_their_frame(fused_runs):
    """Each host span is tagged with its frame's trajectory row and lies
    inside that frame's `frame` span, which is its host_ms."""
    _, (traj, pipe) = fused_runs
    spans = pipe.tracing.spans
    frames = {row: (t0, t1) for row, name, parent, t0, t1 in spans
              if name == "frame"}
    assert sorted(frames) == list(range(len(traj)))
    for j, (t0, t1) in frames.items():
        assert pipe.log.rows[j]["host_ms"] == pytest.approx((t1 - t0) * 1e3)
    names = set()
    for row, name, parent, t0, t1 in spans:
        if name != "frame":
            assert parent == "frame"
            assert frames[row][0] <= t0 <= t1 <= frames[row][1], name
            names.add(name)
    assert {"packet", "inputs", "replay", "outputs", "prefetch",
            "ship_images"} <= names
    # one replay a frame after the first
    assert sum(n == "replay" for _, n, *_ in spans) == len(traj) - 1


@pytest.mark.parametrize("form", ["split", "fused", "staged"])
def test_tracing_leaves_trajectories_bitwise(small, fused_runs, form):
    """The same trajectory, bit for bit, with tracing on and off."""
    if form == "fused":
        (a, _), (b, _) = fused_runs
    else:
        tpu = {} if form == "split" else {"stage_timing": True}
        a, _ = _run(small, False, **tpu)
        b, pb = _run(small, True, **tpu)
        assert all("lio_ms" in r for r in pb.log.rows[1:])
    assert [t for t, _, _ in a] == [t for t, _, _ in b]
    for (_, Ra, pa), (_, Rb, pb_) in zip(a, b):
        assert np.array_equal(Ra, Rb) and np.array_equal(pa, pb_)


def test_by_stage_splits_counts_between_marks():
    """Counts read before each mark go to the innermost span open after
    it, less each mark's own; outside every span to "other"."""
    # a(0, 5) holding b(1, 2) and c(3, 4); d(6, 7); marks 0..7
    spans = [("a", -1, 0, 5), ("b", 0, 1, 2), ("c", 0, 3, 4), ("d", -1, 6, 7)]
    assert timing.stage_paths(spans) == ["a", "a/b", "a/c", "d"]
    before = np.array([2, 3, 9, 12, 20, 21, 30, 36])
    got = timing.by_stage(spans, before, 40, 1)
    # after mark s: 0 a, 1 b, 2 a, 3 c, 4 a, 5 none, 6 d, 7 none
    assert got == {"other": 2 + 8 + 3, "a": 0 + 2 + 0, "a/b": 5,
                   "a/c": 7, "d": 5}
    assert sum(got.values()) + len(before) == 40
    vec = timing.by_stage(spans[:1], np.array([[0, 0], [4, 1]]),
                          np.array([4, 1]), 0)
    assert {k: v.tolist() for k, v in vec.items()} == {"a": [4, 1]}


def test_stage_clock_spans_and_limit():
    """annotate ranges inside an active clock become its spans, with
    their parents; outside it they mark nothing; one frame holds at most
    SLOTS marks."""
    with timing.annotate("outside"):
        pass
    with timing.StageClock("cpu") as clock:
        with timing.annotate("a"):
            with timing.annotate("b"):
                pass
        with timing.annotate("a"):
            pass
    assert clock.spans == [("a", -1, 0, 3), ("b", 0, 1, 2), ("a", -1, 4, 5)]
    assert clock.marks.shape == (timing.SLOTS,)
    ms, timed = timing.stage_times(clock.spans, clock.marks.numpy())
    assert list(ms) == ["a_ms", "b_ms"] and len(timed) == 3
    assert clock.kernel_nodes_by_stage() is None
    with pytest.raises(RuntimeError, match="stage bounds"):
        with timing.StageClock("cpu"):
            for _ in range(timing.SLOTS // 2 + 1):
                with timing.annotate("x"):
                    pass


def test_enable_tracing_after_a_capture_raises(small):
    pipe = LIVOPipeline(small[0], "livo", device="cpu")
    pipe._frame_graphs = types.SimpleNamespace(graphs={("key",): None})
    with pytest.raises(RuntimeError, match="before the first fused frame"):
        pipe.enable_tracing()
    assert pipe.tracing is None


@pytest.mark.cuda
def test_traced_graph_marks_and_kernel_nodes_by_stage(monkeypatch):
    """A captured LIVO graph replayed twice: each replay writes its marks
    anew, in slot order; the kernel nodes by stage and the graph's marks
    add up to the kernel nodes of the captured graph; and the counted
    wrappers' launches fall in their stages: K1 in propagate, K2's 20 in
    vio.photometric, the ordered add once in the downsample and twice
    in the map insert, as many as a replay launches."""
    _need_card()
    # the benchmark's map insert: layer 0, then the descending lanes
    # (descend_compact below max_points_down), each an ordered add
    cfg, seq = _small_livo(fused_frame=True, descend_compact=2048)
    graphs = []
    plain = torch.cuda.CUDAGraph

    def kept():
        graphs.append(plain(keep_graph=True))
        return graphs[-1]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", kept)
    pipe = LIVOPipeline(cfg, "livo", device="cuda")
    pipe.enable_tracing()
    pipe.push_sequence(seq)
    while pipe.frame_id < 2:  # IMU init, the map frame, warm-up + capture
        pipe.poll(max_frames=1, flush=True)
    assert len(pipe._frame_graphs.graphs) == 1 and len(graphs) == 1
    for _ in range(2):
        assert pipe.poll(max_frames=1, flush=True) == 1
    s = pipe._frame_graphs.summary()
    n_marks = s["stage_marks_per_replay"][0]
    last = [pipe.log.rows[j]["marks"][:n_marks].cpu() for j in (-2, -1)]
    for m in last:
        assert torch.all(m[1:] >= m[:-1]) and m[-1] > m[0]
    assert last[1][0] > last[0][-1]  # the second replay wrote them again

    nodes = s["kernel_nodes_by_stage"][0]
    total = timing.graph_kernel_nodes(graphs[0].raw_cuda_graph())
    assert sum(nodes.values()) + n_marks == total
    assert {p.split("/")[0] for p in nodes} <= set(TOP) | {"other"}
    by = s["launches_by_stage"][0]
    assert by["propagate"] == {"cov_scan": 1}
    assert by["vio/vio.photometric"] == {"photo_iteration": 20,
                                         "photo_tail": 20}
    assert by["downsample/ordered_add"] == {"ordered_add": 1}
    assert by["map/ordered_add"] == {"ordered_add": 2}
    for path, launches in by.items():
        assert nodes[path] >= sum(launches.values())
    sums = {}
    for launches in by.values():
        for k, v in launches.items():
            sums[k] = sums.get(k, 0) + v
    assert sums == {k: v for k, v in s["launches_per_replay"][0].items() if v}
    pipe._finalize_host_views()
    for r in pipe.log.rows[-2:]:
        assert tuple(x[0] for x in r["stage_spans"] if x[1] < 0) == TOP
        assert all(r[f"{n}_ms"] > 0.0 for n in TOP)

"""The readers of the program's stage trace (lib/stages.py) on a fake
profile: two traced frames of mark kernels around the kernels of their
stages, one mark dropped by the profiler, kernels outside the frames."""

import types

import pytest
import torch

from livo_bench.lib import deployment, stages

# a frame's stage spans: a(0, 5) holding b(1, 2) and c(3, 4); d(6, 7)
LAYOUT = [("a", -1, 0, 5), ("b", 0, 1, 2), ("c", 0, 3, 4), ("d", -1, 6, 7)]


def mark(slot, t):
    return (f"void stage_mark_kernel<{slot}>(unsigned long long*)", t, t + 0.1)


def frame(t0, drop=None):
    """Marks 0..7 at t0 + 0, 1, ..., 7 and a kernel in every interval
    between them, named after the stage it runs in; slot `drop`'s mark
    is left out."""
    out = [mark(s, t0 + s) for s in range(8) if s != drop]
    owners = ["a", "a/b", "a", "a/c", "a", "other", "d"]
    out += [(f"k_{o}", t0 + s + 0.5, t0 + s + 0.6) for s, o in enumerate(owners)]
    return out


def test_kernels_by_stage_with_a_dropped_mark():
    kernels = frame(10.0) + frame(20.0, drop=3) + [
        ("k_outside", 5.0, 5.5), ("k_outside", 18.0, 18.5),
        ("Memcpy DtoD (Device -> Device)", 15.2, 15.3), ("memset32", 25.2, 25.3)]
    got = stages.kernels_by_stage(kernels, [LAYOUT, LAYOUT])
    by = got["by_stage"]
    # frame 1: every kernel in its own stage. Frame 2, without mark 3:
    # the kernels of (2, 3) and (3, 4) lie in one interval, which a
    # alone holds whole. The copy and the fill (a graph's fill node, run
    # as a CUDA kernel) go where they ran, but are no kernel.
    assert {k: v[0] for k, v in by.items()} == {
        "a": 3 + 4, "a/b": 2, "a/c": 1, "d": 2, "other": 2 + 1 + 1,
        stages.OUTSIDE: 2}
    assert by["a/b"][1] == pytest.approx(0.2)
    assert [f["marks"] for f in got["frames"]] == [8, 7]
    assert [f["kernels"] for f in got["frames"]] == [7, 7]
    assert got["frames"][1]["first"] == 20.0
    assert got["frames"][1]["last"] == pytest.approx(27.1)
    assert got["assigned_share"] == pytest.approx(16 / 18)
    assert got["outside_share"] == pytest.approx(2 / 18)
    # frames found by their marks' slots, the first mark of one dropped
    assert len(stages.mark_frames(frame(10.0) + frame(20.0, drop=0))) == 2
    assert stages.kernels_by_stage([("k", 0.0, 1.0)], [LAYOUT]) is None


def test_graph_idle_pct_and_gap_labels():
    kernels = frame(10.0)
    # busy: the marks and kernels; idle inside [10, 17.1] is the rest
    intervals = sorted([[a, b] for _, a, b in kernels])
    profile = {"kernels": kernels, "intervals": intervals}
    busy = sum(b - a for a, b in intervals)
    assert stages.graph_idle_pct(profile) == pytest.approx(
        100.0 * (1 - busy / 7.1))
    assert stages.graph_idle_pct({"kernels": [("k", 0.0, 1.0)],
                                  "intervals": [[0.0, 1.0]]}) is None
    # a poll from 9 to 18: the replay span, then the prefetch; the
    # benchmark's push before it
    program = [(3, "frame", None, 9.0, 18.0), (3, "replay", "frame", 9.0, 9.9),
               (3, "prefetch", "frame", 17.2, 18.0)]
    bench = [("push", 7.0, 9.0), ("poll", 9.0, 18.0)]
    gaps = stages.idle_gaps_by_program_span(intervals, 7.0, 18.0, program, bench)
    labels = {}
    for label, s in gaps:
        labels[label] = labels.get(label, 0.0) + s
    assert labels == pytest.approx({"push": 3.0, "frame": 7.1 - busy,
                                    "prefetch": 0.9})
    assert gaps == sorted(gaps, key=lambda g: -g[1])


def test_readers_read_the_trace_and_none_without_it():
    rows = [{"propagate_ms": 1.0, "undistort_ms": 2.0, "downsample_ms": 3.0,
             "lio_ms": 4.0, "map_ms": 5.0, "ordered_add_ms": 0.5},
            {"propagate_ms": 1.0, "undistort_ms": 2.0, "downsample_ms": 3.0,
             "lio_ms": 6.0, "vio_ms": 8.0, "map_ms": 7.0, "ordered_add_ms": 1.5}]
    spans = [(4, "packet", "frame", 0.0, 0.002), (4, "prefetch", "frame", 1.0, 1.001),
             (5, "prefetch", "frame", 2.0, 2.003), (5, "replay", "frame", 3.0, 3.004),
             (6, "prefetch", "frame", 4.0, 4.5)]
    run = types.SimpleNamespace(
        trace={"stage_ms": rows, "window_rows": [4, 6], "host_spans": spans},
        profile=None)
    want = {"frontend_device_ms_per_frame.live": 6.0,
            "lio_device_ms_per_frame.replay": 5.0,
            "vio_device_ms_per_frame.live": 8.0,
            "map_insert_device_ms_per_frame.replay": 6.0,
            "ordered_add_call_device_ms_per_frame.replay": 1.0,
            "packet_prep_ms_per_frame.replay": 3.0,
            "graph_launch_ms_per_frame.replay": 2.0}
    for name, value in want.items():
        assert deployment.reader(name).read(run) == pytest.approx(value), name
    bare = types.SimpleNamespace(profile=None, frames=[])
    for name in list(want) + ["graph_idle_pct.live"]:
        assert deployment.reader(name).read(bare) is None, name


def test_window_stage_ms_converts_marks_in_one_transfer():
    ns = torch.tensor([0, 1_000_000, 1_500_000, 4_000_000] + [0] * 60)
    rows = [{"stage_spans": [("a", -1, 0, 3), ("b", 0, 1, 2)], "marks": ns},
            {"host_ms": 1.0}]
    got = stages.window_stage_ms(rows)
    assert got == [pytest.approx({"a_ms": 4.0, "b_ms": 0.5})]
    assert stages.window_stage_ms(rows[1:]) is None
    pipe = types.SimpleNamespace(log=types.SimpleNamespace(rows=rows))
    assert stages.collect(pipe, (0, 1), (1, 2), None, 0.0, 1.0, None) is None

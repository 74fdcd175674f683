"""Fixtures of the benchmark's own tests (run them with
`python -m pytest livo_bench/tests -q`; the repository's tier-1 command
does not collect them).

`tiny`: a cell made of new files alone, in a temporary copy of the
benchmark's folders: a deployment cut to a size the CPU runs in seconds
(a 16 x 512 ring LiDAR, a 160 x 128 camera, small tables) and a replay
mix whose checked frames fall in the first frames of a short window.
"""

import copy
import json
import os
import shutil

import pytest
import torch

from livo_bench.lib import deployment


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; the test skips itself "
        "where torch.cuda.is_available() is false")


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def tiny_deployment():
    d = deployment._json("configs", "avia")
    d = copy.deepcopy(d)
    d["name"] = "tiny"
    d["rig"].update(lines=16, per_line=512)
    d["camera"] = {"cam_model": "Pinhole", "cam_width": 320, "cam_height": 256,
                   "scale": 1.0, "cam_fx": 200.0, "cam_fy": 200.0, "cam_cx": 160.0,
                   "cam_cy": 128.0, "cam_d0": -0.07, "cam_d1": 0.1,
                   "cam_d2": -0.001, "cam_d3": 0.0002}
    d["sensor"]["tpu"].update(max_points_per_scan=8192, max_points_down=2048,
                              hash_capacity_log2=14, vis_point_capacity=2048,
                              frame_ring=8, descend_compact=1024, insert_compact=1024)
    return d


@pytest.fixture
def tiny(tmp_path):
    """(bench dict, root) of a temporary benchmark folder that adds the
    cell `tiny.replay_tiny` and the metric `frames_run.tiny` as files."""
    root = tmp_path / "livo_bench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(deployment.ROOT, sub), root / sub)
    with open(root / "configs" / "tiny.json", "w") as f:
        json.dump(tiny_deployment(), f)
    mix = deployment.mix("replay")
    mix.update(warm_s=1.0, check_from_s=0.2, check_frames=2,
               max_speedup=1.5, margin_s=1.0)
    with open(root / "traffic" / "replay_tiny.json", "w") as f:
        json.dump(mix, f)
    with open(root / "metrics" / "frames_run.tiny.py", "w") as f:
        f.write("def read(run):\n    return float(len(run.frames))\n")
    bench = deployment.benchmark()
    bench["configs"].append({"name": "tiny", "source": "test", "why": "test",
                             "file": "livo_bench/configs/tiny.json", "reduced": []})
    bench["workloads"].append({"name": "tiny.replay_tiny", "config": "tiny",
                               "traffic": "replay_tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "frames_run.tiny", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "frames_per_s",
                               "workloads": ["tiny.replay_tiny"]})
    torch.set_num_threads(2)
    return bench, str(root)

"""Deployments, traffic mixes and metric readers, found by name.

- `configs/<config>.json`: a deployment (the sensor yaml and the camera
  yaml as they are run, the rig's LiDAR pattern and camera rate, the
  reference that judges it, the limits of its comparison);
- `traffic/<mix>.json`: a traffic mix's parameters, read by the one
  runner in lib/drive.py;
- `metrics/<metric>.py`: one reader per metric, `read(run)` returning a
  number or None.

A cell `<config>.<mix>` is an entry of BENCHMARK.json's `workloads`.
"""

import importlib.util
import json
import os

import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(ROOT)
# What a run builds or caches stays inside the checkout, at fixed paths.
WORK = os.path.join(CHECKOUT, "build", "livo_bench")


def benchmark(path=None) -> dict:
    with open(path or os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, root=None) -> dict:
    with open(os.path.join(root or ROOT, kind, f"{name}.json")) as f:
        return json.load(f)


def deployment(bench: dict, name: str, root=None) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json("configs", os.path.splitext(os.path.basename(c["file"]))[0],
                         root)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(name: str, root=None) -> dict:
    return _json("traffic", name, root)


def reader(name: str, root=None):
    """The module of metric `name` (metrics/<name>.py)."""
    path = os.path.join(root or ROOT, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "livo_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell_name: str, trace: bool):
    """The metrics a run of the cell reports: its end-to-end ones, or
    with `trace` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def port_config(deploy: dict, work=WORK):
    """The port's LIVOConfig of the deployment, through its own yaml
    loader, from copies of the pair written at fixed paths."""
    from fast_livo2_tpu_torch.utils.config import load_config

    os.makedirs(work, exist_ok=True)
    paths = []
    for part in ("sensor", "camera"):
        p = os.path.join(work, f"{deploy['name']}.{part}.yaml")
        with open(p, "w") as f:
            yaml.safe_dump(deploy[part], f)
        paths.append(p)
    return load_config(*paths)

"""One run of one benchmark cell of fast_livo2_tpu_torch.

    python3 -m livo_bench.run --workload avia.live --seed 7 --seconds 30 --trace 0

from the root of a checkout on a machine with an NVIDIA card. Earlier
lines of standard output carry what the run saw (the recording, the
generator's lateness, the check's per-frame readings, the profile's
drops); the last line is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), device, with --trace 1 a breakdown, and last the compared
numbers each beside its limit (also the last lines of standard error).

`--control` (not for the benchmark's own runs) also judges the plain
reference in float32 with TF32 products, put in the program's place,
and prints its readings.
"""

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# One process, few threads: the host libraries' worker pools stay at one
# thread, so no pool spins beside the runner and the program's host path.
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")
os.environ.setdefault("USE_FLAX", "0")

import numpy as np  # noqa: E402

from livo_bench.lib import deployment  # noqa: E402

# Build and kernel caches stay inside the checkout, at fixed paths.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(deployment.WORK, "cache", sub)


FORBIDDEN = ("jax", "jaxlib", "flax", "fast_livo2_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(msg: str, code: int = 2):
    print(f"livo_bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    bench = deployment.benchmark()
    cell = deployment.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell needs {cell['chips']} CUDA device(s); "
             f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from livo_bench.lib import harness

    out, correct, compared, device, info = harness.run(
        args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS0,
        control=args.control, bench=bench)
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}")

    frames = out.frames
    info["late_s"] = {"max": max(out.late_s) if out.late_s else None,
                      "pushes": len(out.late_s)}
    if out.frames:
        lat = [(f.out - f.due) * 1e3 for f in out.frames if f.due == f.due]
        host = [f.host_ms for f in out.frames]
        q = (50, 90, 95, 99, 100)
        thirds = np.array_split(np.asarray(lat), 3) if lat else []
        info["frames_ms"] = {
            "n": len(out.frames),
            "latency_p95_by_third": [float(np.percentile(x, 95)) for x in thirds if len(x)],
            "latency_pcts": dict(zip(q, np.percentile(lat, q).tolist())) if lat else None,
            "host_pcts": dict(zip(q, np.percentile(host, q).tolist()))}
        if not lat:  # a replay: frames a second in each third of the window
            ends = np.asarray([f.out for f in out.frames])
            edges = np.linspace(ends[0], ends[-1], 4)
            info["frames_ms"]["rate_by_third"] = [
                float(np.sum((ends > a) & (ends <= b)) / (b - a)) if b > a else None
                for a, b in zip(edges[:-1], edges[1:])]
    if out.profile is not None:
        k2_seen = sum(1 for k in out.profile["kernels"] if "photo_iteration_kernel" in k[0])
        info["profile"] = {"frames": len(out.profile_frames),
                           "launches": out.profile_launches,
                           "k2_kernels_seen": k2_seen,
                           "k2_dropped": out.profile_launches.get("photo_iteration", 0) - k2_seen}
    try:
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["nvidia_smi"] = None
    for k, v in info.items():
        print(json.dumps({"info": k, "value": v}, default=float), flush=True)

    metrics = {}
    for m in deployment.cell_metrics(bench, args.workload, bool(args.trace)):
        value = deployment.reader(m["name"]).read(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": v, "limit": lim} for name, v, lim in compared}
    result = {"correct": bool(correct), "attempted": len(frames),
              "failed": 0, "metrics": metrics, "device": device}
    if out.profile is not None:
        result["breakdown"] = {"device_ops": out.profile["device_ops"],
                               "idle_gaps": out.profile["idle_gaps"]}
    result["checks"] = checks
    for name, v, lim in compared:
        print(f"check {name} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

"""The cells on the card, briefly: each runs through the one command and
prints a result whose checks pass (skipped where there is no card)."""

import json
import subprocess
import sys

import pytest

from livo_bench.lib import deployment


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in deployment.benchmark()["workloads"]])
def test_cell_runs(card, cell):
    out = subprocess.run([sys.executable, "-m", "livo_bench.run", "--workload", cell,
                          "--seed", str(2 ** 31 + 99), "--seconds", "6", "--trace", "1"],
                         capture_output=True, text=True, cwd=deployment.CHECKOUT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0 and res["metrics"]

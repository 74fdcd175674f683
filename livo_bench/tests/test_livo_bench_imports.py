"""Nothing the benchmark loads has the top-level name of JAX or of the
JAX package (names compared whole: the port's name begins with the JAX
package's), and the plain reference loads nothing of the port."""

import subprocess
import sys

from livo_bench.lib import deployment

FORBIDDEN = ("jax", "jaxlib", "flax", "fast_livo2_tpu")
PROBE = """
import sys, json
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(body):
    out = subprocess.run([sys.executable, "-c", PROBE.format(body=body)],
                         capture_output=True, text=True, check=True,
                         cwd=deployment.CHECKOUT)
    return set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    body = ("import livo_bench.run, livo_bench.lib.harness\n"
            "from fast_livo2_tpu_torch.core.pipeline import LIVOPipeline\n"
            "from livo_bench.lib import deployment as d\n"
            "b = d.benchmark()\n"
            "[d.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]")
    mods = loaded(body)
    assert "fast_livo2_tpu_torch" in mods
    assert not mods & set(FORBIDDEN), mods & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    mods = loaded("import livo_bench.reference.lio, livo_bench.reference.vio")
    assert not mods & (set(FORBIDDEN) | {"fast_livo2_tpu_torch"})


def test_run_compares_whole_top_level_names(monkeypatch):
    import types

    from livo_bench import run

    for name in ("fast_livo2_tpu_torch", "fast_livo2_tpu_torch.core", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == sorted(set(FORBIDDEN) & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in run.forbidden_modules()

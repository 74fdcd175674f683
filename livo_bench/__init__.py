"""The benchmark of fast_livo2_tpu_torch on one NVIDIA card: one run of
one cell a process (`python3 -m livo_bench.run --workload <cell> ...`),
driven by BENCHMARK.json and the files under configs/, traffic/ and
metrics/. See README.md."""

"""The benchmark of llama_pipeline_parallel_tpu_torch on an NVIDIA H100.

`python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once; README.md in this folder says how the
pieces fit and how a cell, a configuration or a metric is added.
"""

"""The benchmark of the PyTorch and CUDA port on one H100 (see
`BENCHMARK.json` at the repository root and `PERF.md`).

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""

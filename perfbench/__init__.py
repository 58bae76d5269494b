"""The benchmark of the PyTorch/CUDA port (`repro_torch`): run one cell with
`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`.
Cells, configurations, traffic mixes and metrics are named in `BENCHMARK.json`
at the repository root and live in files of their own under this folder."""

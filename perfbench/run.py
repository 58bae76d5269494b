"""Run one benchmark cell of the PyTorch/CUDA port on this machine's GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the checks, each number beside its limit, as the last lines of
standard error, and one JSON object (`correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` also `breakdown`, then `checks`) as
the last line of standard output. Exits non-zero, printing no result,
without enough CUDA devices. Every cache the run's programs keep is a fixed
directory under `build/` in this checkout.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    cache = os.path.join(ROOT, "build", "perfbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from perfbench import harness

    return harness.main(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())

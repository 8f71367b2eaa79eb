"""Run one cell of ``BENCHMARK.json`` and print its result as the last line
of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Set-up phases, ``nvidia-smi`` readings before and after the window
and the numbers that decide ``correct`` (each beside its limit, last) go
to standard error.  Exits 0 with a result; without the cards, or where
the run has loaded JAX or ``alan_tpu``, it exits non-zero and prints none.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# every compile cache at a fixed path inside the checkout, so that only a
# checkout's first run builds: the port's nvcc libraries already go to
# alan_tpu_torch/_native/; these hold PyTorch's runtime-compiled kernels
# and the driver's
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from benchmark import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), T_START)
    except ImportError as exc:
        print(f"benchmark: cannot import the program: {exc}", file=sys.stderr)
        return 5
    except harness.NoDevice as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

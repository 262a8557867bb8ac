"""The benchmark of ``repro_torch``'s served sparse pattern search.

    python3 searchbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``src/`` and
``searchbench/``, on a machine with the CUDA cards the cell asks for.
The last line of standard output is the run's JSON result; the numbers
that decided ``correct`` are the last lines of standard error. Without a
card, or without ``src/``, it exits non-zero and prints no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root and the program's sources, not this folder: its
# module names must not shadow the standard library's
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
# caches at fixed paths inside the checkout (the port's own kernels
# build into build/kernels/ there)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / sub)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("searchbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    from searchbench import harness
    return harness.main(args, T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())

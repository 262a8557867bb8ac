"""The readings that the limits of ``checks.py`` are set from, in one
process: the program over many seeds, and the control, the reference in
bfloat16 put in the program's place, over a few.

    python3 searchbench/limits.py --workload ell-2p25-c64 \\
        --seeds 101 102 ... --control-seeds 201 202 203 --seconds 5

Each run is a whole run of the cell (its corpus, its load, every answer
held to the reference), with a short window; it prints each run's
numbers and, per number, the largest of the program's and the smallest
of the control's.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def control_searcher(cfg, built, device):
    import torch
    from searchbench import reference
    s = built.slab
    return reference.Searcher(s["ids"], s["vals"], cfg["vocab_size"],
                              cfg["top_k"], dtype=torch.bfloat16)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-docs", type=int, default=None,
                    help="a smaller corpus (rehearsals on the CPU)")
    args = ap.parse_args()
    import torch
    from searchbench import checks, harness
    if args.device == "cuda" and not torch.cuda.is_available():
        print("limits: no CUDA device", file=sys.stderr)
        return 2
    size = {"n_docs": args.n_docs} if args.n_docs else {}
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    got = {"program": {}, "control": {}}
    runs = [("program", s) for s in args.seeds] + [
        ("control", s) for s in args.control_seeds]
    for side, seed in runs:
        kw = {"overrides": size}
        if side == "control":
            kw = {"make_searcher": control_searcher,
                  "overrides": {**size, "layout": "ell"}}
        if args.device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        res = harness.run(args.workload, seed, args.seconds, False,
                          device=args.device, log=log, **kw)
        nums = {k: v["value"] for k, v in res["checks"].items()}
        print(f"{args.workload} {side} seed {seed}: correct "
              f"{res['correct']} attempted {res['attempted']} peak "
              f"{res['device']['memory_peak_bytes']} {json.dumps(nums)}",
              flush=True)
        for k, v in nums.items():
            got[side].setdefault(k, []).append(v)
    for k in checks.LIMITS:
        lo = max(got["program"].get(k, [None]) or [None],
                 key=lambda v: -1 if v is None else v)
        hi = min(got["control"].get(k, [None]) or [None],
                 key=lambda v: float("inf") if v is None else v)
        print(f"{args.workload} {k}: program's largest {lo}, control's "
              f"smallest {hi}, limit {checks.LIMITS[k]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sets of runs of cells, as the bounds are measured: each run a process
of its own (``run.py``), one after another, on the machine this starts on.

    python3 searchbench/sets.py --workload ell-2p25-c64 --seeds 11 12 13 \\
        --seconds 30 [--trace 0] [--sets 2] [--out chiprun_out/sets]

Each run's standard output and error go to ``--out``; one line a run is
printed, then each metric's spread in each set: the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) as a
share of the median, and the bound five times the widest would give.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sets"))
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    summary = {}
    for wl in args.workload:
        for k in range(args.sets):
            for seed in args.seeds:
                tag = f"{wl}.set{k}.seed{seed}.trace{args.trace}"
                t0 = time.perf_counter()
                p = subprocess.run(
                    [sys.executable, str(ROOT / "searchbench" / "run.py"),
                     "--workload", wl, "--seed", str(seed), "--seconds",
                     str(args.seconds), "--trace", str(args.trace)],
                    cwd=ROOT, capture_output=True, text=True)
                wall = time.perf_counter() - t0
                (out / f"{tag}.out").write_text(p.stdout)
                (out / f"{tag}.err").write_text(p.stderr)
                lines = p.stdout.strip().splitlines()
                try:
                    res = json.loads(lines[-1])
                except (IndexError, ValueError):
                    print(f"{tag}: rc {p.returncode}, no result; "
                          f"{p.stderr[-1500:]}", flush=True)
                    continue
                vals = {m: v["value"] for m, v in res["metrics"].items()}
                chk = {m: v["value"] for m, v in res["checks"].items()}
                print(f"{tag}: rc {p.returncode} wall {wall:.1f} s correct "
                      f"{res['correct']} attempted {res['attempted']} failed "
                      f"{res['failed']} peak {res['device']['memory_peak_bytes']}"
                      f" {json.dumps(vals)} checks {json.dumps(chk)}"
                      + (f" busy {res['device'].get('busy_s')} window "
                         f"{res['device'].get('window_s')}"
                         if args.trace else ""), flush=True)
                for m, v in vals.items():
                    summary.setdefault((wl, m), {}).setdefault(k, []).append(v)
    for (wl, m), sets in summary.items():
        spreads = [spread(v) for v in sets.values()]
        meds = [statistics.median(v) for v in sets.values()]
        widest = max((s for s in spreads if s is not None), default=None)
        print(f"{wl} {m}: medians {meds} spreads {spreads}"
              + (f" -> 5x widest {5 * widest:.4f}" if widest is not None
                 else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

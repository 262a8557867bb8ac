"""Where an LM serving call's time goes in the PyTorch/CUDA port, on one card.

    PYTHONPATH=src python benchmarks/port_serve_profile.py \
        [--arch qwen2-0.5b] [--layers N] [--batch 4] [--prompt-len 1024] \
        [--max-new 32] [--reps 5] [--json]

Builds the model at full width from seed 0 (random weights, the config's
dtype) on the card, at full depth or cut to its first ``--layers N``
(kimi-k2 at 2: its dense lead and one MoE layer, ~40 GB; qwen3-moe at 8,
~42 GB; at full depth they do not fit one card), and serves one batch of
random prompts through
``repro_torch.serve.step.generate``: a warm-up call, then ``--reps``
calls on the host clock (prefill with the first token, and the decode
steps; each ends with the card synchronized), then one more call of
each phase under ``torch.profiler``: device time by kernel and the
device's idle share of the phase's wall time (profiler on). For the
recurrent archs (``--arch rwkv6-7b``, ``zamba2-1.2b``) one more prefill
times their chunked scans (rwkv6's ``_wkv_chunked``, mamba2's
``_ssd_chunked``) by CUDA events around each call: the scans' device
span, summed over the layers, beside the prefill's. Needs a card; it
does not run on the CPU.
"""
import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.models import mamba2, model as M, rwkv6
from repro_torch.serve import step

# the chunked scans of the recurrent families: (module, function name)
SCANS = {"ssm": (rwkv6, "_wkv_chunked"), "hybrid": (mamba2, "_ssd_chunked")}


def profiled(fn):
    """Run ``fn`` under the profiler: (wall ms, device ms by kernel /
    copy / memset, busy ms, device events). Only device-side events
    count; one stream, so their total is the time the card was busy."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    table, n_events = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CPU and ev.self_device_time_total > 0:
            table[ev.key] = ev.self_device_time_total / 1e3
            n_events += ev.count
    table = dict(sorted(table.items(), key=lambda kv: -kv[1]))
    return wall, table, sum(table.values()), n_events


def scan_span(cfg, fn):
    """Run ``fn`` with the family's chunked scan wrapped in CUDA events:
    (wall ms of ``fn``, the scans' device span in ms summed over their
    calls, the number of calls). A span runs from the scan's first
    kernel to its last, gaps the host leaves between them included."""
    mod, name = SCANS[cfg.family]
    scan, events = getattr(mod, name), []

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = scan(*args, **kw)
        end.record()
        events.append((start, end))
        return out
    setattr(mod, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        setattr(mod, name, scan)
    return wall, sum(s.elapsed_time(e) for s, e in events), len(events)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="qwen2-0.5b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to its first N layers (0: all)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    cfg = get_config(args.arch)
    if args.layers:
        if not 0 < args.layers <= cfg.n_layers:
            raise SystemExit(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.n_layers}")
        print(f"cut: {cfg.name} at {args.layers} of its {cfg.n_layers} "
              "layers, full width")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    B, S, N = args.batch, args.prompt_len, args.max_new
    params = M.init(cfg, seed=0, device=dev)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32), device=dev)
    step.generate(params, cfg, prompt, max_new=N, max_len=S + N, device=dev)
    runs = []
    for _ in range(args.reps):
        stats = {}
        step.generate(params, cfg, prompt, max_new=N, max_len=S + N,
                      device=dev, stats=stats)
        runs.append(stats)
    pre_ms = statistics.median(r["prefill_s"] for r in runs) * 1e3
    dec_ms = statistics.median(r["decode_s"] for r in runs) * 1e3 / (N - 1)

    prefill, decode = step.make_prefill(cfg), step.make_decode_step(cfg)
    logits, kv = prefill(params, {"tokens": prompt})
    cache = step.decode_cache(cfg, kv, B, S, S + N, dev)
    del kv
    tok = step.sample(logits)
    phases = {"prefill": lambda: prefill(params, {"tokens": prompt})}

    def decode_steps():
        t = tok
        for i in range(N - 1):
            lg, _ = decode(params, {"tokens": t}, cache, S + i)
            t = step.sample(lg)
    phases["decode"] = decode_steps
    for name, fn in phases.items():
        wall, table, busy, n_events = profiled(fn)
        per = 1 if name == "prefill" else N - 1
        idle = 1.0 - busy / wall
        top = "; ".join(f"{k[:50]} {v / per:.3f}" for k, v in
                        list(table.items())[:8])
        host = pre_ms if name == "prefill" else dec_ms
        print(f"{name}: host-clock median {host:.3f}"
              f" ms{'' if name == 'prefill' else '/step'} (n={args.reps}); "
              f"profiled: wall {wall / per:.3f} ms, device busy "
              f"{busy / per:.3f} ms in {n_events / per:.0f} kernels and "
              f"copies, idle share {idle:.3f}; top device ms: {top}")
        if args.json:
            print(json.dumps({
                "phase": name, "arch": cfg.name, "layers": cfg.n_layers,
                "batch": B,
                "prompt_len": S, "max_new": N, "card": card,
                "host_ms_median": host,
                "n": args.reps, "profiled_wall_ms": wall / per,
                "device_ms": busy / per, "device_events": n_events / per,
                "idle_share": idle,
                "device_ms_by_op": {k: v / per for k, v in table.items()}}))
    if cfg.family in SCANS:
        wall, span, calls = scan_span(
            cfg, lambda: prefill(params, {"tokens": prompt}))
        print(f"scan: {SCANS[cfg.family][1]} x {calls} in one prefill, "
              f"device span {span:.3f} ms of the prefill's {wall:.3f} ms "
              f"wall ({span / wall:.3f})")
        if args.json:
            print(json.dumps({"phase": "scan", "arch": cfg.name,
                              "layers": cfg.n_layers, "card": card,
                              "scan": SCANS[cfg.family][1], "calls": calls,
                              "span_ms": span, "prefill_wall_ms": wall}))
    print(f"tokens/s: {B * N / (pre_ms + dec_ms * (N - 1)) * 1e3:.1f} "
          f"generated end to end, {B * S / pre_ms * 1e3:.0f} prompt tokens "
          f"in prefill, {B / dec_ms * 1e3:.1f} while decoding")


if __name__ == "__main__":
    main()

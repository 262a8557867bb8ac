"""Kernel B4's time at the LM prefill shapes, for the port on ``PYTHONPATH``.

    PYTHONPATH=src python benchmarks/port_b4_times.py [--reps 20] [--json]

Times ``repro_torch.kernels.flash_attention.flash_attention_gqa`` in
bf16, causal, from seed 0, as a CUDA-graph replay of 10 launches (median
of ``--reps`` replays by CUDA events), at the prefill shapes of
qwen2-0.5b, qwen3-4b and gemma3-4b (global, and with its window of 1024).
To hold two versions of the kernel against each other on one card, run
it once for each tree, in turns, in one call: e.g. the parent unpacked by
``git archive`` under ``build/parent``, then

    for t in build/parent . . build/parent; do
        PYTHONPATH=$t/src python benchmarks/port_b4_times.py; done

(each tree builds its kernels under its own ``build/kernels``). A shape
that the tree's kernel refuses (a head dim or a window it does not take)
prints ``refused``. Needs a card; it does not run on the CPU.
"""
import argparse
import json
import statistics
import subprocess

import torch

SHAPES = {  # name: (B, S, H, KV, hd, window)
    "qwen2-0.5b": (4, 1024, 14, 2, 64, 0),
    "qwen3-4b": (4, 1024, 32, 8, 128, 0),
    "gemma3-4b": (4, 2048, 8, 4, 256, 0),
    "gemma3-4b window": (4, 2048, 8, 4, 256, 1024),
}


def graph_ms(fn, reps, per_graph=10):
    """Device ms of one ``fn``: ``per_graph`` calls in a CUDA graph, the
    median of ``reps`` replays by CUDA events over ``per_graph``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = {"tree": fa.__file__, "card": card}
    for name, (B, S, H, KV, hd, window) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn((B, S, h, hd), generator=gen, device=dev)
                   .bfloat16() for h in (H, KV, KV))
        kw = {"window": window} if window else {}
        try:
            fa.flash_attention_gqa(q, k, v, **kw)
        except (TypeError, ValueError) as err:
            out[name] = f"refused ({err})"
            continue
        out[name] = graph_ms(lambda: fa.flash_attention_gqa(q, k, v, **kw),
                             args.reps)
    if args.json:
        print(json.dumps(out))
    else:
        print(f"B4 ms a launch (graph replay, bf16 causal) for {out['tree']}"
              f" on {card}: " + "; ".join(
                  f"{n} {v:.4f}" if isinstance(v, float) else f"{n} {v}"
                  for n, v in out.items() if n in SHAPES))


if __name__ == "__main__":
    main()

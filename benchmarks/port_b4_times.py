"""Kernel B4's time at the LM prefill shapes, for the port on ``PYTHONPATH``.

    PYTHONPATH=src python benchmarks/port_b4_times.py [--dtype float32]
        [--reps 20] [--json]

Times ``repro_torch.kernels.flash_attention.flash_attention_gqa`` from
seed 0, as a CUDA-graph replay of 10 launches (median of ``--reps``
replays by CUDA events). By default in bf16, causal (the wgmma
instance), at the prefill shapes of qwen2-0.5b, qwen3-4b and gemma3-4b
(global, and with its window of 1024). With ``--dtype float32`` (the
simt instance) at the f32 shapes of ``chip_smoke.py``: those four
(qwen3-4b's with the lse, as the training forward writes it), the
VLM's cross-attention ([4, 1024, 64/8, 128] over 1600 image tokens) and
the same trained on a rank's heads ([1, 1024, 16/2, 128] over 1600,
with the lse); each f32 shape also prints its bound (the operations of
``attention_flops`` at 67 TFLOP/s, the card's f32 peak outside the
tensor cores) and ``scaled_dot_product_attention`` in f32 on the same
inputs (``allow_tf32`` False), timed the same way.
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
F32_SHAPES = {  # name: (B, S, H, KV, hd, window, Sk or None (causal), lse)
    "qwen2-0.5b": (4, 1024, 14, 2, 64, 0, None, False),
    "qwen3-4b lse": (4, 1024, 32, 8, 128, 0, None, True),
    "gemma3-4b": (4, 2048, 8, 4, 256, 0, None, False),
    "gemma3-4b window": (4, 2048, 8, 4, 256, 1024, None, False),
    "vlm cross": (4, 1024, 64, 8, 128, 0, 1600, False),
    "vlm cross rank lse": (1, 1024, 16, 2, 128, 0, 1600, True),
}
F32_OPS_PER_S = 67e12       # H100 SXM float32, outside the tensor cores


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


def f32_times(fa, dev, reps):
    """The simt instance at F32_SHAPES: {name: {"ms", "bound_ms",
    "sdpa_ms", "sdpa_backend"}}, or "refused (...)" where the tree's
    kernel does not take the shape."""
    from torch.nn.attention import SDPBackend
    torch.backends.cuda.matmul.allow_tf32 = False
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, (B, S, H, KV, hd, window, Sk, lse) in F32_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((B, S, H, hd), (B, Sk or S, KV, hd),
                                 (B, Sk or S, KV, hd)))
        kw = {"causal": Sk is None, "window": window, "return_lse": lse}
        try:
            fa.flash_attention_gqa(q, k, v, **kw)
        except (TypeError, ValueError) as err:
            out[name] = f"refused ({err})"
            continue
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:      # the band as a boolean mask (True: attend)
            d = (torch.arange(S, device=dev)[:, None]
                 - torch.arange(S, device=dev)[None, :])
            skw = {"attn_mask": (d >= 0) & (d < window), "is_causal": False}
        else:
            skw = {"attn_mask": None, "is_causal": Sk is None}
        backend = SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, dropout_p=0.0, scale=None, enable_gqa=True,
            **skw)).name
        flops = fa.attention_flops(B, S, Sk or S, H, hd, causal=Sk is None,
                                   window=window)
        out[name] = {
            "ms": graph_ms(lambda: fa.flash_attention_gqa(q, k, v, **kw),
                           reps),
            "bound_ms": flops / F32_OPS_PER_S * 1e3,
            "sdpa_ms": graph_ms(lambda: sdpa(qt, kt, vt, enable_gqa=True,
                                             **skw), reps),
            "sdpa_backend": backend}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
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
    if args.dtype == "float32":
        out.update(f32_times(fa, dev, args.reps))
        if args.json:
            print(json.dumps(out))
            return
        print(f"B4 ms a launch (graph replay, f32, simt) for {out['tree']} "
              f"on {card}: " + "; ".join(
                  f"{n} {r['ms']:.4f} (bound {r['bound_ms']:.4f}, SDPA "
                  f"{r['sdpa_backend']} {r['sdpa_ms']:.4f})"
                  if isinstance(r, dict) else f"{n} {r}"
                  for n, r in out.items() if n in F32_SHAPES))
        return
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

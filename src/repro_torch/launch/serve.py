"""LM serving launcher: prefill a prompt batch, decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        [--smoke] [--batch 2] [--prompt-len 16] [--max-new 8] \
        [--temperature 0] [--seed 0] [--device cuda]

The port of ``repro.launch.serve``: random weights from ``--seed`` (no
checkpoint is loaded), random prompt tokens from the same seed.
``--arch`` takes every arch of ``configs/registry.py``: the dense and
MoE transformers, rwkv6-7b and zamba2-1.2b (whose prefill splits the
prompt into chunks of 64: a longer prompt must be a multiple of 64). It
refuses two, each before any work: musicgen-medium, which takes frame
embeddings, as the reference's launcher does (with its message), and
llama-3.2-vision-90b, which needs image embeddings that a prompt of
tokens does not give (ROADMAP C21; serve both through ``M.init`` and
``serve.step.generate``, the VLM with ``image_embeds=``). Prints
the tokens, and the time split into prefill (with the first token) and
decode, on the host clock; the first call includes the card's warm-up.
``--device`` defaults to the CUDA card; ``--device cpu`` runs the
kernels' plain PyTorch versions.
"""
import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.registry import (ARCH_NAMES, get_config,
                                          get_smoke_config)
from repro_torch.device import resolve
from repro_torch.models import model as M
from repro_torch.serve.step import generate


class ServeRun(NamedTuple):
    tokens: torch.Tensor      # [batch, max_new] int32
    prompt: np.ndarray        # [batch, prompt_len] int32
    params: dict
    stats: dict               # prefill_s, decode_s, init_s


def main(argv=None) -> ServeRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.embeds_input:
        raise SystemExit(f"{args.arch} takes frame embeddings (stub "
                         f"frontend); see examples/rag_serve.py for the "
                         f"embeddings-in path")
    if cfg.family == "vlm":
        raise SystemExit(f"{args.arch} needs image embeddings beside the "
                         "prompt (ROADMAP C21): serve it through "
                         "serve.step.generate(image_embeds=...)")
    device = resolve(args.device)
    t0 = time.perf_counter()
    params = M.init(cfg, seed=args.seed, device=device)
    stats = {"init_s": time.perf_counter() - t0}
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab_size,
                          (args.batch, args.prompt_len)).astype(np.int32)
    out = generate(params, cfg, prompt, max_new=args.max_new,
                   max_len=args.prompt_len + args.max_new,
                   temperature=args.temperature, seed=args.seed,
                   device=device, stats=stats)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    toks = args.batch * args.max_new
    total = stats["prefill_s"] + stats["decode_s"]
    per_tok = stats["decode_s"] / max(args.max_new - 1, 1)
    print(f"[serve] {cfg.name} on {name}: {args.batch} x {args.prompt_len} "
          f"prompt tokens, {toks} new tokens in {total * 1e3:.1f} ms "
          f"({toks / total:.1f} tok/s); prefill + first token "
          f"{stats['prefill_s'] * 1e3:.1f} ms, decode "
          f"{per_tok * 1e3:.2f} ms/step of {args.batch} tokens")
    for b, row in enumerate(out.cpu().tolist()):
        print(f"  seq {b}: {row}")
    return ServeRun(out, prompt, params, stats)


if __name__ == "__main__":
    main()

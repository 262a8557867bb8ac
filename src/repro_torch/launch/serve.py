"""LM serving launcher: prefill a prompt batch, decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        [--smoke] [--batch 2] [--prompt-len 16] [--max-new 8] \
        [--temperature 0] [--seed 0] [--device cuda]

On a mesh, one process a rank, under ``torch.distributed.run``::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch qwen3-4b --mesh 2,2 \
        --dist-backend gloo

``--mesh D,M`` lays the world out as a ``("data", "model")`` mesh (``P,D,M``:
``("pod", "data", "model")``, the batch over pod and data); the world
size must be the mesh's. ``--dist-backend`` (default ``nccl``) is the
wire: NCCL keeps the collectives on the cards and needs one card a rank;
gloo moves them through the host, and is how several ranks share one
card. Each rank draws its blocks of the weights born sharded
(``distributed.sharding.sharded_init``, the same values as one device's
``M.init``) on its device (``cuda:LOCAL_RANK`` modulo the cards, or
``--device cpu``), serves the same prompts in lockstep, and rank 0
prints. The dense and moe families run on a mesh; the others raise
``NotImplementedError`` (ROADMAP A8.5). Without ``--mesh`` the launcher
runs one device, as before.

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
import math
import os
import time
from typing import NamedTuple, Optional

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
    params: dict              # on a mesh: the rank's blocks
    stats: dict               # prefill_s, decode_s, init_s
    ctx: Optional[object] = None


def mesh_ctx(shape, backend: str, device: str):
    """The world (initialized here from ``torch.distributed.run``'s
    environment unless it already is) as a mesh of ``shape``, and the
    rank's ``MeshCtx`` on ``device``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.meshctx import MeshCtx
    dev = resolve(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("--dist-backend nccl needs a card a rank; the CPU "
                         "takes gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, **(
            {"device_id": dev} if backend == "nccl" else {}))
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} "
                         f"ranks; the world has {dist.get_world_size()}")
    names = ("pod", "data", "model") if len(shape) == 3 else \
        ("data", "model")
    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                            mesh_dim_names=names)
    return MeshCtx(mesh, dp_axes=names[:-1], fsdp_axis="data",
                   tp_axis="model", device=dev)


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
    ap.add_argument("--mesh", default=None,
                    help="D,M or P,D,M: serve on a mesh of that shape")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default="nccl")
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
    ctx = None
    if args.mesh:
        from repro_torch.distributed import sharding
        shape = tuple(int(v) for v in args.mesh.split(","))
        if len(shape) not in (2, 3):
            raise SystemExit(f"--mesh takes D,M or P,D,M, got {args.mesh}")
        sharding.check_family(cfg)
        ctx = mesh_ctx(shape, args.dist_backend, args.device)
        device = ctx.device
    else:
        device = resolve(args.device)
    t0 = time.perf_counter()
    params = M.init(cfg, seed=args.seed, device=device) if ctx is None \
        else sharding.sharded_init(cfg, ctx, seed=args.seed)
    stats = {"init_s": time.perf_counter() - t0}
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab_size,
                          (args.batch, args.prompt_len)).astype(np.int32)
    out = generate(params, cfg, prompt, max_new=args.max_new,
                   max_len=args.prompt_len + args.max_new,
                   temperature=args.temperature, seed=args.seed,
                   device=device, stats=stats, ctx=ctx)
    if ctx is not None and ctx.mesh.get_rank() != 0:
        return ServeRun(out, prompt, params, stats, ctx)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if ctx is not None:
        name = (f"rank 0 of a {tuple(ctx.shape.values())} mesh over "
                f"{args.dist_backend} on {name}")
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
    return ServeRun(out, prompt, params, stats, ctx)


if __name__ == "__main__":
    run = main()
    if run.ctx is not None:
        import torch.distributed as dist
        dist.destroy_process_group()

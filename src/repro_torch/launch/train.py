"""Training launcher: the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --steps 100 --seq-len 128 --batch 8 --ckpt-dir build/train/run1 \
        [--smoke] [--lr 3e-4] [--microbatches 1] [--int8-opt] \
        [--ckpt-every 100] [--device cuda] [--layers N] [--dtype float32]

On a mesh, one process a rank, under ``torch.distributed.run`` (every
arch; for the recurrent ones a ``--seq-len`` past 64 is a multiple of
64)::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch qwen3-4b --mesh 2,2 \
        --dist-backend gloo [--grad-compression]

``--mesh D,M`` trains on a ``("data", "model")`` mesh, ``P,D,M`` on
``("pod", "data", "model")`` (the batch over pod and data), laid out by
``launch.serve.mesh_ctx``; ``--dist-backend`` as there (gloo lets
several ranks share one card). ``--grad-compression`` averages the
pods' gradients by the int8 reduction with error feedback
(``distributed/compression.py``; a mesh without ``pod`` trains as
without it). Every rank trains in lockstep, rank 0 prints, and the
checkpoints hold the full arrays, so a run resumes on another mesh.

The reference's flags, plus ``--device`` (the CUDA card by default;
``--device cpu`` runs the kernels' plain versions; ``--layers`` keeps a
model's first N layers; ``--dtype`` trains in another dtype than the
config's, f32 for a run held to f32 limits: the recurrent archs' bf16
gradients at their random init are mostly rounding, so a mesh and one
device agree in f32 and not in bf16). Random weights from
seed 0 and the Zipf batches of ``SyntheticLMData``. Restart the command
to resume from the latest checkpoint in ``--ckpt-dir``; SIGTERM makes a
synchronous final checkpoint. Every arch trains, the recurrent ones
(rwkv6-7b, zamba2-1.2b) too. On one 80 GB card full-size rwkv6-7b fits
only with ``--int8-opt``: its 7.5 B params take 15.1 GB in bf16 and as
much again for the gradients, and f32 m and v 60 GB more (~90 GB in
all); int8 m and v make it ~46 GB before activations. ``main`` returns
the ``Trainer`` (params, optimizer state, per-step ``history``).
"""
import argparse
import dataclasses
import os
import signal
import tempfile

import torch

from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.configs.registry import (ARCH_NAMES, get_config,
                                          get_smoke_config)
from repro_torch.launch.serve import mesh_ctx
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import flatten


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--int8-opt", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="D,M or P,D,M: train on a mesh of that shape")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default="nccl")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to its first N layers")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="the params' dtype (default: the config's)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    tc = TrainConfig(
        model=cfg,
        opt=OptimizerConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                            total_steps=args.steps,
                            int8_states=args.int8_opt,
                            grad_compression=args.grad_compression),
        seq_len=args.seq_len, global_batch=args.batch,
        microbatches=args.microbatches,
        checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt_dir)
    ctx = None
    if args.mesh is not None:
        shape = tuple(int(v) for v in args.mesh.split(","))
        ctx = mesh_ctx(shape, args.dist_backend, args.device)
    rank0 = ctx is None or all(ctx.coord(a) == 0 for a in ctx.shape)
    trainer = Trainer(tc, ctx if ctx is not None else args.device,
                      log_fn=print if rank0 else (lambda s: None))
    previous = trainer.install_preemption_hook()
    where = (torch.cuda.get_device_name(trainer.device)
             if trainer.device.type == "cuda" else "cpu")
    if ctx is None:
        n_params = sum(p.numel() for _, p in flatten(trainer.params))
        print(f"[train] {cfg.name}: {n_params:,} params, {args.steps} steps "
              f"on {where}")
    elif rank0:
        print(f"[train] {cfg.name}: {args.steps} steps on a {args.mesh} mesh "
              f"over {args.dist_backend}, rank 0 on {where}")
    try:
        metrics = trainer.run(args.steps)
    finally:
        signal.signal(signal.SIGTERM, previous)
        trainer.close()
    if rank0:
        print(f"[train] final metrics: {metrics}")
    return trainer


if __name__ == "__main__":
    main()

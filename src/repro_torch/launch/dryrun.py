"""The dry run: one rank of the production mesh, every (arch x shape), on
the meta device. The port of ``repro.launch.dryrun``.

The reference lowers and compiles each step for 512 placeholder host
devices and reads XLA's memory and cost analyses. The port has no
compiler to ask, so it runs the step itself, once, on one rank: its own
``train.step.make_train_step``, ``serve.step.make_prefill`` or
``make_decode_step``, on tensors of the meta device (shapes, no
storage), with a ``meshctx.dry_ctx`` (the mesh's shape and the rank's
coordinates, no process group): the collectives move nothing and count
their bytes (``distributed.compat``), B4 launches nothing and adds its
operations (``kernels/flash_attention.py``: ``attention_flops``), and no
card is touched. It sets no environment variable. Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \\
        --mesh single --out build/dryrun
    python -m repro_torch.launch.dryrun --all --mesh multi --out build/dryrun

Each cell runs rank 0 and the last rank along ``model`` (with
``seq_shard_attn`` its rows meet the most keys) and reports the larger.
Its record, ``{arch}__{shape}__{mesh}[__{variant}].json`` as the
reference's ``run_cell`` names it, holds for the reported rank:

  - ``argument_bytes``: the rank's params, optimizer states, batch
    block, cache block and error-feedback buffers;
  - ``output_bytes``: what the step returns in storage of its own (what
    it updates in place, as the reference's donated buffers, is not
    counted);
  - ``peak_bytes``: the most bytes that live meta storages held at once
    over the step, its arguments included (``LiveBytes``);
  - ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
    the step, and B4's (``flops_b4``, its formula's) added;
  - ``collectives``: calls and bytes by op and axis, forward and
    backward (``compat.stats``);
  - ``params``, ``active_params`` (the analytic counts) and ``fits``:
    whether ``peak_bytes`` fits the card's memory (``card_bytes``: the
    card's where one is present, else ``H100_80GB_HBM3_BYTES``).

A cell that fails keeps its error and traceback, as the reference's
does. Training over 5e11 parameters takes int8 optimizer states (the
reference's rule). ``--variant cf11`` is ``a2aint8`` at capacity factor
1.1. The port writes no HLO: a roofline read from these records is the
benchmark's work.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (SHAPES, ModelConfig, OptimizerConfig,
                                      ShapeSpec, TrainConfig,
                                      shape_applicable)
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.distributed import compat, compression, sharding
from repro_torch.distributed.meshctx import dry_ctx
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import specs as specs_lib
from repro_torch.models import perfcfg
from repro_torch.serve import step as serve_step
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.step import make_train_step

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (the card chip_smoke.py's phase 18d reads it from)
H100_80GB_HBM3_BYTES = 85_017_493_504
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = (*perfcfg.VARIANTS, "cf11")


def card_bytes() -> int:
    """The memory a rank is held to: the card's where one is present,
    else an H100 80GB HBM3's."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_80GB_HBM3_BYTES


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that ops return, while they live: each
    new storage is added as an op makes it and dropped once its weak
    reference expires (looked at only when the count would pass the
    peak, so the peak is exact). ``held``: tensors live from the start
    (the step's arguments)."""

    def __init__(self, held=()):
        super().__init__()
        self.live, self.bytes, self.peak = {}, 0, 0
        for t in held:
            self.add(t)

    def add(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        ref = StorageWeakRef(storage)
        old = self.live.get(ref.cdata)
        if old is not None and not old[0].expired():
            return
        n = storage.nbytes()
        if self.bytes + n > self.peak:
            self.sweep()
        if ref.cdata in self.live:          # an expired storage's address
            self.bytes -= self.live.pop(ref.cdata)[1]
        self.live[ref.cdata] = (ref, n)
        self.bytes += n
        self.peak = max(self.peak, self.bytes)

    def sweep(self) -> None:
        for key in [k for k, (r, _) in self.live.items() if r.expired()]:
            self.bytes -= self.live.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.add(t)
        return out


def _leaves(tree):
    out = []
    for _, leaf in opt_lib.flatten(tree):
        if isinstance(leaf, opt_lib.QTensor):
            out += [leaf.q, leaf.scale]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _block_of(t: torch.Tensor, ctx, spec) -> torch.Tensor:
    """Zeros of the rank's block of ``t``'s shape under ``spec`` on the
    ctx's device (the meta device holds no numbers; elsewhere zeros are
    valid token ids)."""
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    shape = tuple(len(range(*ctx.block(n, e).indices(n)))
                  for n, e in zip(t.shape, spec))
    return torch.zeros(shape, dtype=t.dtype, device=ctx.device)


def _batch_block(batch: dict, ctx) -> dict:
    """The rank's rows of a batch (over the dp axes where they divide, as
    ``data.pipeline.shard_batch`` cuts them)."""
    return {k: _block_of(v, ctx, (ctx.dp_axes,) if ctx.batch_sharded(
        v.shape[0]) else ()) for k, v in batch.items()}


def _cache_block(cfg: ModelConfig, ctx, batch: int, max_len: int) -> dict:
    """The rank's block of the decode cache of ``max_len`` positions, as
    ``serve.step.cache_specs`` lays it out."""
    specs = serve_step.cache_specs(cfg, ctx, batch)

    def cut(path, leaf):
        spec = specs
        for p in path:
            spec = spec[p]
        return _block_of(leaf, ctx, spec)
    return sharding._walk(specs_lib.cache_struct(cfg, batch, max_len), cut)


def prepare(cfg: ModelConfig, shape: ShapeSpec, ctx, int8_opt: bool = False,
            compress: bool = False):
    """(the step's arguments by kind, ``{"params", "opt_states", "batch",
    "cache", "err"}``, each a list of the rank's tensors; a function that
    runs the step once) for ``shape``'s step of ``cfg`` on ``ctx``'s
    rank, everything on the ctx's device: the params born sharded
    (nothing drawn on the meta device), the optimizer states and error
    feedback as ``train.loop.Trainer`` makes them, zeros for the batch
    (the rank's rows in training; the whole batch, which every rank
    passes, to the serving steps) and the decode cache's block."""
    params, specs = sharding.sharded_init(cfg, ctx, with_specs=True)
    inputs = specs_lib.input_specs(cfg, shape)
    args = {"params": _leaves(params)}
    B, S = shape.global_batch, shape.seq_len
    whole = {k: torch.zeros(v.shape, dtype=v.dtype, device=ctx.device)
             for k, v in inputs["batch"].items()}
    if shape.kind == "train":
        for p in args["params"]:
            p.requires_grad_(True)
        tc = TrainConfig(model=cfg, opt=OptimizerConfig(
            int8_states=int8_opt, grad_compression=compress),
            seq_len=S, global_batch=B)
        opt_state = opt_lib.init_state(tc.opt, params, ctx, specs)
        err = compression.init_error_state(params) \
            if compress and "pod" in ctx.shape else None
        batch = _batch_block(inputs["batch"], ctx)
        args.update(opt_states=_leaves(opt_state),
                    batch=list(batch.values()), err=_leaves(err or {}))
        step = make_train_step(tc, cfg, ctx, specs)
        return args, lambda: step(params, opt_state, batch, err)
    args["batch"] = list(_batch_block(inputs["batch"], ctx).values())
    if shape.kind == "prefill":
        prefill = serve_step.make_prefill(cfg, ctx)
        return args, lambda: prefill(params, whole)
    cache = _cache_block(cfg, ctx, B, S)
    args["cache"] = _leaves(cache)
    decode = serve_step.make_decode_step(cfg, ctx)
    return args, lambda: decode(params, whole, cache, S - 1)


def dry_rank(cfg: ModelConfig, shape: ShapeSpec, mesh_shape, names, coords,
             int8_opt: bool = False, compress: bool = False) -> dict:
    """One rank (``coords``) of a mesh of ``mesh_shape`` over ``names``
    running ``shape``'s step of ``cfg`` once on the meta device
    (``prepare``): its argument, output and peak bytes, FLOPs and
    collectives."""
    ctx = dry_ctx(mesh_shape, names, coords)
    args, call = prepare(cfg, shape, ctx, int8_opt, compress)
    held = [t for ts in args.values() for t in ts]
    b4 = fa.flash_attention_gqa
    b4_flops, launches = b4.meta_flops, b4.launches
    compat.stats = {}
    try:
        with torch.set_grad_enabled(shape.kind == "train"), \
                FlopCounterMode(display=False) as flops, \
                LiveBytes(held) as live:
            out = call()
        stats = compat.stats
    finally:
        compat.stats = None
    if b4.launches != launches:
        raise RuntimeError("the dry run launched B4")
    mine = {StorageWeakRef(t.untyped_storage()).cdata for t in held}
    outs = {StorageWeakRef(t.untyped_storage()).cdata: t
            for t in _pytree.tree_leaves(out) if isinstance(t, torch.Tensor)}
    b4_flops = b4.meta_flops - b4_flops
    return {"coords": dict(zip(names, coords)),
            "argument_bytes": {k: _bytes(v) for k, v in args.items()},
            "output_bytes": _bytes(t for k, t in outs.items()
                                   if k not in mine),
            "peak_bytes": live.peak,
            "flops": flops.get_total_flops() + b4_flops,
            "flops_b4": b4_flops, "collectives": stats}


def cell(cfg: ModelConfig, shape: ShapeSpec, mesh, int8_opt: bool = False,
         compress: bool = False) -> dict:
    """One cell's record fields: ``shape``'s step of ``cfg`` on rank 0
    and on the last rank along ``model`` of ``mesh`` (its shape and axis
    names), the larger reported (both under ``ranks``)."""
    mesh_shape, names = mesh
    first = (0,) * len(names)
    last = (0,) * (len(names) - 1) + (mesh_shape[-1] - 1,)
    ranks = [dry_rank(cfg, shape, mesh_shape, names, c, int8_opt, compress)
             for c in dict.fromkeys((first, last))]
    top = max(ranks, key=lambda r: (r["peak_bytes"], r["flops"]))
    memory = card_bytes()
    rec = {k: top[k] for k in ("coords", "argument_bytes", "output_bytes",
                               "peak_bytes", "flops", "flops_b4",
                               "collectives")}
    rec.update(n_chips=math.prod(mesh_shape), params=cfg.param_count(),
               active_params=cfg.active_param_count(), card_bytes=memory,
               fits=top["peak_bytes"] <= memory, ranks=ranks)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             int8_opt: bool = False, compress: bool = False,
             variant: str = "base") -> dict:
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}__{mesh_name}" + \
        (f"__{variant}" if variant != "base" else "")
    os.makedirs(out_dir, exist_ok=True)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "int8_opt": int8_opt, "compress": compress}
    t0 = time.perf_counter()
    try:
        perfcfg.set_variant("a2aint8" if variant == "cf11" else variant)
        cfg = get_config(arch)
        if variant == "cf11":   # tighter expert capacity: cf appears squared
            cfg = dataclasses.replace(cfg, capacity_factor=1.1)
        shape = SHAPES[shape_name]
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            rec.update(status="skipped", reason=why)
        else:
            # >500B-param training takes int8 optimizer states to fit
            if shape.kind == "train" and cfg.param_count() > 5e11:
                rec["int8_opt"] = True
            rec.update(cell(cfg, shape, PRODUCTION[multi_pod],
                            rec["int8_opt"], compress), status="ok")
    except Exception as e:  # noqa: BLE001 — record the failure, don't die
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        perfcfg.reset()
    rec["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    line = {"ok": lambda: (f"{rec['peak_bytes'] / 1e9:.2f} GB peak, "
                           f"{rec['flops']:.4e} FLOP, fits "
                           f"{rec['fits']}"),
            "skipped": lambda: rec["reason"],
            "error": lambda: rec["error"]}[rec["status"]]()
    print(f"[dryrun] {tag}: {rec['status']} ({line}; "
          f"{rec['seconds']:.1f} s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_NAMES))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--int8-opt", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--variant", default="base", choices=VARIANTS)
    args = ap.parse_args(argv)
    multi = args.mesh == "multi"
    if args.all:
        return [run_cell(arch, shape, multi, args.out,
                         int8_opt=args.int8_opt, compress=args.compress)
                for arch in ARCH_NAMES for shape in SHAPES]
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    return [run_cell(args.arch, args.shape, multi, args.out,
                     int8_opt=args.int8_opt, compress=args.compress,
                     variant=args.variant)]


if __name__ == "__main__":
    main()

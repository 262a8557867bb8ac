"""The ranks of ``tests/test_torch_dryrun.py``: a gloo world of 8 ranks on
the CPU (``run``: a spawn, a ``FileStore`` under the test's directory),
each importing torch and ``repro_torch`` only. For each case a rank
builds its mesh over the world, takes the step and its arguments that
the dry run takes (``launch.dryrun.prepare``, here on real tensors), and
runs the step once under ``FlopCounterMode``, with B4's plain version
left out of the count (its operations are added by its formula apart):
the collectives it counted (``compat.stats``), the FLOPs outside B4 and
B4's.

Not a test module: pytest collects ``test_*.py`` only.
"""
import datetime
import os
import pickle

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import compat
from repro_torch.distributed.meshctx import MeshCtx
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun

TIMEOUT = datetime.timedelta(seconds=300)


def case_of(case):
    """(config, shape) of a case: ``arch``'s smoke config and a
    ``ShapeSpec`` of ``kind``, ``seq`` and ``batch``."""
    return (registry.get_smoke_config(case["arch"]),
            ShapeSpec(case["kind"], case["kind"], case["seq"],
                      case["batch"]))


def job(cases):
    out = []
    plain = fa.flash_attention_gqa_plain
    b4 = {"flops": 0}

    def uncounted(q, k, v, *, causal=True, window=0, return_lse=False,
                  q_offset=0):
        B, S, H, hd = q.shape
        b4["flops"] += fa.attention_flops(B, S, k.shape[1], H, hd,
                                          causal=causal, window=window,
                                          q_offset=q_offset)
        with _disable_current_modes():
            return plain(q, k, v, causal=causal, window=window,
                         return_lse=return_lse, q_offset=q_offset)
    fa.flash_attention_gqa_plain = uncounted
    try:
        for case in cases:
            names = tuple(case["names"])
            ctx = MeshCtx(init_device_mesh("cpu", tuple(case["mesh"]),
                                           mesh_dim_names=names),
                          dp_axes=names[:-1], device="cpu")
            cfg, shape = case_of(case)
            _, call = dryrun.prepare(cfg, shape, ctx, case["int8"],
                                     case["compress"])
            b4["flops"] = 0
            compat.stats = {}
            try:
                with torch.set_grad_enabled(shape.kind == "train"), \
                        FlopCounterMode(display=False) as flops:
                    call()
                stats = compat.stats
            finally:
                compat.stats = None
            out.append({"coords": {a: ctx.coord(a) for a in names},
                        "stats": stats, "flops": flops.get_total_flops(),
                        "flops_b4": b4["flops"]})
    finally:
        fa.flash_attention_gqa_plain = plain
    return out


def run(root, cases):
    """``job(cases)`` on 8 ranks; every rank's results, by rank."""
    mp.spawn(_entry, args=(8, str(root), cases), nprocs=8, join=True)
    out = []
    for rank in range(8):
        with open(os.path.join(root, f"{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, world, root, cases):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "filestore"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        out = job(cases)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)

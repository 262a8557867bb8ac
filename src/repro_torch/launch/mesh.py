"""Production mesh builders, the port of ``repro.launch.mesh``.

``make_production_mesh`` lays the initialized ``torch.distributed`` world
out as the reference's (16, 16) ``("data", "model")`` mesh, or (2, 16, 16)
``("pod", "data", "model")`` across pods, and ``make_ctx`` wraps it in a
``MeshCtx``. A world of another size raises ``ValueError``. Other shapes
are built as the tests build them::

    dist.init_process_group("nccl", init_method="tcp://HOST:PORT",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cuda", (4, 2),
                            mesh_dim_names=("data", "model"))
    ctx = MeshCtx(mesh, dp_axes=("data",), device="cuda")
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import DeviceLike
from repro_torch.distributed.meshctx import MeshCtx


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {shape} {axes} needs a world of "
            f"{math.prod(shape)} ranks; the world size is {world} "
            "(None: no process group is initialized)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_ctx(*, multi_pod: bool = False, device: DeviceLike = "cuda"
             ) -> MeshCtx:
    """The production ctx; ``device="cuda"`` is the card the mesh gave
    this rank (``init_device_mesh`` sets it)."""
    dev_type = torch.device(device).type
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev_type)
    dp = ("pod", "data") if multi_pod else ("data",)
    return MeshCtx(mesh=mesh, dp_axes=dp, fsdp_axis="data",
                   tp_axis="model", device=device)

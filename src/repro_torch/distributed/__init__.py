"""The search engine's mesh: ``MeshCtx`` over a ``torch.distributed``
DeviceMesh (``meshctx``), the collectives the engine and ``core.topk``
call (``compat``), and the slab work queue (``fault``). The port of the
search half of ``repro.distributed``."""

from repro_torch.distributed.meshctx import (MeshCtx, refuse_mesh,
                                             single_device_ctx)

__all__ = ["MeshCtx", "refuse_mesh", "single_device_ctx"]

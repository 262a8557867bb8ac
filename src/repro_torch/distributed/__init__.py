"""The mesh: ``MeshCtx`` over a ``torch.distributed`` DeviceMesh
(``meshctx``), the collectives the search engine, ``core.topk`` and the
LM call (``compat``), the LM's parameter sharding rules (``sharding``)
and the slab work queue (``fault``). The port of ``repro.distributed``
but for its int8 gradient compression."""

from repro_torch.distributed.meshctx import (MeshCtx, refuse_mesh,
                                             single_device_ctx)

__all__ = ["MeshCtx", "refuse_mesh", "single_device_ctx"]

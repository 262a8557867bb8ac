"""The mesh: ``MeshCtx`` over a ``torch.distributed`` DeviceMesh
(``meshctx``), the collectives the search engine, ``core.topk`` and the
LM call (``compat``), the LM's parameter sharding rules (``sharding``),
the leader and followers of a served mesh (``lockstep``) and the slab
work queue (``fault``). The port of ``repro.distributed``
but for its int8 gradient compression."""

from repro_torch.distributed.meshctx import MeshCtx, single_device_ctx

__all__ = ["MeshCtx", "single_device_ctx"]

"""Mesh context threaded through the search engine and the LM.

The port of ``repro.distributed.meshctx``. The reference's one controller
drives every device of a ``jax.sharding.Mesh``; here each rank is one
process that holds one device, and a ``torch.distributed`` DeviceMesh
names the ranks' axes as the reference's mesh does: ``("data",
"model")``, or ``("pod", "data", "model")`` across pods. In the search
engine ``dp_axes`` shard the corpus rows (the paper's K partitions) and
``tp_axis`` the query batch's L value columns. In the LM ``dp_axes``
shard the batch, ``tp_axis`` the heads, the FFN's width, the experts and
the vocabulary, and ``fsdp_axis`` the weights' model dimension, gathered
before each use (``distributed/sharding.py``); ``block`` says which
block of a dimension sharded over some axes this rank holds.

Every rank of a mesh runs the same calls in the same order. Where one
process's threads and clock decide them (the serving tier, the write
path), rank 0 leads and the other ranks follow its records
(``distributed.lockstep``).

``single_device_ctx`` is the 1 x 1 context with no DeviceMesh and no
process group (``dist.is_initialized()`` stays False): every collective
of ``repro_torch.distributed.compat`` is then the identity. Building a
1 x 1 DeviceMesh would start a default group from the environment.

``dry_ctx`` is one rank of a mesh of any shape with no process group:
its mesh is a ``DryMesh`` (the shape, the axis names, the rank's
coordinates), its device ``"meta"``, and ``distributed.compat``'s
collectives on it return empty results of the right shapes and count
their bytes (the dry run, ``launch/dryrun.py``).

The ctx carries the device the rank launches on; it defaults to the CUDA
card through ``repro_torch.device.resolve``, as every entry point does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve


def _names(axes) -> tuple:
    return () if axes is None else (
        (axes,) if isinstance(axes, str) else tuple(axes))


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    mesh: Optional[object]          # a DeviceMesh; None: one device
    dp_axes: Tuple[str, ...] = ("data",)
    fsdp_axis: str = "data"
    tp_axis: str = "model"
    device: DeviceLike = None       # resolved: cuda:0 unless named

    def __post_init__(self):
        object.__setattr__(self, "device", resolve(self.device))
        names = self.shape
        for axis in (*self.dp_axes, self.tp_axis):
            if axis not in names:
                raise ValueError(f"axis {axis!r} is not one of the mesh's "
                                 f"{tuple(names)}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in the mesh's order."""
        if self.mesh is None:
            return {a: 1 for a in dict.fromkeys((*self.dp_axes,
                                                 self.tp_axis))}
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def dp_size(self) -> int:
        return math.prod(self.shape[a] for a in self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.shape[self.tp_axis]

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return 0 if self.mesh is None else self.mesh.get_local_rank(axis)

    @property
    def dp_index(self) -> int:
        """This rank's row block: its coordinates along ``dp_axes``,
        first axis major (the reference's ``P(dp_axes)`` order)."""
        index = 0
        for axis in self.dp_axes:
            index = index * self.shape[axis] + self.coord(axis)
        return index

    def axes_size(self, axes) -> int:
        """The ranks over ``axes`` (a spec entry: ``None``, one axis
        name, or a tuple of them)."""
        return math.prod(self.shape[a] for a in _names(axes))

    def block(self, n: int, axes) -> slice:
        """This rank's block of a dimension of ``n`` sharded over
        ``axes`` (a spec entry, the first axis major), as the reference's
        ``PartitionSpec`` lays it out; the whole dimension for ``None``."""
        index, size = 0, self.axes_size(axes)
        for axis in _names(axes):
            index = index * self.shape[axis] + self.coord(axis)
        if n % size:
            raise ValueError(f"a dimension of {n} does not split over "
                             f"{_names(axes)} ({size} ranks)")
        return slice(index * n // size, (index + 1) * n // size)

    def batch_sharded(self, batch_size: int) -> bool:
        """Whether a batch of ``batch_size`` splits over ``dp_axes`` (the
        reference's ``cache_specs`` rule); otherwise every rank of the dp
        axes holds the whole batch."""
        return batch_size % self.dp_size == 0 and batch_size >= self.dp_size

    def group(self, axis: str):
        """The process group of the ranks along ``axis`` through this
        rank (a real mesh only)."""
        return self.mesh.get_group(axis)

    def axis_ranks(self, axis: str) -> List[int]:
        """Global ranks along ``axis`` through this rank, in coordinate
        order (a real mesh only)."""
        dims = list(self.mesh.mesh_dim_names)
        at = list(self.mesh.get_coordinate())
        at[dims.index(axis)] = slice(None)
        return self.mesh.mesh[tuple(at)].tolist()


def single_device_ctx(device: DeviceLike = None) -> MeshCtx:
    """The 1 x 1 context with the production axis names and no process
    group: the engine runs its single-device path unchanged."""
    return MeshCtx(mesh=None, device=device)


class DryMesh:
    """What a ``MeshCtx`` reads of a DeviceMesh (the axis names, the
    shape, this rank's coordinates, the ranks' layout), for one rank of a
    mesh that no process group backs: ``get_group`` raises, and
    ``distributed.compat`` moves nothing on it (``dry``)."""

    dry = True

    def __init__(self, shape, names, coords):
        if not (len(shape) == len(names) == len(coords)) or any(
                not 0 <= c < n for c, n in zip(coords, shape)):
            raise ValueError(f"coordinates {tuple(coords)} of a mesh "
                             f"{tuple(shape)} over {tuple(names)}")
        self.mesh_dim_names = tuple(names)
        self.mesh = torch.arange(math.prod(shape)).reshape(tuple(shape))
        self._coords = tuple(coords)

    def get_local_rank(self, axis: str) -> int:
        return self._coords[self.mesh_dim_names.index(axis)]

    def get_coordinate(self) -> List[int]:
        return list(self._coords)

    def get_group(self, axis: str):
        raise RuntimeError("a dry mesh has no process group")


def dry_ctx(shape, names, coords, dp_axes=None,
            device: DeviceLike = "meta") -> MeshCtx:
    """One rank (``coords``) of a mesh of ``shape`` over ``names`` with no
    process group, on ``device`` (the meta device); ``dp_axes`` default
    every axis but the last (``model``), ``fsdp`` is ``data``."""
    names = tuple(names)
    return MeshCtx(mesh=DryMesh(shape, names, coords),
                   dp_axes=tuple(dp_axes or names[:-1]), fsdp_axis="data",
                   tp_axis=names[-1], device=device)

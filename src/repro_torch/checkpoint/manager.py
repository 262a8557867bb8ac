"""Atomic, async checkpoints in the reference's on-disk format: the port
of ``repro.checkpoint.manager``.

Layout:  <dir>/step_<N>/            N as %09d
           manifest.json            {"step", "extra", "leaves": [{"path",
                                     "kind", "files", "dtype" | "shape"}]}
           arr_<i>.npy              one file a leaf (its host value)
           arr_<i>_q.npy, _s.npy    a QTensor leaf's int8 payload, scales
         <dir>/step_<N>.tmp/        written first, atomically renamed

bfloat16 is stored as its uint16 bits with dtype ``"bfloat16"``, as the
reference stores it; the port goes through torch's int16 view, and needs
no ``ml_dtypes`` (the card's machine has none). Paths are the tree's keys
and list indices joined by ``/``, dict keys in sorted order, as the
reference's ``_path_str`` writes them.

- Atomic commit: a checkpoint is visible iff the rename completed.
- Async: ``save_async`` copies the tree to the host, then writes it on a
  background thread while training goes on.
- ``restore(step, like)`` loads into the tensors of ``like`` in place (a
  40 GB tree restored beside itself would need twice the card);
  ``restore(step)`` with no ``like`` returns the checkpoint's own tree
  (nested dicts by path, CPU tensors and QTensors): a directory the
  reference wrote opens so, and ``repro_torch.carry``'s
  ``lm_params_from_reference`` and ``opt_state_from_reference`` carry it
  into the port's layout.

On a mesh (``CheckpointManager(..., ctx=)`` with a DeviceMesh, and the
tree's ``specs``: the params' and ``sharding.opt_state_specs``'), a
save gathers each leaf whole from the ranks' blocks
onto rank 0 (``sharding.gather_whole``) on the calling
thread, leaf by leaf in ``flatten``'s order, so that every rank runs the
collectives in one order; rank 0 alone keeps the host copies and writes
them, in the same
format, and renames atomically; a barrier over the mesh follows the
write (for ``save_async``, in ``wait``, which every rank calls at the
same points). So a checkpoint holds the full logical arrays, as the
reference's does, and ``restore`` cuts each rank's block from them: it
opens on any mesh and on one device (the reference's elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.train.optimizer import QTensor, flatten


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's bits as numpy (bfloat16 as uint16) on the
    host: a copy even of a CPU tensor, which training updates in place
    while ``save_async`` writes."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_disk(t: torch.Tensor):
    return _to_host(t), str(t.dtype).replace("torch.", "")


def _from_disk(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _nest(leaves: Dict[str, Any]) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}} (list indices stay keys)."""
    out: dict = {}
    for path, val in leaves.items():
        *head, last = path.split("/")
        node = out
        for key in head:
            node = node.setdefault(key, {})
        node[last] = val
    return out


def _rank0(ctx) -> bool:
    return all(ctx.coord(axis) == 0 for axis in ctx.shape)


def _whole(leaf, spec, ctx):
    """A leaf gathered whole from the ranks' blocks onto rank 0 (a
    QTensor's payload and scales each by its own spec); None on the other
    ranks."""
    from repro_torch.distributed.sharding import gather_whole
    if isinstance(leaf, QTensor):
        q = gather_whole(leaf.q, spec.q, ctx)
        scale = gather_whole(leaf.scale, spec.scale, ctx)
        return None if q is None else QTensor(q=q, scale=scale,
                                              shape=tuple(q.shape))
    return gather_whole(leaf.detach(), spec, ctx)


def _cut(val, spec, ctx):
    """The rank's block of a whole leaf read from disk."""
    from repro_torch.distributed.sharding import block
    if isinstance(val, QTensor):
        q = block(val.q, spec.q, ctx)
        return QTensor(q=q, scale=block(val.scale, spec.scale, ctx),
                       shape=tuple(q.shape))
    return block(val, spec, ctx) if val.dim() else val


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, ctx=None):
        self.dir = directory
        self.keep = keep
        self.ctx = ctx if ctx is not None and ctx.mesh is not None else None
        self.writer = self.ctx is None or _rank0(self.ctx)
        if self.writer:
            os.makedirs(directory, exist_ok=True)
        self._barrier()
        self._pending: Optional[threading.Thread] = None
        self._unsynced = False

    def _barrier(self):
        """Every rank of the mesh past this point (a one-element
        all-reduce over its axes); nothing off a mesh."""
        if self.ctx is not None:
            from repro_torch.distributed import compat
            compat.all_reduce_axis(torch.zeros(1, device=self.ctx.device),
                                   self.ctx, tuple(self.ctx.shape))

    # -- write ---------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             specs: Any = None):
        """``specs``: on a mesh, the tree's specs (``tree`` the rank's
        blocks)."""
        self.wait()
        host = self._snapshot(tree, specs)
        if self.writer:
            self._write(step, host, extra or {})
        self._barrier()

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None,
                   specs: Any = None):
        self.wait()
        host = self._snapshot(tree, specs)  # device -> host copy happens here
        if self.writer:
            t = threading.Thread(target=self._write, args=(step, host,
                                                           extra or {}))
            t.start()
            self._pending = t
        self._unsynced = self.ctx is not None

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._unsynced:
            self._unsynced = False
            self._barrier()

    def _snapshot(self, tree, specs=None):
        """The host copies of the tree's leaves (on a mesh, the whole
        leaves, gathered here; ranks other than 0 keep none)."""
        leaves = []
        spec_leaves = [None] * len(flatten(tree)) if self.ctx is None \
            else [sp for _, sp in flatten(specs)]
        for (path, leaf), spec in zip(flatten(tree), spec_leaves):
            if spec is not None:
                leaf = _whole(leaf, spec, self.ctx)
            if not self.writer:
                continue
            if isinstance(leaf, QTensor):
                leaves.append((path, "qtensor", (_to_host(leaf.q),
                                                 _to_host(leaf.scale),
                                                 leaf.shape)))
            else:
                leaves.append((path, "array", _to_disk(leaf)))
        return leaves

    def _write(self, step: int, leaves, extra: Dict):
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for i, (path, kind, val) in enumerate(leaves):
            entry = {"path": _path_str(path), "kind": kind, "files": []}
            if kind == "qtensor":
                q, s, shape = val
                np.save(os.path.join(tmp, f"arr_{i}_q.npy"), q)
                np.save(os.path.join(tmp, f"arr_{i}_s.npy"), s)
                entry["files"] = [f"arr_{i}_q.npy", f"arr_{i}_s.npy"]
                entry["shape"] = list(shape)
            else:
                raw, dt = val
                np.save(os.path.join(tmp, f"arr_{i}.npy"), raw)
                entry["files"] = [f"arr_{i}.npy"]
                entry["dtype"] = dt
            manifest["leaves"].append(entry)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, d: str, e: dict):
        if e["kind"] == "qtensor":
            return QTensor(
                q=torch.from_numpy(np.load(os.path.join(d, e["files"][0]))),
                scale=torch.from_numpy(np.load(os.path.join(d,
                                                            e["files"][1]))),
                shape=tuple(e["shape"]))
        val = np.load(os.path.join(d, e["files"][0]))
        return _from_disk(val, e.get("dtype", str(val.dtype)))

    def restore(self, step: int, like: Any = None, specs: Any = None):
        """(tree, extra). With ``like`` (the port's tree of tensors and
        QTensors), each leaf of the checkpoint at ``like``'s path is
        copied into ``like``'s tensor in place (cast to its dtype) and
        ``like`` is returned; without, the checkpoint's own tree on the
        host. On a mesh ``like`` holds the rank's blocks and ``specs``
        their specs: each is cut from the whole leaf on disk, whatever
        mesh (or one device) wrote it."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if like is None:
            return _nest({e["path"]: self._load(d, e)
                          for e in manifest["leaves"]}), manifest["extra"]
        by_path = {e["path"]: e for e in manifest["leaves"]}
        spec_leaves = [None] * len(flatten(like)) if self.ctx is None \
            else [sp for _, sp in flatten(specs)]
        with torch.no_grad():
            for (path, leaf), spec in zip(flatten(like), spec_leaves):
                val = self._load(d, by_path[_path_str(path)])
                if spec is not None:
                    val = _cut(val, spec, self.ctx)
                if isinstance(leaf, QTensor):
                    leaf.q.copy_(val.q)
                    leaf.scale.copy_(val.scale)
                else:
                    leaf.copy_(val)
        return like, manifest["extra"]

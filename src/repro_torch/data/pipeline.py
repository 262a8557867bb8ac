"""Deterministic, resumable data with epoch-tagged prefetch: the port of
``repro.data.pipeline``.

A batch is a pure function of (seed, step), drawn with numpy's Philox
counter-based generator exactly as the reference draws it, so the two
packages see the same batches bit for bit and a restarted job
regenerates the stream from any step with no state to lose.

``PrefetchingLoader`` prepares batch(step + 1) on a background thread,
tagging each with an epoch; ``seek`` (on restore) bumps the epoch, and
stale prefetches are discarded by tag. It puts each batch on the
trainer's device, or, on a mesh, each rank's block of it
(``shard_batch``): every rank draws the same counter-based batch and
keeps its rows.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.distributed.meshctx import MeshCtx


class SyntheticLMData:
    """Token batches ~ Zipf(1.2) over the vocab (realistic logits scale)."""

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=self.seed + 2**32,
                                                   counter=step))
        V = self.cfg.vocab_size
        toks = rng.zipf(1.2, size=(self.global_batch, self.seq_len))
        toks = (toks - 1) % V
        batch = {"tokens": toks.astype(np.int32)}
        if self.cfg.embeds_input:
            batch["labels"] = batch.pop("tokens")
            batch["embeds"] = rng.standard_normal(
                (self.global_batch, self.seq_len, self.cfg.d_model),
                np.float32) * 0.02
        if self.cfg.family == "vlm":
            batch["image_embeds"] = rng.standard_normal(
                (self.global_batch, self.cfg.n_image_tokens,
                 self.cfg.d_model), np.float32) * 0.02
        return batch


def to_device(batch: Dict[str, np.ndarray], device: torch.device):
    """A numpy batch as tensors of the same dtypes on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def shard_batch(batch: Dict[str, np.ndarray], ctx, microbatches: int = 1):
    """The rank's rows of a numpy batch, as tensors on ``ctx.device``:
    the reference's ``shard_batch`` places the batch over the dp axes
    (``P(dp_axes)``). With ``microbatches`` n, microbatch i is rows
    ``[i·B/n, (i+1)·B/n)`` of the batch (the reference's reshape), and
    the rank keeps its block of each, in microbatch order; where a
    microbatch does not split over the dp axes (``batch_sharded``), all
    of it. Off a mesh (no DeviceMesh) the whole batch."""
    if ctx.mesh is None:
        return to_device(batch, ctx.device)
    out = {}
    for k, v in batch.items():
        n = max(microbatches, 1)
        rows = v.shape[0] // n
        parts = [v[i * rows:(i + 1) * rows] for i in range(n)]
        if ctx.batch_sharded(rows):
            cut = ctx.block(rows, ctx.dp_axes)
            parts = [p[cut] for p in parts]
        out[k] = torch.from_numpy(np.ascontiguousarray(
            np.concatenate(parts))).to(ctx.device)
    return out


class PrefetchingLoader:
    """Epoch-tagged double-buffered loader over a batch_at(step) source,
    its batches on ``where``: a device (default the CUDA card), or a
    ``MeshCtx``, whose rank keeps its rows (``shard_batch``, with
    ``microbatches``)."""

    def __init__(self, source, where=None, depth: int = 2,
                 microbatches: int = 1):
        self.source = source
        self.ctx = where if isinstance(where, MeshCtx) else None
        self.device = self.ctx.device if self.ctx is not None \
            else resolve(where)
        self.microbatches = microbatches
        self.depth = depth
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._epoch = 0
        self._next_step = 0
        self._lock = threading.Lock()
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop:
            with self._lock:
                epoch, step = self._epoch, self._next_step
                self._next_step += 1
            batch = self.source.batch_at(step)
            batch = to_device(batch, self.device) if self.ctx is None \
                else shard_batch(batch, self.ctx, self.microbatches)
            try:
                self._q.put((epoch, step, batch), timeout=0.5)
            except queue.Full:
                with self._lock:  # nobody consumed: rewind our speculation
                    if self._epoch == epoch:
                        self._next_step = step
                continue

    def seek(self, step: int):
        """Restart: bump the epoch; stale prefetches get discarded."""
        with self._lock:
            self._epoch += 1
            self._next_step = step

    def next(self, expected_step: int):
        while True:
            epoch, step, batch = self._q.get()
            with self._lock:
                cur = self._epoch
            if epoch == cur and step == expected_step:
                return batch
            # mispredicted prefetch (stale epoch or wrong step): discard
            if epoch == cur and step > expected_step:
                self.seek(expected_step)

    def close(self):
        """Stop the worker and wait for it (it wakes within 0.5 s)."""
        self._stop = True
        self._thread.join(timeout=5.0)

"""Deterministic, resumable data with epoch-tagged prefetch: the port of
``repro.data.pipeline``.

A batch is a pure function of (seed, step), drawn with numpy's Philox
counter-based generator exactly as the reference draws it, so the two
packages see the same batches bit for bit and a restarted job
regenerates the stream from any step with no state to lose.

``PrefetchingLoader`` prepares batch(step + 1) on a background thread,
tagging each with an epoch; ``seek`` (on restore) bumps the epoch, and
stale prefetches are discarded by tag. It puts each batch on the
trainer's device, where the reference calls ``shard_batch`` onto its
mesh.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve


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


class PrefetchingLoader:
    """Epoch-tagged double-buffered loader over a batch_at(step) source,
    its batches on ``device`` (default the CUDA card)."""

    def __init__(self, source, device: DeviceLike = None, depth: int = 2):
        self.source = source
        self.device = resolve(device)
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
            batch = to_device(self.source.batch_at(step), self.device)
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

"""Fault-tolerant training loop on one device: the port of
``repro.train.loop``.

- auto-restore from the latest atomic checkpoint (restart == preemption
  recovery);
- async checkpointing every N steps;
- deterministic counter-based data (any step regenerates identically);
- preemption hook (SIGTERM -> synchronous final checkpoint).

The reference's elastic resharding onto another mesh has no counterpart
on one card. ``history`` keeps each step's metrics and its host-clock
seconds (the step ends in a read of its loss, which waits for the
device).
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Dict

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import PrefetchingLoader, SyntheticLMData
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.step import make_train_step


class Trainer:
    def __init__(self, tc: TrainConfig, device: DeviceLike = None,
                 log_fn: Callable[[str], None] = print):
        self.tc = tc
        self.cfg = tc.model
        self.device = resolve(device)
        self.log = log_fn
        self.ckpt = CheckpointManager(tc.checkpoint_dir,
                                      keep=tc.keep_checkpoints)
        self.step_fn = make_train_step(tc, self.cfg)
        self._preempted = False
        self.history = []

        self.params = M.init(self.cfg, seed=tc.seed, device=self.device)
        for _, p in opt_lib.flatten(self.params):
            p.requires_grad_(True)
        self.opt_state = opt_lib.init_state(tc.opt, self.params)
        self.start_step = 0

        latest = self.ckpt.latest_step()
        if latest is not None:
            self._restore(latest)

        self.data = SyntheticLMData(self.cfg, tc.global_batch, tc.seq_len,
                                    seed=tc.seed)
        self.loader = PrefetchingLoader(self.data, self.device)
        self.loader.seek(self.start_step)

    # ------------------------------------------------------------------
    def _state(self):
        return {"params": self.params, "opt": self.opt_state}

    def _restore(self, step: int):
        _, extra = self.ckpt.restore(step, self._state())
        self.start_step = int(extra.get("next_step", step))
        self.log(f"[trainer] restored step {step} "
                 f"(resume at {self.start_step}) on {self.device}")

    def _save(self, step: int, sync: bool = False):
        extra = {"next_step": step + 1}
        if sync:
            self.ckpt.save(step, self._state(), extra)
        else:
            self.ckpt.save_async(step, self._state(), extra)

    def install_preemption_hook(self):
        """SIGTERM sets the flag that ``run`` checks after each step.
        Returns the handler it replaced (for ``signal.signal`` to put
        back)."""
        def handler(signum, frame):
            self._preempted = True
        return signal.signal(signal.SIGTERM, handler)

    def close(self):
        """Wait for a pending checkpoint and stop the loader's thread."""
        self.ckpt.wait()
        self.loader.close()

    # ------------------------------------------------------------------
    def run(self, n_steps: int) -> Dict[str, float]:
        metrics = {}
        t0 = time.time()
        for step in range(self.start_step, self.start_step + n_steps):
            t_step = time.perf_counter()
            batch = self.loader.next(step)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            row = {k: float(v) for k, v in metrics.items()}
            row.update(step=step, seconds=time.perf_counter() - t_step)
            self.history.append(row)
            if step % 10 == 0 or step == self.start_step + n_steps - 1:
                self.log(f"[trainer] step {step} loss {row['loss']:.4f} "
                         f"lr {row['lr']:.2e} "
                         f"gnorm {row['grad_norm']:.3f} "
                         f"({(time.time()-t0):.1f}s)")
            if self._preempted:
                self.log(f"[trainer] preempted at step {step}: checkpointing")
                self._save(step, sync=True)
                return {k: float(v) for k, v in metrics.items()}
            if (step + 1) % self.tc.checkpoint_every == 0:
                self._save(step)
        self.ckpt.wait()
        return {k: float(v) for k, v in metrics.items()}

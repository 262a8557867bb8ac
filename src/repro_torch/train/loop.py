"""Fault-tolerant training loop: the port of ``repro.train.loop``.

- auto-restore from the latest atomic checkpoint (restart == preemption
  recovery);
- async checkpointing every N steps;
- deterministic counter-based data (any step regenerates identically);
- preemption hook (SIGTERM -> synchronous final checkpoint);
- elastic: a checkpoint holds the full logical arrays, so one saved on
  any mesh (or one device) restores onto another.

``Trainer(tc, where)``: ``where`` a ``MeshCtx`` with a DeviceMesh trains
any family on it, every rank in lockstep: the
params born sharded (``sharding.sharded_init``), the optimizer's states
on the rank's blocks (laid out as ``sharding.opt_state_specs`` says),
the error feedback of the compressed pod reduction where
``grad_compression`` is on and the mesh has a ``pod`` axis, the
loader's batches cut to the rank's rows (``data.pipeline.shard_batch``).
A device, a ``single_device_ctx`` or None trains one device, as
before. ``history`` keeps each step's metrics and its host-clock
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
from repro_torch.device import resolve
from repro_torch.distributed import compat, compression, sharding
from repro_torch.distributed.meshctx import MeshCtx
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.step import make_train_step


class Trainer:
    def __init__(self, tc: TrainConfig, where=None,
                 log_fn: Callable[[str], None] = print):
        self.tc = tc
        self.cfg = tc.model
        if isinstance(where, MeshCtx) and where.mesh is not None:
            ctx = where
            self.device = ctx.device
        else:
            # a device (or None, or one device's ctx): one device
            ctx = None
            self.device = resolve(where.device if isinstance(where, MeshCtx)
                                  else where)
        self.ctx = ctx
        self.log = log_fn
        self.ckpt = CheckpointManager(tc.checkpoint_dir,
                                      keep=tc.keep_checkpoints, ctx=ctx)
        self._preempted = False
        self.history = []

        if ctx is None:
            self.params = M.init(self.cfg, seed=tc.seed, device=self.device)
            self.specs = self.opt_specs = None
        else:
            self.params, self.specs = sharding.sharded_init(
                self.cfg, ctx, seed=tc.seed, with_specs=True)
        for _, p in opt_lib.flatten(self.params):
            p.requires_grad_(True)
        self.step_fn = make_train_step(tc, self.cfg, ctx, self.specs)
        self.opt_state = opt_lib.init_state(tc.opt, self.params, ctx,
                                            self.specs)
        if ctx is not None:
            self.opt_specs = sharding.opt_state_specs(self.opt_state,
                                                      self.specs, ctx)
        self.err = compression.init_error_state(self.params) \
            if tc.opt.grad_compression and ctx is not None \
            and "pod" in ctx.shape else None
        self.start_step = 0

        latest = self.ckpt.latest_step()
        if latest is not None:
            self._restore(latest)

        self.data = SyntheticLMData(self.cfg, tc.global_batch, tc.seq_len,
                                    seed=tc.seed)
        self.loader = PrefetchingLoader(
            self.data, self.device if ctx is None else ctx,
            microbatches=tc.microbatches)
        self.loader.seek(self.start_step)

    # ------------------------------------------------------------------
    def _state(self):
        return {"params": self.params, "opt": self.opt_state}

    def _specs(self):
        return None if self.ctx is None else \
            {"params": self.specs, "opt": self.opt_specs}

    def _restore(self, step: int):
        _, extra = self.ckpt.restore(step, self._state(), self._specs())
        self.start_step = int(extra.get("next_step", step))
        where = self.device if self.ctx is None else \
            f"mesh {self.ctx.shape}"
        self.log(f"[trainer] restored step {step} "
                 f"(resume at {self.start_step}) on {where}")

    def _save(self, step: int, sync: bool = False):
        extra = {"next_step": step + 1}
        if sync:
            self.ckpt.save(step, self._state(), extra, self._specs())
        else:
            self.ckpt.save_async(step, self._state(), extra, self._specs())

    def install_preemption_hook(self):
        """SIGTERM sets the flag that ``run`` checks after each step.
        Returns the handler it replaced (for ``signal.signal`` to put
        back)."""
        def handler(signum, frame):
            self._preempted = True
        return signal.signal(signal.SIGTERM, handler)

    def _stop(self) -> bool:
        """Whether a SIGTERM came; on a mesh, to any rank (a one-element
        max over the mesh after each step), so that every rank saves."""
        if self.ctx is None:
            return self._preempted
        flag = torch.tensor([float(self._preempted)], device=self.device)
        return bool(compat.all_reduce_axis(flag, self.ctx,
                                           tuple(self.ctx.shape),
                                           op="max")[0])

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
                self.params, self.opt_state, batch, self.err)
            row = {k: float(v) for k, v in metrics.items()}
            row.update(step=step, seconds=time.perf_counter() - t_step)
            self.history.append(row)
            if step % 10 == 0 or step == self.start_step + n_steps - 1:
                self.log(f"[trainer] step {step} loss {row['loss']:.4f} "
                         f"lr {row['lr']:.2e} "
                         f"gnorm {row['grad_norm']:.3f} "
                         f"({(time.time()-t0):.1f}s)")
            if self._stop():
                self.log(f"[trainer] preempted at step {step}: checkpointing")
                self._save(step, sync=True)
                return {k: float(v) for k, v in metrics.items()}
            if (step + 1) % self.tc.checkpoint_every == 0:
                self._save(step)
        self.ckpt.wait()
        return {k: float(v) for k, v in metrics.items()}

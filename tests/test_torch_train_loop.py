"""The port's train step, trainer and training launcher on the CPU.

One train step against the reference's ``make_train_step`` on shared
params (carried from ``repro.models.model.init(PRNGKey(0), cfg)`` in
f32) and a numpy batch, at 1 and 2 microbatches, f32 and int8 states.
Then the reference's ``tests/test_train_loop.py`` checks on the port's
``Trainer`` (its params come from ``torch.Generator``s, so the two
trainers' numbers are not compared): the loss goes down, a restart from
a checkpoint is bit-identical, SIGTERM checkpoints synchronously, int8
optimizer states converge as f32 ones do, and the entry points need
``device="cpu"`` without a card.

Tolerances of the step, each with its reason:

  - the loss, ce, aux, lr and grad norm within 1e-5 relative (sums in
    other orders: attention tiles, the vocab, the norm's leaves). The
    first Adam step moves a param by lr x g / (|g| + eps), so the
    gradients' own error (~1e-6 of a leaf's largest) shows where |g| is
    small: f32 states, params within 1e-6 relative but for entries whose
    gradient is below 1e-3 of their leaf's largest (measured 23-24 of
    90,496, each within 2 lr). int8 states store each value at the
    nearest of 255 levels of its block, so a gradient's last bits can
    move an m or v payload one quantum: payloads within one quantum. A v
    one quantum apart moves the denominator sqrt(v̂) by 1 / sqrt(1 - b2)
    half-quanta, which near 0 changes the entry's step by up to its whole
    size, and the first step's size is below 4.5 lr with int8 states
    (|g| / the half-quantum floor, where sqrt(v) quantizes to 0): params
    within 9 lr everywhere and 97% of them within 1e-6 relative
    (measured 98%; the largest move 0.37 lr).
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.distributed.meshctx import single_device_ctx
from repro.models import model as RM
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch import carry
from repro_torch.configs import base, registry
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import PrefetchingLoader, SyntheticLMData
from repro_torch.launch import train as train_launcher
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import Trainer
from repro_torch.train.step import make_train_step

torch.set_num_threads(2)
LOSS_TOL = 1e-5


def _tc(tmp, arch="qwen2-0.5b", **opt_kw):
    cfg = get_smoke_config(arch)
    return TrainConfig(
        model=cfg, opt=OptimizerConfig(lr=1e-3, warmup_steps=5,
                                       total_steps=100, **opt_kw),
        seq_len=32, global_batch=4, checkpoint_every=5,
        checkpoint_dir=str(tmp), keep_checkpoints=2, seed=0)


def _trainer(tc):
    return Trainer(tc, "cpu", log_fn=lambda s: None)


def _params(trainer):
    return [p.detach().clone() for _, p in opt.flatten(trainer.params)]


def test_loss_decreases_over_30_steps(tmp_path):
    t = _trainer(_tc(tmp_path / "a"))
    m = t.run(30)
    t.close()
    first = t.history[0]["loss"]
    assert len(t.history) == 30
    assert m["loss"] < first - 0.3, (first, m["loss"])
    assert all(np.isfinite(r["loss"]) and r["seconds"] > 0
               for r in t.history)


def test_checkpoint_restart_is_bit_identical(tmp_path):
    t1 = _trainer(_tc(tmp_path / "x"))
    m1 = t1.run(10)
    t1.close()
    t2 = _trainer(_tc(tmp_path / "y"))
    t2.run(5)            # checkpoint_every=5: step 4 saved, resume at 5
    t2.close()
    t3 = _trainer(_tc(tmp_path / "y"))
    assert t3.start_step == 5
    m3 = t3.run(5)
    t3.close()
    assert m3["loss"] == m1["loss"]
    assert [r["loss"] for r in t3.history] == [r["loss"] for r in
                                              t1.history[5:]]
    for a, b in zip(_params(t1), _params(t3)):
        assert torch.equal(a, b)
    for key in ("m", "v"):
        for (_, a), (_, b) in zip(opt.flatten(t1.opt_state[key]),
                                  opt.flatten(t3.opt_state[key])):
            assert torch.equal(a, b)
    assert int(t3.opt_state["step"]) == 10


def test_sigterm_checkpoints_synchronously(tmp_path):
    tc = _tc(tmp_path / "p")
    t = _trainer(tc)
    previous = t.install_preemption_hook()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        t.run(7)
    finally:
        signal.signal(signal.SIGTERM, previous)
    # stopped after its first step, and the checkpoint is on disk now,
    # with nothing pending
    assert len(t.history) == 1 and t.ckpt._pending is None
    assert t.ckpt.latest_step() == 0
    t.close()
    again = _trainer(tc)
    assert again.start_step == 1
    for a, b in zip(_params(t), _params(again)):
        assert torch.equal(a, b)
    again.close()


def test_int8_states_converge_as_f32_states_do(tmp_path):
    runs = {}
    for int8 in (False, True):
        t = _trainer(_tc(tmp_path / str(int8), int8_states=int8))
        runs[int8] = t.run(30)["loss"]
        first = t.history[0]["loss"]
        assert isinstance(t.opt_state["m"]["embed"]["table"],
                          opt.QTensor) == int8
        t.close()
    assert runs[True] < first - 0.3
    assert abs(runs[True] - runs[False]) < 0.05 * runs[False], runs


def test_the_loader_prefetches_in_order_and_seeks(tmp_path):
    cfg = get_smoke_config("qwen3-4b")
    data = SyntheticLMData(cfg, 2, 8, seed=1)
    loader = PrefetchingLoader(data, "cpu")
    try:
        for step in (0, 1, 2):
            got = loader.next(step)
            assert np.array_equal(got["tokens"].numpy(),
                                  data.batch_at(step)["tokens"])
        loader.seek(40)
        assert np.array_equal(loader.next(40)["tokens"].numpy(),
                              data.batch_at(40)["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_the_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--steps",
            "3", "--seq-len", "16", "--batch", "2", "--ckpt-every", "3",
            "--ckpt-dir", str(tmp_path)]
    handler = signal.getsignal(signal.SIGTERM)
    t = train_launcher.main(argv)
    assert [r["step"] for r in t.history] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in t.history)
    assert t.ckpt.latest_step() == 2
    out = capsys.readouterr().out
    assert "[train] qwen3-4b-smoke:" in out and "on cpu" in out
    resumed = train_launcher.main(argv)          # restores step 2
    assert resumed.start_step == 3
    assert [r["step"] for r in resumed.history] == [3, 4, 5]
    # the launcher put SIGTERM's handler back
    assert signal.getsignal(signal.SIGTERM) is handler


@pytest.mark.parametrize("arch,flags", [("rwkv6-7b", ["--int8-opt"]),
                                        ("zamba2-1.2b", [])])
def test_the_launcher_trains_and_resumes_the_recurrent_archs(arch, flags,
                                                             tmp_path):
    """The smoke configs at S 128 (two chunks of the scan), rwkv6 with
    int8 states as it trains on the card: 3 steps and a checkpoint, then
    the same command resumes from it."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
            "--seq-len", "128", "--batch", "2", "--ckpt-every", "3",
            "--ckpt-dir", str(tmp_path)] + flags
    t = train_launcher.main(argv)
    assert [r["step"] for r in t.history] == [0, 1, 2]
    assert all(np.isfinite([r["loss"], r["grad_norm"]]).all()
               for r in t.history)
    assert t.ckpt.latest_step() == 2
    assert isinstance(t.opt_state["m"]["embed"]["table"],
                      opt.QTensor) == bool(flags)
    resumed = train_launcher.main(argv)
    assert resumed.start_step == 3
    assert [r["step"] for r in resumed.history] == [3, 4, 5]
    assert all(np.isfinite(r["loss"]) for r in resumed.history)


def test_entry_points_without_a_card_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_tc(tmp_path / "t"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launcher.main(["--arch", "qwen3-4b", "--smoke",
                             "--ckpt-dir", str(tmp_path / "l")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrefetchingLoader(SyntheticLMData(get_smoke_config("qwen3-4b"), 1,
                                          4))


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------
def _setup(arch, seed=0):
    ref_cfg = dataclasses.replace(ref_registry.get_smoke_config(arch),
                                  dtype="float32")
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="float32")
    ref = RM.init(jax.random.PRNGKey(seed), ref_cfg)
    params = carry.lm_params_from_reference(jax.tree.map(np.asarray, ref),
                                            cfg, "cpu")
    for _, p in opt.flatten(params):
        p.requires_grad_(True)
    return ref_cfg, cfg, ref, params


def _batch(cfg, B, S=32, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_grads(ref, ref_cfg, cfg, batch):
    """The reference's gradients of ``loss_fn``, in the port's layout."""
    ctx = single_device_ctx()
    _, g = jax.jit(lambda p, b: jax.value_and_grad(
        RM.loss_fn, has_aux=True)(p, ref_cfg, ctx, b))(
            ref, {k: jnp.asarray(v) for k, v in batch.items()})
    return carry.lm_params_from_reference(jax.tree.map(np.asarray, g), cfg,
                                          "cpu")


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_one_train_step_matches_the_references(microbatches, int8):
    arch = "qwen3-4b"
    ref_cfg, cfg, ref, params = _setup(arch)
    oc = dict(lr=1e-2, warmup_steps=0, total_steps=10, int8_states=int8)
    ref_tc = ref_base.TrainConfig(model=ref_cfg,
                                  opt=ref_base.OptimizerConfig(**oc),
                                  seq_len=32, global_batch=4,
                                  microbatches=microbatches)
    tc = base.TrainConfig(model=cfg, opt=base.OptimizerConfig(**oc),
                          seq_len=32, global_batch=4,
                          microbatches=microbatches)
    batch = _batch(cfg, B=4)
    ref_state = ref_opt.init_state(ref_tc.opt, ref)
    step = ref_step.make_train_step(ref_tc, ref_cfg, single_device_ctx(),
                                    donate=False)
    ref_new, ref_state, _, ref_m = step(
        ref, ref_state, {k: jnp.asarray(v) for k, v in batch.items()}, {})
    state = opt.init_state(tc.opt, params)
    ref_g = params if int8 else _ref_grads(ref, ref_cfg, cfg, batch)
    params, state, m = make_train_step(tc, cfg)(params, state,
                                               _torch_batch(batch))
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(ref_m[key]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=key)
    want = carry.lm_params_from_reference(jax.tree.map(np.asarray, ref_new),
                                          cfg, "cpu")
    lr = oc["lr"]
    apart, total = 0, 0
    for (path, a), (_, b), (_, gr) in zip(opt.flatten(params),
                                          opt.flatten(want),
                                          opt.flatten(ref_g)):
        a = a.detach()
        close = torch.isclose(a, b, rtol=1e-6,
                              atol=1e-6 * float(b.abs().max()))
        apart += int((~close).sum())
        total += a.numel()
        if int8:
            assert float((a - b).abs().max()) <= 9 * lr, path
        else:
            small = gr.abs() < 1e-3 * float(gr.abs().max())
            assert bool((close | small).all()), path
            assert float((a - b).abs().max()) <= 2.0 * lr * (1 + 1e-6)
    print(f"params outside 1e-6: {apart} of {total}")
    assert apart <= (total * 3 // 100 if int8 else total // 1000), apart
    assert int(state["step"]) == 1
    if int8:
        ref_st = carry.opt_state_from_reference(
            jax.tree.map(np.asarray, ref_state), cfg, "cpu")
        for key in ("m", "v"):
            for (path, a), (_, b) in zip(opt.flatten(state[key]),
                                         opt.flatten(ref_st[key])):
                assert int((a.q.int() - b.q.int()).abs().max()) <= 1, path


def test_grad_compression_without_a_pod_axis_is_the_plain_step():
    """The reference ignores ``grad_compression`` where the mesh has no
    ``pod`` axis (``src/repro/train/step.py:62``); so does the port on
    one device: the same step, bit for bit."""
    _, cfg, _, params = _setup("qwen3-4b")
    batch = _torch_batch(_batch(cfg, B=4))
    runs = []
    for compress in (False, True):
        tc = base.TrainConfig(model=cfg, opt=base.OptimizerConfig(
            lr=1e-2, warmup_steps=0, total_steps=10,
            grad_compression=compress), seq_len=32, global_batch=4)
        p = [t.detach().clone().requires_grad_(True)
             for _, t in opt.flatten(params)]
        p = opt.unflatten(params, p)
        state = opt.init_state(tc.opt, p)
        p, state, m = make_train_step(tc, cfg)(p, state, batch)
        runs.append((p, m))
    (a, ma), (b, mb) = runs
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert float(ma[key]) == float(mb[key]), key
    for (_, x), (_, y) in zip(opt.flatten(a), opt.flatten(b)):
        assert torch.equal(x, y)

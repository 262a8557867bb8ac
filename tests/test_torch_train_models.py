"""The port's training forward against the JAX package: the loss and
every gradient per family, and the remat policies.

Params come from ``repro.models.model.init(PRNGKey(0), cfg)`` in f32 and
are carried into the port with ``lm_params_from_reference``; batches are
made with numpy from a seed. The port runs on the CPU (B4's plain
version forward, the plain backward).

Tolerances, each with its reason:

  - loss, 1e-5 relative: sums in other orders (attention tiles, the
    cross-entropy's sum over the vocab);
  - gradients, per leaf: rtol 1e-5 and atol 1e-5 x the leaf's largest
    |gradient| (measured: at most 3e-6 of it; rwkv6-7b's too). zamba2's,
    1e-4 (``GRAD_TOLS``): measured 2.6e-5 of conv_w's largest, and the
    reference against itself at chunks of 32 in place of 64 moves the
    same leaf by 2.3e-5 of it (its logits differ from the port's by
    2.3e-5 at |logit| 4.2: the SSD state grows to ~11 over four Mamba
    layers);
  - remat: the three policies recompute the same operations on the same
    inputs, so their gradients are equal bit for bit;
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.distributed.meshctx import single_device_ctx
from repro.models import model as RM
from repro_torch import carry
from repro_torch.configs import registry
from repro_torch.models import model as TM
from repro_torch.models import rematcfg
from repro_torch.train import optimizer as opt

torch.set_num_threads(2)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
GRAD_TOLS = {"zamba2-1.2b": 1e-4}
FAMILY_ARCHS = ("qwen2-0.5b", "qwen3-4b", "gemma3-4b", "qwen3-moe-235b-a22b",
                "musicgen-medium", "llama-3.2-vision-90b", "rwkv6-7b",
                "zamba2-1.2b")
# the recurrent archs at S 128, two chunks of 64: the scan's carry is used
SEQ = {"rwkv6-7b": 128, "zamba2-1.2b": 128}


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


def _batch(cfg, B=2, S=32, seed=1):
    """tokens, or for embeddings-in (musicgen) labels and embeds; the
    VLM's image embeddings beside them, as ``SyntheticLMData`` lays a
    batch out."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.embeds_input:
        batch = {"labels": toks, "embeds": (rng.standard_normal(
            (B, S, cfg.d_model)) * 0.02).astype(np.float32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = (rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(params, cfg, batch, remat=True):
    loss, (ce, aux) = TM.loss_fn(params, cfg, _torch_batch(batch),
                                 remat=remat)
    leaves = [p for _, p in opt.flatten(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), ce.detach(), aux.detach(), grads


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch):
    ref_cfg, cfg, ref, params = _setup(arch)
    batch = _batch(cfg, S=SEQ.get(arch, 32))
    ctx = single_device_ctx()
    (loss, (ce, aux)), g = jax.jit(lambda p, b: jax.value_and_grad(
        RM.loss_fn, has_aux=True)(p, ref_cfg, ctx, b))(
            ref, {k: jnp.asarray(v) for k, v in batch.items()})
    t_loss, t_ce, t_aux, t_grads = _grads(params, cfg, batch)
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(t_ce), float(ce), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(t_aux), float(aux), rtol=LOSS_TOL,
                               atol=1e-7)
    if cfg.n_experts:
        assert float(t_aux) > 0
    want = carry.lm_params_from_reference(jax.tree.map(np.asarray, g), cfg,
                                          "cpu")
    flat = opt.flatten(want)
    assert len(flat) == len(t_grads)
    tol = GRAD_TOLS.get(arch, GRAD_TOL)
    for (path, w), got in zip(flat, t_grads):
        scale = float(w.abs().max())
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=tol,
                                   atol=tol * max(scale, 1e-30),
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama-3.2-vision-90b", "rwkv6-7b",
                                  "zamba2-1.2b"])
def test_remat_policies_give_equal_gradients(arch):
    _, cfg, _, params = _setup(arch)
    batch = _batch(cfg, S=SEQ.get(arch, 32))
    runs = {policy: _grads(params, cfg, batch, remat=policy)
            for policy in rematcfg.POLICIES}
    base_loss, _, _, base_grads = runs["none"]
    for policy, (loss, _, _, grads) in runs.items():
        assert torch.equal(loss, base_loss), policy
        for a, b in zip(grads, base_grads):
            assert torch.equal(a, b), policy
    assert rematcfg.resolve(True) == "minimal"
    assert rematcfg.resolve(False) == "none"
    with pytest.raises(ValueError, match="remat policy"):
        rematcfg.resolve("everything")


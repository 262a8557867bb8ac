"""The reference's perf flags on a mesh, on the CPU: the port's ranks of
a gloo world of 8 on a 2 x 4 ``("data", "model")`` mesh
(``tests/torch_perf_mesh_ranks.py``) against the JAX package on an
Auto-axis 2 x 4 ``Mesh`` (ROADMAP C25; ``tests/torch_perf_mesh_ref.py``,
a subprocess started first, so that the two run side by side), each with
the same flags set (``models/perfcfg``), on the same numpy weights and
tokens, in f32:

  - qwen2-0.5b's smoke config with 6 q heads over 2 kv heads, which do
    not divide the model axis of 4 (as qwen2-0.5b's 14 do not), at S
    1024 (the reference's ``seq_shard_attn`` needs S >= 1024), B 2:
    ``seq_shard_attn`` (each rank's rows, B4 at a query offset), and
    ``sp_residual`` (the residual stream as the rank's rows): the
    prefill's logits and the gradients of ``loss_fn``;
  - qwen3-moe-235b-a22b's smoke config, S 64, B 2: ``a2a_int8`` (with
    ``sp_residual``, the reference's ``a2aint8`` variant);
  - on the port alone, against the flag off: ``sp_residual`` on
    kimi-k2's smoke config (a dense lead, a shared expert) and on the
    qwen2 config above with an FFN 130 wide, which does not divide the
    model axis (replicated there).

Tolerances, each with its reason:

  - ``sp_residual`` against the flag off, the port's own: bit for bit.
    In f32 over gloo a reduce-scatter is an all-reduce and its block,
    and the norms and residual adds on a rank's rows are those rows of
    the whole sequence's;
  - against the reference, 1e-5 (logits, rtol and atol) and 1e-5 of a
    leaf's largest |value| (gradients): the same products summed in
    other orders, as ``tests/test_torch_lm_mesh.py`` and
    ``tests/test_torch_train_mesh.py`` hold the mesh;
  - ``a2a_int8`` against the reference's mesh: as above (the int8
    quantization is the reference's bit for bit,
    ``tests/test_torch_perfcfg.py``), and the reference test's own rule
    (mean |Δ| / mean |base| < 0.03) against the flag off.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import torch_perf_mesh_ranks as ranks
from repro.configs import registry as ref_registry
from repro.models import model as RM
from repro_torch import carry
from repro_torch.configs import registry
from repro_torch.train import optimizer as opt

ROOT = Path(__file__).resolve().parents[1]
REF = Path(__file__).resolve().parent / "torch_perf_mesh_ref.py"
F32_TOL = 1e-5
QWEN = ("qwen2-0.5b", {"n_heads": 6, "dtype": "float32"})
MOE = ("qwen3-moe-235b-a22b", {"dtype": "float32"})
KIMI = ("kimi-k2-1t-a32b", {"dtype": "float32"})
# an FFN that does not divide the model axis of 4 (replicated there)
QWEN_FF = ("qwen2-0.5b", {"n_heads": 6, "d_ff": 130, "dtype": "float32"})
SEQ = {"seq_shard_attn": True}
SP = {"sp_residual": True}
A2A = {"sp_residual": True, "a2a_int8": True}


def _case(tag, model, flags, tokens, prefill=True, grads=False):
    arch, fields = model
    return {"tag": tag, "arch": arch, "cfg": fields, "flags": flags,
            "weights": _weights(model), "tokens": tokens,
            "prefill": prefill, "grads": grads}


def _weights(model):
    arch, fields = model
    return arch + "".join(f"-{k}{v}" for k, v in sorted(fields.items())
                          if k != "dtype")


# the port's cases; the reference takes those of REF_TAGS
CASES = [_case("qwen-off", QWEN, {}, "tokens_qwen.npy", grads=True),
         _case("qwen-seq", QWEN, SEQ, "tokens_qwen.npy", grads=True),
         _case("qwen-sp", QWEN, SP, "tokens_qwen.npy", grads=True),
         _case("qwen-both", QWEN, {**SEQ, **SP}, "tokens_qwen.npy"),
         _case("moe-off", MOE, {}, "tokens_moe.npy"),
         _case("moe-sp", MOE, SP, "tokens_moe.npy"),
         _case("moe-a2a", MOE, A2A, "tokens_moe.npy"),
         _case("kimi-off", KIMI, {}, "tokens_moe.npy"),
         _case("kimi-sp", KIMI, SP, "tokens_moe.npy"),
         _case("ff-off", QWEN_FF, {}, "tokens_qwen.npy", grads=True),
         _case("ff-sp", QWEN_FF, SP, "tokens_qwen.npy", grads=True)]
REF_TAGS = ("qwen-seq", "qwen-sp", "qwen-both", "moe-a2a")


def _np_params(arch, fields, seed):
    """The reference's tree for the case's config drawn with numpy (f32):
    matrices N(0, 1/fan_in), the embedding N(0, 0.02²), norms 1 +
    N(0, 0.1²), biases N(0, 0.1²)."""
    cfg = dataclasses.replace(ref_registry.get_smoke_config(arch), **fields)
    shapes = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(p.key for p in path)
        name, shape = path[-1].key, leaf.shape
        if name in ("ln1", "ln2", "final_norm", "q_norm", "k_norm"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bq", "bk", "bv"):
            a = 0.1 * rng.standard_normal(shape)
        elif name == "table":
            a = 0.02 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        flat[key] = a.astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("perf_mesh_in")
    rng = np.random.default_rng(5)
    for seed, model in enumerate((QWEN, MOE, KIMI, QWEN_FF)):
        np.savez(d / f"{_weights(model)}.npz",
                 **_np_params(*model, 40 + seed))
    vocab = ref_registry.get_smoke_config(QWEN[0]).vocab_size
    np.save(d / "tokens_qwen.npy",
            rng.integers(0, vocab, (2, 1024)).astype(np.int32))
    vocab = ref_registry.get_smoke_config(MOE[0]).vocab_size
    np.save(d / "tokens_moe.npy",
            rng.integers(0, vocab, (2, 64)).astype(np.int32))
    (d / "cases.json").write_text(json.dumps(
        [c for c in CASES if c["tag"] in REF_TAGS]))
    return d


@pytest.fixture(scope="module")
def reference(inputs):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, str(REF), str(inputs)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ports(inputs, reference, tmp_path_factory):
    return ranks.run(tmp_path_factory.mktemp("perf_world"),
                     inputs=str(inputs), cases=CASES)


@pytest.fixture(scope="module")
def port(ports):
    return ports[0]


@pytest.fixture(scope="module")
def ref(reference, inputs):
    _, err = reference.communicate(timeout=900)
    assert reference.returncode == 0, err[-3000:]
    return dict(np.load(inputs / "out.npz"))


def _ref_grads(ref, tag, model):
    """The reference's gradients of ``tag`` in the port's layout."""
    arch, fields = model
    prefix = f"{tag}/grads/"
    tree = {}
    for key, a in ref.items():
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a
    cfg = dataclasses.replace(registry.get_smoke_config(arch), **fields)
    got = carry.lm_params_from_reference(tree, cfg, "cpu")
    return {"/".join(map(str, path)): t.numpy()
            for path, t in opt.flatten(got)}


def _grads_held(got, want, what):
    assert set(got) == set(want), what
    for key in want:
        tol = F32_TOL * float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=max(tol, 1e-30),
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("tag", ["qwen-seq", "qwen-sp", "qwen-both"])
def test_qwen2_prefill_under_the_flags_equals_the_references(port, ref, tag):
    np.testing.assert_allclose(port[f"{tag}/prefill"], ref[f"{tag}/prefill"],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("tag", ["qwen-seq", "qwen-sp"])
def test_qwen2_gradients_under_the_flags_equal_the_references(port, ref,
                                                              tag):
    _grads_held(port[f"{tag}/grads"], _ref_grads(ref, tag, QWEN), tag)


@pytest.mark.parametrize("tag", ["qwen", "moe", "kimi"])
def test_sp_residual_is_the_flag_off_bit_for_bit(port, tag):
    assert np.array_equal(port[f"{tag}-sp/prefill"],
                          port[f"{tag}-off/prefill"])


def test_sp_residual_gradients_equal_the_flag_off(port):
    _grads_held(port["qwen-sp/grads"], port["qwen-off/grads"], "sp vs off")


def test_sp_residual_runs_a_replicated_ffn_on_the_ranks_rows(port):
    """An FFN whose width (130) does not divide the model axis is
    replicated there; under ``sp_residual`` each rank runs it on its own
    rows, its weights entering "f": the logits within 1e-5 of the flag
    off (its products on fewer rows may round otherwise), the
    gradients within 1e-5 of a leaf's largest."""
    np.testing.assert_allclose(port["ff-sp/prefill"], port["ff-off/prefill"],
                               rtol=F32_TOL, atol=F32_TOL)
    _grads_held(port["ff-sp/grads"], port["ff-off/grads"], "ff sp vs off")


def test_seq_shard_attn_gradients_equal_the_flag_off(port):
    _grads_held(port["qwen-seq/grads"], port["qwen-off/grads"], "seq vs off")


def test_the_flags_change_the_ranks_collectives(ports):
    """``sp_residual`` ends blocks with reduce-scatters over ``model``
    (the flag off has none in a prefill); ``seq_shard_attn`` gathers each
    layer's rows (an all-gather over ``model`` the flag off does not
    make for attention replicated there)."""
    for o in ports:
        off, sp = o["qwen-off/stats"]["by"], o["qwen-sp/stats"]["by"]
        seq = o["qwen-seq/stats"]["by"]
        assert "reduce_scatter/model" not in off
        n_layers = registry.get_smoke_config(QWEN[0]).n_layers
        # the embedding and each layer's wo (replicated: none) and w_down
        assert sp["reduce_scatter/model"]["calls"] == 1 + n_layers
        assert seq["all_gather/model"]["calls"] == \
            off.get("all_gather/model", {}).get("calls", 0) + n_layers


def test_a2a_int8_on_the_mesh_equals_the_references(port, ref):
    np.testing.assert_allclose(port["moe-a2a/prefill"], ref["moe-a2a/prefill"],
                               rtol=F32_TOL, atol=F32_TOL)


def test_a2a_int8_on_the_mesh_is_close_to_the_flag_off(port):
    base, opt_ = port["moe-off/prefill"], port["moe-a2a/prefill"]
    assert np.abs(opt_ - base).mean() / (np.abs(base).mean() + 1e-6) < 0.03

"""What the dry run reads of the configs, and its input stand-ins, against
the JAX package: ``SHAPES``, ``shape_applicable``, ``param_count`` and
``active_param_count`` of the ten full configs; ``launch.specs``'
``batch_specs``, ``input_specs`` and ``cache_struct`` (meta tensors)
against the reference's ``ShapeDtypeStruct``s (its ``cache_struct`` is
``jax.eval_shape`` of ``init_cache``) leaf by leaf, for each arch and
shape, under the module's dtype map (int32 ids and ``cur_index``, bf16
embeddings, the cache in the config's dtype); and ``perfcfg``'s variants.
The one difference of layout, stated in ``launch/specs.py``: the VLM's
self caches are flat in the port, the reference's ``[n_sb, per, ...]``
with the two superblock axes merged.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.launch import specs as ref_specs
from repro.models import perfcfg as ref_perfcfg
from repro_torch.configs import base
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.launch import specs
from repro_torch.models import perfcfg

DTYPES = {np.dtype("int32"): torch.int32,
          np.dtype(jax.numpy.bfloat16): torch.bfloat16,
          np.dtype("float32"): torch.float32}


def test_the_shapes_are_the_references():
    assert set(base.SHAPES) == set(ref_base.SHAPES)
    for name, s in base.SHAPES.items():
        r = ref_base.SHAPES[name]
        assert (s.name, s.kind, s.seq_len, s.global_batch) == \
            (r.name, r.kind, r.seq_len, r.global_batch)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_parameter_counts_and_rules_are_the_references(arch):
    cfg, ref = get_config(arch), ref_registry.get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.supports_long_context == ref.supports_long_context
    for name in base.SHAPES:
        assert base.shape_applicable(cfg, base.SHAPES[name]) == \
            ref_base.shape_applicable(ref, ref_base.SHAPES[name])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _held(got, want, vlm_cache=False):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        shape = tuple(w.shape)
        if vlm_cache and key in ("k", "v"):       # [n_sb, per, ...] flat
            shape = (shape[0] * shape[1],) + shape[2:]
        assert g.device.type == "meta", key
        assert tuple(g.shape) == shape, key
        assert g.dtype == DTYPES[np.dtype(w.dtype)], key


@pytest.mark.parametrize("shape", list(base.SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_are_the_references(arch, shape):
    cfg, ref = get_config(arch), ref_registry.get_config(arch)
    s, r = base.SHAPES[shape], ref_base.SHAPES[shape]
    _held(specs.batch_specs(cfg, s.global_batch, s.seq_len),
          ref_specs.batch_specs(ref, r.global_batch, r.seq_len))
    got, want = specs.input_specs(cfg, s), ref_specs.input_specs(ref, r)
    assert set(got) == set(want)
    _held(got["batch"], want["batch"])
    if s.kind == "decode":
        _held(got["cache"], want["cache"], vlm_cache=cfg.family == "vlm")
        _held({"i": got["cur_index"]}, {"i": want["cur_index"]})


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_struct_is_the_references_eval_shape(arch):
    cfg, ref = get_config(arch), ref_registry.get_config(arch)
    _held(specs.cache_struct(cfg, 2, 64), ref_specs.cache_struct(ref, 2, 64),
          vlm_cache=cfg.family == "vlm")


def test_the_perf_variants_are_the_references():
    assert perfcfg.VARIANTS == ref_perfcfg.VARIANTS
    perfcfg.reset()
    ref_perfcfg.reset()
    assert perfcfg._FLAGS == ref_perfcfg._FLAGS
    for name in perfcfg.VARIANTS:
        perfcfg.set_variant(name)
        ref_perfcfg.set_variant(name)
        assert perfcfg._FLAGS == ref_perfcfg._FLAGS, name
    perfcfg.reset()
    ref_perfcfg.reset()
    with pytest.raises(KeyError):
        perfcfg.set_flags(no_such_flag=True)

"""The reference's side of ``tests/test_torch_perf_mesh.py``: run as a
script in a subprocess of its own, with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, on an Auto-axis
2 x 4 ``jax.sharding.Mesh`` (ROADMAP C25).

    python tests/torch_perf_mesh_ref.py <dir>

reads ``<dir>/cases.json`` (a tag, an arch, its smoke config's changed
fields, the perf flags, the tokens' file, and whether to take the
prefill's logits and the gradients of ``loss_fn``) and each case's
weights ``<dir>/<weights>.npz`` (``torch_lm_mesh_ranks.save_params``'
format), sets the flags (``repro.models.perfcfg``), and writes
``<dir>/out.npz``: per tag the prefill logits and the gradients, f32.

Not a test module: pytest collects ``test_*.py`` only.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.distributed.meshctx import MeshCtx  # noqa: E402
from repro.distributed.sharding import build_param_shardings  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import perfcfg  # noqa: E402


def load(root, name, cfg):
    z = np.load(os.path.join(root, f"{name}.npz"))
    shapes = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), cfg))

    def leaf(path, _):
        return jnp.asarray(z["/".join(p.key for p in path)])
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def main():
    root = sys.argv[1]
    assert len(jax.devices()) == 8
    ctx = MeshCtx(mesh=Mesh(np.array(jax.devices()).reshape(2, 4),
                            ("data", "model")),
                  dp_axes=("data",), fsdp_axis="data", tp_axis="model")
    out = {}
    for case in json.load(open(os.path.join(root, "cases.json"))):
        cfg = dataclasses.replace(registry.get_smoke_config(case["arch"]),
                                  **case["cfg"])
        params = load(root, case["weights"], cfg)
        p = jax.device_put(params, build_param_shardings(params, cfg, ctx))
        batch = {"tokens": jnp.asarray(
            np.load(os.path.join(root, case["tokens"])))}
        perfcfg.reset()
        perfcfg.set_flags(**case["flags"])
        tag = case["tag"]
        if case["prefill"]:
            logits = jax.jit(lambda p, b: RM.apply_prefill(
                p, cfg, ctx, b)[0])(p, batch)
            out[f"{tag}/prefill"] = np.asarray(logits, np.float32)
        if case["grads"]:
            grads = jax.jit(jax.grad(lambda p, b: RM.loss_fn(
                p, cfg, ctx, b)[0]))(p, batch)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
                key = "/".join(p.key for p in path)
                out[f"{tag}/grads/{key}"] = np.asarray(g, np.float32)
    perfcfg.reset()
    np.savez(os.path.join(root, "out.npz"), **out)


if __name__ == "__main__":
    main()

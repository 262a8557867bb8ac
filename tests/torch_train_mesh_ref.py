"""The reference's side of ``tests/test_torch_train_mesh.py``: run as a
script in a subprocess of its own, with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, on Auto-axis
``jax.sharding.Mesh``es (ROADMAP C25).

    python tests/torch_train_mesh_ref.py <dir> <part>

reads ``<dir>/jobs_<part>.json`` (a list of jobs: a tag, an arch, a
dtype, a mesh shape, int8 states, grad compression, microbatches, and
whether to keep the gradients or save a checkpoint) and the weights
``<dir>/<arch>-<dtype>.npz`` (``torch_lm_mesh_ranks.save_params``'
format), runs each job's two train steps (``make_train_step`` with
``donate=False``) on ``SyntheticLMData(cfg, 8, 32, seed=0)``'s batches
0 and 1, and writes ``<dir>/out_<part>.npz``: per tag the gradients of
``loss_fn`` at the first params, and after each step the metrics, the
params, the optimizer states and the error feedback, every array as f32
(int8 payloads as they are).

Not a test module: pytest collects ``test_*.py`` only.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.checkpoint.manager import CheckpointManager  # noqa: E402
from repro.configs import base, registry  # noqa: E402
from repro.data.pipeline import SyntheticLMData  # noqa: E402
from repro.distributed.compression import init_error_state  # noqa: E402
from repro.distributed.meshctx import MeshCtx  # noqa: E402
from repro.distributed.sharding import build_param_shardings  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import optimizer as O  # noqa: E402
from repro.train import step as S  # noqa: E402

B, SEQ, LR, EPS = 8, 32, 1e-3, 1e-3


def mesh_ctx(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    n = int(np.prod(shape))
    return MeshCtx(mesh=Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             names),
                   dp_axes=names[:-1], fsdp_axis="data", tp_axis="model")


def load(root, arch, dtype, cfg):
    z = np.load(os.path.join(root, f"{arch}-{dtype}.npz"))
    shapes = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), cfg))

    def leaf(path, _):
        key = "/".join(p.key for p in path)
        if key + "|bf16" in z.files:
            return jnp.asarray(z[key + "|bf16"].view(ml_dtypes.bfloat16))
        return jnp.asarray(z[key])
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def compiled(fn, dtype):
    """``jax.jit(fn)``; bf16 without XLA's excess precision, as the
    port's tests run the reference. A compile is kept for the arguments'
    shapes, types and shardings, as ``jax.jit`` keeps its own: a step's
    outputs may come out laid out otherwise than its inputs went in
    (rwkv6's per-head leaves over ``model``), and the next step then
    compiles anew."""
    jitted = jax.jit(fn)
    if dtype != "bfloat16":
        return jitted
    cache = {}

    def run(*args):
        key = str(jax.tree.map(lambda a: (jnp.shape(a), jnp.result_type(a),
                                          getattr(a, "sharding", None)),
                               args))
        if key not in cache:
            cache[key] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return cache[key](*args)
    return run


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, O.QTensor))[0]:
        key = prefix + "/".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        if isinstance(leaf, O.QTensor):
            out[key + "/q"] = np.asarray(leaf.q)
            out[key + "/scale"] = np.asarray(leaf.scale, np.float32)
        else:
            out[key] = np.asarray(leaf, np.float32)
    return out


def run_job(root, job, out):
    tag, arch, dtype = job["tag"], job["arch"], job["dtype"]
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype)
    ctx = mesh_ctx(tuple(job["mesh"]))
    params = load(root, arch, dtype, cfg)
    p = jax.device_put(params, build_param_shardings(params, cfg, ctx))
    tc = base.TrainConfig(
        model=cfg, opt=base.OptimizerConfig(
            lr=LR, eps=EPS, warmup_steps=0, total_steps=10,
            int8_states=job["int8"], grad_compression=job["compress"]),
        seq_len=SEQ, global_batch=B, microbatches=job["micro"])
    data = SyntheticLMData(cfg, B, SEQ, seed=0)
    batches = [{k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
               for i in range(2)]
    state = O.init_state(tc.opt, p)
    if job["compress"]:
        if job["grads"]:
            vg = compiled(lambda p, b: jax.value_and_grad(
                RM.loss_fn, has_aux=True)(p, cfg, ctx, b), dtype)
            out.update(flat(vg(p, batches[0])[1], f"{tag}/grads/"))
        train = compiled(S.make_train_step(tc, cfg, ctx, jit=False), dtype)
        err = init_error_state(p)

        def step(p, state, batch, err):
            return train(p, state, batch, err) + (None,)
    else:
        # the reference's SPMD train_step (``_grads_fn``, then
        # ``apply_updates``), its gradients kept: one compile for both
        def spmd(p, state, batch):
            grads, m = S._grads_fn(tc, cfg, ctx)(p, batch)
            p, state, om = O.apply_updates(tc.opt, p, grads, state)
            m.update(om)
            return p, state, m, grads
        train = compiled(spmd, dtype)
        err = {}

        def step(p, state, batch, err):
            p, state, m, grads = train(p, state, batch)
            return p, state, err, m, grads
    for i, batch in enumerate(batches):
        p, state, err, m, grads = step(p, state, batch, err)
        if i == 0 and job["grads"] and grads is not None:
            out.update(flat(grads, f"{tag}/grads/"))
        for k, v in m.items():
            out[f"{tag}/step{i}/metrics/{k}"] = np.asarray(v, np.float32)
        out.update(flat(p, f"{tag}/step{i}/params/"))
        out.update(flat({"m": state["m"], "v": state["v"]},
                        f"{tag}/step{i}/"))
        if job["compress"]:
            out.update(flat(err, f"{tag}/step{i}/err/"))
        if i == 0 and job.get("save"):
            CheckpointManager(os.path.join(root, job["save"])).save(
                0, {"params": p, "opt": state}, {"next_step": 1})


def main():
    root, part = sys.argv[1], sys.argv[2]
    assert len(jax.devices()) == 8
    jobs = json.load(open(os.path.join(root, f"jobs_{part}.json")))
    out = {}
    for job in jobs:
        run_job(root, job, out)
    np.savez(os.path.join(root, f"out_{part}.npz"), **out)


if __name__ == "__main__":
    main()

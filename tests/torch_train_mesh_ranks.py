"""The ranks of ``tests/test_torch_train_mesh.py``: each runs in a process
of its own (``run``: a spawn, a gloo group through a
``FileStore`` under the test's directory), imports torch and
``repro_torch`` only, trains the test's cases on the CPU and pickles
what it found to ``<dir>/<rank>.pkl``. Rank 0 keeps the whole arrays,
gathered from every rank's blocks (``sharding.gather_whole``).

Not a test module: pytest collects ``test_*.py`` only.
"""
import dataclasses
import datetime
import os
import pickle
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

import torch_lm_mesh_ranks as lm_ranks
from repro_torch import carry
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLMData, shard_batch
from repro_torch.distributed import compat, sharding
from repro_torch.distributed.meshctx import MeshCtx
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import Trainer
from repro_torch.train.step import dp_summed, make_train_step

B, SEQ, LR, EPS = 8, 32, 1e-3, 1e-3
TIMEOUT = datetime.timedelta(seconds=300)
REF_WAIT_S = 300


def run(*worlds):
    """Run each ``(world size, job, root, kw)`` on its own gloo ranks, all
    the worlds at once; each world's ranks' results, by rank."""
    running = [mp.start_processes(_entry, args=(n, str(root), job, kw),
                                  nprocs=n, join=False,
                                  start_method="spawn")
               for n, job, root, kw in worlds]
    for ctx in running:
        while not ctx.join():
            pass
    out = []
    for n, _, root, _ in worlds:
        ranks = []
        for rank in range(n):
            with open(os.path.join(root, f"{rank}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        out.append(ranks)
    return out


def _entry(rank, world, root, job, kw):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "filestore"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        out = JOBS[job](root=root, **kw)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def ctx_of(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)
    return MeshCtx(mesh, dp_axes=names[:-1], device="cpu")


def rank0(ctx):
    return all(ctx.coord(a) == 0 for a in ctx.shape)


def train_config(case, root):
    cfg = dataclasses.replace(registry.get_smoke_config(case["arch"]),
                              dtype=case["dtype"])
    return TrainConfig(
        model=cfg, opt=OptimizerConfig(
            lr=LR, eps=EPS, warmup_steps=0, total_steps=10,
            int8_states=case["int8"], grad_compression=case["compress"]),
        seq_len=SEQ, global_batch=B, microbatches=case["micro"],
        checkpoint_every=1000, keep_checkpoints=3,
        checkpoint_dir=os.path.join(root, "ckpt-" + case["tag"]))


def _np(t):
    """A numpy copy (a replicated leaf is gathered as itself, and the
    next step updates it in place)."""
    t = t.detach()
    return (t.float() if t.dtype != torch.int8 else t).numpy().copy()


def whole(tree, specs, ctx):
    """{path: numpy} of a tree of blocks gathered whole (QTensors as
    ``/q`` and ``/scale``), on rank 0; None on the others."""
    out = {}
    for (path, leaf), (_, spec) in zip(opt.flatten(tree),
                                       opt.flatten(specs)):
        key = "/".join(str(p) for p in path)
        parts = {"/q": (leaf.q, spec.q), "/scale": (leaf.scale, spec.scale)} \
            if isinstance(leaf, opt.QTensor) else {"": (leaf, spec)}
        for suffix, (t, sp) in parts.items():
            got = sharding.gather_whole(t, sp, ctx)
            if got is not None:
                out[key + suffix] = _np(got)
    return out if rank0(ctx) else None


def state_shapes_held(trainer):
    """Whether every optimizer-state block has the shape that
    ``opt_state_specs`` gives the whole state's leaf on this rank."""
    ctx, specs = trainer.ctx, trainer.specs
    meta = opt.tree_map(lambda p, s: torch.zeros(
        sharding.whole_shape(p.shape, s, ctx), device="meta"),
        trainer.params, specs)
    wstate = opt.init_state(trainer.tc.opt, meta)
    wspecs = sharding.opt_state_specs(wstate, specs, ctx)
    ok = []
    for key in ("m", "v"):
        for (_, w), (_, s), (_, got) in zip(
                opt.flatten(wstate[key]), opt.flatten(wspecs[key]),
                opt.flatten(trainer.opt_state[key])):
            pairs = [(w.q, s.q, got.q), (w.scale, s.scale, got.scale)] \
                if isinstance(w, opt.QTensor) else [(w, s, got)]
            for wt, sp, g in pairs:
                want = tuple(len(range(*ctx.block(n, e).indices(n)))
                             for n, e in zip(wt.shape, tuple(sp) + (None,) *
                                             (wt.dim() - len(sp))))
                ok.append(tuple(g.shape) == want)
    return all(ok), len(ok)


def grads_of(params, specs, cfg, ctx, batch):
    """(the gradients of ``loss_fn`` summed over the dp axes, whole on
    rank 0; this rank's gradients of the leaves it holds whole, the
    replicated ones)."""
    loss, _ = M.loss_fn(params, cfg, batch, ctx=ctx, rows=B)
    g = torch.autograd.grad(loss, [p for _, p in opt.flatten(params)],
                            allow_unused=True, materialize_grads=True)
    g = dp_summed(opt.unflatten(params, list(g)), ctx, specs, ctx.dp_axes)
    own = {"/".join(map(str, path)): _np(t)
           for (path, t), (_, spec) in zip(opt.flatten(g),
                                           opt.flatten(specs))
           if not any(spec)}
    return whole(g, specs, ctx), own


def snapshot(trainer):
    tree = {"params": trainer.params, "m": trainer.opt_state["m"],
            "v": trainer.opt_state["v"]}
    specs = {"params": trainer.specs, "m": trainer.opt_specs["m"],
             "v": trainer.opt_specs["v"]}
    if trainer.err is not None:
        tree["err"], specs["err"] = trainer.err, trainer.specs
    return whole(tree, specs, trainer.ctx)


def load_blocks(trainer, inputs, case):
    """The case's weights (the reference's tree) as the trainer's params,
    copied into its blocks in place."""
    tree = lm_ranks.load_params(os.path.join(
        inputs, f"{case['arch']}-{case['dtype']}.npz"))
    blocks = carry.lm_params_from_reference(tree, trainer.cfg, "cpu",
                                            ctx=trainer.ctx)
    with torch.no_grad():
        for (_, dst), (_, src) in zip(opt.flatten(trainer.params),
                                      opt.flatten(blocks)):
            dst.copy_(src)


def train_case(ctx, case, inputs, root):
    """Two steps of ``Trainer(tc, ctx)`` from the case's weights: the
    gradients at the first params (where asked), each step's metrics,
    and after each the params, states and error feedback whole; whether
    the states' block shapes are ``opt_state_specs``'; with ``save``, a
    checkpoint after the first step."""
    tc = train_config(case, root)
    quiet = lambda s: None  # noqa: E731
    trainer = Trainer(tc, ctx, log_fn=quiet)
    load_blocks(trainer, inputs, case)
    out = {"state_shapes": state_shapes_held(trainer)}
    if case["grads"]:
        batch = shard_batch(SyntheticLMData(trainer.cfg, B, SEQ, seed=0)
                            .batch_at(0), ctx)
        out["grads"], out["own_grads"] = grads_of(
            trainer.params, trainer.specs, trainer.cfg, ctx, batch)
    compat.stats = {}
    try:
        trainer.run(1)
        out["stats"] = dict(compat.stats)
    finally:
        compat.stats = None
    out["step0"] = snapshot(trainer)
    if case.get("save"):
        trainer._save(0, sync=True)
    trainer.start_step = 1
    trainer.run(1)
    out["step1"] = snapshot(trainer)
    out["history"] = trainer.history
    trainer.close()
    return out


def mesh_dir(root, shape):
    """Where a mesh's checkpoints go (one directory a case)."""
    return os.path.join(root, "x".join(map(str, shape)))


def job_train(shape, cases, inputs, root, launcher=False):
    ctx = ctx_of(shape)
    root = mesh_dir(root, shape)
    out = {"coord": {a: ctx.coord(a) for a in ctx.shape}, "cases": {}}
    for case in cases:
        out["cases"][case["tag"]] = train_case(ctx, case, inputs, root)
    if launcher:
        out["launcher"] = launched(shape, root)
    return out


def launched(shape, root, arch="qwen3-4b", flags=()):
    """``launch.train.main --mesh`` for 2 steps of ``arch``'s smoke
    config (and ``flags``), checkpointing after the second: each step's
    loss and grad norm."""
    t = train_launcher.main([*flags,
        "--arch", arch, "--smoke", "--device", "cpu", "--mesh",
        ",".join(map(str, shape)), "--dist-backend", "gloo", "--steps", "2",
        "--seq-len", str(SEQ), "--batch", str(B), "--ckpt-every", "2",
        "--ckpt-dir", os.path.join(root, "launcher")])
    return [(r["step"], r["loss"], r["grad_norm"]) for r in t.history]


def job_restore(shape, cases, ckpt_root, ref_ckpt, root):
    """On another mesh: each case's checkpoint (saved on the first mesh
    after its first step) restored by ``Trainer(tc, ctx)``, and its
    second step; the reference's checkpoint of the first case (waited
    for: its subprocess writes it) restored through ``carry`` and cut to
    this mesh's blocks, and its second step; the launcher resumed from
    its checkpoint for one more step."""
    ctx = ctx_of(shape)
    out = {"cases": {}}
    quiet = lambda s: None  # noqa: E731
    for case in cases:
        trainer = Trainer(train_config(case, ckpt_root), ctx, log_fn=quiet)
        out["cases"][case["tag"]] = {"start": trainer.start_step}
        trainer.run(1)
        out["cases"][case["tag"]]["step1"] = snapshot(trainer)
        out["cases"][case["tag"]]["history"] = trainer.history
        trainer.close()
    case = cases[0]
    tc = train_config(case, os.path.join(ckpt_root, "unused"))
    deadline = time.time() + REF_WAIT_S
    while CheckpointManager(ref_ckpt).latest_step() is None:
        if time.time() > deadline:
            raise TimeoutError(f"no reference checkpoint in {ref_ckpt}")
        time.sleep(0.2)
    tree, extra = CheckpointManager(ref_ckpt).restore(0)
    cfg = tc.model
    whole_params = carry.lm_params_from_reference(tree["params"], cfg, "cpu")
    whole_state = carry.opt_state_from_reference(tree["opt"], cfg, "cpu")
    specs = sharding.build_param_specs(whole_params, cfg, ctx)
    params = sharding.shard_params(whole_params, cfg, ctx, "cpu")
    for _, p in opt.flatten(params):
        p.requires_grad_(True)
    state = opt.init_state(tc.opt, params, ctx, specs)
    sspecs = sharding.opt_state_specs(state, specs, ctx)
    with torch.no_grad():
        state["step"].copy_(whole_state["step"])
        for key in ("m", "v"):
            for (_, dst), (_, w), (_, sp) in zip(
                    opt.flatten(state[key]), opt.flatten(whole_state[key]),
                    opt.flatten(sspecs[key])):
                dst.copy_(sharding.block(w, sp, ctx))
    step = make_train_step(tc, cfg, ctx, specs)
    batch = shard_batch(SyntheticLMData(cfg, B, SEQ, seed=0).batch_at(
        int(extra["next_step"])), ctx)
    params, state, m = step(params, state, batch)
    out["ref_ckpt"] = {"metrics": {k: float(v) for k, v in m.items()},
                       "step1": whole({"params": params, "m": state["m"],
                                       "v": state["v"]},
                                      {"params": specs, "m": sspecs["m"],
                                       "v": sspecs["v"]}, ctx)}
    t = train_launcher.main([
        "--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--mesh",
        ",".join(map(str, shape)), "--dist-backend", "gloo", "--steps", "1",
        "--seq-len", str(SEQ), "--batch", str(B), "--ckpt-every", "100",
        "--ckpt-dir", os.path.join(ckpt_root, "launcher")])
    out["launcher"] = [(r["step"], r["loss"], r["grad_norm"])
                       for r in t.history]
    return out


# ---------------------------------------------------------------------------
# the autograd collectives, on a world of two ranks
# ---------------------------------------------------------------------------
def _leaf(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64)


def job_collectives(root, shape=(4, 2)):
    """Each collective's forward and backward on a ``shape`` mesh (``D``
    ranks of ``data``, ``M`` of ``model``): the rank's results, for the
    test to hold against one process computing the same sums."""
    ctx = ctx_of(shape)
    D, Mm = shape
    r, m = ctx.coord("data"), ctx.coord("model")
    out = {"coord": (r, m)}
    # FSDP: the weight's rows over data, each data rank its own batch rows
    W, X, C = _leaf(1, 2 * D, 3), _leaf(2, D, 5, 2 * D), _leaf(3, D, 5, 3)
    w = W[2 * r:2 * r + 2].clone().requires_grad_(True)
    y = X[r] @ compat.fsdp_gather_axis(w, ctx, "data", 0)
    (gw,) = torch.autograd.grad((y * C[r]).sum(), [w])
    out["fsdp"] = gw.numpy()
    # f and g over model: x replicated, a column- then a row-parallel
    # product, the sum's result replicated
    x = _leaf(4, 5, 4).requires_grad_(True)
    A, U, c = _leaf(5, 4, 3 * Mm), _leaf(6, 3 * Mm, 4), _leaf(7, 5, 4)
    a = A[:, 3 * m:3 * m + 3].clone().requires_grad_(True)
    u = U[3 * m:3 * m + 3].clone().requires_grad_(True)
    h = torch.tanh(compat.to_parallel(x, ctx, "model") @ a)
    z = compat.all_reduce_axis(h @ u, ctx, "model")
    gx, ga, gu = torch.autograd.grad((z * c).sum(), [x, a, u])
    out["fg"] = (float((z * c).sum()), gx.numpy(), ga.numpy(), gu.numpy())
    # the all-to-all: [M, k] blocks out, the reverse exchange back
    t = _leaf(8 + m, Mm, 3).requires_grad_(True)
    e = compat.all_to_all_axis(t, ctx, "model")
    (gt,) = torch.autograd.grad((e * _leaf(20 + m, Mm, 3)).sum(), [t])
    out["a2a"] = (e.detach().numpy(), gt.numpy())
    # pmean over model (replicated downstream) and over data (shares)
    s = _leaf(12, 3).requires_grad_(True)
    pm = compat.pmean_axis(s, ctx, "model")
    (gm,) = torch.autograd.grad((pm * _leaf(14, 3)).sum(), [s])
    pd = compat.pmean_axis(s, ctx, "data")
    (gd,) = torch.autograd.grad((pd * _leaf(30 + r, 3)).sum(), [s])
    out["pmean"] = (gm.numpy(), gd.numpy())
    # an activation gather: replicated downstream, the backward a slice
    v = _leaf(17 + m, 2, 3).requires_grad_(True)
    gv = compat.all_gather_axis(v, ctx, "model", 0)
    (gg,) = torch.autograd.grad((gv * _leaf(19, 2 * Mm, 3)).sum(), [v])
    out["gather"] = gg.numpy()
    return out


def job_all(root, meshes, inputs, restore, ref_ckpt):
    """The 8-rank meshes in turn on one world: ``meshes`` {name: (shape,
    cases)} trained (``job_train``; the 4 x 2's launcher too), then the
    ``restore`` mesh (``job_restore``, the 4 x 2 mesh's checkpoints) and
    the collectives."""
    out = {}
    for name, (shape, cases) in meshes.items():
        out[name] = job_train(shape, cases, inputs, root,
                              launcher=name == "4x2")
    shape, cases = restore
    out["restore"] = job_restore(shape, cases, mesh_dir(root, [4, 2]),
                                 ref_ckpt, root)
    out["collectives"] = job_collectives(root)
    return out


def job_meshes(root, meshes, inputs, launcher=None):
    """``meshes`` {name: (shape, cases)} trained in turn on one world
    (``job_train``), each under its own directory; then, with
    ``launcher`` (shape, arch, flags), ``launch.train.main --mesh`` for
    that arch's smoke config (``launched``)."""
    out = {name: job_train(shape, cases, inputs, root)
           for name, (shape, cases) in meshes.items()}
    if launcher is not None:
        shape, arch, flags = launcher
        out["launcher"] = launched(shape, mesh_dir(root, shape), arch, flags)
    return out


JOBS = {"train": job_train, "all": job_all, "meshes": job_meshes}

"""Training on a mesh, on the CPU: ranks of gloo ``torch.distributed``
worlds, one process each (``tests/torch_train_mesh_ranks.py``), against
the JAX package's train step on meshes of the same shapes.

The reference runs in subprocesses (``tests/torch_train_mesh_ref.py``)
with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on
Auto-axis ``jax.sharding.Mesh``es (ROADMAP C25), started before the
worlds so that both run side by side. Both packages take the same numpy
weights (``test_torch_lm_mesh._np_params``) and the batches of
``SyntheticLMData(cfg, 8, 32, seed=0)``, and train two steps of AdamW
(lr 1e-3, no warmup):

  - SPMD training through ``Trainer(tc, ctx)``: the smoke configs of
    qwen3-4b and qwen3-moe-235b-a22b in f32 and bf16, kimi-k2-1t-a32b in
    f32 (its dense lead and shared expert), on a 4 x 2 ``("data",
    "model")`` and a 2 x 2 x 2 ``("pod", "data", "model")`` mesh; the
    gradients of ``loss_fn`` at the first params, gathered whole from
    the ranks' blocks, against ``jax.value_and_grad(M.loss_fn)`` on the
    reference's mesh; each step's metrics; the params and the optimizer
    states after each step; the states' block shapes against
    ``opt_state_specs``. The MoE is held to the reference's mesh, not
    to its one device (ROADMAP C26);
  - int8 states (qwen3-4b, f32, 4 x 2): the smoke config's ``wo``,
    ``w_down`` and the table have a last dim of 64 over ``data``'s 4
    ranks, one quantization block spanning them;
  - ``microbatches=2`` on 4 x 2;
  - the compressed pod reduction on 2 x 2 x 1 and 2 x 1 x 2, with the
    error feedback and the reported metrics (one pod's, ROADMAP C28);
    and the reference's compressed step on 2 x 2 x 2, which aborts
    (ROADMAP C27);
  - checkpoints: the 4 x 2 world's after its first step restores on a
    2 x 4 world and on one device, and the next step equals the
    uninterrupted one; it opens in the reference's
    ``CheckpointManager``; the reference's, saved on its 4 x 2 mesh,
    restores on the 2 x 4 world through ``carry``; ``launch.train
    --mesh`` trains 2 steps on 4 x 2, as one device does, and resumes on
    2 x 4;
  - the autograd collectives on the 4 x 2 world, against one process
    computing the same sums.

The vlm, audio, ssm and hybrid families train on a mesh in
``tests/test_torch_train_mesh_families.py``, on the same rank helpers.

Both sides' AdamW takes eps 1e-3, so that an update is a smooth
function of its gradient: with the default 1e-8 the first step moves an
entry by lr x sign(g), and a gradient within rounding of 0 steps either
way.

Tolerances, each with its reason:

  - f32, 1e-5: the metrics relative; the gradients, params and optimizer
    states 1e-5 relative or 1e-5 of their leaf's largest |value| (the
    same products summed in other orders: the row-parallel and dp sums,
    attention tiles, the vocabulary's).
  - bf16, ``lm_atol``: the loss, ce, aux and grad norm within 0.1 or six
    bf16 ulps at the value; the gradients within six bf16 ulps at their
    leaf's largest |value| (each a sum of bf16 products rounded to bf16,
    taken in other orders); the params within 2 lr and one bf16 ulp at
    the value a step (an update within 2 lr, computed in f32 and rounded
    once to bf16, may land on the next bf16 value); m and v within six
    ulps at their leaf's largest |value| after the first step and 64
    after the second, whose gradients are taken at params that already
    differ by up to an ulp an entry (measured up to 47 on the MoE).
  - int8 states: payloads within one level and scales within 1e-5 (a
    gradient's last bits can move a payload one level), params within 9
    lr (``test_torch_train_loop.py``'s rule).
  - the compressed step: see ``test_compressed_step_equals_the_references``.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_lm_mesh_ranks as lm_ranks
import torch_train_mesh_ranks as ranks
from test_torch_lm_mesh import _np_params, lm_atol
from repro_torch import carry
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.launch import train as train_launcher
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import Trainer

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
REF = Path(__file__).resolve().parent / "torch_train_mesh_ref.py"
F32_TOL = 1e-5
LM_ULPS = 6
SECOND_STEP_ULPS = 64


def _case(tag, arch, dtype, int8=False, compress=False, micro=1,
          grads=False, save=None):
    return {"tag": tag, "arch": arch, "dtype": dtype, "int8": int8,
            "compress": compress, "micro": micro, "grads": grads,
            "save": save}


SPMD = [_case("dense-f32", "qwen3-4b", "float32", grads=True),
        _case("dense-bf16", "qwen3-4b", "bfloat16", grads=True),
        _case("moe-f32", "qwen3-moe-235b-a22b", "float32", grads=True),
        _case("moe-bf16", "qwen3-moe-235b-a22b", "bfloat16", grads=True),
        _case("kimi-f32", "kimi-k2-1t-a32b", "float32", grads=True)]
EXTRA_4X2 = [_case("dense-int8", "qwen3-4b", "float32", int8=True),
             _case("dense-micro2", "qwen3-4b", "float32", micro=2)]
COMPRESSED = [_case("dense-comp", "qwen3-4b", "float32", compress=True,
                     grads=True)]
WORLDS = {"4x2": [4, 2], "2x2x2": [2, 2, 2]}
COMP_WORLDS = {"2x2x1": [2, 2, 1], "2x1x2": [2, 1, 2]}
SAVED = "dense-f32"              # the 4 x 2 world saves it after step 0


def _cases(world):
    cases = [dict(c) for c in SPMD]
    if world == "4x2":
        cases += [dict(c) for c in EXTRA_4X2]
        next(c for c in cases if c["tag"] == SAVED)["save"] = "ref_ckpt"
    return cases


def _jobs(world, shape, cases):
    return [dict(c, tag=f"{world}/{c['tag']}", mesh=shape) for c in cases]


# the reference's jobs, split into parts that run at once
REF_PARTS = {
    "4x2a": ("4x2", ["dense-f32", "dense-bf16", "dense-micro2"]),
    "4x2b": ("4x2", ["moe-f32", "moe-bf16"]),
    "4x2c": ("4x2", ["kimi-f32", "dense-int8"]),
    "2x2x2a": ("2x2x2", ["dense-f32", "dense-bf16", "kimi-f32"]),
    "2x2x2b": ("2x2x2", ["moe-f32", "moe-bf16"]),
    "2x2x1": ("2x2x1", ["dense-comp"]),
    "2x1x2": ("2x1x2", ["dense-comp"]),
}
SHAPES = dict(WORLDS, **COMP_WORLDS)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh_in")
    seen = set()
    for i, c in enumerate(SPMD):
        key = (c["arch"], c["dtype"])
        if key not in seen:
            seen.add(key)
            lm_ranks.save_params(d / f"{c['arch']}-{c['dtype']}.npz",
                                 _np_params(c["arch"], c["dtype"],
                                            seed=30 + i))
    for part, (world, tags) in REF_PARTS.items():
        cases = {c["tag"]: c for c in (_cases(world) if world in WORLDS
                                       else COMPRESSED)}
        jobs = _jobs(world, SHAPES[world], [cases[t] for t in tags])
        (d / f"jobs_{part}.json").write_text(json.dumps(jobs))
    (d / "jobs_c27.json").write_text(json.dumps(
        _jobs("2x2x2", [2, 2, 2], COMPRESSED)))
    return d


@pytest.fixture(scope="module")
def reference_run(inputs):
    """The reference's subprocesses, one a part, started at once (they
    run beside the worlds)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {part: subprocess.Popen(
        [sys.executable, str(REF), str(inputs), part], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in (*REF_PARTS, "c27")}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


_ENDED = {}


def _wait(proc):
    """(the return code, the stderr) of a reference subprocess, once it
    has ended."""
    if proc.pid not in _ENDED:
        _, err = proc.communicate(timeout=600)
        _ENDED[proc.pid] = (proc.returncode, err)
    return _ENDED[proc.pid]


@pytest.fixture(scope="module")
def reference(reference_run, inputs):
    out = {}
    for part in REF_PARTS:
        rc, err = _wait(reference_run[part])
        assert rc == 0, err[-3000:]
        out.update(np.load(inputs / f"out_{part}.npz"))
    return out


@pytest.fixture(scope="module")
def worlds(inputs, reference_run, tmp_path_factory):
    """One world of 8 ranks runs the 4 x 2 and 2 x 2 x 2 meshes' training,
    then the 2 x 4 mesh's restores (the 4 x 2 mesh's checkpoints, under
    its directory ``root``, and the reference's) and the collectives;
    beside it, a world of 4 ranks for each compressed mesh.
    Rank 0's results by mesh, and each rank's under "ranks"."""
    root = tmp_path_factory.mktemp("world8")
    comp = {w: tmp_path_factory.mktemp(w) for w in COMP_WORLDS}
    meshes = {w: (s, _cases(w)) for w, s in WORLDS.items()}
    saved = [c for c in _cases("4x2") if c["tag"] == SAVED]
    eight, *fours = ranks.run(
        (8, "all", root, dict(meshes=meshes, inputs=str(inputs),
                              restore=([2, 4], saved),
                              ref_ckpt=str(inputs / "ref_ckpt"))),
        *[(4, "train", comp[w], dict(shape=s, cases=COMPRESSED,
                                     inputs=str(inputs)))
          for w, s in COMP_WORLDS.items()])
    out = {w: [o[w] for o in eight] for w in WORLDS}
    out.update(zip(COMP_WORLDS, fours))
    out["restore"] = eight[0]["restore"]
    out["collectives"] = [o["collectives"] for o in eight]
    out["root"] = root
    return out


@pytest.fixture(scope="module")
def restored(worlds):
    return worlds["restore"]


@pytest.fixture(scope="module")
def collectives(worlds):
    return worlds["collectives"]


# ---------------------------------------------------------------------------
# the reference's trees in the port's layout
# ---------------------------------------------------------------------------
def _nest(flat):
    tree = {}
    for key, a in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return tree


def _qtensors(tree):
    """{.../q, .../scale} leaves as QTensor-like objects."""
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"q", "scale"}:
        return types.SimpleNamespace(q=tree["q"], scale=tree["scale"],
                                     shape=tree["q"].shape)
    return {k: _qtensors(v) for k, v in tree.items()}


def _ref_flat(reference, prefix):
    n = len(prefix)
    return {k[n:]: reference[k] for k in reference if k.startswith(prefix)}


def _port_layout(flat, cfg, kind):
    """The reference's flat {path: array} (stacked layout) as the port's
    {path: numpy}: ``kind`` "params" (and grads, err) or "state"."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tree = _qtensors(_nest(flat))
    if kind == "state":
        tree = carry.opt_state_from_reference(
            {"step": np.int32(0), "m": tree["m"], "v": tree["v"]}, cfg32,
            "cpu")
        tree = {"m": tree["m"], "v": tree["v"]}
    else:
        tree = carry.lm_params_from_reference(tree, cfg32, "cpu")
    out = {}
    for path, leaf in opt.flatten(tree):
        key = "/".join(str(p) for p in path)
        if isinstance(leaf, opt.QTensor):
            out[key + "/q"] = leaf.q.numpy()
            out[key + "/scale"] = leaf.scale.numpy()
        else:
            out[key] = leaf.float().numpy()
    return out


def _cfg(case):
    return dataclasses.replace(registry.get_smoke_config(case["arch"]),
                               dtype=case["dtype"])


def _ulps(x, n=LM_ULPS):
    big = float(np.abs(x).max())
    return n * 2.0 ** (np.floor(np.log2(max(big, 1e-30))) - 7)


def _metric_held(got, want, dtype, key, f32=F32_TOL):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=f32, atol=1e-7,
                                   err_msg=key)
    else:
        tol = lm_atol(dtype, np.asarray([want]))
        assert abs(got - want) <= tol, (key, got, want, tol)


def _grads_held(got, want, dtype, what, f32=F32_TOL, ulps=LM_ULPS):
    """Each leaf within ``f32`` of its largest |value| (f32), or ``ulps``
    bf16 ulps at it (bf16)."""
    assert set(got) == set(want), what
    for key in want:
        tol = f32 * float(np.abs(want[key]).max()) \
            if dtype == "float32" else _ulps(want[key], ulps)
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=max(tol, 1e-30),
                                   err_msg=f"{what} {key}")


def _params_held(got, want, dtype, lr, what, int8=False, steps=1,
                 flips=None, f32=F32_TOL):
    for key, w in want.items():
        g = got[key]
        if flips is not None and key in flips:
            # a payload one level off: the step moved the entry otherwise
            f = flips[key]
            assert (np.abs(g - w)[f] <= 2 * steps * lr).all(), (what, key)
            g, w = g[~f], w[~f]
        if int8:
            assert float(np.abs(g - w).max()) <= 9 * lr, (what, key)
        elif dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=f32,
                                       atol=f32 * float(np.abs(w).max()),
                                       err_msg=f"{what} {key}")
        else:
            # each step's f32 update rounds once to bf16: one ulp at the
            # value a step
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30)))
                          - 7)
            assert (np.abs(g - w) <= steps * (2 * lr + ulp)).all(), \
                (what, key)


def _states_held(got, want, dtype, what, int8=False, ulps=LM_ULPS,
                 flips=None, f32=F32_TOL):
    for key, w in want.items():
        g = got[key]
        leaf = key.split("/", 1)[1]
        if flips is not None and leaf in flips:
            g, w = g[~flips[leaf]], w[~flips[leaf]]
        if int8 and key.endswith("/q"):
            assert int(np.abs(g.astype(np.int32) - w.astype(np.int32))
                       .max()) <= 1, (what, key)
        elif int8 or dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=f32,
                                       atol=f32 * float(np.abs(w).max()),
                                       err_msg=f"{what} {key}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=_ulps(w, ulps),
                                       err_msg=f"{what} {key}")


def _split(snap):
    """A rank-0 snapshot as ({params}, {m, v}, {err})."""
    params = {k[len("params/"):]: v for k, v in snap.items()
              if k.startswith("params/")}
    state = {k: v for k, v in snap.items() if k.startswith(("m/", "v/"))}
    err = {k[len("err/"):]: v for k, v in snap.items()
           if k.startswith("err/")}
    return params, state, err


def _step_held(got_snap, reference, tag, step, case, history, flips=None,
               f32=F32_TOL, ulps=LM_ULPS):
    """A step's metrics, params and states against the reference's;
    ``f32`` and ``ulps`` (the second step's states at least
    ``SECOND_STEP_ULPS``) as ``_states_held`` takes them."""
    cfg = _cfg(case)
    dtype = case["dtype"]
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        want = float(reference[f"{tag}/step{step}/metrics/{key}"])
        _metric_held(history[step][key], want, dtype, f"{tag} {key}", f32)
    params, state, err = _split(got_snap)
    want_p = _port_layout(_ref_flat(reference, f"{tag}/step{step}/params/"),
                          cfg, "params")
    assert set(params) == set(want_p)
    _params_held(params, want_p, dtype, ranks.LR, tag, int8=case["int8"],
                 steps=step + 1, flips=flips, f32=f32)
    want_s = _port_layout({k: v for k, v in _ref_flat(
        reference, f"{tag}/step{step}/").items()
        if k.startswith(("m/", "v/"))}, cfg, "state")
    assert set(state) == set(want_s)
    _states_held(state, want_s, dtype, tag, int8=case["int8"],
                 ulps=ulps if step == 0 else max(ulps, SECOND_STEP_ULPS),
                 flips=flips, f32=f32)
    return err


def _ref_grads(reference, tag, case):
    return _port_layout(_ref_flat(reference, f"{tag}/grads/"), _cfg(case),
                        "params")


# ---------------------------------------------------------------------------
# SPMD training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", SPMD, ids=[c["tag"] for c in SPMD])
@pytest.mark.parametrize("world", list(WORLDS))
def test_spmd_training_equals_the_references_mesh(worlds, reference, world,
                                                  case):
    """Gradients at the first params, each step's metrics, and the params
    and states after each of two steps, against the reference's mesh of
    the same shape; every rank's state blocks are ``opt_state_specs``'
    and every rank reports the same metrics."""
    tag = f"{world}/{case['tag']}"
    outs = worlds[world]
    got = outs[0]["cases"][case["tag"]]
    want_g = _ref_grads(reference, tag, case)
    _grads_held(got["grads"], want_g, case["dtype"], tag)
    for step in (0, 1):
        _step_held(got[f"step{step}"], reference, tag, step, case,
                   got["history"])
    for o in outs:
        held, n = o["cases"][case["tag"]]["state_shapes"]
        assert held and n > 0
        assert [r["loss"] for r in o["cases"][case["tag"]]["history"]] == \
            [r["loss"] for r in got["history"]]


def test_int8_states_take_the_whole_leafs_blocks(worlds, reference):
    """int8 m and v on 4 x 2, where the smoke config's last dims of 64
    over ``data``'s 4 ranks make one quantization block span them (its
    absmax a pmax there, its scale replicated): payloads within one
    level and scales within 1e-5 of the reference's."""
    case = EXTRA_4X2[0]
    tag = f"4x2/{case['tag']}"
    got = worlds["4x2"][0]["cases"][case["tag"]]
    scales = {k: v for k, v in got["step0"].items()
              if k.endswith("/scale") and "attn/wo" in k}
    assert scales and all(v.shape[-1] == 1 for v in scales.values())
    for step in (0, 1):
        _step_held(got[f"step{step}"], reference, tag, step, case,
                   got["history"])
    for o in worlds["4x2"]:
        assert o["cases"][case["tag"]]["state_shapes"][0]


def test_microbatches_on_a_mesh_equal_the_references(worlds, reference):
    """``microbatches=2`` on 4 x 2: microbatch i is rows [4i, 4i + 4) of
    the batch and the rank's block of those, as the reference's reshape
    splits them."""
    case = EXTRA_4X2[1]
    tag = f"4x2/{case['tag']}"
    got = worlds["4x2"][0]["cases"][case["tag"]]
    for step in (0, 1):
        _step_held(got[f"step{step}"], reference, tag, step, case,
                   got["history"])


# ---------------------------------------------------------------------------
# the compressed pod reduction
# ---------------------------------------------------------------------------
def _off(got, want, atol, f32=F32_TOL):
    return ~np.isclose(got, want, rtol=f32, atol=atol)


@pytest.mark.parametrize("world", list(COMP_WORLDS))
def test_compressed_step_equals_the_references(worlds, reference, world):
    """``grad_compression`` on a pod mesh: the gradients at the first
    params, the metrics (one pod's, C28), and the params, states and pod
    0's error feedback after each of two steps. Where the two packages'
    last bits put an entry's g + err on the other side of a rounding
    boundary in any pod, its payload is one level off, the mean gradient
    a quantum / n apart, and that pod's error feedback a quantum (one
    block scale, at most twice the leaf's largest |err|): such entries
    (at most 1 in 1000 of a leaf, and any pod's, while only pod 0's error
    feedback is in the reference's output) are held to that, their
    params to the step's bound, 2 lr a step. Every other entry as f32:
    the error feedback within 1e-5 of the leaf's largest |g| (the
    reference's gradient at the first params), as it is g + err less a
    value near it."""
    case = COMPRESSED[0]
    compressed_held(worlds[world][0]["cases"][case["tag"]], reference,
                    f"{world}/{case['tag']}", case)


def compressed_held(got, reference, tag, case, f32=F32_TOL, second=None):
    """``test_compressed_step_equals_the_references``' rule for one case:
    ``got`` rank 0's results, ``tag`` the reference's; ``f32`` in place
    of 1e-5 throughout. With ``second``, the second step is held only
    within bounds (``_second_step_bounded``), states within ``second``
    of a leaf's largest |value|."""
    cfg = _cfg(case)
    grads = _ref_grads(reference, tag, case)
    _grads_held(got["grads"], grads, case["dtype"], tag, f32)
    flips = {}
    for step in (0, 1):
        if step and second is not None:
            _second_step_bounded(got, reference, tag, case, f32, second)
            continue
        params, state, err = _split(got[f"step{step}"])
        want_p = _port_layout(_ref_flat(
            reference, f"{tag}/step{step}/params/"), cfg, "params")
        want_s = _port_layout({k: v for k, v in _ref_flat(
            reference, f"{tag}/step{step}/").items()
            if k.startswith(("m/", "v/"))}, cfg, "state")
        want_e = _port_layout(_ref_flat(reference, f"{tag}/step{step}/err/"),
                              cfg, "params")
        assert set(err) == set(want_e) == set(params) == set(want_p)
        for key, w in want_p.items():
            g_big = float(np.abs(grads[key]).max())
            off = (_off(params[key], w, f32 * float(np.abs(w).max()), f32)
                   | _off(err[key], want_e[key], f32 * g_big, f32))
            for s in ("m/", "v/"):
                ws = want_s[s + key]
                off |= _off(state[s + key], ws,
                            f32 * float(np.abs(ws).max()), f32)
            flips[key] = flips.get(key, False) | off
            assert int(flips[key].sum()) <= max(2, w.size // 1000), \
                (tag, key, int(flips[key].sum()))
            e_big = float(np.abs(want_e[key]).max())
            assert (np.abs(err[key] - want_e[key]) <= 2.02 * e_big
                    + f32 * g_big).all(), (tag, key)
        _step_held(got[f"step{step}"], reference, tag, step, case,
                   got["history"], flips, f32)


def _second_step_bounded(got, reference, tag, case, f32, second):
    """The second compressed step where the first step's payloads one
    level off move the gradients that the second takes, at params that
    differ, past the f32 limit: the metrics within ``f32``, every
    param within the step's bound (2 lr a step), m and v within
    ``second`` of their leaf's largest |value|, the error feedback
    within a quantum (2.02 times the leaf's largest |err|) and ``f32``
    of the first gradient's largest."""
    cfg = _cfg(case)
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        _metric_held(got["history"][1][key],
                     float(reference[f"{tag}/step1/metrics/{key}"]),
                     case["dtype"], f"{tag} {key}", f32)
    params, state, err = _split(got["step1"])
    grads = _ref_grads(reference, tag, case)
    want_p = _port_layout(_ref_flat(reference, f"{tag}/step1/params/"), cfg,
                          "params")
    want_s = _port_layout({k: v for k, v in _ref_flat(
        reference, f"{tag}/step1/").items() if k.startswith(("m/", "v/"))},
        cfg, "state")
    want_e = _port_layout(_ref_flat(reference, f"{tag}/step1/err/"), cfg,
                          "params")
    assert set(params) == set(want_p) == set(err) == set(want_e)
    assert set(state) == set(want_s)
    for key, w in want_p.items():
        assert (np.abs(params[key] - w) <= 4 * ranks.LR).all(), (tag, key)
        e_big = float(np.abs(want_e[key]).max())
        g_big = float(np.abs(grads[key]).max())
        assert (np.abs(err[key] - want_e[key]) <= 2.02 * e_big
                + f32 * g_big).all(), (tag, key)
    for key, w in want_s.items():
        np.testing.assert_allclose(state[key], w, rtol=0,
                                   atol=second * float(np.abs(w).max()),
                                   err_msg=f"{tag} {key}")


def test_c28_compressed_metrics_are_pod_0s(worlds, reference):
    """The reference's compressed step reports one pod's loss, not the
    batch's (``out_specs=P()``, ``check_vma=False``): pod 0's, the loss
    of rows [0, 4) alone; its SPMD step reports the batch's."""
    got = worlds["2x2x1"][0]["cases"]["dense-comp"]["history"][0]["loss"]
    comp = float(reference["2x2x1/dense-comp/step0/metrics/loss"])
    spmd = float(reference["4x2/dense-f32/step0/metrics/loss"])
    assert abs(comp - spmd) > 1e-4
    np.testing.assert_allclose(got, comp, rtol=F32_TOL)


def test_c27_references_compressed_step_aborts_on_2x2x2(reference_run):
    """ROADMAP C27: the reference's compressed step on a 2 x 2 x 2 pod
    mesh ends its process inside XLA's SPMD partitioner (SIGABRT)."""
    rc, err = _wait(reference_run["c27"])
    assert rc == -signal.SIGABRT, (rc, err[-2000:])
    assert "spmd_partitioner_util" in err


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_the_launcher_trains_on_a_mesh_as_on_one_device(worlds, tmp_path):
    """``launch.train.main --mesh 4,2`` against one device: the same
    weights (born sharded from seed 0), the same batches, bf16: each
    step's loss and grad norm within ``lm_atol``."""
    got = worlds["4x2"][0]["launcher"]
    one = train_launcher.main([
        "--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--steps", "2",
        "--seq-len", str(ranks.SEQ), "--batch", str(ranks.B),
        "--ckpt-every", "100", "--ckpt-dir", str(tmp_path)])
    want = [(r["step"], r["loss"], r["grad_norm"]) for r in one.history]
    assert [g[0] for g in got] == [w[0] for w in want] == [0, 1]
    for (_, loss, gn), (_, wl, wg) in zip(got, want):
        assert abs(loss - wl) <= lm_atol("bfloat16", np.asarray([wl]))
        assert abs(gn - wg) <= lm_atol("bfloat16", np.asarray([wg]))


def _trainer_step1(restored_case, saved):
    """A restored run's second step against the uninterrupted one."""
    case = next(c for c in SPMD if c["tag"] == SAVED)
    params, state, _ = _split(restored_case["step1"])
    want_p, want_s, _ = _split(saved["step1"])
    _params_held(params, want_p, "float32", ranks.LR, "restored")
    _states_held(state, want_s, "float32", "restored")
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        _metric_held(restored_case["history"][0][key],
                     saved["history"][1][key], case["dtype"], key)


def test_a_checkpoint_of_4x2_restores_on_2x4(worlds, restored):
    """``Trainer(tc, ctx)`` on 2 x 4 opens the 4 x 2 world's checkpoint
    (saved after its first step, full logical arrays), resumes at step 1,
    and its second step equals the uninterrupted run's (f32)."""
    got = restored["cases"][SAVED]
    assert got["start"] == 1
    _trainer_step1(got, worlds["4x2"][0]["cases"][SAVED])


def test_a_checkpoint_of_4x2_restores_on_one_device(worlds, restored):
    """The same checkpoint restores on one device (``Trainer(tc,
    "cpu")``), and its second step equals the 4 x 2 world's."""
    case = next(c for c in _cases("4x2") if c["tag"] == SAVED)
    tc = ranks.train_config(case, ranks.mesh_dir(worlds["root"], [4, 2]))
    t = Trainer(tc, "cpu", log_fn=lambda s: None)
    try:
        assert t.start_step == 1
        t.run(1)
    finally:
        t.close()
    snap = {f"params/{'/'.join(map(str, p))}": v.detach().numpy()
            for p, v in opt.flatten(t.params)}
    for key in ("m", "v"):
        snap.update({f"{key}/{'/'.join(map(str, p))}": v.numpy()
                     for p, v in opt.flatten(t.opt_state[key])})
    _trainer_step1({"step1": snap, "history": t.history},
                   worlds["4x2"][0]["cases"][SAVED])


def test_the_ports_mesh_checkpoint_opens_in_the_references_manager(worlds):
    """The reference's ``CheckpointManager.restore`` reads the 4 x 2
    world's checkpoint into a tree of the port's layout: every leaf the
    port's own ``restore`` gives, bit for bit."""
    from repro.checkpoint.manager import CheckpointManager as RefManager
    d = os.path.join(ranks.mesh_dir(worlds["root"], [4, 2]), f"ckpt-{SAVED}")
    mine, extra = CheckpointManager(d).restore(0)
    like = opt.tree_map(lambda t: np.zeros(t.shape, np.float32), mine)
    theirs, ref_extra = RefManager(d).restore(0, like)
    assert extra == ref_extra == {"next_step": 1}
    a, b = opt.flatten(mine), opt.flatten(theirs)
    assert [p for p, _ in a] == [p for p, _ in b] and len(a) > 20
    for (path, x), (_, y) in zip(a, b):
        assert np.array_equal(x.numpy(), np.asarray(y)), path


def test_the_references_checkpoint_restores_on_the_ports_2x4(restored,
                                                             reference):
    """The reference's checkpoint, saved on its 4 x 2 mesh after the
    first step, carried into the port's layout and cut to the 2 x 4
    world's blocks: its second step equals the reference's own (f32)."""
    case = next(c for c in SPMD if c["tag"] == SAVED)
    tag = f"4x2/{SAVED}"
    got = restored["ref_ckpt"]
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        _metric_held(got["metrics"][key],
                     float(reference[f"{tag}/step1/metrics/{key}"]),
                     case["dtype"], key)
    _step_held(got["step1"], reference, tag, 1, case,
               [None, got["metrics"]])


def test_the_launcher_resumes_on_another_mesh(worlds, restored):
    """``launch.train.main --mesh 2,4`` resumes the 4 x 2 launcher's run
    from its checkpoint (saved after step 1) at step 2."""
    assert [r[0] for r in worlds["4x2"][0]["launcher"]] == [0, 1]
    (step, loss, gnorm), = restored["launcher"]
    assert step == 2 and np.isfinite([loss, gnorm]).all()


# ---------------------------------------------------------------------------
# the collectives' gradients
# ---------------------------------------------------------------------------
def _leaf(seed, *shape):
    return ranks._leaf(seed, *shape).numpy()


D, MM = 4, 2              # the collectives' mesh: data x model


def test_the_fsdp_gathers_backward_is_a_reduce_scatter(collectives):
    """Each data rank uses the whole weight on its own batch rows: its
    gradient block is the block of the sum over the ranks."""
    X, C = _leaf(2, D, 5, 2 * D), _leaf(3, D, 5, 3)
    full = sum(X[r].T @ C[r] for r in range(D))
    for o in collectives:
        r = o["coord"][0]
        np.testing.assert_allclose(o["fsdp"], full[2 * r:2 * r + 2],
                                   rtol=1e-12)


def test_f_and_g_give_the_replicated_gradients(collectives):
    """x (replicated) enters a column-parallel product through "f", the
    row-parallel partials are summed through "g": the loss and the
    gradients of x and of each rank's blocks are one process's."""
    x, A, U, c = _leaf(4, 5, 4), _leaf(5, 4, 3 * MM), _leaf(6, 3 * MM, 4), \
        _leaf(7, 5, 4)
    xt = torch.from_numpy(x).requires_grad_(True)
    At = torch.from_numpy(A).requires_grad_(True)
    Ut = torch.from_numpy(U).requires_grad_(True)
    loss = ((torch.tanh(xt @ At) @ Ut) * torch.from_numpy(c)).sum()
    gx, gA, gU = torch.autograd.grad(loss, [xt, At, Ut])
    for o in collectives:
        m = o["coord"][1]
        value, ox, oa, ou = o["fg"]
        np.testing.assert_allclose(value, float(loss), rtol=1e-12)
        np.testing.assert_allclose(ox, gx.numpy(), rtol=1e-12)
        np.testing.assert_allclose(oa, gA.numpy()[:, 3 * m:3 * m + 3],
                                   rtol=1e-12)
        np.testing.assert_allclose(ou, gU.numpy()[3 * m:3 * m + 3],
                                   rtol=1e-12)


def test_the_all_to_alls_backward_is_the_reverse_exchange(collectives):
    """Block j of model rank i lands on rank j as its block i; the
    gradient of rank m's block j is rank j's upstream gradient's block
    m."""
    t = [_leaf(8 + m, MM, 3) for m in range(MM)]
    c = [_leaf(20 + m, MM, 3) for m in range(MM)]
    for o in collectives:
        m = o["coord"][1]
        e, gt = o["a2a"]
        np.testing.assert_array_equal(e, np.stack([t[i][m]
                                                   for i in range(MM)]))
        np.testing.assert_array_equal(gt, np.stack([c[j][m]
                                                    for j in range(MM)]))


def test_pmean_and_the_activation_gather_follow_the_convention(collectives):
    """pmean over ``model`` feeds replicated work: g / M; over ``data``
    the shares differ: their sum / D; an activation gather's backward is
    the rank's block of the (replicated) upstream gradient."""
    d = _leaf(14, 3)
    shares = sum(_leaf(30 + r, 3) for r in range(D))
    w = _leaf(19, 2 * MM, 3)
    for o in collectives:
        m = o["coord"][1]
        gm, gd = o["pmean"]
        np.testing.assert_allclose(gm, d / MM, rtol=1e-12)
        np.testing.assert_allclose(gd, shares / D, rtol=1e-12)
        np.testing.assert_allclose(o["gather"], w[2 * m:2 * m + 2],
                                   rtol=1e-12)


"""The search engine on a mesh, on the CPU: ranks of a gloo
``torch.distributed`` world, one process each (``tests/torch_mesh_ranks.py``),
against the JAX package's engine on an 8-device mesh and against the
port's own single-device engine and session.

Two worlds run once each, as module fixtures whose results several tests
read: 8 ranks (a 4 x 2 ``("data", "model")`` mesh and an (8, 1) one) and
4 ranks (2 x 2). The reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_engine_multidev.py`` does) on the same numpy inputs. Its
corpus has integral counts, so every comparison is bit for bit: doc ids,
and the scores' bits.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks as ranks
from repro_torch.configs.paper_search import smoke
from repro_torch.core import topk as topk_lib
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.distributed.meshctx import single_device_ctx
from repro_torch.launch import mesh as launch_mesh
from repro_torch.serve import Query
from repro_torch.storage import FlashSearchSession, FlashStore

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
REF_BACKENDS = {"torch": "jnp", "gpu": "pallas", "gpu_packed": "pallas_packed"}

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.paper_search import smoke
from repro.core import corpus as corpus_lib
from repro.core import topk as topk_lib
from repro.core.engine import PatternSearchEngine
from repro.distributed.compat import shard_map
from repro.core.corpus import Corpus
from repro.distributed.meshctx import MeshCtx, single_device_ctx
from repro.serve.api import Query

assert len(jax.devices()) == 8
inp = np.load(sys.argv[1])
out = {}
cfg = smoke()
corpus = corpus_lib.synthesize(256, cfg.vocab_size, cfg.avg_nnz_per_doc,
                               cfg.nnz_pad, seed=5)
ctx = MeshCtx(mesh=jax.make_mesh((4, 2), ("data", "model")),
              dp_axes=("data",), fsdp_axis="data", tp_axis="model")
for b in ("jnp", "pallas", "pallas_packed"):
    eng = PatternSearchEngine(corpus, cfg, ctx, backend=b)
    for L in (4, 3):
        r = eng.search_typed(Query(inp[f"qi{L}"], inp[f"qv{L}"]))
        out[f"{b}_{L}_ids"], out[f"{b}_{L}_scores"] = r.doc_ids, r.scores

# the padded corpora (+NaN and -NaN) on one device and on the 4 x 2 mesh
for sign in ("p", "n"):
    pc = Corpus(inp[f"pad{sign}_doc_ids"], inp[f"pad{sign}_ids"],
                inp[f"pad{sign}_vals"], inp[f"pad{sign}_norms"])
    q = Query(inp["padq_ids"], inp["padq_vals"])
    for mesh, c in (("1x1", single_device_ctx()), ("4x2", ctx)):
        for b in ("jnp", "pallas"):
            r = PatternSearchEngine(pc, cfg, c, backend=b).search_typed(q)
            out[f"pad{sign}_{mesh}_{b}_ids"] = r.doc_ids
            out[f"pad{sign}_{mesh}_{b}_scores"] = r.scores

# tests/test_topk.py's tree_topk / tree_topk_ppermute script, on our inputs
k = int(inp["k"])
def local(scores, doc_ids):
    v, i = topk_lib.local_topk(scores, doc_ids, k)
    vg, ig = topk_lib.tree_topk(v, i, k, "data")
    vp, ip = topk_lib.tree_topk_ppermute(v, i, k, "data", 8)
    return vg, ig, vp, ip
f = shard_map(local, mesh=jax.make_mesh((8,), ("data",)),
              in_specs=(P("data"), P("data")),
              out_specs=(P(), P(), P(), P()), check_vma=False)
for name, x in zip(("gv", "gi", "pv", "pi"),
                   f(inp["scores"], inp["doc_ids"])):
    out[f"topk_{name}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return ranks.run(8, "eight", tmp_path_factory.mktemp("eight"))


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_store") / "store"
    ranks.build_store(root)
    return str(root)


@pytest.fixture(scope="module")
def four(tmp_path_factory, store_root):
    return ranks.run(4, "four", tmp_path_factory.mktemp("four"),
                     store_root=store_root)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's 4 x 2 engine and 8-device top-k, on the port's
    query arrays and top-k inputs."""
    d = tmp_path_factory.mktemp("reference")
    corpus = ranks.engine_corpus()
    scores, doc_ids = ranks.topk_inputs()
    inp = {"scores": scores, "doc_ids": doc_ids, "k": ranks.TOPK_K}
    for L in ranks.ENGINE_QUERIES:
        inp[f"qi{L}"], inp[f"qv{L}"] = ranks.engine_queries(corpus, L)
    for sign, name in ((1, "p"), (-1, "n")):
        pc = ranks.padded_corpus(sign)
        for field in ("doc_ids", "ids", "vals", "norms"):
            inp[f"pad{name}_{field}"] = getattr(pc, field)
    inp["padq_ids"], inp["padq_vals"] = ranks.padded_queries(pc)
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(d / "in.npz"),
         str(d / "out.npz")], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def single():
    """The port's single-device engine, one per backend."""
    corpus = ranks.engine_corpus()
    return {b: PatternSearchEngine(corpus, smoke(), "cpu", b)
            for b in ranks.ENGINE_BACKENDS}


def _same(got, want, label=""):
    (gi, gs), (wi, ws) = got, want
    np.testing.assert_array_equal(gi, wi, label)
    np.testing.assert_array_equal(np.asarray(gs, np.float32).view(np.uint32),
                                  np.asarray(ws, np.float32).view(np.uint32),
                                  label)


def _res(r):
    return r.doc_ids, r.scores


@pytest.mark.parametrize("backend", ranks.ENGINE_BACKENDS)
@pytest.mark.parametrize("L", [4, 3])
def test_4x2_mesh_equals_the_reference_mesh(eight, reference, backend, L):
    jb = REF_BACKENDS[backend]
    want = (reference[f"{jb}_{L}_ids"], reference[f"{jb}_{L}_scores"])
    for rank, out in enumerate(eight):
        _same(out["engine", backend, L], want, f"rank {rank}")
    ids = eight[0]["engine", backend, L][0]
    assert list(ids[:, 0]) == ranks.ENGINE_QUERIES[L]      # self-search


@pytest.mark.parametrize("backend", ranks.ENGINE_BACKENDS)
@pytest.mark.parametrize("L", [4, 3])
def test_4x2_mesh_equals_the_single_device_engine(eight, single, backend, L):
    corpus = ranks.engine_corpus()
    want = _res(single[backend].search_typed(
        Query(*ranks.engine_queries(corpus, L))))
    for rank, out in enumerate(eight):
        _same(out["engine", backend, L], want, f"rank {rank}")


@pytest.mark.parametrize("backend", ranks.ENGINE_BACKENDS)
def test_4x2_ranks_hold_their_rows_and_columns(eight, backend):
    coords = sorted((o["dp_index"], o["model"]) for o in eight)
    assert coords == [(d, m) for d in range(4) for m in range(2)]
    assert all(o["shape"] == {"data": 4, "model": 2} for o in eight)
    # 256 rows over 4 blocks; L = 4 and 3 both bucket to 4, 2 columns a
    # rank; the merged stream's capacity is the bucket's 4 x block_query
    for o in eight:
        assert o["rows", backend] == 64
        assert o["keys", backend] == [(2, 4 * smoke().block_query, 64)]


REF_PAD = {"torch": "jnp", "gpu": "pallas"}


@pytest.mark.parametrize("backend", ["torch", "gpu"])
def test_padding_rows_never_displace_real_documents(eight, reference,
                                                    backend):
    """Three documents on four mesh rows, so row blocks 3 and 4 hold
    padding only; doc 1 scores +NaN for row 1 (the card's NaN), which
    ranks first, with its own id, on one device, on the mesh and in the
    reference's 4 x 2 engine."""
    pc = ranks.padded_corpus(1)
    want = _res(PatternSearchEngine(pc, smoke(), "cpu", backend)
                .search_typed(Query(*ranks.padded_queries(pc))))
    for rank, out in enumerate(eight):
        _same(out["pad", backend, 1], want, f"rank {rank}")
    for mesh in ("1x1", "4x2"):
        key = f"padp_{mesh}_{REF_PAD[backend]}"
        _same((reference[key + "_ids"], reference[key + "_scores"]), want,
              f"reference {mesh}")
    ids, scores = want
    assert np.isnan(scores[1, 0]) and ids[1, 0] == 1
    assert not np.signbit(scores[1, 0])
    for row_ids in ids:
        real = row_ids >= 0
        assert real.sum() == 3 and real[:3].all()            # pads last


@pytest.mark.parametrize("backend", ["torch", "gpu"])
def test_negative_nan_ranks_below_the_fillers_as_in_the_reference(
        eight, reference, backend):
    """ROADMAP C23: doc 1 scores -NaN for row 1 (the CPU's inf / inf),
    which the floats' total order puts below -inf. The reference folds
    its top-k over every mesh, so on its 1 x 1 mesh the (-inf, -1) filler
    that pads three rows to k = 4 comes first, and on its 4 x 2 mesh each
    rank's fillers come first and doc 1 drops out; the port's mesh does
    the same. The port's single-device path runs no reduction and keeps
    doc 1 ahead of the filler, as before the mesh existed."""
    pc = ranks.padded_corpus(-1)
    single = _res(PatternSearchEngine(pc, smoke(), "cpu", backend)
                  .search_typed(Query(*ranks.padded_queries(pc))))
    jb = REF_PAD[backend]
    ref_1x1 = (reference[f"padn_1x1_{jb}_ids"],
               reference[f"padn_1x1_{jb}_scores"])
    for rank, out in enumerate(eight):
        _same(out["pad", backend, -1], (reference[f"padn_4x2_{jb}_ids"],
                                        reference[f"padn_4x2_{jb}_scores"]),
              f"4x2 rank {rank}")
    assert list(single[0][1]) == [2, 0, 1, -1]
    assert np.isnan(single[1][1, 2]) and np.signbit(single[1][1, 2])
    assert list(ref_1x1[0][1]) == [2, 0, -1, 1]
    assert list(eight[0]["pad", backend, -1][0][1]) == [2, 0, -1, -1]
    # the two finite scores of every row agree; only the order of the
    # -NaN document and the filler differs
    for got in (ref_1x1, eight[0]["pad", backend, -1]):
        _same((got[0][:, :2], got[1][:, :2]),
              (single[0][:, :2], single[1][:, :2]))


@pytest.mark.parametrize("backend", ["torch", "gpu"])
def test_streaming_on_the_mesh_equals_the_single_device(eight, single,
                                                        backend):
    corpus = ranks.engine_corpus()
    want = _res(single[backend].search_streaming(
        *ranks.engine_queries(corpus, 3), iter(ranks.slabs(corpus))))
    for rank, out in enumerate(eight):
        _same(out["stream", backend], want, f"rank {rank}")


def test_gpu_fused_on_a_mesh_raises(eight):
    for out in eight:
        assert out["fused_error"] == (
            "backend='gpu_fused' is single-device (packed doc tiles are not "
            "mesh-sharded); mesh has 8 devices — use 'gpu' or 'torch' there")


def _topk_oracle():
    """Stable descending sort of every row by the floats' total order,
    pads (doc id -1) masked to -inf: the single-device top-k."""
    scores, doc_ids = ranks.topk_inputs()
    v, i = topk_lib.local_topk(torch.from_numpy(scores),
                               torch.from_numpy(doc_ids), ranks.TOPK_K)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("mesh", ["8", "4x2"])
def test_tree_topk_equals_ppermute_and_the_reference(eight, reference, mesh):
    want_v, want_i = _topk_oracle()
    for rank, out in enumerate(eight):
        gv, gi, pv, pi = out["topk", mesh]
        _same((gi, gv), (want_i, want_v), f"tree_topk rank {rank}")
        _same((pi, pv), (want_i, want_v), f"ppermute rank {rank}")
    # the reference's script (tests/test_topk.py) on the same inputs
    _same((reference["topk_gi"], reference["topk_gv"]), (want_i, want_v))
    _same((reference["topk_pi"], reference["topk_pv"]), (want_i, want_v))
    # the inputs plant what the reduction must order: NaN and +inf,
    # ties across ranks (lower block first), padding tied with -inf
    assert np.isnan(want_v[0]).sum() == 2 and np.isposinf(want_v[0]).any()
    assert (want_v[1] == 1.0).all()
    assert list(want_i[1] // ranks.TOPK_PER) == [1, 2, 3, 4]
    assert list(want_i[2, :2]) == [20, 100] and (want_i[2, 2:] == -1).all()


@pytest.mark.parametrize("backend", ranks.ENGINE_BACKENDS)
@pytest.mark.parametrize("query", ["cold", "warm", "narrow", "approx"])
def test_2x2_session_equals_the_single_device_session(four, store_root,
                                                      backend, query):
    sess = FlashSearchSession(FlashStore.open(store_root), smoke(), "cpu",
                              backend)
    try:
        want = ranks.session_results(sess)[query]
    finally:
        sess.close()
    for rank, out in enumerate(four):
        got = out["session", backend][query]
        _same(got[:2], want[:2], f"{query} rank {rank}")
        assert got[2] == want[2], f"{query} stats, rank {rank}"
    stats = want[2]
    if query == "cold":
        assert stats["cache_misses"] == stats["segments_scored"] == 5
    elif query == "warm":
        assert stats["cache_hits"] == 5
    elif query == "narrow":
        assert stats["segments_skipped"] > 0
    else:
        assert stats["approx_segments"] > 0


@pytest.mark.parametrize("backend", ranks.ENGINE_BACKENDS)
def test_2x2_session_plans_on_mesh_rows(four, backend):
    for out in four:
        assert out["plan", backend] == (2, 62)


def test_2x2_engine_equals_the_single_device_engine(four, single):
    corpus = ranks.engine_corpus()
    for L, q in enumerate(ranks.engine_requests(corpus), 1):
        want = _res(single["gpu"].search_typed(Query(*q)))
        for rank, out in enumerate(four):
            _same(out["engine"][L - 1], want, f"L={L} rank {rank}")


def test_mesh_slabs_name_their_row_block(four):
    """A shard's slab is not the whole slab: a slab cache shared with a
    single-device session must never hand one to the other."""
    blocks = sorted(o["slab_fmt"] for o in four)
    assert blocks == sorted(
        (f"ell@rows{r}/2", f"packed@rows{r}/2") for r in (0, 0, 1, 1))


def test_single_device_collectives_are_the_identity():
    from repro_torch.distributed import compat
    ctx = single_device_ctx("cpu")
    t = torch.arange(6.0).reshape(2, 3)
    assert compat.all_gather_axis(t, ctx, "data", dim=1) is t
    assert compat.ppermute(t, ctx, "data", [(0, 0)]) is t
    assert torch.equal(compat.ppermute(t, ctx, "data", []),
                       torch.zeros_like(t))
    v, i = topk_lib.tree_topk_ppermute(t, t.int(), 2, ctx, "data", 1)
    assert v is t


@pytest.mark.parametrize("world", ["four", "eight"])
def test_make_ctx_raises_on_a_world_of_another_size(request, world):
    n = {"four": 4, "eight": 8}[world]
    for out in request.getfixturevalue(world):
        assert f"the world size is {n}" in out["make_ctx_error"]


def test_make_ctx_raises_without_a_process_group():
    with pytest.raises(ValueError, match="world size is None"):
        launch_mesh.make_ctx(device="cpu")


def test_single_device_ctx_needs_no_process_group():
    ctx = single_device_ctx("cpu")
    assert not dist.is_initialized()
    assert (ctx.size, ctx.dp_size, ctx.tp_size, ctx.dp_index) == (1, 1, 1, 0)
    corpus = ranks.engine_corpus()
    for backend in ranks.ENGINE_BACKENDS:
        eng = PatternSearchEngine(corpus, smoke(), backend=backend, ctx=ctx)
        plain = PatternSearchEngine(corpus, smoke(), "cpu", backend)
        assert eng.slab_fmt == plain.slab_fmt
        for L, q in enumerate(ranks.engine_requests(corpus), 1):
            _same(_res(eng.search_typed(Query(*q))),
                  _res(plain.search_typed(Query(*q))), f"{backend} L={L}")
        assert eng.compile_stats == plain.compile_stats
    assert not dist.is_initialized()

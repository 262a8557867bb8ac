"""The plain reference against the port's plain path, and the control."""
import numpy as np
import pytest
import torch

from repro_torch.configs.paper_search import SearchConfig
from repro_torch.core.corpus import Corpus
from repro_torch.core.engine import PatternSearchEngine
from repro_torch.serve import Query
from searchbench import checks, corpusgen, reference

CFG = dict(name="t", n_docs=3000, vocab_size=141_000, avg_nnz_per_doc=60,
           nnz_pad=128, docs_per_base=16, base_width=256, zipf=1.1,
           mutate_every=8, count_max=29, layout="ell", block_docs=128,
           top_k=16)
SEED = 2**31 + 5


@pytest.fixture(scope="module")
def world():
    built = corpusgen.build(CFG, {"pool": 24}, SEED, "cpu")
    s = built.slab
    corpus = Corpus(s["doc_ids"].numpy().astype(np.int64), s["ids"].numpy(),
                    s["vals"].numpy(), s["norms"].numpy())
    return built, corpus


@pytest.mark.parametrize("backend", ["gpu", "gpu_fused", "torch"])
def test_reference_matches_the_port_plain_path(world, backend):
    built, corpus = world
    eng = PatternSearchEngine(corpus, SearchConfig(name="t"), device="cpu",
                              backend=backend)
    qi, qv = _stack(built.queries)
    got = eng.search(Query(qi, qv))
    answers = [(p, 0.0, 0.0, got.doc_ids[p], got.scores[p])
               for p in range(len(built.queries))]
    top = reference.TopK(built.queries, CFG["vocab_size"], 16,
                         reference.served_pairs(answers), "cpu")
    for ch in corpusgen.chunks(CFG, SEED, "cpu"):
        top.add(ch.d0, ch.ids, ch.vals)
    # bit for bit: integral counts keep every sum exact in float32
    assert np.array_equal(top.top_scores(), got.scores)
    nums = checks.compare(answers, 0, top.top_scores(),
                          top.pair_scores(), CFG["n_docs"])
    assert nums == {"lost": 0.0, "rank_gap": 0.0, "id_gap": 0.0}
    # every self-query finds its own document at cosine 1, to rounding
    assert np.all(np.abs(got.scores[:, 0] - 1.0) < 1e-6)


def test_searcher_float32_equals_topk(world):
    built, _ = world
    s = built.slab
    qi, qv = _stack(built.queries[:5])
    ans = reference.Searcher(s["ids"], s["vals"], CFG["vocab_size"],
                             16).search(qi, qv)
    top = reference.TopK(built.queries[:5], CFG["vocab_size"], 16, {}, "cpu")
    top.add(0, s["ids"], s["vals"])
    assert np.array_equal(ans.scores, top.top_scores())


def test_bfloat16_control_fails_the_comparison(world):
    """The control: the reference in bfloat16 in the program's place."""
    built, _ = world
    s = built.slab
    qi, qv = _stack(built.queries)
    ans = reference.Searcher(s["ids"], s["vals"], CFG["vocab_size"], 16,
                             dtype=torch.bfloat16).search(qi, qv)
    answers = [(p, 0.0, 0.0, ans.doc_ids[p], ans.scores[p])
               for p in range(len(built.queries))]
    top = reference.TopK(built.queries, CFG["vocab_size"], 16,
                         reference.served_pairs(answers), "cpu")
    top.add(0, s["ids"], s["vals"])
    nums = checks.compare(answers, 0, top.top_scores(),
                          top.pair_scores(), CFG["n_docs"])
    assert not checks.verdict(nums)
    assert nums["rank_gap"] > 10 * checks.LIMITS["rank_gap"]


def test_compare_reads_each_fault():
    ref_top = np.array([[1.0, 0.5, 0.25]], np.float32)
    pairs = {(0, 7): 1.0, (0, 3): 0.5, (0, 9): 0.25, (0, 4): 0.125}
    good = (0, 0.0, 0.0, np.array([7, 3, 9]), ref_top[0])

    def nums(*answers, attempted=None):
        lost = (attempted or len(answers)) - len(answers)
        return checks.compare(list(answers), lost, ref_top, pairs,
                              n_docs=10)

    assert nums(good) == {"lost": 0.0, "rank_gap": 0.0, "id_gap": 0.0}
    assert nums(good, attempted=3)["lost"] == 2.0
    swapped = (0, 0, 0, np.array([7, 4, 9]), ref_top[0])
    assert nums(swapped)["id_gap"] == 0.375
    assert nums(swapped)["rank_gap"] == 0.0
    empty = (0, 0, 0, np.array([-1, -1, -1]),
             np.full(3, -np.inf, np.float32))
    assert nums(empty) == {"lost": 0.0, "rank_gap": 1.0, "id_gap": 1.0}
    twice = (0, 0, 0, np.array([7, 7, 9]), ref_top[0])
    assert nums(twice)["id_gap"] == 1.0
    outside = (0, 0, 0, np.array([7, 3, 12]), ref_top[0])
    assert nums(outside)["id_gap"] == 1.0
    # nothing checked, nothing shown
    assert checks.compare([], 0, ref_top, pairs, n_docs=10) == {
        "lost": 0.0, "rank_gap": 1.0, "id_gap": 1.0}


def _stack(queries):
    w = max(q[0].size for q in queries)
    qi = np.full((len(queries), w), -1, np.int32)
    qv = np.zeros((len(queries), w), np.float32)
    for l, (i, v) in enumerate(queries):
        qi[l, :i.size] = i
        qv[l, :v.size] = v
    return qi, qv

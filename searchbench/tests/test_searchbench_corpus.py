"""The benchmark's corpus generator and Fig. 8 tile encoder, on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.core.corpus import Corpus, synthesize
from repro_torch.kernels.fused import corpus_to_stream, tile_stream
from searchbench import corpusgen

CFG = dict(name="t", n_docs=8192, vocab_size=141_000, avg_nnz_per_doc=60,
           nnz_pad=128, docs_per_base=16, base_width=256, zipf=1.1,
           mutate_every=8, count_max=29, layout="ell", block_docs=128)


def stats(ids, vals):
    nnz = (ids >= 0).sum(1)
    w = ids[ids >= 0].astype(np.int64)
    df = np.bincount(w, minlength=CFG["vocab_size"])
    return {"nnz_mean": nnz.mean(), "nnz_std": nnz.std(),
            "count_mean": vals[ids >= 0].mean(), "top10": (w < 10).mean(),
            "top1000": (w < 1000).mean(), "distinct": np.unique(w).size,
            "df_max": df.max() / ids.shape[0]}


@pytest.fixture(scope="module")
def made():
    return corpusgen.build(CFG, {"pool": 16}, 2**31 + 12345, "cpu")


def test_statistics_match_the_host_synthesizer(made):
    mine = stats(made.slab["ids"].numpy(), made.slab["vals"].numpy())
    ref = synthesize(CFG["n_docs"], CFG["vocab_size"], 60, 128, seed=3)
    theirs = stats(ref.ids, ref.vals)
    for key, rel in (("nnz_mean", 0.02), ("nnz_std", 0.06),
                     ("count_mean", 0.02), ("top10", 0.05),
                     ("top1000", 0.03), ("distinct", 0.03),
                     ("df_max", 0.02)):
        assert mine[key] == pytest.approx(theirs[key], rel=rel), key


def test_rows_are_sorted_unique_and_in_range(made):
    ids = made.slab["ids"]
    vals = made.slab["vals"]
    real = ids >= 0
    # real words first, then -1 padding
    assert torch.equal(real, real.sort(dim=1, descending=True).values)
    big = torch.where(real, ids.long(), 1 << 40)
    assert bool(((big[:, 1:] > big[:, :-1]) | ~real[:, 1:]).all())
    assert int(ids.max()) < CFG["vocab_size"]
    assert bool(((vals >= 1) & (vals <= 29))[real].all())
    assert bool((vals[~real] == 0).all())
    assert bool((real.sum(1) >= 1).all())
    n = vals.double().pow(2).sum(1).sqrt().float()
    assert torch.equal(made.slab["norms"], n)


def test_same_seed_same_corpus_and_chunks_stand_alone():
    cfg = dict(CFG, n_docs=corpusgen.CHUNK_DOCS + 300)
    bases = corpusgen.make_bases(cfg, 99, "cpu")
    assert torch.equal(bases, corpusgen.make_bases(cfg, 99, "cpu"))
    late = corpusgen.make_chunk(cfg, 99, bases, 1)
    again = list(corpusgen.chunks(cfg, 99, "cpu"))[1]
    assert late.d0 == again.d0 == corpusgen.CHUNK_DOCS
    assert torch.equal(late.ids, again.ids)
    assert torch.equal(late.vals, again.vals)
    other = corpusgen.make_chunk(cfg, 100, corpusgen.make_bases(cfg, 100,
                                                                "cpu"), 1)
    assert not torch.equal(late.ids, other.ids)


def test_queries_are_their_documents(made):
    assert len(made.queries) == made.pool.size == 16
    for d, (qi, qv) in zip(made.pool, made.queries):
        row = made.slab["ids"][d]
        assert np.array_equal(qi, row[row >= 0].numpy())
        assert np.array_equal(qv, made.slab["vals"][d][row >= 0].numpy())


def test_every_seed_asks_the_same_query_sizes():
    sizes = []
    for seed in (1, 2, 2**31 + 9):
        b = corpusgen.build(dict(CFG, n_docs=20000), {"pool": 64}, seed,
                            "cpu")
        asked = [q[0].size for q in b.queries]
        assert asked == sorted(asked)        # slot i: the i-th quantile
        sizes.append(asked)
        assert np.unique(b.pool).size == 64
    # the corpus's word-count quantiles, one a slot: alike in every seed
    for other in sizes[1:]:
        assert np.abs(np.subtract(sizes[0], other)).max() <= 1


def test_pick_pool_takes_each_quantile():
    nnz = np.array([5, 5, 5, 9, 9, 9, 9, 20])
    hist = np.bincount([5] * 50 + [9] * 50, minlength=21)
    got = corpusgen.pick_pool(nnz, hist, 4, seed=3)
    assert list(nnz[got]) == [5, 5, 9, 9]
    # none of the count wanted left: the nearest count
    got = corpusgen.pick_pool(nnz, np.bincount([20] * 10, minlength=21), 2,
                              seed=3)
    assert sorted(nnz[got]) == [9, 20]


@pytest.mark.parametrize("kind", ["whole", "", None])
def test_a_query_kind_the_generator_lacks_is_refused(kind):
    with pytest.raises(ValueError, match="queries"):
        corpusgen.candidates(CFG, {"pool": 4, "queries": kind}, 1)


@pytest.mark.parametrize("n,chunk", [(1000, 0), (128 * 5, 1), (77, 3)])
def test_tiles_byte_for_byte_tile_stream(n, chunk):
    cfg = dict(CFG, n_docs=2000)
    bases = corpusgen.make_bases(cfg, 7, "cpu")
    ch = corpusgen.make_chunk(cfg, 7, bases, 0)
    d0 = chunk * corpusgen.CHUNK_DOCS
    ch = corpusgen.Chunk(d0, ch.ids[:n], ch.vals[:n], ch.nnz[:n])
    corpus = Corpus(np.arange(d0, d0 + n), ch.ids.numpy(), ch.vals.numpy(),
                    corpusgen.norms(ch.vals).numpy())
    ref, n_docs, n_trunc = tile_stream(corpus_to_stream(corpus),
                                       block_docs=128, nnz_pad=128,
                                       pad_docs_to=n)
    assert (n_docs, n_trunc) == (n, 0)
    got = corpusgen.encode_tiles(ch, 128)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref.view(np.int32))


def test_fig8_build_holds_every_chunk_as_tiles():
    cfg = dict(CFG, n_docs=corpusgen.CHUNK_DOCS + 256 + 40, layout="fig8")
    built = corpusgen.build(cfg, {"pool": 4}, 5, "cpu")
    tiles = built.slab["tiles"]
    ell = list(corpusgen.chunks(dict(cfg, layout="ell"), 5, "cpu"))
    ids = torch.cat([c.ids for c in ell]).numpy()
    vals = torch.cat([c.vals for c in ell]).numpy()
    corpus = Corpus(np.arange(cfg["n_docs"]), ids, vals,
                    np.zeros(cfg["n_docs"], np.float32))
    ref, _, _ = tile_stream(corpus_to_stream(corpus), block_docs=128,
                            nnz_pad=128, pad_docs_to=cfg["n_docs"])
    assert np.array_equal(tiles.numpy(), ref.view(np.int32))
    assert built.n_pairs == int((ids >= 0).sum())

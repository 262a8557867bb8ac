"""The port's host-side formats against the JAX package's, byte for byte:
the Fig. 8 stream codec, ELL decode, corpus synthesis, fused doc tiling,
the packed-word encoding and the carry of corpus state between packages.
The same numpy inputs go to both; numpy outputs must be identical."""
import numpy as np
import pytest
import torch

from repro.core import corpus as j_corpus
from repro.core import stream_format as j_sf
from repro.kernels import fused as j_fused
from repro.kernels.sparse_match_packed import pack as j_pack
from repro_torch import carry
from repro_torch.core import corpus as t_corpus
from repro_torch.core import stream_format as t_sf
from repro_torch.kernels import fused as t_fused
from repro_torch.kernels.sparse_match_packed import pack as t_pack

torch.set_num_threads(2)
VOCAB = 512


def _docs(seed, n_docs=40, max_nnz=14):
    rng = np.random.default_rng(seed)
    docs = []
    for d in range(n_docs):
        nw = int(rng.integers(0, max_nnz))
        ws = sorted(rng.choice(VOCAB, nw, replace=False).tolist())
        docs.append((int(rng.integers(0, 2**31 - 1)) if d % 7 == 3 else d,
                     [(int(w), int(rng.integers(1, 5000))) for w in ws]))
    return docs


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_decode_identical(seed):
    docs = _docs(seed)
    stream = t_sf.encode(docs)
    _same(stream, j_sf.encode(docs))
    assert t_sf.decode(stream) == j_sf.decode(stream)
    assert t_sf.stream_bytes(docs) == j_sf.stream_bytes(docs)
    assert t_sf.uci_bytes(docs) == j_sf.uci_bytes(docs)


@pytest.mark.parametrize("nnz_pad", [1, 5, 16])
def test_decode_to_ell_and_from_stream_identical(nnz_pad):
    stream = t_sf.encode(_docs(nnz_pad))
    got = t_sf.decode_to_ell(stream, nnz_pad)
    want = j_sf.decode_to_ell(stream, nnz_pad)
    for g, w in zip(got[:4], want[:4]):
        _same(g, w)
    assert got[4] == want[4]
    tc, jc = t_corpus.from_stream(stream, nnz_pad), \
        j_corpus.from_stream(stream, nnz_pad)
    for f in ("doc_ids", "ids", "vals", "norms"):
        _same(getattr(tc, f), getattr(jc, f))
    if want[4]:
        with pytest.raises(ValueError, match="truncated"):
            t_corpus.from_stream(stream, nnz_pad, strict=True)


@pytest.mark.parametrize("n_docs,seed", [(1, 0), (300, 5)])
def test_synthesize_and_make_query_identical(n_docs, seed):
    tc = t_corpus.synthesize(n_docs, VOCAB, 12, 16, seed=seed)
    jc = j_corpus.synthesize(n_docs, VOCAB, 12, 16, seed=seed)
    for f in ("doc_ids", "ids", "vals", "norms"):
        _same(getattr(tc, f), getattr(jc, f))
    for i in (0, n_docs - 1):
        for g, w in zip(t_corpus.make_query(tc, i, 8),
                        j_corpus.make_query(jc, i, 8)):
            _same(g, w)
    padded = tc.pad_docs_to(n_docs + 3)
    jpadded = jc.pad_docs_to(n_docs + 3)
    for f in ("doc_ids", "ids", "vals", "norms"):
        _same(getattr(padded, f), getattr(jpadded, f))


@pytest.mark.parametrize("block_docs,nnz_pad,pad_to", [(1, 3, None),
                                                       (4, 8, 50),
                                                       (16, 16, None)])
def test_tile_stream_identical(block_docs, nnz_pad, pad_to):
    stream = t_sf.encode(_docs(block_docs, n_docs=37))
    got = t_fused.tile_stream(stream, block_docs=block_docs,
                              nnz_pad=nnz_pad, pad_docs_to=pad_to)
    want = j_fused.tile_stream(stream, block_docs=block_docs,
                               nnz_pad=nnz_pad, pad_docs_to=pad_to)
    _same(got[0], want[0])
    assert got[1:] == want[1:]


def test_tile_stream_refuses_pad_aliasing_doc_id_like_reference():
    stream = t_sf.encode([(t_sf.MAX_DOC_ID, [(1, 2)])])
    for mod in (t_fused, j_fused):
        with pytest.raises(ValueError, match="alias"):
            mod.tile_stream(stream, block_docs=8, nnz_pad=4)


def test_corpus_to_stream_and_pack_identical():
    corpus = t_corpus.from_stream(t_sf.encode(_docs(9)), 16).pad_docs_to(45)
    corpus.doc_ids[:] = np.where(corpus.doc_ids >= 0,
                                 corpus.doc_ids % 1000, -1)
    _same(t_fused.corpus_to_stream(corpus), j_fused.corpus_to_stream(corpus))
    _same(t_pack(corpus.ids, corpus.vals), j_pack(corpus.ids, corpus.vals))
    bad = t_corpus.Corpus(np.array([0]), np.array([[3]], np.int32),
                          np.array([[1.5]], np.float32),
                          np.array([1.5], np.float32))
    for mod in (t_fused, j_fused):
        with pytest.raises(ValueError, match="integral"):
            mod.corpus_to_stream(bad)


def test_carry_from_reference():
    """The reference's corpus, stream and tile matrix carry over as the
    port's, bit for bit."""
    jc = j_corpus.synthesize(50, VOCAB, 12, 16, seed=4)
    tc = carry.from_reference(jc)
    assert isinstance(tc, t_corpus.Corpus)
    for f in ("doc_ids", "ids", "vals", "norms"):
        _same(getattr(tc, f), getattr(jc, f))
    stream = j_fused.corpus_to_stream(jc)
    _same(carry.from_reference(stream), stream)
    tiles, _, _ = j_fused.tile_stream(stream, block_docs=8, nnz_pad=16)
    slab = carry.from_reference(j_fused.PackedSlab(tiles), device="cpu")
    assert isinstance(slab, t_fused.PackedSlab)
    _same(slab.tiles.numpy().view(np.uint32), tiles)
    with pytest.raises(TypeError):
        carry.from_reference(np.zeros(3, np.float32))

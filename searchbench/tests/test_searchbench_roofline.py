"""``scan_roofline``'s counting reads the same work from either layout."""
import numpy as np
import pytest

from searchbench import corpusgen, roofline

CFG = dict(name="t", n_docs=1500, vocab_size=141_000, avg_nnz_per_doc=60,
           nnz_pad=128, docs_per_base=16, base_width=256, zipf=1.1,
           mutate_every=8, count_max=29, block_docs=128)


def test_ell_and_fig8_forms_give_one_bound():
    ell = corpusgen.build(dict(CFG, layout="ell"), {"pool": 8}, 3, "cpu")
    fig8 = corpusgen.build(dict(CFG, layout="fig8"), {"pool": 8}, 3, "cpu")
    a = roofline.counts_from_ell(ell.slab["ids"], CFG["vocab_size"])
    b = roofline.counts_from_tiles(fig8.slab["tiles"], CFG["vocab_size"])
    assert a[:2] == b[:2] == (CFG["n_docs"], ell.n_pairs)
    assert np.array_equal(a[2], b[2])
    assert np.array_equal(a[2], ell.df) and np.array_equal(b[2], fig8.df)
    # the tiles' capacity and ELL's padding count for nothing
    assert roofline.corpus_bytes(a[0], a[1]) == 4 * (CFG["n_docs"]
                                                     + ell.n_pairs)
    assert ell.slab["ids"].numel() * 8 > roofline.corpus_bytes(*a[:2])
    assert fig8.slab["tiles"].numel() * 4 > roofline.corpus_bytes(*b[:2])
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    qi = np.full((3, 100), -1, np.int32)
    for l, (i, _) in enumerate(ell.queries[:3]):
        qi[l, :i.size] = i
    for counts in (a, b):
        nb, fl = roofline.batch_work(qi, counts[2], 16,
                                     roofline.corpus_bytes(*counts[:2]))
        assert (nb, fl) == roofline.batch_work(
            qi, ell.df, 16, roofline.corpus_bytes(CFG["n_docs"],
                                                  ell.n_pairs))
    assert roofline.least_seconds(nb, fl, pk) == max(nb / 3.35e12,
                                                     fl / 67e12)


def test_batch_work_counts_matched_products():
    df = np.zeros(10, np.int64)
    df[[2, 5, 7]] = [100, 10, 1]
    qi = np.array([[2, 5, -1], [5, 7, 9]], np.int32)
    nbytes, flops = roofline.batch_work(qi, df, top_k=4, corpus_nbytes=1000)
    # (100 + 10) + (10 + 1 + 0) matched pairs, 2 operations each
    assert flops == 2 * 121
    # 5 query items, each an id and Lp = 2 value columns; a [2, 4] answer
    assert nbytes == 1000 + 4 * 5 * 3 + 8 * 2 * 4


@pytest.mark.parametrize("L,Lp", [(1, 1), (2, 2), (3, 4), (17, 32), (32, 32)])
def test_bucket(L, Lp):
    assert roofline.bucket(L) == Lp


def test_no_peaks_for_an_unknown_card():
    assert roofline.peaks("cpu") is None
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["bytes_per_s"] == 3.35e12

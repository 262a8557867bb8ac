"""A run with the timed path broken underneath it comes out not correct:
one fault of each kind a served search can have, planted in the program
on the CPU at a small corpus."""
import numpy as np
import pytest

from repro_torch.core import engine as engine_mod
from repro_torch.core import topk as topk_lib
from repro_torch.kernels import ops as kops
from searchbench import harness

# batches wait up to 50 ms to fill, so a loaded test machine still
# forms the batches that the faults below break
SMALL = {"n_docs": 5000, "service": {"max_batch": 32, "max_delay_ms": 50.0}}


def stale(mp):
    """A search that hands back its last answer: state left unchanged."""
    real = engine_mod.PatternSearchEngine._search_arrays
    last = {}

    def search(self, q_ids, q_vals):
        res = real(self, q_ids, q_vals)
        out = last.get("res", res)
        last["res"] = res
        L, k = q_ids.shape[0], out.doc_ids.shape[1]
        return engine_mod.SearchResult(np.resize(out.doc_ids, (L, k)),
                                       np.resize(out.scores, (L, k)))
    mp.setattr(engine_mod.PatternSearchEngine, "_search_arrays", search)


def half(mp):
    """Half of each batch left out of the merged stream."""
    real = kops.merge_queries

    def merge(q_ids, q_vals):
        q_ids = q_ids.copy()
        q_ids[q_ids.shape[0] // 2:] = -1
        return real(q_ids, q_vals)
    mp.setattr(kops, "merge_queries", merge)


def altered(mp):
    """An answer altered where it is produced: the top id moved by one."""
    for mod, name in ((topk_lib, "local_topk"), (kops, "fold_topk")):
        real = getattr(mod, name)

        def bad(*a, _real=real, **k):
            v, i = _real(*a, **k)
            i = i.clone()
            i[:, 0] = (i[:, 0] + 1) % SMALL["n_docs"]
            return v, i
        mp.setattr(mod, name, bad)


def swapped(mp):
    """The demux hands each client another client's row."""
    real = engine_mod.PatternSearchEngine._search_arrays

    def search(self, q_ids, q_vals):
        r = real(self, q_ids, q_vals)
        return engine_mod.SearchResult(np.roll(r.doc_ids, 1, 0),
                                       np.roll(r.scores, 1, 0))
    mp.setattr(engine_mod.PatternSearchEngine, "_search_arrays", search)


# a batch of one query (the c1 cells) has no half and no other row
CASES = ([(c, f) for c in ("ell-2p25-c64", "fig8-2p26-c64")
          for f in (stale, half, altered, swapped)]
         + [(c, f) for c in ("ell-2p25-c1", "fig8-2p26-c1")
            for f in (stale, altered)])


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_comes_out_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = harness.run(cell, 2**31 + 11, 0.7, False, device="cpu",
                      overrides=SMALL, log=lambda s: None)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())

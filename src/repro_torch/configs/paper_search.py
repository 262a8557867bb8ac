"""The paper's own workload configs (§IV): sparse pattern search.

Not an LM architecture — these configure the sparse pattern engine.
Numbers from the paper: vocab ~141k words, ~60 nnz/doc (0.04% sparsity),
query memory 2K nnz (8 KB BRAM), 8 kernels / 2 GB/s flash baseline and the
optimized 20-kernel / 3-query-batch variant (Table 2). A copy of ``repro.configs.paper_search``.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    name: str
    vocab_size: int = 141_000       # prominent-word bag size (§V.C)
    avg_nnz_per_doc: int = 60       # 0.04% sparsity (§V.C)
    max_query_nnz: int = 2048       # 8 KB query memory (§IV.A)
    doc_tile: int = 128             # ELL tile rows (documents per tile)
    nnz_pad: int = 128              # ELL row width (padded nnz per doc)
    query_batch: int = 1            # L in the paper's K*L kernel grid
    top_k: int = 16                 # results reported to host
    # kernel tiling (the padding rules of kernels/ops.py; DESIGN.md §11)
    block_docs: int = 128
    block_query: int = 512


def baseline() -> SearchConfig:
    """8-kernel / single-query configuration (paper Table 2 row 1)."""
    return SearchConfig(name="paper-baseline", query_batch=1)


def optimized() -> SearchConfig:
    """20-kernel / 3-query-batch configuration (paper Table 2 row 2)."""
    return SearchConfig(name="paper-optimized", query_batch=3)


def smoke() -> SearchConfig:
    return SearchConfig(
        name="paper-smoke", vocab_size=512, avg_nnz_per_doc=12,
        max_query_nnz=64, doc_tile=16, nnz_pad=16, top_k=4,
        block_docs=16, block_query=32)

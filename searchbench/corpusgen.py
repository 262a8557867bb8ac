"""The benchmark's corpus, made on the device from the run's seed.

A vectorised, chunked copy of the statistics of the paper's synthesizer
(arXiv:1611.03380 §IV.A; ``repro_torch.core.corpus.synthesize`` is the
host version): documents permute Zipf word sets with random add/remove.

- lengths Poisson(``avg_nnz_per_doc``), clipped to [1, ``nnz_pad``];
- topic bases of ``base_width`` Zipf(``zipf``) ranks mod ``vocab_size``,
  one base per ``docs_per_base`` documents; each document takes a random
  subset of its base's positions (without replacement);
- the first ``max(1, len // mutate_every)`` words replaced uniformly;
- words unique and sorted per row; counts uniform in 1..``count_max``.

Every piece has a random stream of its own (``stream_seed``), so a chunk
of ``CHUNK_DOCS`` documents can be made again alone, in any order: the
reference makes the corpus again, chunk by chunk, after the window.
Zipf draws follow numpy's rejection sampler (``random_zipf``) in
float64, so the ranks have numpy's distribution.

``encode_tiles`` is the harness's own Fig. 8 encoder: a chunk's rows as
the fused kernel's packed doc tiles, byte for byte what
``kernels.fused.tile_stream(corpus_to_stream(...))`` gives on the host.
Plain PyTorch; it runs on the card or the CPU alike.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

CHUNK_DOCS = 1 << 17          # documents a chunk (a multiple of any tile)
BASE_PIECE = 1 << 16          # topic bases made per random stream
HEADER = 1 << 31
VAL_BITS = 12
INT64_MAX = (1 << 63) - 1
CANDIDATES = 16               # documents drawn for each query of a pool


def stream_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the random stream ``keys`` of run ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + tuple(keys)).encode()).digest()
    return int.from_bytes(h[:8], "little") & INT64_MAX


def generator(device, seed: int, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  *keys))


def zipf(gen: torch.Generator, n: int, a: float, device) -> torch.Tensor:
    """``n`` Zipf(``a``) draws as int64, numpy's rejection sampler."""
    am1 = a - 1.0
    b = 2.0 ** am1
    umin = float(INT64_MAX) ** -am1
    out, have = [], 0
    while have < n:
        m = int((n - have) * 1.15) + 1024
        u01 = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        v = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        u = u01 * umin + (1.0 - u01)
        x = torch.floor(u ** (-1.0 / am1))
        ok = (x >= 1.0) & (x < 2.0 ** 63)
        x = torch.where(ok, x, 1.0)
        t = (1.0 + 1.0 / x) ** am1
        ok &= v * x * (t - 1.0) / (b - 1.0) <= t / b
        got = x[ok][:n - have].to(torch.int64)
        out.append(got)
        have += got.numel()
    return torch.cat(out)


def make_bases(cfg: dict, seed: int, device) -> torch.Tensor:
    """[n_base, base_width] int32 topic bases of the whole corpus."""
    n_base = max(1, cfg["n_docs"] // cfg["docs_per_base"])
    w = cfg["base_width"]
    out = torch.empty((n_base, w), dtype=torch.int32, device=device)
    for p, b0 in enumerate(range(0, n_base, BASE_PIECE)):
        nb = min(BASE_PIECE, n_base - b0)
        g = generator(device, seed, 0, p)
        r = zipf(g, nb * w, cfg["zipf"], device) % cfg["vocab_size"]
        out[b0:b0 + nb] = r.view(nb, w).to(torch.int32)
    return out


class Chunk(NamedTuple):
    d0: int                   # global index of the chunk's first document
    ids: torch.Tensor         # [n, nnz_pad] int32, sorted, -1 padded
    vals: torch.Tensor        # [n, nnz_pad] float32 counts (0 padded)
    nnz: torch.Tensor         # [n] int64


def make_chunk(cfg: dict, seed: int, bases: torch.Tensor, c: int) -> Chunk:
    """Chunk ``c`` of the corpus (documents ``c * CHUNK_DOCS`` on)."""
    dev = bases.device
    d0 = c * CHUNK_DOCS
    n = min(CHUNK_DOCS, cfg["n_docs"] - d0)
    K, W, V = cfg["nnz_pad"], cfg["base_width"], cfg["vocab_size"]
    g = generator(dev, seed, 1, c)
    lens = torch.poisson(torch.full((n,), float(cfg["avg_nnz_per_doc"]),
                                    device=dev), generator=g)
    lens = lens.clamp(1, K).to(torch.int64)
    bidx = torch.randint(0, bases.shape[0], (n,), generator=g, device=dev)
    keys = torch.rand((n, W), generator=g, device=dev)
    pos = torch.argsort(keys, dim=1, stable=True)[:, :K]
    words = bases.view(-1)[bidx[:, None] * W + pos].to(torch.int64)
    n_mut = (lens // cfg["mutate_every"]).clamp(min=1)
    m = K // cfg["mutate_every"]
    mut = torch.randint(0, V, (n, m), generator=g, device=dev)
    col = torch.arange(K, device=dev)
    words[:, :m] = torch.where(col[:m] < n_mut[:, None], mut, words[:, :m])
    big = torch.iinfo(torch.int64).max
    s = torch.where(col < lens[:, None], words, big).sort(dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    s = torch.where(dup, big, s).sort(dim=1).values
    real = s != big
    counts = torch.randint(1, cfg["count_max"] + 1, (n, K), generator=g,
                           device=dev)
    ids = torch.where(real, s, -1).to(torch.int32)
    vals = torch.where(real, counts, 0).to(torch.float32)
    return Chunk(d0, ids, vals, real.sum(1))


def chunks(cfg: dict, seed: int, device,
           bases: Optional[torch.Tensor] = None) -> Iterator[Chunk]:
    """Every chunk of the corpus in order."""
    if bases is None:
        bases = make_bases(cfg, seed, device)
    for c in range(-(-cfg["n_docs"] // CHUNK_DOCS)):
        yield make_chunk(cfg, seed, bases, c)


def norms(vals: torch.Tensor) -> torch.Tensor:
    """float32 L2 norms of rows of integral counts: the sums are exact,
    and a square root taken in float64 and rounded once more is the
    correctly rounded float32 one on either device."""
    return torch.sqrt((vals * vals).sum(1).double()).float()


def encode_tiles(ch: Chunk, block_docs: int) -> torch.Tensor:
    """A chunk's rows as Fig. 8 doc tiles, int32 view: ``[ceil(n /
    block_docs), block_docs * (1 + nnz_pad)]``, each tile its documents'
    header word (bit 31 | doc id) and (word << 12 | count) pairs one after
    another, then pad words (-1). The chunk must start on a tile."""
    n, K = ch.ids.shape
    dev = ch.ids.device
    if ch.d0 % block_docs:
        raise ValueError("a chunk must start on a tile boundary")
    cap = block_docs * (1 + K)
    T = -(-n // block_docs)
    hdr = torch.arange(ch.d0, ch.d0 + n, device=dev) - HEADER
    pair = (ch.ids.to(torch.int64) << VAL_BITS) | ch.vals.to(torch.int64)
    words = torch.cat([hdr[:, None], pair], 1).to(torch.int32)
    width = torch.zeros(T * block_docs, dtype=torch.int64, device=dev)
    width[:n] = ch.nnz + 1
    width = width.view(T, block_docs)
    start = (torch.cumsum(width, 1) - width).view(-1)[:n]
    tile = torch.arange(n, device=dev) // block_docs
    col = torch.arange(K + 1, device=dev)
    keep = col[None, :] < (ch.nnz + 1)[:, None]
    flat = (tile * cap + start)[:, None] + col[None, :]
    out = torch.full((T * cap,), -1, dtype=torch.int32, device=dev)
    out[flat[keep]] = words[keep]
    return out.view(T, cap)


class Built(NamedTuple):
    """What set-up hands on: the slab's tensors, the query pool (its
    documents and their rows on the host), and the counts the roofline
    needs."""
    slab: Dict[str, torch.Tensor]   # ell: ids, vals, norms, doc_ids;
    #                                 fig8: tiles
    pool: np.ndarray                # [P] the documents the queries are
    queries: list                   # [(ids int32, vals float32)] per pool q
    df: np.ndarray                  # [vocab] pairs a word has in the corpus
    n_pairs: int                    # real (word, count) pairs


QUERY_KINDS = ("self",)


def candidates(cfg: dict, traffic: dict, seed: int) -> np.ndarray:
    """Documents drawn uniformly from the seed, ``CANDIDATES`` for each
    query of the pool, sorted."""
    if traffic.get("queries", "self") not in QUERY_KINDS:
        raise ValueError(f"queries {traffic['queries']!r}: the generator "
                         f"makes {QUERY_KINDS} only")
    rng = np.random.default_rng(stream_seed(seed, 2))
    return np.unique(rng.integers(0, cfg["n_docs"],
                                  CANDIDATES * traffic["pool"]))


def pick_pool(nnz: np.ndarray, hist: np.ndarray, size: int,
              seed: int) -> np.ndarray:
    """Positions in the candidates (their word counts ``nnz``) of a pool
    whose slot ``i`` holds a document of the corpus's word-count quantile
    (i + 1/2) / size (``hist``: documents by word count): every seed's
    pool asks the same sizes in the same slots, so a seed changes which
    documents are asked, not how much work they are. Each is drawn from
    the seed among the unused candidates of that count (the nearest count
    where none is left)."""
    rng = np.random.default_rng(stream_seed(seed, 4))
    cdf = np.cumsum(hist) / hist.sum()
    want = np.searchsorted(cdf, (np.arange(size) + 0.5) / size)
    free = np.ones(nnz.size, bool)
    take = []
    for t in want:
        gap = np.where(free, np.abs(nnz - t), np.iinfo(np.int64).max)
        pick = rng.choice(np.flatnonzero(gap == gap.min()))
        free[pick] = False
        take.append(pick)
    return np.asarray(take)


def build(cfg: dict, traffic: dict, seed: int, device) -> Built:
    """The corpus on the device in the configuration's layout, and the
    traffic's pool of self-queries."""
    D, K = cfg["n_docs"], cfg["nnz_pad"]
    bd = cfg["block_docs"]
    if cfg["layout"] == "ell":
        slab = {"ids": torch.empty((D, K), dtype=torch.int32, device=device),
                "vals": torch.empty((D, K), dtype=torch.float32,
                                    device=device),
                "norms": torch.empty(D, dtype=torch.float32, device=device),
                "doc_ids": torch.arange(D, dtype=torch.int32, device=device)}
    elif cfg["layout"] == "fig8":
        if CHUNK_DOCS % bd:
            raise ValueError(f"block_docs {bd} must divide {CHUNK_DOCS}")
        slab = {"tiles": torch.empty((-(-D // bd), bd * (1 + K)),
                                     dtype=torch.int32, device=device)}
    else:
        raise ValueError(f"unknown layout {cfg['layout']!r}")
    cand = candidates(cfg, traffic, seed)
    rows = []
    df = torch.zeros(cfg["vocab_size"], dtype=torch.int64, device=device)
    hist = torch.zeros(K + 1, dtype=torch.int64, device=device)
    n_pairs = 0
    for ch in chunks(cfg, seed, device):
        n = ch.ids.shape[0]
        if cfg["layout"] == "ell":
            sl = slice(ch.d0, ch.d0 + n)
            slab["ids"][sl] = ch.ids
            slab["vals"][sl] = ch.vals
            slab["norms"][sl] = norms(ch.vals)
        else:
            t0 = ch.d0 // bd
            tiles = encode_tiles(ch, bd)
            slab["tiles"][t0:t0 + tiles.shape[0]] = tiles
        real = ch.ids[ch.ids >= 0].to(torch.int64)
        df += torch.bincount(real, minlength=cfg["vocab_size"])
        hist += torch.bincount(ch.nnz, minlength=K + 1)
        n_pairs += real.numel()
        here = cand[(cand >= ch.d0) & (cand < ch.d0 + n)]
        if here.size:
            idx = torch.as_tensor(here - ch.d0, device=device)
            qi, qv, qn = (t.cpu().numpy() for t in (
                ch.ids[idx], ch.vals[idx], ch.nnz[idx]))
            rows += [(qi[j, :qn[j]].copy(), qv[j, :qn[j]].copy())
                     for j in range(here.size)]
    nnz = np.asarray([r[0].size for r in rows])
    pick = pick_pool(nnz, hist.cpu().numpy(), traffic["pool"], seed)
    return Built(slab, cand[pick], [rows[i] for i in pick], df.cpu().numpy(),
                 n_pairs)

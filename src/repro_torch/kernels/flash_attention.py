"""Flash attention, forward: the port of ``repro.kernels.flash_attention``.

    o = softmax(q kᵀ / sqrt(hd), causal and window mask at -1e30) v

with an online softmax over key tiles: running max and sum in f32, ``p``
rounded to v's dtype before ``p·v``, f32 accumulation, and the output
``acc / max(l, 1e-30)`` in q's dtype. On the card this is
``csrc/flash_attention.cu``; ``flash_attention_gqa_plain`` takes the same
steps in PyTorch, tile by tile, and is what the wrappers run for CPU
tensors and what the kernel is held against.

The source holds two instances, and ``design(dtype, head_dim)`` picks
one: ``"wgmma"`` (tensor cores) for bfloat16 at head dims 16, 32, 64,
128 and 256, ``"simt"`` (CUDA cores, full f32 arithmetic with explicit
FMAs and no TF32) for float32 at every head dim and bfloat16 at 8, which
is below wgmma's bf16 depth of 16. A launch that fails raises; neither
instance stands in for the other.

Two entry points, as in the reference:

  - ``flash_attention_gqa``: q ``[B, S, H, hd]``, k and v ``[B, Sk, KV,
    hd]`` as the model holds them; head h reads kv head ``h // (H // KV)``.
    Unlike the reference it neither repeats k and v nor transposes: the
    kernel reads the heads by stride.
  - ``flash_attention``: q, k, v ``[BH, S, hd]``.

``Sk`` is S for self-attention. Cross-attention (llama-3.2-vision's
queries over its image tokens) has keys of their own length ``Sk != S``,
which the reference's jnp blockwise attention takes; the reference's
Pallas kernel does not. It is allowed only non-causal and with no
window: the reference runs neither mask at Sk != S, and both compare a
query's position with a key's, which cross-attention does not share.

``return_lse`` (``flash_attention_gqa`` and its plain version): also
return each query row's log-sum-exp ``m + log(max(l, 1e-30))`` of the
scaled scores, f32 ``[B, H, S]``, which the training backward reads
(``models/layers.py``; the reference's ``_flash_fwd`` returns the same
``lse``). B4 computes no gradient: the wrapper raises where grad mode is
on and q, k or v requires grad, so that autograd never meets a result
with no history. Training reaches it through the autograd Function of
``models/layers.py``, whose forward runs with grad mode off.

``q_offset`` (``flash_attention_gqa`` and its plain version; causal
only): query row i of the call sits at key position ``q_offset + i``, so
a rank that holds the query rows ``[r·S/M, (r+1)·S/M)`` of a causal
prefill attends over the keys ``[0, (r+1)·S/M)`` with ``q_offset =
r·S/M`` (``seq_shard_attn``, ``models/transformer.py``). The keys must
be exactly that prefix, ``Sk == q_offset + S``. The causal test is ``key
> q_offset + row``, the window's ``q_offset + row - key >= window``, and
a query tile's key loop runs from the band's first tile to ``min(Sk,
q_offset + q0 + BLOCK_Q)``: where ``q_offset`` is a multiple of
``BLOCK_Q`` the call's rows run the tiles of the full call's rows in the
same order, and equal them bit for bit.

``window`` (both entry points, both instances): 0 is global attention;
``w > 0`` keeps a key at position dk for the query at dq only where
``dq - dk < w``, on top of the causal test where ``causal`` (the
reference's ``_attn_mask`` in ``repro.models.layers``, which gemma3's
local layers use; the reference's Pallas kernel has no window). The key
loop starts at the tile that holds the block's first key of the band, so
tiles below it cost nothing.

Head dims 8, 16, 32, 64, 128 and 256 (the kernel is compiled for each);
any other raises. Any S and Sk: partial tiles are masked, not resized. The
wgmma instance reads 16-byte chunks, so it needs q, k and v 16-byte
aligned with (batch, position, head) strides that are multiples of 8
elements (any view of the model's projections is); it raises on others.
The simt instance copies 16-byte chunks where the views allow that and
one element at a time where they do not, so it takes any strides.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sparse_match import on_cpu, stream_of

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
BLOCK_Q = 64                  # csrc/flash_attention.cu: kBlockQ (both)
BLOCK_K = 64                  # csrc/flash_attention.cu: kBlockK (both)
DESIGNS = ("wgmma", "simt")
WGMMA_HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def design(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel instance runs these inputs: ``"wgmma"`` for bfloat16
    at head dims 16 to 256 (the tensor cores: bf16 operands, K 16 deep),
    else ``"simt"`` (float32, the accuracy reference, and bf16 at head
    dim 8): the CUDA cores in full f32, 128 threads a 64-row query tile
    (256 at head dim 256) with scores and outputs in register tiles."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _band_start(q0: int, window: int) -> int:
    """The first key tile a query tile at key position ``q0`` reads: the
    one that holds key ``q0 - window + 1`` with a window, else 0."""
    return max(0, q0 - window + 1) // BLOCK_K * BLOCK_K if window > 0 else 0


def _sum_min(a: int, b: int, w: int) -> int:
    """sum of min(x, w) for x in [a, b] (0 where the range is empty)."""
    if b < a:
        return 0
    c = min(b, w)
    low = (a + c) * (c - a + 1) // 2 if c >= a else 0
    return low + w * (b - max(a - 1, w)) if b > w else low


def attention_flops(B: int, S: int, Sk: int, H: int, hd: int, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> int:
    """The operations B4 needs for these shapes: q·kᵀ and p·v, 2·hd each
    a (query, key) pair a head that the mask keeps. A causal row at key
    position p sees min(p + 1, window) keys (p + 1 with no window); a
    non-causal row all Sk, or with a window (Sk == S) the keys from
    p - window + 1 on. The bound of B4's rows in ``chip_smoke.py`` and
    the dry run's count (``launch/dryrun.py``) are this."""
    if causal:
        w = window if window > 0 else q_offset + S
        pairs = _sum_min(q_offset + 1, q_offset + S, w)
    elif window <= 0:
        pairs = S * Sk
    else:
        n = S - window               # rows whose band starts past key 0
        pairs = S * Sk - (n * (n + 1) // 2 if n > 0 else 0)
    return 4 * B * H * hd * pairs


def flash_attention_gqa_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0, return_lse: bool = False,
                              q_offset: int = 0):
    """The kernel's function in PyTorch, in its tiles: q [B, S, H, hd],
    k, v [B, Sk, KV, hd] -> [B, S, H, hd] in q's dtype, and with
    ``return_lse`` also the rows' log-sum-exp, f32 [B, H, S]; query row
    i at key position ``q_offset + i``."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, S, KV, G, hd).float()
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    lse = torch.empty((B, KV, G, S), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, BLOCK_Q):
        qt = qf[:, q0:q0 + BLOCK_Q]                       # [B, bq, KV, G, hd]
        bq = qt.shape[1]
        qpos = torch.arange(q_offset + q0, q_offset + q0 + bq,
                            device=q.device)
        m = torch.full((B, KV, G, bq), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, bq), device=q.device)
        acc = torch.zeros((B, KV, G, bq, hd), device=q.device)
        k_end = min(Sk, q_offset + q0 + BLOCK_Q) if causal else Sk
        for k0 in range(_band_start(q_offset + q0, window), k_end, BLOCK_K):
            kt, vt = kf[:, k0:k0 + BLOCK_K], vf[:, k0:k0 + BLOCK_K]
            s = torch.einsum("bqkgd,bskd->bkgqs", qt, kt) * scale
            if causal or window > 0:
                kpos = torch.arange(k0, k0 + kt.shape[1], device=q.device)
                d = qpos[:, None] - kpos[None, :]
                keep = (d >= 0 if causal
                        else torch.ones_like(d, dtype=torch.bool))
                if window > 0:
                    keep &= d < window
                s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vt)
            m = m_new
        denom = torch.clamp(l, min=1e-30)
        o = acc / denom[..., None]                        # [B, KV, G, bq, hd]
        out[:, q0:q0 + bq] = o.permute(0, 3, 1, 2, 4).reshape(
            B, bq, H, hd).to(q.dtype)
        lse[..., q0:q0 + bq] = m + torch.log(denom)
    return (out, lse.view(B, H, S)) if return_lse else out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0
                          ) -> torch.Tensor:
    """``flash_attention_gqa_plain`` on [BH, S, hd] (one head a row)."""
    return flash_attention_gqa_plain(q.unsqueeze(2), k.unsqueeze(2),
                                     v.unsqueeze(2), causal=causal,
                                     window=window).squeeze(2)


# q, k, v, o, lse (or null), B, S, Sk, H, KV, strides, causal, window,
# q_offset, scale, stream
_TAIL = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
# design -> (C symbol, argtypes): simt takes (device, dtype, hd, ...),
# wgmma (device, hd, ...), bf16 only
_SYMBOLS = {"simt": ("flash_attention_launch", [ctypes.c_int] * 3 + _TAIL),
            "wgmma": ("flash_attention_wgmma_launch",
                      [ctypes.c_int] * 2 + _TAIL)}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int, q_offset: int = 0) -> None:
    B, S, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} must be [B, S, H, hd] and "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "[B, Sk, KV, hd]")
    Sk, KV = k.shape[1], k.shape[2]
    if q_offset < 0 or (q_offset and not causal):
        raise ValueError(f"q_offset {q_offset}: a query offset is causal "
                         "and not negative")
    if (Sk != q_offset + S) if causal else (Sk != S and (window or not Sk)):
        raise ValueError(f"{Sk} keys for {S} queries at offset {q_offset}: "
                         "causal attention takes the keys up to its last "
                         "row (Sk == q_offset + S); cross-attention (Sk != "
                         "S) takes at least one key, and is non-causal "
                         "with no window")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window {window} must be 0 (global) or positive")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        return_lse: bool = False, q_offset: int = 0):
    """q [B, S, H, hd], k, v [B, Sk, KV, hd] (float32 or bfloat16, hd in
    ``HEAD_DIMS``, each with a contiguous last dim) -> [B, S, H, hd];
    ``window`` 0 (global) or the sliding window's width. Causal, Sk ==
    ``q_offset`` + S (query row i at key position ``q_offset + i``);
    non-causal, ``q_offset`` 0 and Sk != S only with no window
    (cross-attention). With ``return_lse``, (out, lse f32 [B, H, S]).
    Raises ``RuntimeError`` where grad mode is on and q, k or v requires
    grad (B4 has no backward of its own).

    CPU tensors run ``flash_attention_gqa_plain``; CUDA tensors launch
    the instance ``design`` names (counted in
    ``flash_attention_gqa.launches`` and, by design, in
    ``flash_attention_gqa.launches_by_design``; those with a window
    narrower than the keys also in
    ``flash_attention_gqa.launches_windowed``, the non-causal ones at Sk
    != S in ``flash_attention_gqa.launches_cross``, those at a query
    offset in ``flash_attention_gqa.launches_offset``, and those that
    write the lse in ``flash_attention_gqa.launches_lse``) or raise.
    Meta tensors (the dry run, ``launch/dryrun.py``) launch nothing: they
    give empty results of the right shapes and add ``attention_flops``
    to ``flash_attention_gqa.meta_flops``."""
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be [B, S, H, hd]")
    _check(q, k, v, causal, window, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_gqa computes no gradient: train through "
            "repro_torch.models.layers.blockwise_attention, whose autograd "
            "Function runs B4 forward and the backward beside it")
    if all(t.device.type == "meta" for t in (q, k, v)):
        return _meta(q, k, causal, window, return_lse, q_offset)
    if on_cpu(q, k, v, contiguous=False):
        return flash_attention_gqa_plain(q, k, v, causal=causal,
                                         window=window,
                                         return_lse=return_lse,
                                         q_offset=q_offset)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("kernel inputs need a contiguous head_dim")
    B, S, H, hd = q.shape
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    which = design(q.dtype, hd)
    symbol, argtypes = _SYMBOLS[which]
    fn = _build.kernel("flash_attention", symbol, argtypes)
    if which == "wgmma":
        for t in (q, k, v, out):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(
                    "the wgmma instance needs 16-byte aligned tensors with "
                    f"strides that are multiples of 8, got {t.stride()}")
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    head = (q.device.index, hd) if which == "wgmma" else (
        q.device.index, _DTYPES[q.dtype], hd)
    # a window as wide as the keys keeps every key: the global path
    Sk = k.shape[1]
    _build.check("flash_attention", fn(
        *head, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, S, Sk, H,
        k.shape[2], strides, int(causal), window if window < Sk else 0,
        q_offset, 1.0 / math.sqrt(hd), stream_of(out)))
    also = "launches_windowed" if 0 < window < Sk else (
        "launches_cross" if Sk != S and not causal else None)
    _build.count_launch(flash_attention_gqa, which, also,
                        "launches_lse" if return_lse else None,
                        "launches_offset" if q_offset else None)
    return (out, lse) if return_lse else out


def _meta(q, k, causal, window, return_lse, q_offset):
    """The dry run's B4: empty outputs on the meta device, its operations
    added to ``flash_attention_gqa.meta_flops``; nothing launched."""
    B, S, H, hd = q.shape
    flash_attention_gqa.meta_flops += attention_flops(
        B, S, k.shape[1], H, hd, causal=causal, window=window,
        q_offset=q_offset)
    out = torch.empty_like(q)
    if not return_lse:
        return out
    return out, torch.empty((B, H, S), dtype=torch.float32, device="meta")


flash_attention_gqa.launches = 0
flash_attention_gqa.launches_by_design = dict.fromkeys(DESIGNS, 0)
flash_attention_gqa.launches_windowed = 0   # of them, with a window < S
flash_attention_gqa.launches_cross = 0      # of them, non-causal at Sk != S
flash_attention_gqa.launches_offset = 0     # of them, at a query offset
flash_attention_gqa.launches_lse = 0        # of them, writing the lse
flash_attention_gqa.meta_flops = 0          # the dry run's, on meta tensors


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v [BH, S, hd] -> [BH, S, hd]: ``flash_attention_gqa`` with
    one head a row (its launches count there)."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} must all be [BH, S, hd]")
    return flash_attention_gqa(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                               causal=causal, window=window).squeeze(2)

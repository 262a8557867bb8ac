"""Kernel B4 (flash attention, forward) of the port against the JAX package.

On the CPU the port's wrappers run their plain PyTorch version, so this
holds ``flash_attention_gqa_plain`` (the function the CUDA kernel is held
against on the card, ``tests/test_torch_cuda.py``) against the Pallas
kernel in interpret mode, as ``tests/test_flash_kernel.py`` runs it.
Inputs are made with numpy from a seed and handed to both.

Tolerances: float32 2e-5 (rtol and atol), as ``test_flash_kernel.py``
holds the Pallas kernel to its oracle: the two sum the same products in
other orders and cut the keys into other tiles. bfloat16 3e-2, as there:
outputs are rounded to bf16 (8 bits), so one ulp of a value near 1 is
2^-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention import flash_attention_gqa as ref_gqa
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(2)
F32_TOL = 2e-5
BF16_TOL = 3e-2


def _qkv(seed, q_shape, kv_shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32).astype(dtype)
                 for s in (q_shape, kv_shape, kv_shape))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", [
    # (BH, S, hd, causal, bq, bk): tests/test_flash_kernel.py's cases
    (2, 64, 16, True, 16, 16),
    (1, 128, 32, True, 32, 64),
    (3, 48, 8, False, 16, 16),
    (2, 96, 16, True, 32, 16),
    # S that no tile of the port's (64) divides; hd of qwen2
    (2, 100, 64, True, 256, 512),
    (1, 130, 8, False, 256, 512),
])
def test_plain_matches_pallas_f32(case):
    BH, S, hd, causal, bq, bk = case
    q, k, v = _qkv(sum(case[:3]), (BH, S, hd), (BH, S, hd))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_q=bq, block_kv=bk, interpret=True)
    got = fa.flash_attention(*_torch(q, k, v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (BH, S, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_plain_matches_pallas_bf16():
    import ml_dtypes
    q, k, v = _qkv(1, (2, 64, 16), (2, 64, 16), ml_dtypes.bfloat16)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, block_q=16, block_kv=16, interpret=True)
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)).bfloat16()
                  for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (2, 64, 4, 2, 16, True),        # tests/test_flash_kernel.py's case
    (1, 80, 14, 2, 64, True),       # qwen2's heads, S not a tile multiple
    (2, 40, 6, 3, 32, False),
])
def test_gqa_plain_matches_pallas_gqa(B, S, H, KV, hd, causal):
    q, k, v = _qkv(S + H, (B, S, H, hd), (B, S, KV, hd))
    want = ref_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, interpret=True)
    got = fa.flash_attention_gqa(*_torch(q, k, v), causal=causal)
    assert got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_gqa_reads_strided_views_as_the_model_holds_them():
    """q, k, v sliced out of one packed projection (not contiguous) give
    what their contiguous copies give."""
    B, S, H, KV, hd = 2, 70, 4, 2, 8
    rng = np.random.default_rng(5)
    packed = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * KV, hd)).astype(np.float32))
    q, k, v = packed[:, :, :H], packed[:, :, H:H + KV], packed[:, :, H + KV:]
    assert not q.is_contiguous()
    got = fa.flash_attention_gqa(q, k, v)
    want = fa.flash_attention_gqa(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_plain_takes_the_kernels_tiles_and_roundings():
    """One hand-checkable case: a query row sees exactly the keys at or
    before it, p is rounded to v's dtype before p·v, and a row whose
    keys span two 64-key tiles matches a one-pass softmax."""
    S, hd = fa.BLOCK_K + 3, 8
    q, k, v = _torch(*_qkv(9, (1, S, hd), (1, S, hd)))
    got = fa.flash_attention(q, k, v, causal=True)
    s = (q[0] @ k[0].T) / np.sqrt(hd)
    s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s, fa.NEG_INF)
    want = torch.softmax(s, dim=-1) @ v[0]
    torch.testing.assert_close(got[0], want, rtol=F32_TOL, atol=F32_TOL)
    assert torch.equal(got[0, 0], v[0, 0])          # row 0 sees key 0 only


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = _torch(*_qkv(0, (1, 8, 2, 24), (1, 8, 1, 24)))
    with pytest.raises(ValueError, match="head_dim 24"):
        fa.flash_attention_gqa(q, k, v)
    q, k, v = _torch(*_qkv(0, (1, 8, 3, 16), (1, 8, 2, 16)))
    with pytest.raises(ValueError, match="do not group"):
        fa.flash_attention_gqa(q, k, v)
    q, k, v = _torch(*_qkv(0, (1, 8, 2, 16), (1, 8, 1, 16)))
    with pytest.raises(TypeError):
        fa.flash_attention_gqa(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        fa.flash_attention_gqa(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="BH, S, hd"):
        fa.flash_attention(q[:, :, 0], k[:, :4, 0], v[:, :, 0])


def test_cpu_tensors_do_not_count_as_launches():
    before = fa.flash_attention_gqa.launches
    fa.flash_attention_gqa(*_torch(*_qkv(0, (1, 8, 2, 16), (1, 8, 1, 16))))
    assert fa.flash_attention_gqa.launches == before


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_design_rule_picks_the_instance_by_dtype_and_head_dim(dtype, hd):
    """bf16 at head dims 16 to 256 runs on the tensor cores (wgmma);
    f32 at every head dim, and bf16 at 8 (below wgmma's bf16 K of 16),
    on the CUDA cores (simt)."""
    want = "wgmma" if dtype == torch.bfloat16 and hd >= 16 else "simt"
    assert fa.design(dtype, hd) == want
    assert want in fa.DESIGNS


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tensors_load_the_symbol_of_their_design(monkeypatch, dtype, hd):
    """The wrapper asks the kernel loader for the C function of the
    instance ``design`` names, and for no other."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import _build

    asked = []

    def loader(name, symbol, argtypes):
        asked.append(symbol)
        raise RuntimeError("kernel loader called")

    monkeypatch.setattr(_build, "kernel", loader)
    with FakeTensorMode():
        q = torch.zeros(1, 8, 4, hd, dtype=dtype, device="cuda")
        kv = torch.zeros(1, 8, 2, hd, dtype=dtype, device="cuda")
        with pytest.raises(RuntimeError, match="kernel loader called"):
            fa.flash_attention_gqa(q, kv, kv)
    assert asked == [fa._SYMBOLS[fa.design(dtype, hd)][0]]


@pytest.mark.parametrize("B,S,H,KV,causal", [
    (1, 64, 1, 1, True),            # one whole tile
    (2, 100, 4, 2, True),           # the Qwen3 family's hd, S past a tile
    (1, 70, 8, 1, False),
])
def test_head_dim_128_plain_matches_pallas(B, S, H, KV, causal):
    """hd 128 (qwen3, internlm2, qwen3-moe): the plain version against
    the Pallas kernel in interpret mode, float32 and bfloat16."""
    import ml_dtypes
    q, k, v = _qkv(S + H, (B, S, H, 128), (B, S, KV, 128))
    want = ref_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, interpret=True)
    got = fa.flash_attention_gqa(*_torch(q, k, v), causal=causal)
    assert got.shape == (B, S, H, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    bq, bk, bv = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    want = ref_gqa(jnp.asarray(bq), jnp.asarray(bk), jnp.asarray(bv),
                   causal=causal, interpret=True)
    got = fa.flash_attention_gqa(*(torch.from_numpy(a.astype(np.float32))
                                   .bfloat16() for a in (bq, bk, bv)),
                                 causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("hd", [96, 512])
def test_head_dims_outside_the_kernel_are_refused_naming_the_supported_dims(
        hd):
    """A head dim the kernel has no instance for (ROADMAP C19): a
    ValueError that lists the head dims it takes, never the plain path."""
    q, k, v = _torch(*_qkv(0, (1, 8, 2, hd), (1, 8, 1, hd)))
    with pytest.raises(ValueError, match=rf"head_dim {hd} is not one of "
                                         r"\(8, 16, 32, 64, 128, 256\)"):
        fa.flash_attention_gqa(q, k, v)
    assert 256 in fa.WGMMA_HEAD_DIMS and hd not in fa.HEAD_DIMS


# ---------------------------------------------------------------------------
# head dim 256 (gemma3) and the sliding window
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,KV,causal", [
    (1, 64, 2, 1, True),            # one whole tile
    (2, 100, 8, 4, True),           # gemma3's heads over kv, S past a tile
    (1, 70, 4, 2, False),
])
def test_head_dim_256_plain_matches_pallas(B, S, H, KV, causal):
    """hd 256 (gemma3): the plain version against the Pallas kernel in
    interpret mode, float32 and bfloat16, with GQA."""
    import ml_dtypes
    q, k, v = _qkv(S + H + 256, (B, S, H, 256), (B, S, KV, 256))
    want = ref_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, interpret=True)
    got = fa.flash_attention_gqa(*_torch(q, k, v), causal=causal)
    assert got.shape == (B, S, H, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    bq, bk, bv = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    want = ref_gqa(jnp.asarray(bq), jnp.asarray(bk), jnp.asarray(bv),
                   causal=causal, interpret=True)
    got = fa.flash_attention_gqa(*(torch.from_numpy(a.astype(np.float32))
                                   .bfloat16() for a in (bq, bk, bv)),
                                 causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [48, 150])
@pytest.mark.parametrize("w", ["1", "16", "S-1", "S"])
def test_windowed_plain_matches_blockwise_attention(w, S, causal):
    """The window against the reference's ``models.layers.
    blockwise_attention(..., window=w)`` (its ``_attn_mask``: a key is
    kept iff dq - dk < w, on top of the causal test), f32, with GQA:
    one key, a band inside a tile, and bands as wide as S."""
    from repro.models import layers as RL
    window = {"1": 1, "16": 16, "S-1": S - 1, "S": S}[w]
    q, k, v = _qkv(S + window, (2, S, 4, 16), (2, S, 2, 16))
    want = RL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window)
    got = fa.flash_attention_gqa(*_torch(q, k, v), causal=causal,
                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    if window == 1 and causal:          # each row sees its own key alone
        np.testing.assert_array_equal(got.numpy(),
                                      np.repeat(v, 2, axis=2))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_windowed_plain_at_head_dim_256_matches_blockwise_attention(dtype):
    """gemma3's local layers in small: hd 256, 8 heads over 4, a window
    of 40 over S 130, float32 and bfloat16."""
    import ml_dtypes
    from repro.models import layers as RL
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    q, k, v = _qkv(3, (1, 130, 8, 256), (1, 130, 4, 256), np_dt)
    want = RL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=40)
    got = fa.flash_attention_gqa(*(torch.from_numpy(a.astype(np.float32))
                                   .to(getattr(torch, str(np.dtype(np_dt))))
                                   for a in (q, k, v)), window=40)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_window_starts_the_key_loop_at_the_band():
    """A window as wide as S is global, bit for bit; a narrower one skips
    the key tiles below each query tile's band (the plain version reads
    the tiles the kernel reads): rows that see only keys of their own
    tile give the same output whatever lies in the tiles below."""
    S = 3 * fa.BLOCK_K
    q, k, v = _torch(*_qkv(4, (1, S, 2, 8), (1, S, 1, 8)))
    glob = fa.flash_attention_gqa(q, k, v)
    for window in (S, S + 5):
        assert torch.equal(fa.flash_attention_gqa(q, k, v, window=window),
                           glob)
    assert fa._band_start(2 * fa.BLOCK_K, 1) == 2 * fa.BLOCK_K
    assert fa._band_start(2 * fa.BLOCK_K, fa.BLOCK_K + 1) == fa.BLOCK_K
    assert fa._band_start(fa.BLOCK_K, 0) == 0
    k2, v2 = k.clone(), v.clone()
    k2[:, :fa.BLOCK_K] = float("nan")      # below the last tile's band
    v2[:, :fa.BLOCK_K] = float("nan")
    got = fa.flash_attention_gqa(q, k2, v2, window=fa.BLOCK_K // 2)
    want = fa.flash_attention_gqa(q, k, v, window=fa.BLOCK_K // 2)
    assert torch.equal(got[:, 2 * fa.BLOCK_K:], want[:, 2 * fa.BLOCK_K:])


def test_negative_windows_are_refused():
    q, k, v = _torch(*_qkv(0, (1, 8, 2, 16), (1, 8, 1, 16)))
    with pytest.raises(ValueError, match="window -1"):
        fa.flash_attention_gqa(q, k, v, window=-1)


# ---------------------------------------------------------------------------
# a causal query offset: a rank's block of the query rows (seq_shard_attn)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_query_offset_rows_equal_the_full_calls_rows(dtype, window, lse):
    """Where the offset is a multiple of BLOCK_Q, each block of rows runs
    the full causal call's tiles in the same order: its output (and lse)
    equal those rows bit for bit."""
    S, n = 4 * fa.BLOCK_Q, fa.BLOCK_Q
    q, k, v = _torch(*_qkv(7, (2, S, 4, 16), (2, S, 2, 16)))
    if dtype == "bfloat16":
        q, k, v = (t.bfloat16() for t in (q, k, v))
    full = fa.flash_attention_gqa(q, k, v, window=window, return_lse=True)
    for r in range(S // n):
        a, b = r * n, (r + 1) * n
        got = fa.flash_attention_gqa(q[:, a:b], k[:, :b], v[:, :b],
                                     window=window, q_offset=a,
                                     return_lse=lse)
        out = got[0] if lse else got
        assert torch.equal(out, full[0][:, a:b])
        if lse:
            assert torch.equal(got[1], full[1][..., a:b])


@pytest.mark.parametrize("a,b", [(0, 70), (70, 150), (128, 150)])
def test_query_offset_matches_the_reference_rows(a, b):
    """Rows [a, b) at offset a over keys [0, b), any offset, against the
    same rows of the Pallas kernel's causal call (interpret mode)."""
    S = 150
    q, k, v = _qkv(11, (1, S, 4, 16), (1, S, 2, 16))
    want = np.asarray(ref_gqa(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True, interpret=True))
    tq, tk, tv = _torch(q[:, a:b], k[:, :b], v[:, :b])
    got = fa.flash_attention_gqa(tq, tk, tv, q_offset=a)
    np.testing.assert_allclose(got.numpy(), want[:, a:b], rtol=F32_TOL,
                               atol=F32_TOL)


def test_query_offsets_are_causal_over_the_keys_up_to_the_last_row():
    q, k, v = _torch(*_qkv(0, (1, 8, 2, 16), (1, 24, 1, 16)))
    with pytest.raises(ValueError, match="Sk == q_offset"):
        fa.flash_attention_gqa(q, k, v, q_offset=8)
    with pytest.raises(ValueError, match="causal and not negative"):
        fa.flash_attention_gqa(q, k, v, causal=False, q_offset=16)
    with pytest.raises(ValueError, match="causal and not negative"):
        fa.flash_attention_gqa(q, k[:, :8], v[:, :8], q_offset=-1)
    assert fa.flash_attention_gqa(q, k, v, q_offset=16).shape == q.shape


@pytest.mark.parametrize("causal,window,S,Sk,off", [
    (True, 0, 50, 50, 0), (True, 0, 30, 100, 70), (True, 7, 30, 100, 70),
    (True, 200, 30, 100, 70), (False, 0, 20, 33, 0), (False, 9, 40, 40, 0)])
def test_attention_flops_count_the_pairs_the_mask_keeps(causal, window, S,
                                                        Sk, off):
    d = (off + torch.arange(S))[:, None] - torch.arange(Sk)[None, :]
    keep = d >= 0 if causal else torch.ones_like(d, dtype=torch.bool)
    if window:
        keep &= d < window
    pairs = int(keep.sum())
    assert fa.attention_flops(2, S, Sk, 3, 8, causal=causal, window=window,
                              q_offset=off) == 4 * 2 * 3 * 8 * pairs


def test_meta_tensors_launch_nothing_and_add_their_operations():
    """The dry run's B4: shapes only, no launch, the FLOPs of
    ``attention_flops`` added to ``meta_flops``."""
    b4 = fa.flash_attention_gqa
    launches, flops = b4.launches, b4.meta_flops
    q = torch.empty(2, 64, 4, 16, device="meta")
    kv = torch.empty(2, 192, 2, 16, device="meta")
    out, lse = b4(q, kv, kv, q_offset=128, return_lse=True)
    assert out.device.type == lse.device.type == "meta"
    assert out.shape == q.shape and lse.shape == (2, 4, 64)
    assert b4.launches == launches
    assert b4.meta_flops - flops == fa.attention_flops(2, 64, 192, 4, 16,
                                                       q_offset=128)
    with pytest.raises(ValueError, match="one CUDA device or all"):
        b4(q, torch.empty(kv.shape), kv, q_offset=128)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 256),
                                      (torch.float32, 64),
                                      (torch.bfloat16, 8)])
def test_query_offset_on_the_card(dtype, hd, window, lse):
    """Both instances (wgmma: bf16 at hd 16-256; simt: f32, and bf16 at
    hd 8) at each rank's rows of a causal call, with and without the
    lse and the window: each rank's rows equal the full call's bit for
    bit, and the plain version's within 2e-5 (f32) or 3e-2 (bf16);
    every offset launch counted."""
    dev = _card()
    S, ranks = 512, 4
    q, k, v = (t.to(dev, dtype) for t in _torch(
        *_qkv(3, (2, S, 4, hd), (2, S, 2, hd))))
    full = fa.flash_attention_gqa(q, k, v, window=window, return_lse=True)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    n = S // ranks
    for r in range(ranks):
        a, b = r * n, (r + 1) * n
        before = fa.flash_attention_gqa.launches_offset
        got = fa.flash_attention_gqa(q[:, a:b], k[:, :b], v[:, :b],
                                     window=window, q_offset=a,
                                     return_lse=lse)
        want = fa.flash_attention_gqa_plain(q[:, a:b], k[:, :b], v[:, :b],
                                            window=window, q_offset=a,
                                            return_lse=True)
        torch.cuda.synchronize()
        assert fa.flash_attention_gqa.launches_offset == before + (a > 0)
        out = got[0] if lse else got
        assert torch.equal(out, full[0][:, a:b])
        torch.testing.assert_close(out.float(), want[0].float(), rtol=tol,
                                   atol=tol)
        if lse:
            assert torch.equal(got[1], full[1][..., a:b])
            torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)

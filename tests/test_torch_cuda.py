"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Run there with `pytest -m cuda tests/test_torch_cuda.py`; without a
card each test skips (decided inside the test, never at import).

Tolerances: the writers move bytes and must match exactly. Attention in
fp32 differs from the plain version only in summation order (atol = rtol =
1e-5 is loose enough at these sizes: outputs are O(1) averages); bf16 uses
2e-2, the bound of tests/test_attention_pallas.py:83-85 (one bf16 ulp of an
O(1) output is 2^-8 to 2^-7, and probabilities round to bf16 before PV).
"""

import numpy as np
import pytest
import torch

from hip_llama_tpu_torch.models.llama import KVCache
from hip_llama_tpu_torch.ops import attention as A
from hip_llama_tpu_torch.ops import cache as C

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (B, H, KVH, S, HS): the golden fixture's GQA head shape, a mid size, and
# Llama-2-7B's head shape
SHAPES = [(4, 8, 4, 96, 8), (3, 8, 2, 200, 64), (8, 32, 32, 512, 128)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_decode_kernel(shape, dtype):
    dev = _card()
    b, h, kvh, s, hs = shape
    rng = np.random.default_rng(0)
    n_layers = 2
    q = _rand(rng, (b, h, hs), dtype, dev)
    k = _rand(rng, (b, n_layers, kvh, s, hs), dtype, dev)
    v = _rand(rng, (b, n_layers, kvh, s, hs), dtype, dev)
    kc = _rand(rng, (b, kvh, hs), dtype, dev)
    vc = _rand(rng, (b, kvh, hs), dtype, dev)
    pos = torch.tensor(np.r_[0, s - 1, rng.integers(0, s, b - 2)], dtype=torch.int32, device=dev)
    got = A.attention_decode(q, k, v, 1, pos, kc, vc)
    want = A.attention_decode_plain(q, k, v, 1, pos, kc, vc)
    torch.cuda.synchronize()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_prefill_kernel(shape, dtype):
    dev = _card()
    b, h, kvh, s, hs = shape
    t = 64 if s < 512 else 256
    rng = np.random.default_rng(1)
    q = _rand(rng, (b, t, h, hs), dtype, dev)
    k = _rand(rng, (b, 2, kvh, s, hs), dtype, dev)
    v = _rand(rng, (b, 2, kvh, s, hs), dtype, dev)
    start = np.r_[0, s - t // 2, rng.integers(0, s - t, b - 2)]
    valid = np.r_[t, t // 2, 0, rng.integers(1, t + 1, b - 3)]
    start_t = torch.tensor(start, dtype=torch.int32, device=dev)
    valid_t = torch.tensor(valid, dtype=torch.int32, device=dev)
    got = A.attention_prefill(q, k, v, 0, start_t, valid_t)
    want = A.attention_prefill_plain(q, k, v, 0, start_t, valid_t)
    torch.cuda.synchronize()
    live = torch.arange(t, device=dev)[None, :] < valid_t[:, None]
    _close(got[live], want[live], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kv_writers_kernel(shape, dtype):
    dev = _card()
    b, _, kvh, s, hs = shape
    n_layers, t = 3, 16
    rng = np.random.default_rng(2)
    base = KVCache(_rand(rng, (b, n_layers, kvh, s, hs), dtype, dev),
                   _rand(rng, (b, n_layers, kvh, s, hs), dtype, dev))
    pos = torch.tensor(np.r_[0, s - 1, rng.integers(0, s, b - 2)], dtype=torch.int32, device=dev)
    valid = torch.tensor(np.r_[1, 0, np.ones(b - 2)], dtype=torch.int32, device=dev)
    kr = _rand(rng, (n_layers, b, kvh, hs), dtype, dev)
    vr = _rand(rng, (n_layers, b, kvh, hs), dtype, dev)
    for vl in (None, valid):
        got = C.kv_commit_rows(KVCache(base.k.clone(), base.v.clone()), kr, vr, pos, vl)
        want = C.kv_commit_rows_plain(KVCache(base.k.clone(), base.v.clone()), kr, vr, pos, vl)
        torch.cuda.synchronize()
        assert torch.equal(got.k, want.k) and torch.equal(got.v, want.v)

    start = torch.tensor(np.r_[s - t // 2, 0, rng.integers(0, s - t, b - 2)],
                         dtype=torch.int32, device=dev)
    cvalid = torch.tensor(np.r_[t, 0, rng.integers(1, t + 1, b - 2)], dtype=torch.int32, device=dev)
    ck = _rand(rng, (b, t, kvh, hs), dtype, dev)
    cv = _rand(rng, (b, t, kvh, hs), dtype, dev)
    got = C.kv_write_chunk(KVCache(base.k.clone(), base.v.clone()), ck, cv, 2, start, cvalid)
    want = C.kv_write_chunk_plain(KVCache(base.k.clone(), base.v.clone()), ck, cv, 2, start, cvalid)
    torch.cuda.synchronize()
    assert torch.equal(got.k, want.k) and torch.equal(got.v, want.v)


def test_wrappers_count_launches_and_reject_bad_operands():
    dev = _card()
    b, h, kvh, s, hs = SHAPES[0]
    rng = np.random.default_rng(3)
    k = _rand(rng, (b, 1, kvh, s, hs), torch.float32, dev)
    q = _rand(rng, (b, h, hs), torch.float32, dev)
    cur = _rand(rng, (b, kvh, hs), torch.float32, dev)
    pos = torch.zeros(b, dtype=torch.int32, device=dev)
    n0 = A.attention_decode.launches
    A.attention_decode(q, k, k, 0, pos, cur, cur)
    assert A.attention_decode.launches == n0 + 1
    with pytest.raises(TypeError):
        A.attention_decode(q, k, k, 0, pos.long(), cur, cur)
    with pytest.raises(ValueError):
        A.attention_decode(q[:, :, :4].contiguous(), k, k, 0, pos, cur, cur)
    assert A.attention_decode.launches == n0 + 1


# ---------------------------------------------------------------------------
# the Q8 slice: K15, K17, K18 against their plain versions, and K5

from hip_llama_tpu_torch.ops import quant as Q  # noqa: E402

# (K, N or H, gs): the golden fixture's widths, a tile-ragged width, and
# Llama-2-7B's QKV / FFN widths
Q8_SHAPES = [(64, 128, 64), (192, 208, 32), (4096, 12288, 64)]
Q8_FFN_SHAPES = [(64, 192, 64), (128, 256, 32), (4096, 11008, 64)]


def _qt(rng, k, n, gs, dev):
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    return Q.q8_quantize_weights(torch.from_numpy(w).to(dev), gs)


@pytest.mark.parametrize("m", [1, 8, 16, 40, 300])
@pytest.mark.parametrize("shape", Q8_SHAPES)
@pytest.mark.parametrize("epi", ["none", "norm", "residual", "norm_rope"])
def test_q8_matmul_kernel(m, shape, epi):
    dev = _card()
    k, n, gs = shape
    rng = np.random.default_rng(4)
    qt = _qt(rng, k, n, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = {}
    if epi in ("norm", "norm_rope"):
        kw["norm_weight"] = (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()
    if epi == "residual":
        kw["residual"] = _rand(rng, (m, n), torch.bfloat16, dev)
    if epi == "norm_rope":
        hs = 8 if n < 1024 else 128
        kw.update(rope_pos=torch.tensor(rng.integers(0, 2048, m), dtype=torch.int32, device=dev),
                  rope_limit=(2 * n // 3) // hs * hs, rope_head=hs, rope_theta=10000.0)
    n0 = Q.q8_matmul.launches
    got = Q.q8_matmul(x, qt, **kw)
    want = Q.q8_matmul_plain(x, qt, **kw)
    torch.cuda.synchronize()
    assert Q.q8_matmul.launches == n0 + 1 and got.shape == (m, n)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("m", [4, 16, 40, 512])
@pytest.mark.parametrize("shape", Q8_FFN_SHAPES)
def test_q8_matmul_silu_kernel(m, shape):
    dev = _card()
    k, h, gs = shape
    rng = np.random.default_rng(5)
    qt13 = _qt(rng, k, 2 * h, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    g = (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()
    got = Q.q8_matmul_silu(x, qt13, norm_weight=g)
    want = Q.q8_matmul_silu_plain(x, qt13, norm_weight=g)
    torch.cuda.synchronize()
    assert got.shape == (m, h)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("m", [1, 8, 16, 40, 128])
@pytest.mark.parametrize("shape", Q8_FFN_SHAPES)
def test_q8_matmul_ffn_kernel(m, shape):
    dev = _card()
    k, h, gs = shape
    rng = np.random.default_rng(6)
    qt13, qt2 = _qt(rng, k, 2 * h, gs, dev), _qt(rng, h, k, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    g = (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()
    got = Q.q8_matmul_ffn(x, qt13, qt2, x, g)
    want = Q.q8_matmul_ffn_plain(x, qt13, qt2, x, g)
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_decode_fused_kernel(shape, dtype):
    dev = _card()
    b, h, kvh, s, hs = shape
    rng = np.random.default_rng(7)
    qkv = _rand(rng, (b, h + 2 * kvh, hs), dtype, dev)
    k = _rand(rng, (b, 2, kvh, s, hs), dtype, dev)
    v = _rand(rng, (b, 2, kvh, s, hs), dtype, dev)
    pos = torch.tensor(np.r_[0, s - 1, rng.integers(0, s, b - 2)], dtype=torch.int32, device=dev)
    got = A.attention_decode_fused(qkv, k, v, 1, pos, h)
    want = A.attention_decode_fused_plain(qkv, k, v, 1, pos, h)
    torch.cuda.synchronize()
    _close(got, want, dtype)
    # the same numbers as K1 on the sliced operands
    sliced = A.attention_decode(qkv[:, :h].contiguous(), k, v, 1, pos,
                                qkv[:, h:h + kvh].contiguous(), qkv[:, h + kvh:].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, sliced)


# ---------------------------------------------------------------------------
# K23: the whole Q8 decode layer in one kernel

from hip_llama_tpu_torch.ops import layer_fused as LF  # noqa: E402

# (H, KVH, HS, hidden, S, gs): the golden fixture's layer, a GQA layer with
# a hidden width that is no multiple of 64, and Llama-2-7B's layer
LAYER_SHAPES = [(8, 4, 8, 192, 96, 64), (4, 2, 64, 352, 200, 32), (32, 32, 128, 11008, 512, 64)]


@pytest.mark.parametrize("b", [1, 4, 8, 20])
@pytest.mark.parametrize("shape", LAYER_SHAPES)
def test_q8_layer_fused_kernel(b, shape):
    dev = _card()
    h, kvh, hs, hid, s, gs = shape
    d = h * hs
    rng = np.random.default_rng(8)
    wqkv, wo = _qt(rng, d, (h + 2 * kvh) * hs, gs, dev), _qt(rng, d, d, gs, dev)
    w13, w2 = _qt(rng, d, 2 * hid, gs, dev), _qt(rng, hid, d, gs, dev)
    g1, g2 = ((1 + 0.1 * _rand(rng, (d,), torch.float32, dev)).contiguous() for _ in range(2))
    x = _rand(rng, (b, d), torch.bfloat16, dev)
    k = _rand(rng, (b, 2, kvh, s, hs), torch.bfloat16, dev)
    v = _rand(rng, (b, 2, kvh, s, hs), torch.bfloat16, dev)
    pos = torch.tensor(np.r_[0, s - 1, rng.integers(0, s, b)][:b], dtype=torch.int32, device=dev)
    ops = (x, wqkv, wo, w13, w2, g1, g2, k, v, 1, pos)
    n0 = LF.q8_layer_fused.launches
    got, kv = LF.q8_layer_fused(*ops, n_heads=h)
    want, kv_want = LF.q8_layer_fused_plain(*ops, n_heads=h)
    torch.cuda.synchronize()
    assert LF.q8_layer_fused.launches == n0 + 1
    _close(got, want, torch.bfloat16)
    _close(kv, kv_want, torch.bfloat16)
    # the four kernels in a row round alike (their GEMV route: B <= 16)
    qkv = Q.q8_matmul(x, wqkv, norm_weight=g1, rope_pos=pos, rope_limit=(h + kvh) * hs,
                      rope_head=hs).view(b, h + 2 * kvh, hs)
    att = A.attention_decode_fused(qkv, k, v, 1, pos, h)
    x2 = Q.q8_matmul(att.reshape(b, d), wo, residual=x)
    four = Q.q8_matmul_ffn(x2, w13, w2, x2, g2)
    torch.cuda.synchronize()
    if b <= Q.GEMV_MAX_M:
        assert torch.equal(got, four) and torch.equal(kv, qkv[:, h:])
    else:
        _close(got, four, torch.bfloat16)


# ---------------------------------------------------------------------------
# the int8 KV cache: the int8 branches of K1-K5 and K23, and K12

# int8-cache attention vs plain: exact int8 dots on both sides at the same
# blocks; an ulp of expf can move one quantized probability by one int8
# step, so the fp32 outputs agree to about 1e-3 and bf16 to an ulp or two
INT8_TOL = {torch.float32: 4e-3, torch.bfloat16: 2e-2}


def _int8_cache(rng, b, n_layers, kvh, s, hs, dev):
    planes = [C.quantize_kv_rows(_rand(rng, (b, n_layers, kvh, s, hs), torch.float32, dev))
              for _ in range(2)]
    return KVCache(planes[0][0], planes[1][0], planes[0][1], planes[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_decode_int8_kernels(shape, dtype):
    dev = _card()
    b, h, kvh, s, hs = shape
    rng = np.random.default_rng(9)
    cache = _int8_cache(rng, b, 2, kvh, s, hs, dev)
    sc = (cache.k_scale, cache.v_scale)
    qkv = _rand(rng, (b, h + 2 * kvh, hs), dtype, dev)
    q, kc, vc = (x.contiguous() for x in (qkv[:, :h], qkv[:, h:h + kvh], qkv[:, h + kvh:]))
    pos = torch.tensor(np.r_[0, s - 1, rng.integers(0, s, b - 2)], dtype=torch.int32, device=dev)
    n0, n1 = A.attention_decode.launches_int8, A.attention_decode_fused.launches_int8
    got = A.attention_decode(q, cache.k, cache.v, 1, pos, kc, vc, *sc)
    want = A.attention_decode_plain(q, cache.k, cache.v, 1, pos, kc, vc, *sc)
    fused = A.attention_decode_fused(qkv, cache.k, cache.v, 1, pos, h, *sc)
    torch.cuda.synchronize()
    assert A.attention_decode.launches_int8 == n0 + 1
    assert A.attention_decode_fused.launches_int8 == n1 + 1
    tol = INT8_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(fused, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_prefill_int8_kernel(shape, dtype):
    dev = _card()
    b, h, kvh, s, hs = shape
    t = 64 if s < 512 else 256
    rng = np.random.default_rng(10)
    cache = _int8_cache(rng, b, 2, kvh, s, hs, dev)
    q = _rand(rng, (b, t, h, hs), dtype, dev)
    start = np.r_[0, s - t // 2, rng.integers(0, s - t, b - 2)]
    valid = np.r_[t, t // 2, 0, rng.integers(1, t + 1, b - 3)]
    start_t = torch.tensor(start, dtype=torch.int32, device=dev)
    valid_t = torch.tensor(valid, dtype=torch.int32, device=dev)
    got = A.attention_prefill(q, cache.k, cache.v, 0, start_t, valid_t, cache.k_scale,
                              cache.v_scale)
    want = A.attention_prefill_plain(q, cache.k, cache.v, 0, start_t, valid_t, cache.k_scale,
                                     cache.v_scale)
    torch.cuda.synchronize()
    live = torch.arange(t, device=dev)[None, :] < valid_t[:, None]
    # the probabilities round to bf16 before PV whatever q's dtype
    _close(got[live], want[live], torch.bfloat16)


@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kv_writers_int8_kernels(shape, rows_dtype):
    dev = _card()
    b, _, kvh, s, hs = shape
    n_layers, t = 3, 16
    rng = np.random.default_rng(11)
    base = _int8_cache(rng, b, n_layers, kvh, s, hs, dev)

    def copy():
        return KVCache(base.k.clone(), base.v.clone(), base.k_scale.clone(), base.v_scale.clone())

    def same(x, y):
        return all(torch.equal(getattr(x, f), getattr(y, f)) for f in ("k", "v", "k_scale", "v_scale"))

    pos = torch.tensor(np.r_[0, s - 1, rng.integers(0, s, b - 2)], dtype=torch.int32, device=dev)
    valid = torch.tensor(np.r_[1, 0, np.ones(b - 2)], dtype=torch.int32, device=dev)
    kr = _rand(rng, (n_layers, b, kvh, hs), rows_dtype, dev)
    vr = _rand(rng, (n_layers, b, kvh, hs), rows_dtype, dev)
    kr[0, 0, 0] = 0  # a zero row: scale 1
    for vl in (None, valid):
        n0 = C.kv_commit_rows.launches_int8
        got = C.kv_commit_rows(copy(), kr, vr, pos, vl)
        want = C.kv_commit_rows_plain(copy(), kr, vr, pos, vl)
        torch.cuda.synchronize()
        assert C.kv_commit_rows.launches_int8 == n0 + 1 and same(got, want)

    start = torch.tensor(np.r_[s - t // 2, 0, rng.integers(0, s - t, b - 2)],
                         dtype=torch.int32, device=dev)
    cvalid = torch.tensor(np.r_[t, 0, rng.integers(1, t + 1, b - 2)], dtype=torch.int32, device=dev)
    (ck, cks), (cv, cvs) = (C.quantize_kv_rows(_rand(rng, (b, t, kvh, hs), rows_dtype, dev))
                            for _ in range(2))
    n0, n1 = C.kv_write_chunk.launches_int8, C.scale_write_chunk.launches
    got = C.scale_write_chunk(C.kv_write_chunk(copy(), ck, cv, 2, start, cvalid), cks, cvs, 2,
                              start, cvalid)
    want = C.scale_write_chunk_plain(C.kv_write_chunk_plain(copy(), ck, cv, 2, start, cvalid),
                                     cks, cvs, 2, start, cvalid)
    torch.cuda.synchronize()
    assert C.kv_write_chunk.launches_int8 == n0 + 1 and C.scale_write_chunk.launches == n1 + 1
    assert same(got, want)


@pytest.mark.parametrize("b", [1, 4, 8, 20])
@pytest.mark.parametrize("shape", LAYER_SHAPES)
def test_q8_layer_fused_int8_kernel(b, shape):
    dev = _card()
    h, kvh, hs, hid, s, gs = shape
    d = h * hs
    rng = np.random.default_rng(12)
    wqkv, wo = _qt(rng, d, (h + 2 * kvh) * hs, gs, dev), _qt(rng, d, d, gs, dev)
    w13, w2 = _qt(rng, d, 2 * hid, gs, dev), _qt(rng, hid, d, gs, dev)
    g1, g2 = ((1 + 0.1 * _rand(rng, (d,), torch.float32, dev)).contiguous() for _ in range(2))
    x = _rand(rng, (b, d), torch.bfloat16, dev)
    cache = _int8_cache(rng, b, 2, kvh, s, hs, dev)
    sc = (cache.k_scale, cache.v_scale)
    pos = torch.tensor(np.r_[0, s - 1, rng.integers(0, s, b)][:b], dtype=torch.int32, device=dev)
    ops = (x, wqkv, wo, w13, w2, g1, g2, cache.k, cache.v, 1, pos, *sc)
    n0 = LF.q8_layer_fused.launches_int8
    got, kv = LF.q8_layer_fused(*ops, n_heads=h)
    want, kv_want = LF.q8_layer_fused_plain(*ops, n_heads=h)
    torch.cuda.synchronize()
    assert LF.q8_layer_fused.launches_int8 == n0 + 1
    _close(got, want, torch.bfloat16)
    _close(kv, kv_want, torch.bfloat16)
    # the four int8-cache kernels in a row round alike (their GEMV route)
    qkv = Q.q8_matmul(x, wqkv, norm_weight=g1, rope_pos=pos, rope_limit=(h + kvh) * hs,
                      rope_head=hs).view(b, h + 2 * kvh, hs)
    att = A.attention_decode_fused(qkv, cache.k, cache.v, 1, pos, h, *sc)
    x2 = Q.q8_matmul(att.reshape(b, d), wo, residual=x)
    four = Q.q8_matmul_ffn(x2, w13, w2, x2, g2)
    torch.cuda.synchronize()
    if b <= Q.GEMV_MAX_M:
        assert torch.equal(got, four) and torch.equal(kv, qkv[:, h:])
    else:
        _close(got, four, torch.bfloat16)

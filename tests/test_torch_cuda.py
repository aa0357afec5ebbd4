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
    n0, w0 = Q.q8_matmul.launches, Q.q8_matmul.launches_wgmma
    got = Q.q8_matmul(x, qt, **kw)
    want = Q.q8_matmul_plain(x, qt, **kw)
    torch.cuda.synchronize()
    assert Q.q8_matmul.launches == n0 + 1 and got.shape == (m, n)
    assert Q.q8_matmul.launches_wgmma == w0 + (Q.q8_rows_kernel(m) == "wgmma")
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
    n0, w0 = Q.q8_matmul_silu.launches, Q.q8_matmul_silu.launches_wgmma
    got = Q.q8_matmul_silu(x, qt13, norm_weight=g)
    want = Q.q8_matmul_silu_plain(x, qt13, norm_weight=g)
    torch.cuda.synchronize()
    assert got.shape == (m, h) and Q.q8_matmul_silu.launches == n0 + 1
    assert Q.q8_matmul_silu.launches_wgmma == w0 + (Q.q8_rows_kernel(m) == "wgmma")
    _close(got, want, torch.bfloat16)


# the tiles on q8_wgmma.cuh's mainloop, rows on both sides of the row rule
# (16: the GEMV; 17 up: the tiles): (K, N, gs) with K 288 and 192 (a last
# step past K % 64, zero-filled), N 208 and 480 (a ragged column tile, 480
# the stories15M QKV of 6 + 2 + 2 heads of 48) and groups of 16, 32 and 64;
# the gate at H 208 and 768 (ragged 64-column halves) and 11008
TILE_ROWS = [16, 17, 40, 128, 300, 2048, 4088]
TILE_SHAPES = [(64, 128, 64), (192, 208, 32), (288, 480, 32), (288, 480, 16),
               (4096, 12288, 64), (4096, 4096, 64)]
TILE_GATE_SHAPES = [(64, 192, 64), (192, 208, 16), (288, 768, 32), (4096, 11008, 64)]


@pytest.mark.parametrize("m", TILE_ROWS)
@pytest.mark.parametrize("shape", TILE_SHAPES)
@pytest.mark.parametrize("epi", ["none", "norm", "residual", "norm_rope"])
def test_q8_matmul_wgmma_tiles(m, shape, epi):
    dev = _card()
    k, n, gs = shape
    rng = np.random.default_rng(7)
    qt = _qt(rng, k, n, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = {}
    if epi in ("norm", "norm_rope"):
        kw["norm_weight"] = (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()
    if epi == "residual":
        kw["residual"] = _rand(rng, (m, n), torch.bfloat16, dev)
    if epi == "norm_rope":  # q and k rotate in heads of 48 (K 288) or 8 / 128
        hs = 48 if k == 288 else 8 if n < 1024 else 128
        kw.update(rope_pos=torch.tensor(rng.integers(0, 2048, m), dtype=torch.int32, device=dev),
                  rope_limit=(2 * n // 3) // hs * hs, rope_head=hs, rope_theta=10000.0)
    n0, w0 = Q.q8_matmul.launches, Q.q8_matmul.launches_wgmma
    got = Q.q8_matmul(x, qt, **kw)
    want = Q.q8_matmul_plain(x, qt, **kw)
    torch.cuda.synchronize()
    wgmma = Q.q8_rows_kernel(m) == "wgmma"
    assert wgmma == (m > 16)
    assert (Q.q8_matmul.launches - n0, Q.q8_matmul.launches_wgmma - w0) == (1, int(wgmma))
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("m", TILE_ROWS)
@pytest.mark.parametrize("shape", TILE_GATE_SHAPES)
@pytest.mark.parametrize("norm", [False, True])
def test_q8_matmul_silu_wgmma_tiles(m, shape, norm):
    dev = _card()
    k, h, gs = shape
    rng = np.random.default_rng(8)
    qt13 = _qt(rng, k, 2 * h, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    g = (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous() if norm else None
    n0, w0 = Q.q8_matmul_silu.launches, Q.q8_matmul_silu.launches_wgmma
    got = Q.q8_matmul_silu(x, qt13, norm_weight=g)
    want = Q.q8_matmul_silu_plain(x, qt13, norm_weight=g)
    torch.cuda.synchronize()
    wgmma = Q.q8_rows_kernel(m) == "wgmma"
    assert (Q.q8_matmul_silu.launches - n0, Q.q8_matmul_silu.launches_wgmma - w0) == (
        1, int(wgmma))
    assert got.shape == (m, h)
    _close(got, want, torch.bfloat16)


def test_wgmma_mainloop_probe_runs_both_schedules():
    """The products-only mainloop (chip_smoke's `mainloop` line): both
    schedules launch, count and give finite sums (the same products, the
    same order: equal)."""
    dev = _card()
    n0 = Q.wgmma_mainloop_probe.launches
    a, b = (Q.wgmma_mainloop_probe(4, 8, f, dev) for f in (0, 1))
    torch.cuda.synchronize()
    assert Q.wgmma_mainloop_probe.launches == n0 + 2
    assert bool(torch.isfinite(a).all()) and torch.equal(a, b)


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


# the decode GEMV on the tensor cores (csrc/q8.cuh::gemv_tasks) at every
# row count of its route, 1-16: (K, N) of the golden fixture's QKV, wo and
# W2, stories15M's QKV (6 + 2 + 2 heads of 48: N 480, a ragged 128-column
# strip), wo and W2, and Llama-2-7B's QKV and W2, at group sizes 16, 32, 64
# (a 16-row step in one group: the ring brings its scale row) and 8 and 48
# where they divide K (8: a step over two groups, the scales read a row at
# a time from global memory)
GEMV_SHAPES = [(64, 128), (64, 64), (192, 64), (288, 480), (288, 288), (768, 288),
               (4096, 12288), (11008, 4096)]
GEMV_CASES = [(k, n, gs) for k, n in GEMV_SHAPES for gs in (8, 16, 32, 48, 64) if k % gs == 0
              and (gs in (16, 32, 64) or k <= 768)]


@pytest.mark.parametrize("k,n,gs", GEMV_CASES)
@pytest.mark.parametrize("epi", ["none", "residual"])
def test_q8_gemv_tensor_cores_at_every_decode_row(k, n, gs, epi):
    dev = _card()
    rng = np.random.default_rng(k + n + gs)
    qt = _qt(rng, k, n, gs, dev)
    for m in range(1, Q.GEMV_MAX_M + 1):
        x = _rand(rng, (m, k), torch.bfloat16, dev)
        kw = {"residual": _rand(rng, (m, n), torch.bfloat16, dev)} if epi == "residual" else {}
        n0, w0 = Q.q8_matmul.launches, Q.q8_matmul.launches_wgmma
        got = Q.q8_matmul(x, qt, **kw)
        want = Q.q8_matmul_plain(x, qt, **kw)
        torch.cuda.synchronize()
        assert (Q.q8_matmul.launches, Q.q8_matmul.launches_wgmma) == (n0 + 1, w0), m
        _close(got, want, torch.bfloat16)
        assert torch.equal(got, Q.q8_matmul(x, qt, **kw)), m  # the same bits every run


# K18 up to 16 rows (the GEMV twice, with the gate and residual passes) at
# the three models' FFN widths (K, H) and group sizes 16, 32, 64
FFN_GEMV_CASES = [(k, h, gs) for k, h in [(64, 192), (288, 768), (4096, 11008)]
                  for gs in (16, 32, 64) if k % gs == 0 and h % gs == 0]


@pytest.mark.parametrize("k,h,gs", FFN_GEMV_CASES)
def test_q8_matmul_ffn_gemv_at_every_decode_row(k, h, gs):
    dev = _card()
    rng = np.random.default_rng(k + h + gs)
    qt13, qt2 = _qt(rng, k, 2 * h, gs, dev), _qt(rng, h, k, gs, dev)
    g = (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()
    for m in range(1, Q.GEMV_MAX_M + 1):
        x = _rand(rng, (m, k), torch.bfloat16, dev)
        n0, t0 = Q.q8_matmul_ffn.launches, Q.q8_matmul_ffn.launches_tc
        got = Q.q8_matmul_ffn(x, qt13, qt2, x, g)
        want = Q.q8_matmul_ffn_plain(x, qt13, qt2, x, g)
        torch.cuda.synchronize()
        assert (Q.q8_matmul_ffn.launches, Q.q8_matmul_ffn.launches_tc) == (n0 + 1, t0), m
        _close(got, want, torch.bfloat16)
        # the gate product and W2 with the residual, the same GEMV in a row
        two = Q.q8_matmul(Q.q8_matmul_silu(x, qt13, norm_weight=g), qt2, residual=x)
        torch.cuda.synchronize()
        assert torch.equal(got, two), m


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


# ---------------------------------------------------------------------------
# the int4 slice: K21 and K22 against their plain versions

from hip_llama_tpu_torch.ops import quant4 as Q4  # noqa: E402

# (K, N or H, gs): the golden fixture's QKV, W2 (K/2 = 96) and classifier
# widths, a tile-ragged width with K/2 = 48 (group size 16), and
# Llama-2-7B's QKV and W2 (K/2 = 5504, no multiple of 256); stories15M's
# QKV (6 + 2 + 2 heads of 48, K/2 = 144) at groups of 16, of 12 (no multiple
# of 8: the tiles read those scales a row at a time) and of 8 (4 + 4 scale
# rows a step); K 96 and 288 leave the tiles' last 32-row step half dead
# in each nibble half. The gate: the fixture's, a ragged H 208, stories15M's
# H 768 at groups of 16 and 8, H 128 over K 96 at groups of 12, and 7B's.
Q4_SHAPES = [(64, 128, 32), (192, 64, 32), (64, 512, 32), (96, 208, 16), (4096, 12288, 32),
             (11008, 4096, 32), (288, 480, 16), (288, 480, 12), (288, 480, 8)]
Q4_SILU_SHAPES = [(64, 192, 32), (96, 208, 16), (4096, 11008, 32), (288, 768, 16),
                  (288, 768, 8), (96, 128, 12)]
# rows on both sides of the row rule (16: the GEMV; 17 up: the tiles), and
# around the tiles' 256 rows
Q4_ROWS = [1, 8, 16, 17, 40, 128, 255, 256, 257, 300, 2048, 4088]


def _q4t(rng, k, n, gs, dev):
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    return Q4.q4_quantize_weights(torch.from_numpy(w).to(dev), gs)


@pytest.mark.parametrize("m", Q4_ROWS)
@pytest.mark.parametrize("shape", Q4_SHAPES)
@pytest.mark.parametrize("epi", ["none", "norm", "residual", "norm_rope"])
def test_q4_matmul_kernel(m, shape, epi):
    dev = _card()
    k, n, gs = shape
    rng = np.random.default_rng(13)
    qt = _q4t(rng, k, n, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = {}
    if epi in ("norm", "norm_rope"):
        kw["norm_weight"] = (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()
    if epi == "residual":
        kw["residual"] = _rand(rng, (m, n), torch.bfloat16, dev)
    if epi == "norm_rope":  # q and k rotate in heads of 48 (K 288) or 8 / 128
        hs = 48 if k == 288 else 8 if n < 1024 else 128
        kw.update(rope_pos=torch.tensor(rng.integers(0, 2048, m), dtype=torch.int32, device=dev),
                  rope_limit=(2 * n // 3) // hs * hs, rope_head=hs, rope_theta=10000.0)
    n0, w0 = Q4.q4_matmul.launches, Q4.q4_matmul.launches_wgmma
    got = Q4.q4_matmul(x, qt, **kw)
    want = Q4.q4_matmul_plain(x, qt, **kw)
    torch.cuda.synchronize()
    wgmma = Q4.q4_rows_kernel(m) == "wgmma"
    assert wgmma == (m > 16)
    assert (Q4.q4_matmul.launches - n0, Q4.q4_matmul.launches_wgmma - w0) == (1, int(wgmma))
    assert got.shape == (m, n)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("m", sorted([4, 512] + Q4_ROWS[2:]))
@pytest.mark.parametrize("shape", Q4_SILU_SHAPES)
@pytest.mark.parametrize("norm", [True, False])
def test_q4_matmul_silu_kernel(m, shape, norm):
    dev = _card()
    k, h, gs = shape
    rng = np.random.default_rng(14)
    qt13 = _q4t(rng, k, 2 * h, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = {}
    if norm:
        kw["norm_weight"] = (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()
    n0, w0 = Q4.q4_matmul_silu.launches, Q4.q4_matmul_silu.launches_wgmma
    got = Q4.q4_matmul_silu(x, qt13, **kw)
    want = Q4.q4_matmul_silu_plain(x, qt13, **kw)
    torch.cuda.synchronize()
    wgmma = Q4.q4_rows_kernel(m) == "wgmma"
    assert (Q4.q4_matmul_silu.launches - n0, Q4.q4_matmul_silu.launches_wgmma - w0) == (
        1, int(wgmma))
    assert got.shape == (m, h)
    _close(got, want, torch.bfloat16)


def test_q4_wrappers_reject_bad_operands():
    dev = _card()
    rng = np.random.default_rng(15)
    qt = _q4t(rng, 64, 128, 32, dev)
    x = _rand(rng, (4, 64), torch.bfloat16, dev)
    n0 = Q4.q4_matmul.launches
    with pytest.raises(TypeError):
        Q4.q4_matmul(x.float(), qt)
    with pytest.raises(ValueError):  # K that the packed weight does not have
        Q4.q4_matmul(_rand(rng, (4, 96), torch.bfloat16, dev), qt)
    with pytest.raises(ValueError):  # a strided q
        Q4.q4_matmul(x, Q4.Q4Tensor(q=qt.q.t().contiguous().t(), s=qt.s))
    assert Q4.q4_matmul.launches == n0


# the int4 GEMV on the tensor cores (q8.cuh::gemv_tasks with the int4
# format: 8 packed rows a step, the low nibbles against x[:, k'..] and the
# high ones against x[:, K/2 + k'..]) at every row count of its route, 1-16,
# at the int4 shapes above: groups of 32, 16 and 8 (a step in one group of
# each plane: the ring brings both scale rows) and 12 (a step over two
# groups: the scales read a row at a time), ragged strips (N 208, 480)
Q4_GEMV_CASES = ([(shape, epi) for shape in Q4_SHAPES for epi in ("none", "residual", "norm_rope")]
                 + [(shape, "gate") for shape in Q4_SILU_SHAPES])


@pytest.mark.parametrize("shape,epi", Q4_GEMV_CASES)
def test_q4_gemv_tensor_cores_at_every_decode_row(shape, epi):
    dev = _card()
    k, n, gs = shape
    rng = np.random.default_rng(k + n + gs)
    gate = epi == "gate"
    qt = _q4t(rng, k, 2 * n if gate else n, gs, dev)
    wrapper, plain = ((Q4.q4_matmul_silu, Q4.q4_matmul_silu_plain) if gate
                      else (Q4.q4_matmul, Q4.q4_matmul_plain))
    for m in range(1, Q.GEMV_MAX_M + 1):
        x = _rand(rng, (m, k), torch.bfloat16, dev)
        if gate:
            kw = {"norm_weight": (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()}
        elif epi == "norm_rope":
            hs = 48 if k == 288 else 8 if n < 1024 else 128
            kw = {"norm_weight": (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous(),
                  "rope_pos": torch.tensor(rng.integers(0, 2048, m), dtype=torch.int32,
                                           device=dev),
                  "rope_limit": (2 * n // 3) // hs * hs, "rope_head": hs}
        else:
            kw = {"residual": _rand(rng, (m, n), torch.bfloat16, dev)} if epi == "residual" else {}
        n0, w0 = wrapper.launches, wrapper.launches_wgmma
        got = wrapper(x, qt, **kw)
        want = plain(x, qt, **kw)
        torch.cuda.synchronize()
        assert (wrapper.launches, wrapper.launches_wgmma) == (n0 + 1, w0), m
        assert got.shape == (m, n)
        _close(got, want, torch.bfloat16)
        assert torch.equal(got, wrapper(x, qt, **kw)), m  # the same bits every run


def test_quantizers_divide_on_the_card():
    """The weight quantizers give the CPU's bits on the card: a division by
    a Python number would run there as a product with its reciprocal."""
    dev = _card()
    rng = np.random.default_rng(16)
    w = torch.from_numpy(rng.standard_normal((256, 384)).astype(np.float32))
    for quantize in (Q.q8_quantize_weights, Q4.q4_quantize_weights):
        got, want = quantize(w.to(dev)), quantize(w)
        assert torch.equal(got.q.cpu(), want.q) and torch.equal(got.s.cpu(), want.s)


# ---------------------------------------------------------------------------
# the paged pool: K6, K7, K11, K10, K13 and K14 against their plain versions

from hip_llama_tpu_torch.models.paged import PagedKVCache  # noqa: E402

# (B, H, KVH, HS, PS, MAX_PAGES): the golden fixture's heads and page, a mid
# size with pages of 32, and Llama-2-7B's heads with pages of 128
PAGED_SHAPES = [(4, 8, 4, 8, 16, 6), (3, 8, 2, 64, 32, 7), (8, 32, 32, 128, 128, 4)]


def _paged_pool(rng, n_layers, kvh, n_pages, ps, hs, dtype, dev):
    shape = (n_layers, kvh, n_pages, ps, hs)
    if dtype == torch.int8:
        planes = [C.quantize_kv_rows(_rand(rng, shape, torch.float32, dev)) for _ in range(2)]
        return PagedKVCache(planes[0][0], planes[1][0], planes[0][1], planes[1][1])
    return PagedKVCache(_rand(rng, shape, dtype, dev), _rand(rng, shape, dtype, dev))


def _paged_table(rng, b, max_pages, n_pages, dev):
    """Distinct physical pages 1..n_pages-1 in shuffled order."""
    pages = rng.permutation(np.arange(1, n_pages))[: b * max_pages].reshape(b, max_pages)
    return torch.tensor(pages, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("pages", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_attention_decode_paged_kernel(shape, pages):
    dev = _card()
    b, h, kvh, hs, ps, max_pages = shape
    rng = np.random.default_rng(17)
    n_pages = b * max_pages + 1
    pool = _paged_pool(rng, 2, kvh, n_pages, ps, hs, pages, dev)
    table = _paged_table(rng, b, max_pages, n_pages, dev)
    act = torch.bfloat16 if pages == torch.int8 else pages
    q = _rand(rng, (b, h, hs), act, dev)
    kc, vc = _rand(rng, (b, kvh, hs), act, dev), _rand(rng, (b, kvh, hs), act, dev)
    s = max_pages * ps
    # 0, an exact page boundary, the last row, then ragged
    pos = torch.tensor(np.r_[0, ps, s - 1, rng.integers(0, s, b - 3)], dtype=torch.int32,
                       device=dev)
    sc = (pool.k_scale, pool.v_scale)
    n0 = (A.attention_decode_paged.launches_int8 if pages == torch.int8
          else A.attention_decode_paged.launches)
    got = A.attention_decode_paged(q, pool.k, pool.v, table, 1, pos, kc, vc, *sc)
    want = A.attention_decode_paged_plain(q, pool.k, pool.v, table, 1, pos, kc, vc, *sc,
                                          block=ps)
    torch.cuda.synchronize()
    n1 = (A.attention_decode_paged.launches_int8 if pages == torch.int8
          else A.attention_decode_paged.launches)
    assert n1 == n0 + 1
    tol = INT8_TOL[act] if pages == torch.int8 else TOL[act]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("pages", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_attention_prefill_paged_kernel(shape, pages):
    dev = _card()
    b, h, kvh, hs, ps, max_pages = shape
    t = min(ps, 64)
    rng = np.random.default_rng(18)
    n_pages = b * max_pages + 1
    pool = _paged_pool(rng, 2, kvh, n_pages, ps, hs, pages, dev)
    table = _paged_table(rng, b, max_pages, n_pages, dev)
    act = torch.bfloat16 if pages == torch.int8 else pages
    q = _rand(rng, (b, t, h, hs), act, dev)
    # page-aligned starts: the first page, the last page, a bystander, then ragged
    start = np.r_[0, (max_pages - 1) * ps, ps, rng.integers(0, max_pages, b - 3) * ps]
    valid = np.r_[t, t // 2, 0, rng.integers(1, t + 1, b - 3)]
    start_t = torch.tensor(start, dtype=torch.int32, device=dev)
    valid_t = torch.tensor(valid, dtype=torch.int32, device=dev)
    sc = (pool.k_scale, pool.v_scale)
    got = A.attention_prefill_paged(q, pool.k, pool.v, table, 0, start_t, valid_t, *sc)
    want = A.attention_prefill_paged_plain(q, pool.k, pool.v, table, 0, start_t, valid_t, *sc,
                                           block=ps)
    torch.cuda.synchronize()
    live = torch.arange(t, device=dev)[None, :] < valid_t[:, None]
    # on int8 pages the probabilities round to bf16 before PV whatever q's dtype
    _close(got[live], want[live], torch.bfloat16 if pages == torch.int8 else act)


@pytest.mark.parametrize("pages", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_writers_kernels(shape, pages):
    """K11 and K13 on every page dtype, K10 and K14 on int8 pages, bit for
    bit against their plain versions; an idle slot's row lands on the trash
    page."""
    dev = _card()
    b, _, kvh, hs, ps, max_pages = shape
    n_layers = 3
    rng = np.random.default_rng(19)
    n_pages = b * max_pages + 1
    base = _paged_pool(rng, n_layers, kvh, n_pages, ps, hs, pages, dev)
    table = _paged_table(rng, b, max_pages, n_pages, dev)
    table[b - 1] = 0  # an idle slot: its table names only the trash page
    int8 = pages == torch.int8

    def copy():
        return PagedKVCache(*(None if x is None else x.clone()
                              for x in (base.k, base.v, base.k_scale, base.v_scale)))

    def same(x, y):
        return all(torch.equal(getattr(x, f), getattr(y, f)) for f in ("k", "v")) and (
            not int8 or all(torch.equal(getattr(x, f), getattr(y, f))
                            for f in ("k_scale", "v_scale")))

    s = max_pages * ps
    pos = torch.tensor(np.r_[ps, s - 1, rng.integers(0, s, b - 3), 0], dtype=torch.int32,
                       device=dev)
    rows = [_rand(rng, (n_layers, b, kvh, hs), torch.float32, dev) for _ in range(2)]
    if int8:
        (kr, ksr), (vr, vsr) = (C.quantize_kv_rows(r) for r in rows)
    else:
        kr, vr = (r.to(pages) for r in rows)
    n0 = C.kv_write_rows_paged.launches_int8 if int8 else C.kv_write_rows_paged.launches
    got, want = copy(), copy()
    C.kv_write_rows_paged(got, kr, vr, table, pos)
    C.kv_write_rows_paged_plain(want, kr, vr, table, pos)
    if int8:
        C.scale_write_rows_paged(got, ksr, vsr, table, pos)
        C.scale_write_rows_paged_plain(want, ksr, vsr, table, pos)
    torch.cuda.synchronize()
    n1 = C.kv_write_rows_paged.launches_int8 if int8 else C.kv_write_rows_paged.launches
    assert n1 == n0 + 1 and same(got, want)

    t = min(ps, 16)
    start = torch.tensor(np.r_[0, (max_pages - 1) * ps, rng.integers(0, max_pages, b - 2) * ps],
                         dtype=torch.int32, device=dev)
    cvalid = torch.tensor(np.r_[t, 0, rng.integers(1, t + 1, b - 2)], dtype=torch.int32,
                          device=dev)
    crows = [_rand(rng, (b, t, kvh, hs), torch.float32, dev) for _ in range(2)]
    if int8:
        (ck, cks), (cv, cvs) = (C.quantize_kv_rows(r) for r in crows)
    else:
        ck, cv = (r.to(pages) for r in crows)
    table = _paged_table(rng, b, max_pages, n_pages, dev)  # every slot live again
    got, want = copy(), copy()
    C.kv_write_chunk_paged(got, ck, cv, 2, table, start, cvalid)
    C.kv_write_chunk_paged_plain(want, ck, cv, 2, table, start, cvalid)
    if int8:
        C.scale_write_chunk_paged(got, cks, cvs, 2, table, start, cvalid)
        C.scale_write_chunk_paged_plain(want, cks, cvs, 2, table, start, cvalid)
    torch.cuda.synchronize()
    assert same(got, want)


@pytest.mark.parametrize("pages", [torch.bfloat16, torch.int8])
def test_contiguous_kernels_are_the_paged_kernels_on_laid_out_pages(pages):
    """The row policy changes addresses only: K1 and K5 (fp32 at S 512 and
    bf16) and K23 give bit for bit what K6 gives over the same rows cut into
    pages of 128 (K1's 64-row block is K6's there), so the contiguous path's
    arithmetic is that of the kernels before the policy existed; the K23 =
    four-kernel equalities of the tests above still hold."""
    dev = _card()
    b, h, kvh, hs, s, ps, d, hid, gs = 8, 32, 32, 128, 512, 128, 4096, 11008, 64
    rng = np.random.default_rng(20)
    n_layers = 2
    int8 = pages == torch.int8
    if int8:
        cache = _int8_cache(rng, b, n_layers, kvh, s, hs, dev)
    else:
        cache = KVCache(_rand(rng, (b, n_layers, kvh, s, hs), pages, dev),
                        _rand(rng, (b, n_layers, kvh, s, hs), pages, dev))
    mp = s // ps

    def paged(x):  # (B, L, KVH, S, ...) -> (L, KVH, 1 + B * S / PS, PS, ...), page 0 the trash
        if x is None:
            return None
        y = x.unflatten(3, (mp, ps)).permute(1, 2, 0, 3, *range(4, x.dim() + 1))
        y = y.reshape(n_layers, kvh, b * mp, *y.shape[4:])
        return torch.cat([torch.zeros_like(y[:, :, :1]), y], dim=2).contiguous()

    pool = PagedKVCache(*(paged(x) for x in (cache.k, cache.v, cache.k_scale, cache.v_scale)))
    table = (torch.arange(b * mp, dtype=torch.int32, device=dev) + 1).view(b, mp)
    sc, psc = (cache.k_scale, cache.v_scale), (pool.k_scale, pool.v_scale)
    pos = torch.tensor(np.r_[0, s - 1, rng.integers(0, s, b - 2)], dtype=torch.int32, device=dev)
    qkv = _rand(rng, (b, h + 2 * kvh, hs), torch.bfloat16, dev)
    q, kc, vc = (x.contiguous() for x in (qkv[:, :h], qkv[:, h:h + kvh], qkv[:, h + kvh:]))
    k6 = A.attention_decode_paged(q, pool.k, pool.v, table, 1, pos, kc, vc, *psc)
    k1 = A.attention_decode(q, cache.k, cache.v, 1, pos, kc, vc, *sc)
    k5 = A.attention_decode_fused(qkv, cache.k, cache.v, 1, pos, h, *sc)
    torch.cuda.synchronize()
    assert torch.equal(k1, k6) and torch.equal(k5, k6)
    wqkv, wo = _qt(rng, d, (h + 2 * kvh) * hs, gs, dev), _qt(rng, d, d, gs, dev)
    w13, w2 = _qt(rng, d, 2 * hid, gs, dev), _qt(rng, hid, d, gs, dev)
    g1, g2 = ((1 + 0.1 * _rand(rng, (d,), torch.float32, dev)).contiguous() for _ in range(2))
    x = _rand(rng, (b, d), torch.bfloat16, dev)
    out, kv = LF.q8_layer_fused(x, wqkv, wo, w13, w2, g1, g2, cache.k, cache.v, 1, pos, *sc,
                                n_heads=h)
    qkv = Q.q8_matmul(x, wqkv, norm_weight=g1, rope_pos=pos, rope_limit=(h + kvh) * hs,
                      rope_head=hs).view(b, h + 2 * kvh, hs)
    q, kc, vc = (y.contiguous() for y in (qkv[:, :h], qkv[:, h:h + kvh], qkv[:, h + kvh:]))
    att = A.attention_decode_paged(q, pool.k, pool.v, table, 1, pos, kc, vc, *psc)
    x2 = Q.q8_matmul(att.reshape(b, d), wo, residual=x)
    four = Q.q8_matmul_ffn(x2, w13, w2, x2, g2)
    torch.cuda.synchronize()
    assert torch.equal(out, four) and torch.equal(kv, qkv[:, h:])


def test_paged_wrappers_reject_bad_operands():
    dev = _card()
    rng = np.random.default_rng(21)
    pool = _paged_pool(rng, 1, 2, 5, 16, 8, torch.float32, dev)
    table = _paged_table(rng, 2, 2, 5, dev)
    q, cur = _rand(rng, (2, 4, 8), torch.float32, dev), _rand(rng, (2, 2, 8), torch.float32, dev)
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    n0 = A.attention_decode_paged.launches
    with pytest.raises(TypeError):
        A.attention_decode_paged(q, pool.k, pool.v, table.long(), 0, pos, cur, cur)
    with pytest.raises(ValueError):
        A.attention_decode_paged(q, pool.k, pool.v, table[:1].contiguous(), 0, pos, cur, cur)
    with pytest.raises(TypeError):
        C.kv_write_rows_paged(pool, cur[None].bfloat16(), cur[None].bfloat16(), table, pos)
    assert A.attention_decode_paged.launches == n0


# ---------------------------------------------------------------------------
# the bf16 kernels round at the JAX kernels' KV block


def _moved(got, want):
    """The share of outputs that differ, and max |diff| against one bf16 ulp
    at the largest |want|."""
    g, w = got.float(), want.float()
    ulp = 2.0 ** (torch.floor(torch.log2(w.abs().max())).item() - 7)
    return (g != w).float().mean().item(), (g - w).abs().max().item(), ulp


def _at_block_and_apart_at_64(got, want_block, want_64):
    """Where the block decides the running max at which the probabilities
    round to bf16, the kernel agrees with the plain version at the JAX
    block (moved share at most 1%, max |diff| at most one bf16 ulp of the
    output's magnitude) and is apart from it at 64 rows (at least 5%
    moved), which shows that the check tells the two apart."""
    share, err, ulp = _moved(got, want_block)
    assert share <= 0.01 and err <= ulp, (share, err, ulp)
    share64, _, _ = _moved(got, want_64)
    assert share64 >= 0.05, share64


def test_attention_decode_bf16_rounds_at_the_jax_block():
    """K1 and K5 at S 512: the JAX decode block is 128 rows."""
    dev = _card()
    b, h, kvh, s, hs = 8, 32, 32, 512, 128
    rng = np.random.default_rng(30)
    dt = torch.bfloat16
    k = _rand(rng, (b, 1, kvh, s, hs), dt, dev)
    v = _rand(rng, (b, 1, kvh, s, hs), dt, dev)
    qkv = _rand(rng, (b, h + 2 * kvh, hs), dt, dev)
    q, kc, vc = qkv[:, :h].contiguous(), qkv[:, h:h + kvh].contiguous(), qkv[:, h + kvh:].contiguous()
    pos = torch.tensor([511, 500, 450, 300, 257, 256, 200, 129], dtype=torch.int32, device=dev)
    assert A.decode_block(s) == 128
    got = A.attention_decode(q, k, v, 0, pos, kc, vc)
    fused = A.attention_decode_fused(qkv, k, v, 0, pos, h)
    torch.cuda.synchronize()
    assert torch.equal(got, fused)
    _at_block_and_apart_at_64(got, A.attention_decode_plain(q, k, v, 0, pos, kc, vc),
                              A.attention_decode_plain(q, k, v, 0, pos, kc, vc, block=64))


def test_attention_prefill_bf16_rounds_at_the_jax_block():
    """K4 at S 512: the JAX prefill block is 512 rows, the whole cache."""
    dev = _card()
    b, t, h, kvh, s, hs = 4, 128, 32, 32, 512, 128
    rng = np.random.default_rng(31)
    dt = torch.bfloat16
    k = _rand(rng, (b, 1, kvh, s, hs), dt, dev)
    v = _rand(rng, (b, 1, kvh, s, hs), dt, dev)
    q = _rand(rng, (b, t, h, hs), dt, dev)
    start = torch.tensor([384, 300, 200, 256], dtype=torch.int32, device=dev)
    valid = torch.full((b,), t, dtype=torch.int32, device=dev)
    assert A.ref_block(s, A.PREFILL_BLOCK) == 512
    got = A.attention_prefill(q, k, v, 0, start, valid)
    torch.cuda.synchronize()
    _at_block_and_apart_at_64(got, A.attention_prefill_plain(q, k, v, 0, start, valid),
                              A.attention_prefill_plain(q, k, v, 0, start, valid, block=64))


def test_attention_paged_bf16_rounds_at_the_page():
    """K6 and K7 on bf16 pages of 128 rows: the JAX paged kernels' block is
    the page."""
    dev = _card()
    b, h, kvh, hs, ps, max_pages = 8, 32, 32, 128, 128, 4
    rng = np.random.default_rng(32)
    dt = torch.bfloat16
    n_pages = b * max_pages + 1
    pool = _paged_pool(rng, 1, kvh, n_pages, ps, hs, dt, dev)
    table = _paged_table(rng, b, max_pages, n_pages, dev)
    q = _rand(rng, (b, h, hs), dt, dev)
    kc, vc = _rand(rng, (b, kvh, hs), dt, dev), _rand(rng, (b, kvh, hs), dt, dev)
    pos = torch.tensor([511, 500, 450, 300, 257, 256, 200, 129], dtype=torch.int32, device=dev)
    got = A.attention_decode_paged(q, pool.k, pool.v, table, 0, pos, kc, vc)
    torch.cuda.synchronize()
    args = (q, pool.k, pool.v, table, 0, pos, kc, vc)
    _at_block_and_apart_at_64(got, A.attention_decode_paged_plain(*args),
                              A.attention_decode_paged_plain(*args, block=64))
    t = ps
    qp = _rand(rng, (b, t, h, hs), dt, dev)
    start = torch.tensor([384, 256, 128, 384, 256, 128, 384, 256], dtype=torch.int32, device=dev)
    valid = torch.full((b,), t, dtype=torch.int32, device=dev)
    args = (qp, pool.k, pool.v, table, 0, start, valid)
    got = A.attention_prefill_paged(*args)
    torch.cuda.synchronize()
    _at_block_and_apart_at_64(got, A.attention_prefill_paged_plain(*args),
                              A.attention_prefill_paged_plain(*args, block=64))


# ---------------------------------------------------------------------------
# prefill on the tensor cores (bf16 and int8 caches): more than one JAX
# block, GQA, the head sizes, ragged chunks

# chip_smoke.py's bound for the attention kernels against their plain
# versions (ATTN_ATOL, ATTN_RTOL): both round the probabilities at the same
# block max and differ in the fp32 order of the sums, which can move an
# output by one bf16 ulp: ATTN_ATOL below 1 in magnitude, where chip_smoke's
# 7B outputs lie. These inputs also give outputs in [1, 4) (rows that see
# few cache rows), where one ulp is 2^-7 or 2^-6, so the bound here is one
# bf16 ulp of the plain output, and never less than ATTN_ATOL.
ATTN_ATOL, ATTN_RTOL = 2.0 ** -8, 0.0


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)
# (B, H, KVH, HS): 1, 2 and 4 query heads per KV head at head sizes 8, 64
# and 128, and Llama-2-7B's heads
PREFILL_TC_SHAPES = [(4, 4, 4, 8), (4, 8, 4, 64), (5, 16, 4, 128), (8, 32, 32, 128)]


def _attn_close(got, want, live):
    g, w = got[live].float(), want[live].float()
    bad = (g - w).abs() > torch.maximum(ATTN_ATOL + ATTN_RTOL * w.abs(), _bf16_ulp(w))
    assert not bool(bad.any()), (f"{int(bad.sum())} of {bad.numel()} outside; max "
                                 f"{(g - w).abs().max().item():.3g}")
    # rows t >= valid are written as zeros
    assert not bool(got[~live].float().abs().gt(0).any())


def _ragged_chunk(rng, b, t, s, dev, align: int = 1):
    """start and valid of b slots: a chunk from 0, one that straddles the
    middle of the cache (a JAX block or page boundary), one that ends at
    the last row, a bystander (valid 0), then ragged."""
    start = np.r_[0, s // 2 - t // 2 - 3, s - t, 7,
                  rng.integers(0, (s - t) // align, b - 4) * align]
    valid = np.r_[t, t - 5, t, 0, rng.integers(1, t + 1, b - 4)]
    return (torch.tensor(start, dtype=torch.int32, device=dev),
            torch.tensor(valid, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", PREFILL_TC_SHAPES)
def test_attention_prefill_tensor_cores_over_two_jax_blocks(shape, cache):
    """K4 at S 1024: two JAX blocks of 512 rows, so the rescale between
    blocks (alpha) is held at the JAX block."""
    dev = _card()
    b, h, kvh, hs = shape
    s, t = 1024, 256
    assert A.ref_block(s, A.PREFILL_BLOCK) == 512
    rng = np.random.default_rng(40)
    if cache == torch.int8:
        kv = _int8_cache(rng, b, 2, kvh, s, hs, dev)
        k, v, sc = kv.k, kv.v, (kv.k_scale, kv.v_scale)
    else:
        k = _rand(rng, (b, 2, kvh, s, hs), cache, dev)
        v = _rand(rng, (b, 2, kvh, s, hs), cache, dev)
        sc = ()
    q = _rand(rng, (b, t, h, hs), torch.bfloat16, dev)
    start, valid = _ragged_chunk(rng, b, t, s, dev)
    counts = (A.attention_prefill.launches, A.attention_prefill.launches_int8)
    got = A.attention_prefill(q, k, v, 1, start, valid, *sc)
    want = A.attention_prefill_plain(q, k, v, 1, start, valid, *sc)
    torch.cuda.synchronize()
    int8 = cache == torch.int8
    assert (A.attention_prefill.launches, A.attention_prefill.launches_int8) == (
        counts[0] + (not int8), counts[1] + int8)
    _attn_close(got, want, torch.arange(t, device=dev)[None, :] < valid[:, None])


@pytest.mark.parametrize("pages", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", PREFILL_TC_SHAPES)
def test_attention_prefill_paged_tensor_cores_over_pages(shape, pages):
    """K7 with chunks that span several pages (the JAX block) and start
    anywhere in one, on a shuffled table."""
    dev = _card()
    b, h, kvh, hs = shape
    ps = 128 if hs == 128 else 32
    max_pages, t = 8, 2 * ps
    rng = np.random.default_rng(41)
    n_pages = b * max_pages + 1
    pool = _paged_pool(rng, 2, kvh, n_pages, ps, hs, pages, dev)
    table = _paged_table(rng, b, max_pages, n_pages, dev)
    q = _rand(rng, (b, t, h, hs), torch.bfloat16, dev)
    start, valid = _ragged_chunk(rng, b, t, max_pages * ps, dev)
    sc = (pool.k_scale, pool.v_scale)
    got = A.attention_prefill_paged(q, pool.k, pool.v, table, 1, start, valid, *sc)
    want = A.attention_prefill_paged_plain(q, pool.k, pool.v, table, 1, start, valid, *sc)
    torch.cuda.synchronize()
    _attn_close(got, want, torch.arange(t, device=dev)[None, :] < valid[:, None])


# ---------------------------------------------------------------------------
# the `a8` mode: K15, K17, K21 and K22 against their plain versions

# (K, N, gs): the fixture's and a mid shape at groups of 64, K 96 and 288
# (three units and one unit past a 128-deep step of the wgmma tiles) at
# groups of 32, Llama-2-7B's QKV and W2
A8_Q8_SHAPES = [(64, 128, 64), (192, 384, 64), (96, 384, 32), (288, 480, 32),
                (4096, 12288, 64), (11008, 4096, 64)]
A8_Q4_SHAPES = [(64, 128, 32), (192, 384, 32), (4096, 12288, 32), (11008, 4096, 32)]
# the GEMV's rows, the tiles' edges around 128-row tiles, a T-256 chunk of
# 8 slots and the bench's 8 x 511
A8_ROWS = [1, 8, 12, 16, 17, 40, 128, 255, 256, 257, 300, 2048, 4088]


def _a8_case(wrapper, plain, qt, x, kw, expect_a8):
    """wrapper against plain in `a8`; the `a8` kernel launched where
    expect_a8 (else the reshape kernel), the int8 wgmma tiles where the rule
    says so (`.launches_a8_wgmma`)."""
    n0, a0, w0 = wrapper.launches, wrapper.launches_a8, wrapper.launches_a8_wgmma
    got = wrapper(x, qt, mode="a8", **kw)
    want = plain(x, qt, mode="a8", **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches_a8 - a0, wrapper.launches - n0) == ((1, 0) if expect_a8 else (0, 1))
    wgmma = expect_a8 and Q.a8_rows_kernel(x.shape[0], qt.group_size) == "wgmma"
    assert wrapper.launches_a8_wgmma - w0 == int(wgmma)
    _close(got, want, torch.bfloat16)
    return got


def _epilogue(rng, m, k, n, epi, dev):
    kw = {}
    if "norm" in epi:
        kw["norm_weight"] = (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()
    if epi == "residual":
        kw["residual"] = _rand(rng, (m, n), torch.bfloat16, dev)
    if "rope" in epi:
        hs = 8 if n < 1024 else 128
        kw.update(rope_pos=torch.tensor(rng.integers(0, 2048, m), dtype=torch.int32, device=dev),
                  rope_limit=(2 * n // 3) // hs * hs, rope_head=hs, rope_theta=10000.0)
    return kw


@pytest.mark.parametrize("m", A8_ROWS)
@pytest.mark.parametrize("shape", A8_Q8_SHAPES)
@pytest.mark.parametrize("epi", ["none", "norm", "residual", "norm_rope"])
def test_q8_matmul_a8_kernel(m, shape, epi):
    """The GEMV path (M <= 16, one or two 8-row chunks) and the tiles (the
    int8 wgmma tiles at these group sizes: a8_rows_kernel) with each
    epilogue; where the JAX decision keeps reshape math (K 11008 above 64
    rows: 172 groups), the reshape kernel runs."""
    dev = _card()
    k, n, gs = shape
    rng = np.random.default_rng(40)
    qt = _qt(rng, k, n, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = _epilogue(rng, m, k, n, epi, dev)
    _a8_case(Q.q8_matmul, Q.q8_matmul_plain, qt, x, kw, Q.q8_a8_engages(m, k, n, gs))


@pytest.mark.parametrize("m", [4, 512] + A8_ROWS)
@pytest.mark.parametrize("shape", [(64, 192, 64), (192, 256, 64), (96, 256, 32), (288, 768, 32),
                                   (4096, 11008, 64)])
@pytest.mark.parametrize("norm", [True, False])
def test_q8_matmul_silu_a8_kernel(m, shape, norm):
    """The W1|W3 gate in `a8` with and without the norm: the GEMV up to 16
    rows, the int8 wgmma tiles above (group sizes 32 and 64)."""
    dev = _card()
    k, h, gs = shape
    rng = np.random.default_rng(41)
    qt13 = _qt(rng, k, 2 * h, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = {}
    if norm:
        kw["norm_weight"] = (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()
    a0, w0 = Q.q8_matmul_silu.launches_a8, Q.q8_matmul_silu.launches_a8_wgmma
    got = Q.q8_matmul_silu(x, qt13, mode="a8", **kw)
    want = Q.q8_matmul_silu_plain(x, qt13, mode="a8", **kw)
    torch.cuda.synchronize()
    assert Q.q8_matmul_silu.launches_a8 == a0 + 1 and got.shape == (m, h)
    assert Q.q8_matmul_silu.launches_a8_wgmma - w0 == int(Q.a8_rows_kernel(m, gs) == "wgmma")
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("m", [1, 8, 12, 40, 300])
@pytest.mark.parametrize("shape", A8_Q4_SHAPES)
@pytest.mark.parametrize("epi", ["none", "norm", "residual", "norm_rope"])
def test_q4_matmul_a8_kernel(m, shape, epi):
    """As the Q8 test; at 300 rows of K 4096 or 11008 (more than 2 MiB of
    x) the JAX decision keeps dequant math and the dequant kernel runs."""
    dev = _card()
    k, n, gs = shape
    rng = np.random.default_rng(42)
    qt = _q4t(rng, k, n, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = _epilogue(rng, m, k, n, epi, dev)
    _a8_case(Q4.q4_matmul, Q4.q4_matmul_plain, qt, x, kw, Q4.q4_a8_engages(m, k, n, gs))


@pytest.mark.parametrize("m", [4, 12, 40, 256])
@pytest.mark.parametrize("shape", [(64, 192, 32), (192, 256, 32), (4096, 11008, 32)])
@pytest.mark.parametrize("norm", [True, False])
def test_q4_matmul_silu_a8_kernel(m, shape, norm):
    dev = _card()
    k, h, gs = shape
    rng = np.random.default_rng(43)
    qt13 = _q4t(rng, k, 2 * h, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = {}
    if norm:
        kw["norm_weight"] = (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()
    engages = Q4.q4_a8_engages(m, k, h, gs)
    wrapper = Q4.q4_matmul_silu
    n0, a0, w0 = wrapper.launches, wrapper.launches_a8, wrapper.launches_a8_wgmma
    got = Q4.q4_matmul_silu(x, qt13, mode="a8", **kw)
    want = Q4.q4_matmul_silu_plain(x, qt13, mode="a8", **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches_a8 - a0, wrapper.launches - n0) == ((1, 0) if engages else (0, 1))
    assert wrapper.launches_a8_wgmma - w0 == int(engages and Q.a8_rows_kernel(m, gs) == "wgmma")
    _close(got, want, torch.bfloat16)


# the int4 `a8` tiles, the int8 wgmma tiles (one nibble plane a CTA, the
# planes added by the split pass) against a8.cuh's mma.sync tiles: name ->
# (K, N (2H for the gate), gate, epilogue) at Llama-2-7B's widths, and the
# fixture's QKV (a plane's K/2 = 32: a quarter of one 128-deep step) and a
# gate at K 320 (K/2 = 160: a last step of 32)
Q4_A8_TILES = {"qkv": (4096, 12288, False, "norm_rope"), "wo": (4096, 4096, False, "residual"),
               "gate": (4096, 22016, True, "norm"), "w2": (11008, 4096, False, "residual"),
               "k64 qkv": (64, 128, False, "norm_rope"), "k320 gate": (320, 512, True, "norm")}


@pytest.mark.parametrize("name,m", [(name, m) for name in Q4_A8_TILES
                                    for m in ((64,) if name == "w2" else (17, 128, 256))])
def test_q4_a8_wgmma_tiles_equal_mma_sync(name, m):
    """Bit for bit (ops/quant4.py::q4_a8_tiles_probe, the same quantizer pass
    before either), groups of 32; where the JAX decision engages `a8`, the
    wrapper runs the wgmma tiles and gives the same output."""
    dev = _card()
    k, n, gate, epi = Q4_A8_TILES[name]
    rng = np.random.default_rng(46)
    qt = _q4t(rng, k, n, 32, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = _epilogue(rng, m, k, n, epi, dev)
    wgmma, mma = (Q4.q4_a8_tiles_probe(x, qt, gate, v, **kw) for v in (0, 1))
    torch.cuda.synchronize()
    assert wgmma.shape == (m, n // 2 if gate else n)
    assert torch.isfinite(wgmma.float()).all() and torch.equal(wgmma, mma)
    wrapper = Q4.q4_matmul_silu if gate else Q4.q4_matmul
    if Q4.q4_a8_engages(m, k, n // 2 if gate else n, 32):
        w0 = wrapper.launches_a8_wgmma
        got = wrapper(x, qt, mode="a8", **kw)
        torch.cuda.synchronize()
        assert wrapper.launches_a8_wgmma == w0 + 1 and torch.equal(got, wgmma)


# the `a8` GEMV on the int8 tensor cores (a8.cuh::a8_gemv_tc_kernel)
# against the dp4a GEMV, bit for bit, at 7B widths: (K, N, gate, epilogue)
A8_GEMV_PROBE = {"qkv": (4096, 12288, False, "norm_rope"), "wo": (4096, 4096, False, "residual"),
                 "gate": (4096, 22016, True, "norm"), "w2": (11008, 4096, False, "residual")}


@pytest.mark.parametrize("int4", [False, True], ids=["q8", "int4"])
@pytest.mark.parametrize("name", list(A8_GEMV_PROBE))
@pytest.mark.parametrize("m", [1, 8, 9, 16])
def test_a8_gemv_tensor_cores_equal_dp4a(int4, name, m):
    """ops/quant.py::a8_gemv_probe, the same quantizer pass before either
    GEMV and the same split pass after, Q8_0 groups of 64 and int4 groups
    of 32; where the JAX decision engages `a8`, the wrapper runs the
    tensor-core GEMV (`.launches_a8_tc`) and gives the same output."""
    dev = _card()
    k, n, gate, epi = A8_GEMV_PROBE[name]
    gs = 32 if int4 else 64
    rng = np.random.default_rng(47 + m)
    qt = _q4t(rng, k, n, gs, dev) if int4 else _qt(rng, k, n, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = _epilogue(rng, m, k, n, epi, dev)
    tc, dp4a = (Q.a8_gemv_probe(x, qt, gate, v, **kw) for v in (0, 1))
    torch.cuda.synchronize()
    assert tc.shape == (m, n // 2 if gate else n)
    assert torch.isfinite(tc.float()).all() and torch.equal(tc, dp4a)
    if int4:
        wrapper, engages = (Q4.q4_matmul_silu if gate else Q4.q4_matmul), Q4.q4_a8_engages
    else:
        wrapper, engages = (Q.q8_matmul_silu if gate else Q.q8_matmul), Q.q8_a8_engages
    if engages(m, k, n // 2 if gate else n, gs):
        t0 = wrapper.launches_a8_tc
        got = wrapper(x, qt, mode="a8", **kw)
        torch.cuda.synchronize()
        assert wrapper.launches_a8_tc == t0 + 1 and torch.equal(got, tc)


def test_a8_wrappers_serve_group_size_48():
    """Group size 48 (no divisor of the 32-deep int8 mma step) is served by
    the `a8` kernels, on the GEMV (4 rows) and the tiled path (40 rows)."""
    dev = _card()
    rng = np.random.default_rng(44)
    qt = _qt(rng, 96, 64, 48, dev)
    for m in (4, 40):
        assert Q.q8_a8_engages(m, 96, 64, 48)
        _a8_case(Q.q8_matmul, Q.q8_matmul_plain, qt, _rand(rng, (m, 96), torch.bfloat16, dev),
                 {}, True)


# ---------------------------------------------------------------------------
# --layout stacked and the four-write commit: K20 and its `a8` branch, K1 on
# the flat QKV rows, K8 and K9

# (K, N, gs): the golden fixture's QKV, W1|W3 and W2, and Llama-2-7B's QKV
# and W2 (172 groups)
K20_SHAPES = [(64, 128, 64), (64, 384, 64), (192, 64, 64), (4096, 12288, 64), (11008, 4096, 64)]


def _stacked_qt(rng, n_layers, k, n, gs, dev):
    w = rng.standard_normal((n_layers, k, n)).astype(np.float32) / np.sqrt(k)
    return Q.q8_quantize_weights(torch.from_numpy(w).to(dev), gs)


@pytest.mark.parametrize("mode", ["reshape", "a8"])
@pytest.mark.parametrize("m", [1, 8, 40, 300, 600])
@pytest.mark.parametrize("shape", K20_SHAPES)
@pytest.mark.parametrize("epi", ["norm", "residual", "norm_rope"])
def test_q8_matmul_layered_kernel(mode, m, shape, epi):
    """K20 on the last of three layers against its plain version: the
    reshape kernel, or the `a8` kernel where K20's rule says so (M <= 64);
    past 512 rows q8_matmul on the layer, under its own decision."""
    dev = _card()
    k, n, gs = shape
    rng = np.random.default_rng(50)
    qt = _stacked_qt(rng, 3, k, n, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = _epilogue(rng, m, k, n, epi, dev)
    if "norm_weight" in kw:
        kw["norm_weight"] = (1 + 0.1 * _rand(rng, (3, k), torch.float32, dev)).contiguous()
    wrapper = Q.q8_matmul if m > Q.LAYERED_MAX_M else Q.q8_matmul_layered
    a8 = mode == "a8" and (Q.q8_a8_engages(m, k, n, gs) if m > Q.LAYERED_MAX_M
                           else Q.q8_layered_a8_engages(m, k, n, gs))
    n0, a0 = wrapper.launches, wrapper.launches_a8
    got = Q.q8_matmul_layered(x, qt, 2, mode=mode, **kw)
    want = Q.q8_matmul_layered_plain(x, qt, 2, mode=mode, **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches_a8 - a0, wrapper.launches - n0) == ((1, 0) if a8 else (0, 1))
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("mode", ["reshape", "a8"])
def test_q8_matmul_layered_copies_no_layer(mode):
    """At 7B QKV width and batch 8, K20 allocates nothing of a layer's size
    (50 MB) and gives q8_matmul's output on the layer's view bit for bit:
    the same device code on the layer's addresses."""
    dev = _card()
    k, n, gs = 4096, 12288, 64
    rng = np.random.default_rng(51)
    qt = _stacked_qt(rng, 4, k, n, gs, dev)
    g = (1 + 0.1 * _rand(rng, (4, k), torch.float32, dev)).contiguous()
    x = _rand(rng, (8, k), torch.bfloat16, dev)
    pos = torch.arange(8, dtype=torch.int32, device=dev)
    rope = dict(rope_pos=pos, rope_limit=8192, rope_head=128)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = Q.q8_matmul_layered(x, qt, 3, norm_weight=g, mode=mode, **rope)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < k * n // 4
    want = Q.q8_matmul(x, Q.layer_of(qt, 3), norm_weight=g[3], mode=mode, **rope)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.int8])
def test_attention_decode_reads_flat_qkv_rows_in_place(cache):
    """K1 on q, k and v as column views of the flat QKV rows gives its
    output on contiguous copies, bit for bit."""
    dev = _card()
    b, h, kvh, hs, s = 8, 32, 32, 128, 512
    rng = np.random.default_rng(52)
    qkv = _rand(rng, (b, (h + 2 * kvh) * hs), torch.bfloat16, dev)
    views = qkv.unflatten(1, (h + 2 * kvh, hs))
    q, k, v = views[:, :h], views[:, h:h + kvh], views[:, h + kvh:]
    if cache == torch.int8:
        kc = torch.from_numpy(rng.integers(-127, 128, (b, 2, kvh, s, hs)).astype(np.int8)).to(dev)
        vc = torch.from_numpy(rng.integers(-127, 128, (b, 2, kvh, s, hs)).astype(np.int8)).to(dev)
        sc = [torch.from_numpy(rng.random((b, 2, kvh, s)).astype(np.float32) / 64).to(dev)
              for _ in range(2)]
    else:
        kc, vc = (_rand(rng, (b, 2, kvh, s, hs), torch.bfloat16, dev) for _ in range(2))
        sc = [None, None]
    pos = torch.tensor(rng.integers(0, s, b), dtype=torch.int32, device=dev)
    got = A.attention_decode(q, kc, vc, 1, pos, k, v, *sc)
    want = A.attention_decode(q.contiguous(), kc, vc, 1, pos, k.contiguous(), v.contiguous(), *sc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape", [(4, 4, 4, 96, 8), (8, 32, 32, 512, 128)])
def test_kv_write_rows_and_scale_write_rows_kernels(shape, dtype):
    """K8 on each plane dtype, with and without `valid`, and K9, bit-exact
    against their plain versions; positions -1 and S write nothing."""
    dev = _card()
    b, n_layers, kvh, s, hs = shape
    rng = np.random.default_rng(53)

    def plane(*sh):
        if dtype == torch.int8:
            return torch.from_numpy(rng.integers(-127, 128, sh).astype(np.int8)).to(dev)
        return _rand(rng, sh, dtype, dev)

    cache, rows = plane(b, n_layers, kvh, s, hs), plane(n_layers, b, kvh, hs)
    pos = torch.tensor(np.r_[0, s - 1, -1, s, rng.integers(0, s, b - 4)], dtype=torch.int32,
                       device=dev)
    for valid in (None, torch.tensor(rng.integers(0, 2, b), dtype=torch.int32, device=dev)):
        got = C.kv_write_rows(cache.clone(), rows, pos, valid)
        want = C.kv_write_rows_plain(cache.clone(), rows, pos, valid)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    sc = torch.rand(b, n_layers, kvh, s, device=dev)
    srows = torch.rand(n_layers, b, kvh, device=dev)
    got = C.scale_write_rows(sc.clone(), srows, pos)
    want = C.scale_write_rows_plain(sc.clone(), srows, pos)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_four_writes_equal_kv_commit_rows_on_the_card(int8, monkeypatch):
    """The decode step's commit under HIPLLAMA_KV_COMMIT=0 (quantize_kv_rows,
    K8 twice, K9 twice) writes what K2 writes, bit for bit, at 7B shapes."""
    from hip_llama_tpu_torch.models.llama import _kernels, _step_commit

    dev = _card()
    b, n_layers, kvh, s, hs = 8, 32, 32, 512, 128
    rng = np.random.default_rng(54)
    shape = (b, n_layers, kvh, s, hs)
    if int8:
        c0 = KVCache(*(torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)
                       for _ in range(2)),
                     *(torch.rand(shape[:4], device=dev) for _ in range(2)))
    else:
        c0 = KVCache(*(_rand(rng, shape, torch.bfloat16, dev) for _ in range(2)))
    k_rows, v_rows = (_rand(rng, (n_layers, b, kvh, hs), torch.bfloat16, dev) for _ in range(2))
    pos = torch.tensor(rng.integers(0, s, b), dtype=torch.int32, device=dev)

    def copy():
        return KVCache(*(None if t is None else t.clone()
                         for t in (c0.k, c0.v, c0.k_scale, c0.v_scale)))

    k2 = C.kv_commit_rows(copy(), k_rows, v_rows, pos)
    monkeypatch.setenv("HIPLLAMA_KV_COMMIT", "0")
    n8, n9 = C.kv_write_rows.launches + C.kv_write_rows.launches_int8, C.scale_write_rows.launches
    got = _step_commit(_kernels(plain=False))(copy(), k_rows, v_rows, pos)
    torch.cuda.synchronize()
    assert C.kv_write_rows.launches + C.kv_write_rows.launches_int8 - n8 == 2
    assert C.scale_write_rows.launches - n9 == (2 if int8 else 0)
    for f in ("k", "v", "k_scale", "v_scale"):
        a, bb = getattr(got, f), getattr(k2, f)
        assert (a is None and bb is None) or torch.equal(a, bb), f


# ---------------------------------------------------------------------------
# the prefill variants: K19 (q8_matmul_minner, q8_matmul_silu_minner) and
# K16 (q8_matmul_xheads)

# (K, N, gs): the fixture's width, a column-ragged width (272 = 2 tiles + 16
# columns) over a partial last K step, and Llama-2-7B's wo and W2, each at
# every group size of 32, 64 and 128 that divides K
MINNER_SHAPES = [(k, n, gs) for k, n in [(64, 128), (256, 272), (4096, 4096), (11008, 4096)]
                 for gs in (32, 64, 128) if k % gs == 0]
MINNER_SILU_SHAPES = [(k, h, gs) for k, h in [(128, 192), (256, 256), (4096, 11008)]
                      for gs in (32, 64, 128) if k % gs == 0]
# rows: one past two tiles of 256 (513: one row in the last tile's first
# m64 block, whose warpgroup also multiplies its second on the zeros past
# M), last tiles of 88 (600), 128 (640: one warpgroup's rows) and 76 (1100)
# rows, and a T-256 chunk of 8 slots
MINNER_ROWS = [513, 600, 640, 1100, 2048]


@pytest.mark.parametrize("m", MINNER_ROWS)
@pytest.mark.parametrize("shape", MINNER_SHAPES)
@pytest.mark.parametrize("epi", ["none", "norm", "residual", "norm_rope"])
def test_q8_matmul_minner_kernel(m, shape, epi):
    dev = _card()
    k, n, gs = shape
    rng = np.random.default_rng(60)
    qt = _qt(rng, k, n, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = _epilogue(rng, m, k, n, epi, dev)
    n0, n15 = Q.q8_matmul_minner.launches, Q.q8_matmul.launches
    got = Q.q8_matmul_minner(x, qt, **kw)
    want = Q.q8_matmul_minner_plain(x, qt, **kw)
    torch.cuda.synchronize()
    assert (Q.q8_matmul_minner.launches - n0, Q.q8_matmul.launches - n15) == (1, 0)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("m", MINNER_ROWS)
@pytest.mark.parametrize("shape", MINNER_SILU_SHAPES)
@pytest.mark.parametrize("norm", [False, True])
def test_q8_matmul_silu_minner_kernel(m, shape, norm):
    dev = _card()
    k, h, gs = shape
    rng = np.random.default_rng(61)
    qt13 = _qt(rng, k, 2 * h, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = dict(norm_weight=(1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()) if norm \
        else {}
    n0 = Q.q8_matmul_silu_minner.launches
    got = Q.q8_matmul_silu_minner(x, qt13, **kw)
    want = Q.q8_matmul_silu_minner_plain(x, qt13, **kw)
    torch.cuda.synchronize()
    assert Q.q8_matmul_silu_minner.launches == n0 + 1 and got.shape == (m, h)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("epi", ["none", "norm", "residual", "norm_rope", "silu", "silu_norm"])
def test_q8_matmul_minner_allocates_no_workspace(epi):
    """K19's allocations are its output and, where a norm or RoPE is given,
    the normed rows (M, K) bf16 and the RoPE table (M, HS) fp32: no fp32
    workspace of sums (the caching allocator's allocation count and bytes
    across one call)."""
    dev = _card()
    m, k, n = 1100, 4096, 4096
    rng = np.random.default_rng(65)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    if epi.startswith("silu"):
        qt13 = _qt(rng, k, 2 * n, 64, dev)
        kw = dict(norm_weight=(1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()) \
            if epi == "silu_norm" else {}
        call = lambda: Q.q8_matmul_silu_minner(x, qt13, **kw)  # noqa: E731
        want = [m * n * 2] + ([m * k * 2] if kw else [])
    else:
        qt = _qt(rng, k, n, 64, dev)
        kw = _epilogue(rng, m, k, n, epi, dev)
        call = lambda: Q.q8_matmul_minner(x, qt, **kw)  # noqa: E731
        want = ([m * n * 2] + ([m * k * 2] if "norm" in epi else [])
                + ([m * kw["rope_head"] * 4] if "rope" in epi else []))
    call()  # the build and the launcher's first-call setup
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(dev)
    out = call()
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats(dev)
    count = after["allocation.all.allocated"] - before["allocation.all.allocated"]
    # the allocator may hand out a cached block up to 1 MiB larger than asked
    # (it splits only a larger remainder); K19's old fp32 workspace of sums
    # took 144 MiB at this shape
    nbytes = after["allocated_bytes.all.allocated"] - before["allocated_bytes.all.allocated"]
    assert count == len(want), (count, want)
    assert sum(want) <= nbytes < sum(want) + count * 2**20, (nbytes, want)
    assert out.shape == (m, n)


@pytest.mark.parametrize("m", [32, 256, 2048])
@pytest.mark.parametrize("gh", [2, 8, 32])
@pytest.mark.parametrize("layout", ["contiguous", "head_slice"])
@pytest.mark.parametrize("residual", [False, True])
def test_q8_matmul_xheads_kernel(m, gh, layout, residual):
    dev = _card()
    hs, n = 128, 512
    rng = np.random.default_rng(62)
    qt = _qt(rng, gh * hs, n, 64, dev)
    if layout == "head_slice":  # q|k|v-like rows: the heads sit between others
        x3 = _rand(rng, (m, gh + 4, hs), torch.bfloat16, dev)[:, 2:gh + 2]
    else:
        x3 = _rand(rng, (m, gh, hs), torch.bfloat16, dev)
    res = _rand(rng, (m, n), torch.bfloat16, dev) if residual else None
    n0 = Q.q8_matmul_xheads.launches
    got = Q.q8_matmul_xheads(x3, qt, residual=res)
    want = Q.q8_matmul_xheads_plain(x3, qt, residual=res)
    torch.cuda.synchronize()
    assert Q.q8_matmul_xheads.launches == n0 + 1
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("m,gs", [(200, 32), (200, 64), (2048, 64)])
def test_q8_matmul_xheads_wgmma_at_the_7b_wo_shape(m, gs):
    """K16 on wgmma at Llama-2-7B's wo (32 heads of 128, N 4096, with the
    residual), at M 2048 and at a ragged M tile (200 rows; with groups of
    32 a step of 64 rows takes two scale rows), on a strided view of the
    heads (q|k|v-like rows)."""
    dev = _card()
    gh, hs, n = 32, 128, 4096
    rng = np.random.default_rng(63)
    qt = _qt(rng, gh * hs, n, gs, dev)
    x3 = _rand(rng, (m, 3 * gh, hs), torch.bfloat16, dev)[:, gh:2 * gh]
    assert x3.stride() == (3 * gh * hs, hs, 1)
    res = _rand(rng, (m, n), torch.bfloat16, dev)
    assert Q.xheads_engages(m, gh, hs, gh * hs, n, gs)
    n0 = Q.q8_matmul_xheads.launches
    got = Q.q8_matmul_xheads(x3, qt, residual=res)
    want = Q.q8_matmul_xheads_plain(x3, qt, residual=res)
    torch.cuda.synchronize()
    assert Q.q8_matmul_xheads.launches == n0 + 1
    _close(got, want, torch.bfloat16)


def test_prefill_products_route_by_the_jax_decisions():
    """At 7B widths, 1024 rows: q8_matmul takes K19 with `minner` (wo) and
    K15 without; under a8 wo keeps its a8 kernel; q8_matmul_silu takes K19
    silu with the norm outside (1024 x 4096 rows are past the JAX norm
    prologue's 2 MiB); q8_matmul_xheads flattens 640 rows to q8_matmul."""
    dev = _card()
    rng = np.random.default_rng(63)
    wo, w13 = _qt(rng, 4096, 4096, 64, dev), _qt(rng, 4096, 2 * 1024, 64, dev)
    x = _rand(rng, (1024, 4096), torch.bfloat16, dev)
    g = (1 + 0.1 * _rand(rng, (4096,), torch.float32, dev)).contiguous()

    def delta(f):
        before = (Q.q8_matmul_minner.launches, Q.q8_matmul.launches, Q.q8_matmul.launches_a8,
                  Q.q8_matmul_silu_minner.launches, Q.q8_matmul_xheads.launches)
        f()
        after = (Q.q8_matmul_minner.launches, Q.q8_matmul.launches, Q.q8_matmul.launches_a8,
                 Q.q8_matmul_silu_minner.launches, Q.q8_matmul_xheads.launches)
        return tuple(a - b for a, b in zip(after, before))

    assert delta(lambda: Q.q8_matmul(x, wo, residual=x, minner=True)) == (1, 0, 0, 0, 0)
    assert delta(lambda: Q.q8_matmul(x, wo, residual=x)) == (0, 1, 0, 0, 0)
    assert delta(lambda: Q.q8_matmul(x, wo, minner=True, mode="a8")) == (0, 0, 1, 0, 0)
    assert delta(lambda: Q.q8_matmul_silu(x, w13, norm_weight=g, minner=True)) == (0, 0, 0, 1, 0)
    x3 = x[:640].view(640, 32, 128)
    assert delta(lambda: Q.q8_matmul_xheads(x3, wo, minner=True)) == (1, 0, 0, 0, 0)
    assert delta(lambda: Q.q8_matmul_xheads(x3[:512], wo, mode="a8")) == (0, 0, 0, 0, 1)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# K24-K27, the bandwidth probes (bit-exact: integers in fp32), and the port
# bench's decode chain as one CUDA graph

from hip_llama_tpu_torch import bench as BENCH  # noqa: E402
from hip_llama_tpu_torch.config import ModelConfig  # noqa: E402
from hip_llama_tpu_torch.models.llama import init_kv_cache, make_decode_step  # noqa: E402
from hip_llama_tpu_torch.ops import hbm_bw as HB  # noqa: E402


def _codes(dev, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.empty(shape, dtype=torch.int8, device=dev).random_(-128, 128, generator=g)


@pytest.mark.parametrize("rows,bm,streams", [(64, 8, 1), (200, 8, 3), (4096 + 24, 512, 4),
                                             (262144, 4096, 8), (3 * 2048, 2048, 1)])
def test_dma_read_and_copy_kernels(rows, bm, streams):
    dev = _card()
    x = _codes(dev, (rows, 1024), rows)
    seed = torch.tensor([-9], dtype=torch.int32, device=dev)
    n0, c0 = HB.dma_read.launches, HB.dma_copy.launches
    got, want = HB.dma_read(seed, x, bm, streams), HB.dma_read_plain(seed, x, bm, streams)
    copies, plain = HB.dma_copy(x, bm, streams), HB.dma_copy_plain(x, bm, streams)
    torch.cuda.synchronize()
    assert HB.dma_read.launches == n0 + 1 and HB.dma_copy.launches == c0 + 1
    assert torch.equal(got, want)
    assert len(copies) == streams and all(torch.equal(a, b) for a, b in zip(copies, plain))


@pytest.mark.parametrize("bk,n_cols,bn", [(64, 4096 + 48, 128), (4096, 512 * 300 + 16, 512),
                                          (1000, 1024 * 40, 1024), (8, 256 * 7, 256)])
def test_wshape_read_kernel(bk, n_cols, bn):
    dev = _card()
    x = _codes(dev, (bk, n_cols), bk + n_cols)
    seed = torch.tensor([123], dtype=torch.int32, device=dev)
    n0 = HB.wshape_read.launches
    got, want = HB.wshape_read(seed, x, bn), HB.wshape_read_plain(seed, x, bn)
    torch.cuda.synchronize()
    assert HB.wshape_read.launches == n0 + 1 and torch.equal(got, want)


@pytest.mark.parametrize("rows,bm,depth", [(64, 8, 2), (300, 8, 16), (8 * 2048 + 100, 2048, 8),
                                           (16384, 8, 3), (24, 8, 32)])
def test_deep_read_kernel(rows, bm, depth):
    dev = _card()
    x = _codes(dev, (rows, 1024), rows + depth)
    seed = torch.tensor([4], dtype=torch.int32, device=dev)
    n0 = HB.deep_read.launches
    got, want = HB.deep_read(seed, x, bm, depth), HB.deep_read_plain(seed, x, bm, depth)
    torch.cuda.synchronize()
    assert HB.deep_read.launches == n0 + 1 and torch.equal(got, want)


@pytest.mark.parametrize("quant", ["q8", "q4", "none"])
def test_graph_decode_chain_equals_the_eager_chain(quant):
    """The bench's timed window: the chain captured as one CUDA graph and
    replayed writes the tokens the same chain gives eagerly."""
    dev = _card()
    cfg = ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=2,
                      vocab_size=512, seq_len=256)
    if quant == "q8":
        params = BENCH.rand_qparams_unrolled_on_device(cfg, dev, seed=2)
    elif quant == "q4":
        params = BENCH.rand_q4params_unrolled_on_device(cfg, dev, seed=2)
    else:
        params = BENCH.rand_params_on_device(cfg, torch.bfloat16, dev, seed=2)
    step = make_decode_step(cfg)
    cache = init_kv_cache(cfg, 4, dtype=torch.bfloat16, seq_len=256, device=dev, quantized=True)
    tokens = torch.tensor([1, 50, 300, 7], dtype=torch.int32, device=dev)
    base = torch.tensor([0, 40, 128, 200], dtype=torch.int32, device=dev)
    eager = BENCH.decode_chain(step, params, cache, tokens, base, 8)
    graph, out = BENCH.capture_chain(step, params, cache, tokens, base, 8, warmup=2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


# ---------------------------------------------------------------------------
# every shape the JAX package serves: head sizes that are multiples of 8 up to
# 256 (zero-padded to a compiled size), any number of query heads per KV head,
# `a8` group sizes that are multiples of 8, K16's groups shorter than 8 rows;
# and K18 on the tensor cores above 16 rows

# (HS, query heads per KV head): stories15M's 48 with its 3, 96 and 16, a
# padded 24, 256
HEAD_CASES = [(48, 3), (48, 16), (96, 3), (96, 16), (24, 3), (256, 2)]


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["fp32", "bf16", "int8"])
@pytest.mark.parametrize("hs,m", HEAD_CASES)
def test_attention_kernels_at_every_head_size_and_gqa(hs, m, cache):
    """K1, K5, K4, K6 and K7 against their plain versions at head sizes the
    kernels pad (48 compiled for prefill, 64 for decode; 96; 24) and at 3
    and 16 query heads per KV head (decode tasks of at most 8; prefill rows
    of a tile that 3 does not divide)."""
    dev = _card()
    b, kvh, s, t = 5, 2, 200, 48
    h = m * kvh
    rng = np.random.default_rng(hs + m)
    act = torch.bfloat16 if cache == torch.int8 else cache
    if cache == torch.int8:
        kv = _int8_cache(rng, b, 2, kvh, s, hs, dev)
        k, v, sc = kv.k, kv.v, (kv.k_scale, kv.v_scale)
    else:
        k, v, sc = _rand(rng, (b, 2, kvh, s, hs), cache, dev), _rand(rng, (b, 2, kvh, s, hs),
                                                                    cache, dev), ()
    qkv = _rand(rng, (b, h + 2 * kvh, hs), act, dev)
    q, kc, vc = (x.contiguous() for x in (qkv[:, :h], qkv[:, h:h + kvh], qkv[:, h + kvh:]))
    pos = torch.tensor(np.r_[0, s - 1, rng.integers(0, s, b - 2)], dtype=torch.int32, device=dev)
    dtol = INT8_TOL[act] if cache == torch.int8 else TOL[act]
    for got, want in (
            (A.attention_decode(q, k, v, 1, pos, kc, vc, *sc),
             A.attention_decode_plain(q, k, v, 1, pos, kc, vc, *sc)),
            (A.attention_decode_fused(qkv, k, v, 1, pos, h, *sc),
             A.attention_decode_fused_plain(qkv, k, v, 1, pos, h, *sc))):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=dtol, rtol=dtol)
    qp = _rand(rng, (b, t, h, hs), act, dev)
    start, valid = _ragged_chunk(rng, b, t, s, dev)
    got = A.attention_prefill(qp, k, v, 0, start, valid, *sc)
    want = A.attention_prefill_plain(qp, k, v, 0, start, valid, *sc)
    torch.cuda.synchronize()
    live = torch.arange(t, device=dev)[None, :] < valid[:, None]
    if cache == torch.float32:
        _close(got[live], want[live], cache)
    else:
        _attn_close(got, want, live)
    # the paged pool: pages of 16, the decode and prefill kernels
    ps, max_pages = 16, 8
    n_pages = b * max_pages + 1
    pool = _paged_pool(rng, 2, kvh, n_pages, ps, hs, cache, dev)
    table = _paged_table(rng, b, max_pages, n_pages, dev)
    psc = (pool.k_scale, pool.v_scale) if cache == torch.int8 else ()
    sp = max_pages * ps
    ppos = torch.tensor(np.r_[0, ps, sp - 1, rng.integers(0, sp, b - 3)], dtype=torch.int32,
                        device=dev)
    got = A.attention_decode_paged(q, pool.k, pool.v, table, 0, ppos, kc, vc, *psc)
    want = A.attention_decode_paged_plain(q, pool.k, pool.v, table, 0, ppos, kc, vc, *psc)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=dtol, rtol=dtol)
    tp = 16
    pstart = torch.tensor(np.r_[0, (max_pages - 1) * ps, ps, rng.integers(0, max_pages, b - 3)
                                * ps], dtype=torch.int32, device=dev)
    pvalid = torch.tensor(np.r_[tp, tp // 2, 0, rng.integers(1, tp + 1, b - 3)],
                          dtype=torch.int32, device=dev)
    qpp = qp[:, :tp].contiguous()
    got = A.attention_prefill_paged(qpp, pool.k, pool.v, table, 0, pstart, pvalid, *psc)
    want = A.attention_prefill_paged_plain(qpp, pool.k, pool.v, table, 0, pstart, pvalid, *psc)
    torch.cuda.synchronize()
    live = torch.arange(tp, device=dev)[None, :] < pvalid[:, None]
    if cache == torch.float32:
        _close(got[live], want[live], cache)
    else:
        _attn_close(got, want, live)


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("hs,m", [(48, 3), (96, 16)])
def test_q8_layer_fused_at_every_head_size_and_gqa(hs, m, cache):
    """K23 at head size 48 with 3 query heads per KV head (stories15M's
    layer, dim 288, hidden 768) and 96 with 16, against its plain version."""
    dev = _card()
    b, kvh, s = 4, 2, 96
    h = m * kvh
    d, hid, gs = h * hs, 768, 32
    rng = np.random.default_rng(hs * m)
    if cache == torch.int8:
        kv = _int8_cache(rng, b, 2, kvh, s, hs, dev)
        k, v, sc = kv.k, kv.v, (kv.k_scale, kv.v_scale)
    else:
        k, v, sc = _rand(rng, (b, 2, kvh, s, hs), cache, dev), _rand(rng, (b, 2, kvh, s, hs),
                                                                    cache, dev), ()
    w = dict(wqkv=_qt(rng, d, (h + 2 * kvh) * hs, gs, dev), wo=_qt(rng, d, d, gs, dev),
             w13=_qt(rng, d, 2 * hid, gs, dev), w2=_qt(rng, hid, d, gs, dev))
    g1, g2 = ((1 + 0.1 * _rand(rng, (d,), torch.float32, dev)).contiguous() for _ in range(2))
    x = _rand(rng, (b, d), torch.bfloat16, dev)
    pos = torch.tensor(np.r_[0, s - 1, rng.integers(0, s - 1, b - 2)], dtype=torch.int32,
                       device=dev)
    args = (x, w["wqkv"], w["wo"], w["w13"], w["w2"], g1, g2, k, v, 1, pos, *sc)
    got, rows = LF.q8_layer_fused(*args, n_heads=h)
    want, want_rows = LF.q8_layer_fused_plain(*args, n_heads=h)
    torch.cuda.synchronize()
    _close(rows, want_rows, torch.bfloat16)
    _close(got, want, torch.bfloat16)
    # bit-equal to the four kernels in a row (the layer's block is K5's here)
    qkv = Q.q8_matmul(x, w["wqkv"], norm_weight=g1, rope_pos=pos, rope_limit=(h + kvh) * hs,
                      rope_head=hs).view(b, h + 2 * kvh, hs)
    att = A.attention_decode_fused(qkv, k, v, 1, pos, h, *sc)
    x2 = Q.q8_matmul(att.reshape(b, d), w["wo"], residual=x)
    four = Q.q8_matmul_ffn(x2, w["w13"], w["w2"], x2, g2)
    torch.cuda.synchronize()
    assert torch.equal(got, four) and torch.equal(rows, qkv[:, h:])


# (K, N, gs): the int4 group size at dim 288 (16), 48, and a group of 16
# beside 32-deep steps at a 7B width
A8_GS_SHAPES = [(288, 288, 16), (288, 384, 48), (192, 128, 48), (4096, 1024, 16)]


@pytest.mark.parametrize("m", [1, 8, 40, 300])
@pytest.mark.parametrize("shape", A8_GS_SHAPES)
@pytest.mark.parametrize("epi", ["none", "norm_rope"])
def test_a8_kernels_at_group_sizes_16_and_48(m, shape, epi):
    """The `a8` kernels of K15, K17, K20, K21 and K22 at group sizes that are
    no multiple of 32: the GEMV path and the tiled path's k16 steps, whose
    group sums are rescaled apart (K21 and K22 at twice K: their packed
    halves hold whole groups)."""
    dev = _card()
    k, n, gs = shape
    rng = np.random.default_rng(k + n + gs + m)

    def gate_case(wrapper, plain, w13, x, norm, engages):
        n0, a0 = wrapper.launches, wrapper.launches_a8
        got = wrapper(x, w13, mode="a8", **norm)
        want = plain(x, w13, mode="a8", **norm)
        torch.cuda.synchronize()
        assert (wrapper.launches_a8 - a0, wrapper.launches - n0) == (
            (1, 0) if engages else (0, 1))
        _close(got, want, torch.bfloat16)

    for kk, quant, wrap, gate in ((k, _qt, Q.q8_matmul, Q.q8_matmul_silu),
                                  (2 * k, _q4t, Q4.q4_matmul, Q4.q4_matmul_silu)):
        x = _rand(rng, (m, kk), torch.bfloat16, dev)
        kw = _epilogue(rng, m, kk, n, epi, dev)
        engages = (Q4.q4_a8_engages if quant is _q4t else Q.q8_a8_engages)(m, kk, n, gs)
        plain = Q.q8_matmul_plain if quant is _qt else Q4.q4_matmul_plain
        _a8_case(wrap, plain, quant(rng, kk, n, gs, dev), x, kw, engages)
        norm = {k_: v for k_, v in kw.items() if k_ == "norm_weight"}
        gate_plain = Q.q8_matmul_silu_plain if quant is _qt else Q4.q4_matmul_silu_plain
        gate_case(gate, gate_plain, quant(rng, kk, 2 * n, gs, dev), x, norm, engages)
    # K20 on layer 1 of a stacked weight, its norm weight stacked too
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    kw = _epilogue(rng, m, k, n, epi, dev)
    if "norm_weight" in kw:
        kw["norm_weight"] = (1 + 0.1 * _rand(rng, (2, k), torch.float32, dev)).contiguous()
    st = _stacked_qt(rng, 2, k, n, gs, dev)
    a0 = Q.q8_matmul_layered.launches_a8
    got = Q.q8_matmul_layered(x, st, 1, mode="a8", **kw)
    want = Q.q8_matmul_layered_plain(x, st, 1, mode="a8", **kw)
    torch.cuda.synchronize()
    assert Q.q8_matmul_layered.launches_a8 - a0 == int(Q.q8_layered_a8_engages(m, k, n, gs))
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("m", [32, 200])
@pytest.mark.parametrize("gs,gh", [(4, 4), (8, 4), (24, 3)])
def test_q8_matmul_xheads_at_group_sizes_below_8(m, gs, gh):
    """K16 at group size 4 (head size 128: groups shorter than the 8 rows a
    thread dequantizes, their scales read a row at a time), 8 and 24 (the
    8-row shares of a group that is no power of two, over 3 heads), against
    its plain version, on a strided view of the heads."""
    dev = _card()
    hs, n = 128, 384
    rng = np.random.default_rng(64 + gs)
    qt = _qt(rng, gh * hs, n, gs, dev)
    x3 = _rand(rng, (m, 2 * gh, hs), torch.bfloat16, dev)[:, gh:]
    res = _rand(rng, (m, n), torch.bfloat16, dev)
    assert Q.xheads_engages(m, gh, hs, gh * hs, n, gs)
    n0 = Q.q8_matmul_xheads.launches
    got = Q.q8_matmul_xheads(x3, qt, residual=res)
    want = Q.q8_matmul_xheads_plain(x3, qt, residual=res)
    torch.cuda.synchronize()
    assert Q.q8_matmul_xheads.launches == n0 + 1
    _close(got, want, torch.bfloat16)


# (K, H, gs): the golden fixture's hidden 192, a ragged N (208), stories15M's
# widths, Llama-2-7B's; and a group size that is no multiple of 8
K18_TC_SHAPES = [(64, 192, 64), (208, 256, 16), (288, 768, 32), (4096, 11008, 64),
                 (128, 256, 4)]


@pytest.mark.parametrize("m", [17, 64, 100, 128, 256])
@pytest.mark.parametrize("shape", K18_TC_SHAPES)
def test_q8_matmul_ffn_tensor_cores(m, shape):
    """K18 above 16 rows (csrc/ffn.cu): the gate product, the split-K down
    product and the ordered reduce against the plain version, at ragged row
    counts (17, 100) and both row tiles (64, 128)."""
    dev = _card()
    k, h, gs = shape
    rng = np.random.default_rng(k + h + m)
    qt13, qt2 = _qt(rng, k, 2 * h, gs, dev), _qt(rng, h, k, gs, dev)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    res = _rand(rng, (m, k), torch.bfloat16, dev)
    g = (1 + 0.1 * _rand(rng, (k,), torch.float32, dev)).contiguous()
    n0, t0 = Q.q8_matmul_ffn.launches, Q.q8_matmul_ffn.launches_tc
    got = Q.q8_matmul_ffn(x, qt13, qt2, res, g)
    want = Q.q8_matmul_ffn_plain(x, qt13, qt2, res, g)
    torch.cuda.synchronize()
    assert (Q.q8_matmul_ffn.launches, Q.q8_matmul_ffn.launches_tc) == (n0, t0 + 1)
    _close(got, want, torch.bfloat16)


# ---------------------------------------------------------------------------
# the int8 decode task (csrc/decode_attention.cuh::decode_attention_task_int8:
# K and V tiles through a shared-memory ring, int32 PV a block) at the edges
# of the JAX blocks: pos 0, bk - 1, bk, bk + 1 and S - 1

# (S or pages of PS, query heads per KV head, KV heads, head size): blocks
# of 128 (S 512, pages of 128), 512 (pages) and 1024 (S 2048); 1, 4, 8, 12
# query heads a KV head; head sizes 48, 128, 256
INT8_EDGE_CASES = [(512, 1, 4, 128), (512, 12, 2, 48), (2048, 4, 2, 256), (2048, 8, 2, 128),
                   (2048, 1, 3, 48)]
INT8_PAGE_CASES = [(128, 4, 8, 2, 256), (512, 2, 4, 2, 128), (128, 3, 12, 1, 48),
                   (512, 2, 1, 3, 128)]


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,m,kvh,hs", INT8_EDGE_CASES)
def test_attention_decode_int8_kernels_at_the_block_edges(s, m, kvh, hs, act):
    """K1 and K5 on an int8 cache against their plain versions at the JAX
    block's edges, K5 equal to K1 bit for bit."""
    dev = _card()
    bk = A.decode_block(s, True)
    pos_l = [0, bk - 1, bk, bk + 1, s - 1]
    b, h = len(pos_l), m * kvh
    rng = np.random.default_rng(s + m + hs)
    cache = _int8_cache(rng, b, 2, kvh, s, hs, dev)
    sc = (cache.k_scale, cache.v_scale)
    qkv = _rand(rng, (b, h + 2 * kvh, hs), act, dev)
    q, kc, vc = (x.contiguous() for x in (qkv[:, :h], qkv[:, h:h + kvh], qkv[:, h + kvh:]))
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    n0 = A.attention_decode.launches_int8
    got = A.attention_decode(q, cache.k, cache.v, 1, pos, kc, vc, *sc)
    want = A.attention_decode_plain(q, cache.k, cache.v, 1, pos, kc, vc, *sc)
    fused = A.attention_decode_fused(qkv, cache.k, cache.v, 1, pos, h, *sc)
    torch.cuda.synchronize()
    assert A.attention_decode.launches_int8 == n0 + 1
    tol = INT8_TOL[act]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(fused, got)


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,max_pages,m,kvh,hs", INT8_PAGE_CASES)
def test_attention_decode_paged_int8_kernel_at_the_page_edges(ps, max_pages, m, kvh, hs, act):
    """K6 on int8 pages against its plain version at the page's edges (the
    JAX paged kernel's block), pages in shuffled order."""
    dev = _card()
    s = ps * max_pages
    pos_l = [0, ps - 1, ps, ps + 1, s - 1]
    b, h = len(pos_l), m * kvh
    rng = np.random.default_rng(ps + m + hs)
    n_pages = b * max_pages + 1
    pool = _paged_pool(rng, 2, kvh, n_pages, ps, hs, torch.int8, dev)
    table = _paged_table(rng, b, max_pages, n_pages, dev)
    q = _rand(rng, (b, h, hs), act, dev)
    kc, vc = _rand(rng, (b, kvh, hs), act, dev), _rand(rng, (b, kvh, hs), act, dev)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    sc = (pool.k_scale, pool.v_scale)
    n0 = A.attention_decode_paged.launches_int8
    got = A.attention_decode_paged(q, pool.k, pool.v, table, 1, pos, kc, vc, *sc)
    want = A.attention_decode_paged_plain(q, pool.k, pool.v, table, 1, pos, kc, vc, *sc)
    torch.cuda.synchronize()
    assert A.attention_decode_paged.launches_int8 == n0 + 1
    tol = INT8_TOL[act]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# blocks past a CTA's shared memory, which the int8 task walks in chunks
# (decode_int8_chunk at head size 128: 3840 rows at 8 query heads a KV
# head, 19712 at one): (S, query heads per KV head, KV heads, positions)
INT8_LONG_CASES = [(6392, 8, 1, [0, 3839, 3840, 3841, 6391]),
                   (20008, 1, 2, [0, 19711, 19712, 19713, 20007])]


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,m,kvh,pos_l", INT8_LONG_CASES)
def test_attention_decode_int8_kernels_past_shared_memory(s, m, kvh, pos_l, act):
    """K1 and K5 on an int8 cache whose JAX block is the whole cache (no
    multiple of 128 divides S), past a CTA's shared memory: against their
    plain versions at the chunk's edges, K5 equal to K1 bit for bit."""
    dev = _card()
    hs = 128
    assert A.decode_block(s, True) == s
    b, h = len(pos_l), m * kvh
    rng = np.random.default_rng(s + m)
    cache = _int8_cache(rng, b, 2, kvh, s, hs, dev)
    sc = (cache.k_scale, cache.v_scale)
    qkv = _rand(rng, (b, h + 2 * kvh, hs), act, dev)
    q, kc, vc = (x.contiguous() for x in (qkv[:, :h], qkv[:, h:h + kvh], qkv[:, h + kvh:]))
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    got = A.attention_decode(q, cache.k, cache.v, 1, pos, kc, vc, *sc)
    want = A.attention_decode_plain(q, cache.k, cache.v, 1, pos, kc, vc, *sc)
    fused = A.attention_decode_fused(qkv, cache.k, cache.v, 1, pos, h, *sc)
    torch.cuda.synchronize()
    tol = INT8_TOL[act]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(fused, got)


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
def test_attention_decode_paged_int8_kernel_past_shared_memory(act):
    """K6 on int8 pages of 6400 rows (the JAX block) at 8 query heads per KV
    head, past a CTA's shared memory, against its plain version."""
    dev = _card()
    ps, max_pages, m, kvh, hs = 6400, 2, 8, 1, 128
    pos_l = [0, 3840, ps - 1, ps, ps * max_pages - 1]
    b, h = len(pos_l), m * kvh
    rng = np.random.default_rng(ps)
    n_pages = b * max_pages + 1
    pool = _paged_pool(rng, 2, kvh, n_pages, ps, hs, torch.int8, dev)
    table = _paged_table(rng, b, max_pages, n_pages, dev)
    q = _rand(rng, (b, h, hs), act, dev)
    kc, vc = _rand(rng, (b, kvh, hs), act, dev), _rand(rng, (b, kvh, hs), act, dev)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    sc = (pool.k_scale, pool.v_scale)
    got = A.attention_decode_paged(q, pool.k, pool.v, table, 1, pos, kc, vc, *sc)
    want = A.attention_decode_paged_plain(q, pool.k, pool.v, table, 1, pos, kc, vc, *sc)
    torch.cuda.synchronize()
    tol = INT8_TOL[act]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_q8_layer_fused_int8_past_shared_memory():
    """K23 on an int8 cache whose block (6392 rows, 8 query heads per KV
    head) is past a CTA's shared memory: against its plain version, and bit
    for bit the four kernels in a row."""
    dev = _card()
    b, m, kvh, hs, s = 3, 8, 2, 128, 6392
    h = m * kvh
    d, hid, gs = h * hs, 256, 64
    assert LF.layer_block(s, h, kvh, hs, True) == s
    rng = np.random.default_rng(s)
    kv = _int8_cache(rng, b, 2, kvh, s, hs, dev)
    k, v, sc = kv.k, kv.v, (kv.k_scale, kv.v_scale)
    w = dict(wqkv=_qt(rng, d, (h + 2 * kvh) * hs, gs, dev), wo=_qt(rng, d, d, gs, dev),
             w13=_qt(rng, d, 2 * hid, gs, dev), w2=_qt(rng, hid, d, gs, dev))
    g1, g2 = ((1 + 0.1 * _rand(rng, (d,), torch.float32, dev)).contiguous() for _ in range(2))
    x = _rand(rng, (b, d), torch.bfloat16, dev)
    pos = torch.tensor([0, 3840, s - 1], dtype=torch.int32, device=dev)
    args = (x, w["wqkv"], w["wo"], w["w13"], w["w2"], g1, g2, k, v, 1, pos, *sc)
    got, rows = LF.q8_layer_fused(*args, n_heads=h)
    want, want_rows = LF.q8_layer_fused_plain(*args, n_heads=h)
    qkv = Q.q8_matmul(x, w["wqkv"], norm_weight=g1, rope_pos=pos, rope_limit=(h + kvh) * hs,
                      rope_head=hs).view(b, h + 2 * kvh, hs)
    att = A.attention_decode_fused(qkv, k, v, 1, pos, h, *sc)
    x2 = Q.q8_matmul(att.reshape(b, d), w["wo"], residual=x)
    four = Q.q8_matmul_ffn(x2, w["w13"], w["w2"], x2, g2)
    torch.cuda.synchronize()
    _close(rows, want_rows, torch.bfloat16)
    _close(got, want, torch.bfloat16)
    assert torch.equal(got, four) and torch.equal(rows, qkv[:, h:])


def test_q8_layer_fused_keeps_two_ctas_an_sm():
    """K23's grid (q8_layer_ctas_per_sm: the card's occupancy at the shared
    memory of the kernel's larger phase) holds two CTAs an SM up to 8 rows
    at Llama-2-7B's heads (block 128) and at blocks of 1024 rows with one
    and 8 query heads per KV head, on both caches."""
    from hip_llama_tpu_torch.ops import _build

    _card()
    fn = _build.bind("layer_fused", "q8_layer_ctas_per_sm", "iiiiii")
    for b in (1, 8):
        for kv_int8 in (0, 1):
            assert fn(b, 32, 32, 128, 128, kv_int8) == 2, (b, kv_int8)
            for hs in (64, 128, 256):
                for m in (1, 8):
                    assert fn(b, 2 * m, 2, hs, 1024, kv_int8) == 2, (b, kv_int8, hs, m)
    # a block past a CTA's shared memory runs in chunks, on one CTA an SM
    assert fn(8, 16, 2, 128, 6392, 1) == 1


def test_grid_barrier_probe_passes_its_barriers():
    """K23's grid barrier alone (layer_fused.grid_barrier_probe) on K23's
    grid of two CTAs an SM: any number of barriers passes, the launch
    counts, and a grid past two CTAs an SM is refused."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n0 = LF.grid_barrier_probe.launches
    for n in (0, 1, 9, 64):
        LF.grid_barrier_probe(n, 2 * sms, dev)
    torch.cuda.synchronize()
    assert LF.grid_barrier_probe.launches == n0 + 4
    with pytest.raises(RuntimeError, match="CUDA error"):
        LF.grid_barrier_probe(1, 2 * sms + 1, dev)


# ---------------------------------------------------------------------------
# the fp32/bf16 decode task (csrc/decode_attention.cuh::decode_attention_task):
# a cp.async tile ring, any block (a block past its shared memory in chunks)


def _decode_close(got, want, dtype):
    """fp32: TOL; bf16: one bf16 ulp of |want| and at least 2^-8 absolute
    (chip_smoke's ATTN_ATOL): both sides round p to bf16 at the same block
    max, in another fp32 summation order."""
    g, w = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype])
        return
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    err = (g - w).abs()
    assert bool((err <= ulp.clamp_min(2.0 ** -8)).all()), err.max().item()


# (S, query heads per KV head, KV heads, head size) and (pages of PS, pages a
# slot, ...): blocks of 128 (S 512, pages of 128), 512 (pages) and 1024 (S
# 2048); 1, 4, 8, 12 query heads a KV head; head sizes 48, 128, 256
KV_EDGE_CASES = [(512, 1, 4, 128), (512, 12, 2, 48), (2048, 4, 2, 256), (2048, 8, 2, 128),
                 (2048, 1, 3, 48)]
KV_PAGE_CASES = [(128, 4, 8, 2, 256), (512, 2, 4, 2, 128), (128, 3, 12, 1, 48),
                 (512, 2, 1, 3, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,m,kvh,hs", KV_EDGE_CASES)
def test_attention_decode_kernels_at_the_block_edges(s, m, kvh, hs, dtype):
    """K1 and K5 on an fp32 or bf16 cache against their plain versions at
    the JAX block's edges, K5 equal to K1 bit for bit."""
    dev = _card()
    bk = A.decode_block(s)
    pos_l = [0, bk - 1, bk, bk + 1, s - 1]
    b, h = len(pos_l), m * kvh
    rng = np.random.default_rng(s + m + hs + 7)
    k = _rand(rng, (b, 2, kvh, s, hs), dtype, dev)
    v = _rand(rng, (b, 2, kvh, s, hs), dtype, dev)
    qkv = _rand(rng, (b, h + 2 * kvh, hs), dtype, dev)
    q, kc, vc = (x.contiguous() for x in (qkv[:, :h], qkv[:, h:h + kvh], qkv[:, h + kvh:]))
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    n0 = A.attention_decode.launches
    got = A.attention_decode(q, k, v, 1, pos, kc, vc)
    want = A.attention_decode_plain(q, k, v, 1, pos, kc, vc)
    fused = A.attention_decode_fused(qkv, k, v, 1, pos, h)
    torch.cuda.synchronize()
    assert A.attention_decode.launches == n0 + 1
    _decode_close(got, want, dtype)
    assert torch.equal(fused, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,max_pages,m,kvh,hs", KV_PAGE_CASES)
def test_attention_decode_paged_kernel_at_the_page_edges(ps, max_pages, m, kvh, hs, dtype):
    """K6 on fp32 or bf16 pages against its plain version at the page's
    edges (the JAX paged kernel's block), pages in shuffled order."""
    dev = _card()
    s = ps * max_pages
    pos_l = [0, ps - 1, ps, ps + 1, s - 1]
    b, h = len(pos_l), m * kvh
    rng = np.random.default_rng(ps + m + hs + 7)
    n_pages = b * max_pages + 1
    pool = _paged_pool(rng, 2, kvh, n_pages, ps, hs, dtype, dev)
    table = _paged_table(rng, b, max_pages, n_pages, dev)
    q = _rand(rng, (b, h, hs), dtype, dev)
    kc, vc = _rand(rng, (b, kvh, hs), dtype, dev), _rand(rng, (b, kvh, hs), dtype, dev)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    n0 = A.attention_decode_paged.launches
    got = A.attention_decode_paged(q, pool.k, pool.v, table, 1, pos, kc, vc)
    want = A.attention_decode_paged_plain(q, pool.k, pool.v, table, 1, pos, kc, vc)
    torch.cuda.synchronize()
    assert A.attention_decode_paged.launches == n0 + 1
    _decode_close(got, want, dtype)


# blocks past the task's shared memory (decode_chunk at head size 128: 1280
# bf16 rows at 8 query heads a KV head, 1024 fp32; 10496 and 9984 at one):
# (S = the JAX block, query heads per KV head, KV heads, positions)
KV_LONG_CASES = [(6404, 8, 1, [0, 1024, 1280, 2561, 6403]),
                 (51204, 1, 2, [0, 9984, 10496, 30000, 51203])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,m,kvh,pos_l", KV_LONG_CASES)
def test_attention_decode_kernels_past_shared_memory(s, m, kvh, pos_l, dtype):
    """K1 and K5 on an fp32 or bf16 cache whose JAX block is the whole cache
    (no power of two from 8 divides S), past the task's shared memory:
    against their plain versions, K5 equal to K1 bit for bit, and two calls
    equal bit for bit."""
    dev = _card()
    hs = 128
    assert A.decode_block(s) == s
    b, h = len(pos_l), m * kvh
    rng = np.random.default_rng(s + m)
    k = _rand(rng, (b, 2, kvh, s, hs), dtype, dev)
    v = _rand(rng, (b, 2, kvh, s, hs), dtype, dev)
    qkv = _rand(rng, (b, h + 2 * kvh, hs), dtype, dev)
    q, kc, vc = (x.contiguous() for x in (qkv[:, :h], qkv[:, h:h + kvh], qkv[:, h + kvh:]))
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    got = A.attention_decode(q, k, v, 1, pos, kc, vc)
    again = A.attention_decode(q, k, v, 1, pos, kc, vc)
    want = A.attention_decode_plain(q, k, v, 1, pos, kc, vc)
    fused = A.attention_decode_fused(qkv, k, v, 1, pos, h)
    torch.cuda.synchronize()
    _decode_close(got, want, dtype)
    assert torch.equal(fused, got) and torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_decode_paged_kernel_past_shared_memory(dtype):
    """K6 on fp32 or bf16 pages of 6404 rows (the JAX block) at 8 query
    heads per KV head, past the task's shared memory, against its plain
    version."""
    dev = _card()
    ps, max_pages, m, kvh, hs = 6404, 2, 8, 1, 128
    pos_l = [0, 1280, ps - 1, ps, ps * max_pages - 1]
    b, h = len(pos_l), m * kvh
    rng = np.random.default_rng(ps + 1)
    n_pages = b * max_pages + 1
    pool = _paged_pool(rng, 2, kvh, n_pages, ps, hs, dtype, dev)
    table = _paged_table(rng, b, max_pages, n_pages, dev)
    q = _rand(rng, (b, h, hs), dtype, dev)
    kc, vc = _rand(rng, (b, kvh, hs), dtype, dev), _rand(rng, (b, kvh, hs), dtype, dev)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    got = A.attention_decode_paged(q, pool.k, pool.v, table, 1, pos, kc, vc)
    want = A.attention_decode_paged_plain(q, pool.k, pool.v, table, 1, pos, kc, vc)
    torch.cuda.synchronize()
    _decode_close(got, want, dtype)


def test_q8_layer_fused_bf16_past_shared_memory():
    """K23 on a bf16 cache whose block (6404 rows, 8 query heads per KV
    head) is past the attention task's shared memory: against its plain
    version, bit for bit the four kernels in a row and its own second call,
    on two CTAs an SM (the task's chunk keeps beside a second CTA)."""
    from hip_llama_tpu_torch.ops import _build

    dev = _card()
    b, m, kvh, hs, s = 3, 8, 2, 128, 6404
    h = m * kvh
    d, hid, gs = h * hs, 256, 64
    assert LF.layer_block(s, h, kvh, hs, False) == s
    fn = _build.bind("layer_fused", "q8_layer_ctas_per_sm", "iiiiii")
    assert fn(b, h, kvh, hs, s, 0) == 2
    rng = np.random.default_rng(s + 1)
    k = _rand(rng, (b, 2, kvh, s, hs), torch.bfloat16, dev)
    v = _rand(rng, (b, 2, kvh, s, hs), torch.bfloat16, dev)
    w = dict(wqkv=_qt(rng, d, (h + 2 * kvh) * hs, gs, dev), wo=_qt(rng, d, d, gs, dev),
             w13=_qt(rng, d, 2 * hid, gs, dev), w2=_qt(rng, hid, d, gs, dev))
    g1, g2 = ((1 + 0.1 * _rand(rng, (d,), torch.float32, dev)).contiguous() for _ in range(2))
    x = _rand(rng, (b, d), torch.bfloat16, dev)
    pos = torch.tensor([0, 1281, s - 1], dtype=torch.int32, device=dev)
    args = (x, w["wqkv"], w["wo"], w["w13"], w["w2"], g1, g2, k, v, 1, pos)
    n0 = LF.q8_layer_fused.launches
    got, rows = LF.q8_layer_fused(*args, n_heads=h)
    again, _ = LF.q8_layer_fused(*args, n_heads=h)
    want, want_rows = LF.q8_layer_fused_plain(*args, n_heads=h)
    qkv = Q.q8_matmul(x, w["wqkv"], norm_weight=g1, rope_pos=pos, rope_limit=(h + kvh) * hs,
                      rope_head=hs).view(b, h + 2 * kvh, hs)
    att = A.attention_decode_fused(qkv, k, v, 1, pos, h)
    x2 = Q.q8_matmul(att.reshape(b, d), w["wo"], residual=x)
    four = Q.q8_matmul_ffn(x2, w["w13"], w["w2"], x2, g2)
    torch.cuda.synchronize()
    assert LF.q8_layer_fused.launches == n0 + 2
    _close(rows, want_rows, torch.bfloat16)
    _close(got, want, torch.bfloat16)
    assert torch.equal(got, four) and torch.equal(rows, qkv[:, h:]) and torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_decode_kernels_are_deterministic(dtype):
    """K1, K5 and K6 at Llama-2-7B's heads (B 8, 32 KV heads, S 512, pages
    of 128): two calls give the same bits (the row groups' sums are added
    in a fixed order, never by float atomics)."""
    dev = _card()
    b, h, kvh, s, hs, ps = 8, 32, 32, 512, 128, 128
    rng = np.random.default_rng(33)
    k = _rand(rng, (b, 1, kvh, s, hs), dtype, dev)
    v = _rand(rng, (b, 1, kvh, s, hs), dtype, dev)
    qkv = _rand(rng, (b, h + 2 * kvh, hs), dtype, dev)
    q, kc, vc = (x.contiguous() for x in (qkv[:, :h], qkv[:, h:h + kvh], qkv[:, h + kvh:]))
    pos = torch.tensor([0, 1, 100, 255, 256, 300, 450, s - 1], dtype=torch.int32, device=dev)
    pool = _paged_pool(rng, 1, kvh, b * s // ps + 1, ps, hs, dtype, dev)
    table = _paged_table(rng, b, s // ps, b * s // ps + 1, dev)
    for call in (lambda: A.attention_decode(q, k, v, 0, pos, kc, vc),
                 lambda: A.attention_decode_fused(qkv, k, v, 0, pos, h),
                 lambda: A.attention_decode_paged(q, pool.k, pool.v, table, 0, pos, kc, vc)):
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second)

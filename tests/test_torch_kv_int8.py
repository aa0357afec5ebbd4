"""The port's int8 KV cache ops against the JAX package, on the CPU: the
row quantization (hip_llama_tpu_torch/ops/cache.py::quantize_kv_rows), the
int8 branches of the writers (K2 kv_commit_rows, K3 kv_write_chunk) and the
scale writer (K12 scale_write_chunk), and the int8 branches of decode
attention (K1, K5) and prefill attention (K4), each against the JAX kernel
in interpret mode, from numpy seeds. Mirrors tests/test_kv_int8.py,
test_kv_chunk.py and test_prefill_paths.py.

Tolerances:
- quantization and the writers move or round the same values with the same
  formula: exact. The JAX package's `absmax / 127.0` is compiled by XLA
  into a product with the reciprocal (under jit, as the model runs it), so
  the port is held against `jax.jit(quantize_kv_rows)`.
- decode attention: fp32 q at atol = rtol = 1e-5 (the int8 dots are exact
  on both sides; the scores, softmax and sums are the same fp32 math in
  another summation order, and PyTorch's and XLA's exp may differ by an ulp,
  which can move one row's quantized probability by one step: about 1/127
  of a probability times |v| in a sum normalized by l >= 1 — observed
  errors are at 1e-7); bf16 q at 2e-2, one bf16 ulp of an O(1) output.
- prefill attention: 2e-2 whatever q's dtype, the bf16 bound of
  tests/test_torch_attention.py: on an int8 cache the probabilities (p *
  vs) round to bf16 before PV for fp32 q too (attention.py:934), so an ulp
  of exp can move one of them by a bf16 ulp. Rows t < valid only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.models.llama import KVCache as JKVCache
from hip_llama_tpu.models.llama import _commit_kv_rows, scatter_kv_chunk, scatter_scale_chunk
from hip_llama_tpu.ops.attention import (
    attention_decode_fused as jax_decode_fused,
)
from hip_llama_tpu.ops.attention import attention_decode_pallas, attention_prefill_pallas
from hip_llama_tpu.ops.cache import kv_commit_rows as jax_kv_commit_rows
from hip_llama_tpu.ops.cache import kv_write_chunk as jax_kv_write_chunk
from hip_llama_tpu.ops.cache import quantize_kv_rows as jax_quantize_kv_rows
from hip_llama_tpu.ops.cache import scale_write_chunk as jax_scale_write_chunk
from hip_llama_tpu_torch.models.llama import KVCache
from hip_llama_tpu_torch.ops import attention as A
from hip_llama_tpu_torch.ops import cache as C

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

ACT = {"float32": (jnp.float32, torch.float32, 1e-5),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _int8_cache(rng, b, n_layers, kvh, s, hs):
    """An int8 cache quantized from normal draws, as numpy (k, v, ks, vs)."""
    planes = []
    for _ in range(2):
        q, sc = C.quantize_kv_rows(_t(rng.standard_normal((b, n_layers, kvh, s, hs))))
        planes.append((q.numpy(), sc.numpy()))
    return planes[0][0], planes[1][0], planes[0][1], planes[1][1]


# ---------------------------------------------------------------------------
# quantize_kv_rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_matches_jax(dtype):
    jd, td, _ = ACT[dtype]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 4, 5, 64)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # a zero row: scale 1, q 0
    # exact .5 ties after the scale: absmax 127 gives scale 1, so x / s is x
    x[1, 1, 1] = np.r_[127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, np.zeros(56)]
    xj = jnp.asarray(x, jd)
    want_q, want_s = jax.jit(jax_quantize_kv_rows)(xj)
    got_q, got_s = C.quantize_kv_rows(_t(np.asarray(xj.astype(jnp.float32)), td))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert np.array_equal(got_q.numpy(), np.asarray(want_q))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[0, 0, 0] == 1.0 and not got_q[0, 0, 0].any()
    # ties to even, as jnp.round
    assert got_q[1, 1, 1, :8].tolist() == [127, -127, 0, 2, 2, 0, -2, -2]


# ---------------------------------------------------------------------------
# K2: the decode-step commit on an int8 cache


@pytest.mark.parametrize("rows_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid", [None, [1, 0, 1, 1]])
def test_commit_int8_matches_jax(rows_dtype, valid):
    jd, td, _ = ACT[rows_dtype]
    rng = np.random.default_rng(1)
    b, n_layers, kvh, s, hs = 4, 3, 2, 128, 16
    k, v, ks, vs = _int8_cache(rng, b, n_layers, kvh, s, hs)
    krows, vrows = (jnp.asarray(rng.standard_normal((n_layers, b, kvh, hs)), jd) for _ in range(2))
    krows = krows.at[1, 2, 0].set(0)  # a zero row
    pos = [0, s - 1, 70, 19]
    pos_j = jnp.asarray(pos, jnp.int32)
    cache = KVCache(_t(k, torch.int8), _t(v, torch.int8), _t(ks), _t(vs))
    got = C.kv_commit_rows(cache, _t(_np(krows), td), _t(_np(vrows), td),
                           torch.tensor(pos, dtype=torch.int32),
                           None if valid is None else torch.tensor(valid, dtype=torch.int32))
    jc = JKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs))
    pallas = jax_kv_commit_rows(jc, krows, vrows, pos_j,
                                None if valid is None else jnp.asarray(valid, jnp.int32),
                                interpret=True)
    for plane, want in ((got.k, pallas.k), (got.v, pallas.v), (got.k_scale, pallas.k_scale),
                        (got.v_scale, pallas.v_scale)):
        assert np.array_equal(_np(plane), np.asarray(want, np.float32))
    if valid is None:  # the XLA commit of the JAX step (no valid mask there)
        xla = jax.jit(_commit_kv_rows)(jc, krows, vrows, pos_j)
        for plane, want in ((got.k, xla.k), (got.k_scale, xla.k_scale), (got.v_scale, xla.v_scale)):
            assert np.array_equal(_np(plane), np.asarray(want, np.float32))


def test_commit_int8_skips_positions_past_the_cache():
    b, n_layers, kvh, s, hs = 2, 1, 1, 8, 8
    cache = KVCache(torch.zeros(b, n_layers, kvh, s, hs, dtype=torch.int8),
                    torch.zeros(b, n_layers, kvh, s, hs, dtype=torch.int8),
                    torch.ones(b, n_layers, kvh, s), torch.ones(b, n_layers, kvh, s))
    rows = torch.full((n_layers, b, kvh, hs), 2.0)
    C.kv_commit_rows(cache, rows, rows, torch.tensor([s, 3], dtype=torch.int32))
    assert not cache.k[0].any() and (cache.k_scale[0] == 1).all()
    assert (cache.k[1, 0, 0, 3] == 127).all() and cache.k_scale[1, 0, 0, 3] == 2.0 / 127


# ---------------------------------------------------------------------------
# K3 on int8 rows and K12: the prefill chunk's rows and scales


def test_write_chunk_and_scales_int8_match_jax():
    rng = np.random.default_rng(2)
    # K12's TPU kernel needs S >= align(T, 128) + 256
    b, n_layers, kvh, s, hs, t = 4, 2, 2, 384, 16, 16
    k, v, ks, vs = _int8_cache(rng, b, n_layers, kvh, s, hs)
    (kq, ksr), (vq, vsr) = (C.quantize_kv_rows(_t(rng.standard_normal((b, t, kvh, hs))))
                            for _ in range(2))
    # a full chunk, a bystander (valid 0), a partial chunk, and a window past
    # the end of the cache (start + T > S) whose valid rows run past S
    start, valid = [0, 12, 200, s - 5], [t, 0, 3, 9]
    st_t, va_t = torch.tensor(start, dtype=torch.int32), torch.tensor(valid, dtype=torch.int32)
    st_j, va_j = jnp.asarray(start, jnp.int32), jnp.asarray(valid, jnp.int32)
    layer = 1
    cache = KVCache(_t(k, torch.int8), _t(v, torch.int8), _t(ks), _t(vs))
    C.kv_write_chunk(cache, kq, vq, layer, st_t, va_t)
    C.scale_write_chunk(cache, ksr, vsr, layer, st_t, va_t)

    def scatter(c, n, st, va):
        return scatter_kv_chunk(c, n, st, va, l=layer, t=t, s=s)

    def scatter_s(c, n, st, va):
        return scatter_scale_chunk(c, n, st, va, l=layer, t=t, s=s)

    for plane, old, rows in ((cache.k, k, kq), (cache.v, v, vq)):
        rj = jnp.asarray(rows.numpy())
        assert np.array_equal(plane.numpy(), np.asarray(
            jax_kv_write_chunk(jnp.array(old), rj, jnp.int32(layer), st_j, va_j, interpret=True)))
        assert np.array_equal(plane.numpy(), np.asarray(jax.vmap(scatter)(old, rj, st_j, va_j)))
    for plane, old, srows in ((cache.k_scale, ks, ksr), (cache.v_scale, vs, vsr)):
        sj = jnp.asarray(srows.numpy())
        assert np.array_equal(plane.numpy(), np.asarray(
            jax_scale_write_chunk(jnp.array(old), sj, jnp.int32(layer), st_j, va_j,
                                  interpret=True)))
        assert np.array_equal(plane.numpy(), np.asarray(jax.vmap(scatter_s)(old, sj, st_j, va_j)))
    # rows past valid and past S kept their values
    assert np.array_equal(cache.k_scale[1].numpy(), ks[1])
    assert np.array_equal(cache.k_scale[3, layer, :, : s - 5].numpy(), ks[3, layer, :, : s - 5])


# ---------------------------------------------------------------------------
# K1 and K5 int8 branches


DECODE_CASES = [
    # S 256: two 128-row blocks; S 96: one block of 96 rows (the fixture's)
    (4, 8, 4, 256, 16, [0, 255, 130, 128]),
    (4, 8, 4, 96, 8, [0, 95, 50, 3]),
    (2, 4, 4, 256, 32, [200, 1]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,s,hs,pos", DECODE_CASES)
def test_decode_int8_matches_jax(b, h, kvh, s, hs, pos, dtype):
    jd, td, tol = ACT[dtype]
    rng = np.random.default_rng(3)
    n_layers = 2
    k, v, ks, vs = _int8_cache(rng, b, n_layers, kvh, s, hs)
    q, kc, vc = (np.asarray(jnp.asarray(rng.standard_normal(sh), jd).astype(jnp.float32))
                 for sh in ((b, h, hs), (b, kvh, hs), (b, kvh, hs)))
    jcache = [jnp.asarray(a) for a in (k, v)]
    jsc = [jnp.asarray(a) for a in (ks, vs)]
    pcache = [_t(k, torch.int8), _t(v, torch.int8), _t(ks), _t(vs)]
    pos_j, pos_t = jnp.asarray(pos, jnp.int32), torch.tensor(pos, dtype=torch.int32)
    qkv = np.concatenate([q, kc, vc], axis=1)
    for layer in range(n_layers):
        got = A.attention_decode(_t(q, td), pcache[0], pcache[1], layer, pos_t, _t(kc, td),
                                 _t(vc, td), pcache[2], pcache[3])
        assert got.dtype == td and got.shape == (b, h, hs)
        want = attention_decode_pallas(jnp.asarray(q, jd), *jcache, jnp.int32(layer), pos_j,
                                       jnp.asarray(kc, jd), jnp.asarray(vc, jd), *jsc,
                                       interpret=True)
        assert_close(_np(got), _np(want), atol=tol, rtol=tol, msg=f"K1 layer {layer}")
        fused = A.attention_decode_fused(_t(qkv, td), pcache[0], pcache[1], layer, pos_t, h,
                                         pcache[2], pcache[3])
        want = jax_decode_fused(jnp.asarray(qkv, jd), *jcache, jnp.int32(layer), pos_j, *jsc,
                                n_heads=h, interpret=True)
        assert_close(_np(fused), _np(want), atol=tol, rtol=tol, msg=f"K5 layer {layer}")
        assert torch.equal(fused, got)


def test_decode_int8_block_is_the_jax_block():
    """The int8 probabilities share a scale over each JAX block, so the
    block is part of the result: K1/K5 take 1024 rows at S 1024 and 128 at
    S 512, and S itself where no multiple of 128 divides it."""
    assert [A.decode_block(s, True) for s in (96, 200, 256, 512, 1024, 2048)] == [
        96, 200, 128, 128, 1024, 1024]
    assert [A.decode_block(s) for s in (96, 200, 256, 512, 1024)] == [32, 8, 128, 128, 1024]


# ---------------------------------------------------------------------------
# K4 int8 branch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,t,h,kvh,s,hs",
    [
        (3, 16, 8, 4, 256, 128),  # T-major branch (hs % 128 == 0), one block of 256
        (3, 16, 8, 4, 96, 8),  # head-major, GQA, the fixture's head shape
    ],
)
def test_prefill_int8_matches_jax(b, t, h, kvh, s, hs, dtype):
    jd, td, _ = ACT[dtype]
    tol = ACT["bfloat16"][2]
    rng = np.random.default_rng(4)
    n_layers = 2
    k, v, ks, vs = _int8_cache(rng, b, n_layers, kvh, s, hs)
    q = np.asarray(jnp.asarray(rng.standard_normal((b, t, h, hs)), jd).astype(jnp.float32))
    # a chunk at 0, a bystander (valid 0), and a window clamped at the end
    start, valid = [0, 7, s - t // 2], [t, 0, t // 2]
    st_t, va_t = torch.tensor(start, dtype=torch.int32), torch.tensor(valid, dtype=torch.int32)
    for layer in range(n_layers):
        got = A.attention_prefill(_t(q, td), _t(k, torch.int8), _t(v, torch.int8), layer, st_t,
                                  va_t, _t(ks), _t(vs))
        want = attention_prefill_pallas(
            jnp.asarray(q, jd), jnp.asarray(k), jnp.asarray(v), jnp.int32(layer),
            jnp.asarray(start, jnp.int32), jnp.asarray(valid, jnp.int32), jnp.asarray(ks),
            jnp.asarray(vs), interpret=True)
        assert got.dtype == td and got.shape == (b, t, h, hs)
        for i in range(b):  # rows t < valid only: the rest are unspecified
            assert_close(_np(got)[i, : valid[i]], _np(want)[i, : valid[i]], atol=tol, rtol=tol,
                         msg=f"layer {layer} slot {i}")


def test_int8_wrappers_check_scales():
    k = torch.zeros(1, 1, 1, 8, 8, dtype=torch.int8)
    q = torch.zeros(1, 1, 8)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="scale"):
        A.attention_decode(q, k, k, 0, pos, q, q)
    with pytest.raises(ValueError, match="scale"):
        A.attention_decode(q, k.float(), k.float(), 0, pos, q, q, torch.ones(1, 1, 1, 8),
                           torch.ones(1, 1, 1, 8))

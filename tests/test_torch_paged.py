"""The port's paged KV cache ops against the JAX package's, on the CPU: the
block manager (hip_llama_tpu_torch/engine/block_manager.py, mirroring
tests/test_paged.py), the plain versions of decode (K6) and prefill (K7)
attention over the paged pool against the JAX kernels in interpret mode,
and the four paged writers (K11 rows, K10 row scales, K13 chunk rows, K14
chunk scales) against the JAX writers with interpret=True. From numpy
seeds, GQA with head size 8 and pages of 8 and 16 rows, shuffled page
tables, ragged positions including 0 and exact page boundaries.

Tolerances:
- the writers move the same values: exact.
- decode attention: fp32 at 1e-5 (the same fp32 math in another summation
  order); bf16 pages at 2e-2, one bf16 ulp of an O(1) output
  (tests/test_attention_pallas.py:83-85); int8 pages as
  tests/test_torch_kv_int8.py: fp32 q at 1e-5, bf16 q at 2e-2.
- prefill attention: fp32 at 1e-5; bf16 and int8 pages at 2e-2 (the
  probabilities round to bf16 before PV, on int8 pages whatever q's
  dtype). Rows t < valid only: the rest are unspecified.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.ops.attention import attention_decode_paged as jax_decode_paged
from hip_llama_tpu.ops.attention import attention_prefill_paged as jax_prefill_paged
from hip_llama_tpu.ops.cache import kv_write_chunk_paged as jax_write_chunk_paged
from hip_llama_tpu.ops.cache import kv_write_rows_paged as jax_write_rows_paged
from hip_llama_tpu.ops.cache import scale_write_chunk_paged as jax_scale_chunk_paged
from hip_llama_tpu.ops.cache import scale_write_rows_paged as jax_scale_rows_paged
from hip_llama_tpu_torch.engine.block_manager import BlockManager, OutOfPagesError
from hip_llama_tpu_torch.models.paged import PagedKVCache
from hip_llama_tpu_torch.ops import attention as A
from hip_llama_tpu_torch.ops import cache as C

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

# pages: (page dtype, JAX activation dtype, torch activation dtype, decode
# tolerance, prefill tolerance)
PAGES = {
    "float32": (jnp.float32, jnp.float32, torch.float32, 1e-5, 1e-5),
    "bfloat16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16, 2e-2, 2e-2),
    "int8, fp32 q": (jnp.int8, jnp.float32, torch.float32, 1e-5, 2e-2),
    "int8, bf16 q": (jnp.int8, jnp.bfloat16, torch.bfloat16, 2e-2, 2e-2),
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(x, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32))).to(dtype)


def _pool(rng, n_layers, kvh, n_pages, ps, hs, kind):
    """A pool of seeded draws as numpy arrays (k, v, ks, vs), in the page
    dtype's values (bf16-representable for bf16 pages; int8 rows quantized
    with their scales for int8 pages, ks and vs None otherwise)."""
    shape = (n_layers, kvh, n_pages, ps, hs)
    if kind.startswith("int8"):
        planes = [C.quantize_kv_rows(_t(rng.standard_normal(shape))) for _ in range(2)]
        return planes[0][0].numpy(), planes[1][0].numpy(), planes[0][1].numpy(), planes[1][1].numpy()
    jd = PAGES[kind][0]
    k, v = (np.asarray(jnp.asarray(rng.standard_normal(shape), jd).astype(jnp.float32))
            for _ in range(2))
    return k, v, None, None


def _table(rng, b, max_pages, n_pages):
    """A shuffled page table of distinct physical pages 1..n_pages-1 (page
    0 is the trash page)."""
    pages = rng.permutation(np.arange(1, n_pages))[: b * max_pages]
    return pages.reshape(b, max_pages).astype(np.int32)


def _jax_pool(k, v, ks, vs, kind):
    jd = PAGES[kind][0]
    out = [jnp.asarray(k, jd), jnp.asarray(v, jd)]
    return out + ([jnp.asarray(ks), jnp.asarray(vs)] if ks is not None else [None, None])


def _port_pool(k, v, ks, vs, kind):
    jd = PAGES[kind][0]
    td = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16, jnp.int8: torch.int8}[jd]
    if ks is None:
        return PagedKVCache(_t(k, td), _t(v, td))
    return PagedKVCache(_t(k, td), _t(v, td), _t(ks), _t(vs))


# ---------------------------------------------------------------------------
# the block manager (tests/test_paged.py:32-45, :252-279)


def test_block_manager_alloc_free():
    bm = BlockManager(num_pages=8, page_size=4, num_slots=2)
    assert bm.num_free == 8
    new = bm.ensure_capacity(0, 9)  # 3 pages
    assert len(new) == 3 and bm.num_free == 5
    assert new[0] == 1  # page 1 first; page 0 is the trash page
    assert bm.append_token(0, 9) is None  # page 2 covers pos 9..11
    assert bm.append_token(0, 12) is not None  # new page
    bm.ensure_capacity(1, 16)  # 4 pages
    assert bm.num_free == 0
    with pytest.raises(OutOfPagesError):
        bm.ensure_capacity(1, 17)
    bm.free_slot(0)
    assert bm.num_free == 4
    assert bm.table_array(1, 8)[:4] == bm.page_tables[1]
    assert bm.table_array(1, 8)[4:] == [BlockManager.TRASH_PAGE] * 4
    assert BlockManager.TRASH_PAGE not in bm.page_tables[1]


def test_block_manager_prefix_cache():
    """register -> match -> refcount -> retain after the registrant retires
    -> evict under allocation pressure."""
    ps = 4
    bm = BlockManager(num_pages=6, page_size=ps, num_slots=2)
    toks = list(range(100, 111))  # 11 tokens: rows [0, 10) eligible = 2 pages
    bm.ensure_capacity(0, len(toks))  # prefill allocation (3 pages)
    bm.register_prefix(0, toks)

    n = bm.match_prefix(1, toks)  # identical prompt shares both full pages
    assert n == 2 * ps
    assert bm.page_tables[1] == bm.page_tables[0][:2]
    bm.free_slot(1)

    toks2 = toks[:6] + [999, 998, 997, 996, 995]  # diverges inside page 2
    n = bm.match_prefix(1, toks2)
    assert n == ps
    bm.free_slot(1)

    bm.free_slot(0)  # registrant retires: registered pages are RETAINED
    n = bm.match_prefix(1, toks)
    assert n == 2 * ps
    bm.free_slot(1)

    # pool pressure: retained pages are evicted rather than failing
    assert len(bm.ensure_capacity(0, 6 * ps)) == 6
    bm.free_slot(0)
    assert bm.match_prefix(1, toks) == 0  # evicted: no hits left


def test_block_manager_matches_jax_block_manager():
    """The same random sequence of calls gives the same tables, free counts
    and hits in both packages."""
    from hip_llama_tpu.engine.block_manager import BlockManager as JaxBlockManager
    from hip_llama_tpu.engine.block_manager import OutOfPagesError as JaxOutOfPagesError

    rng = np.random.default_rng(0)
    bms = [BlockManager(num_pages=12, page_size=4, num_slots=3),
           JaxBlockManager(num_pages=12, page_size=4, num_slots=3)]
    prompts = [list(rng.integers(0, 3, 13)) for _ in range(4)]
    for _ in range(200):
        op, slot, n_tok = int(rng.integers(0, 4)), int(rng.integers(0, 3)), int(rng.integers(1, 20))
        toks = prompts[int(rng.integers(0, 4))]
        results = []
        for bm in bms:
            try:
                if op == 0:
                    r = bm.ensure_capacity(slot, n_tok)
                elif op == 1:
                    r = bm.free_slot(slot)
                elif op == 2 and not bm.page_tables[slot]:
                    r = bm.match_prefix(slot, toks)
                    bm.ensure_capacity(slot, len(toks))
                    bm.register_prefix(slot, toks)
                else:
                    r = bm.table_array(slot, 6)
            except (OutOfPagesError, JaxOutOfPagesError):
                r = "out of pages"
            results.append((r, bm.num_free, [list(t) for t in bm.page_tables]))
        assert results[0] == results[1]


# ---------------------------------------------------------------------------
# K6: decode attention over the pool

# (B, H, KVH, HS, PS, MAX_PAGES, pos): GQA at head size 8, pages of 8 and 16;
# positions 0, exact page boundaries, mid-page and the last row
DECODE_CASES = [
    (4, 8, 4, 8, 16, 4, [0, 16, 37, 63]),
    (5, 8, 4, 8, 8, 6, [8, 0, 47, 24, 13]),
    (3, 8, 2, 8, 16, 3, [32, 1, 47]),
]


@pytest.mark.parametrize("kind", list(PAGES))
@pytest.mark.parametrize("b,h,kvh,hs,ps,max_pages,pos", DECODE_CASES)
def test_decode_paged_matches_jax(b, h, kvh, hs, ps, max_pages, pos, kind):
    _, jact, tact, tol, _ = PAGES[kind]
    rng = np.random.default_rng(ps + b)
    n_layers, n_pages = 2, b * max_pages + 3
    k, v, ks, vs = _pool(rng, n_layers, kvh, n_pages, ps, hs, kind)
    table = _table(rng, b, max_pages, n_pages)
    q, kc, vc = (np.asarray(jnp.asarray(rng.standard_normal(sh), jact).astype(jnp.float32))
                 for sh in ((b, h, hs), (b, kvh, hs), (b, kvh, hs)))
    jpool, pool = _jax_pool(k, v, ks, vs, kind), _port_pool(k, v, ks, vs, kind)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    for layer in range(n_layers):
        got = A.attention_decode_paged(_t(q, tact), pool.k, pool.v, torch.from_numpy(table), layer,
                                       pos_t, _t(kc, tact), _t(vc, tact), pool.k_scale,
                                       pool.v_scale)
        assert got.dtype == tact and got.shape == (b, h, hs)
        want = jax_decode_paged(jnp.asarray(q, jact), jpool[0], jpool[1], jnp.asarray(table),
                                jnp.int32(layer), jnp.asarray(pos, jnp.int32),
                                jnp.asarray(kc, jact), jnp.asarray(vc, jact), jpool[2], jpool[3],
                                interpret=True)
        assert_close(_np(got), _np(want), atol=tol, rtol=tol, msg=f"{kind} layer {layer}")


def test_decode_paged_plain_is_the_dense_plain_over_the_gathered_rows():
    """The pages a table names, gathered, are the dense cache the plain
    decode reads: a pool whose table is the identity gives K1's plain
    result at the page's block."""
    rng = np.random.default_rng(5)
    b, h, kvh, hs, ps, max_pages = 2, 8, 4, 8, 8, 3
    dense = _t(rng.standard_normal((b, 2, kvh, max_pages * ps, hs)), torch.bfloat16)
    # page p of slot s holds rows [8 * i, 8 * i + 8) for table[s, i] = p
    table = torch.arange(1, 1 + b * max_pages, dtype=torch.int32).view(b, max_pages)
    pages = torch.zeros(2, kvh, 1 + b * max_pages, ps, hs, dtype=torch.bfloat16)
    pages[:, :, 1:] = dense.view(b, 2, kvh, max_pages, ps, hs).permute(1, 2, 0, 3, 4, 5).reshape(
        2, kvh, b * max_pages, ps, hs)
    q, cur = _t(rng.standard_normal((b, h, hs)), torch.bfloat16), _t(
        rng.standard_normal((b, kvh, hs)), torch.bfloat16)
    pos = torch.tensor([5, 23], dtype=torch.int32)
    got = A.attention_decode_paged(q, pages, pages, table, 1, pos, cur, cur)
    want = A.attention_decode_plain(q, dense, dense, 1, pos, cur, cur, block=ps)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K7: prefill attention over the pool

# (B, T, H, KVH, HS, PS, MAX_PAGES, start, valid): chunks at page-aligned
# starts, one with valid < T, a bystander (valid 0), T < PS
PREFILL_CASES = [
    (4, 16, 8, 4, 8, 16, 4, [0, 16, 48, 32], [16, 9, 16, 0]),
    (3, 8, 8, 2, 8, 8, 5, [32, 0, 8], [8, 3, 0]),
    (2, 5, 8, 4, 8, 8, 3, [8, 16], [5, 2]),
]


@pytest.mark.parametrize("kind", list(PAGES))
@pytest.mark.parametrize("b,t,h,kvh,hs,ps,max_pages,start,valid", PREFILL_CASES)
def test_prefill_paged_matches_jax(b, t, h, kvh, hs, ps, max_pages, start, valid, kind):
    """K7's plain version (K4's plain math at block PS) against the JAX paged
    kernel, whose body is _prefill_kernel (attention.py:743-841, not the
    T-major one): the two share their cast points at this block."""
    _, jact, tact, _, tol = PAGES[kind]
    rng = np.random.default_rng(t + ps)
    n_layers, n_pages = 2, b * max_pages + 2
    k, v, ks, vs = _pool(rng, n_layers, kvh, n_pages, ps, hs, kind)
    table = _table(rng, b, max_pages, n_pages)
    q = np.asarray(jnp.asarray(rng.standard_normal((b, t, h, hs)), jact).astype(jnp.float32))
    jpool, pool = _jax_pool(k, v, ks, vs, kind), _port_pool(k, v, ks, vs, kind)
    st, va = torch.tensor(start, dtype=torch.int32), torch.tensor(valid, dtype=torch.int32)
    for layer in range(n_layers):
        got = A.attention_prefill_paged(_t(q, tact), pool.k, pool.v, torch.from_numpy(table),
                                        layer, st, va, pool.k_scale, pool.v_scale)
        assert got.dtype == tact and got.shape == (b, t, h, hs)
        want = jax_prefill_paged(jnp.asarray(q, jact), jpool[0], jpool[1], jnp.asarray(table),
                                 jnp.int32(layer), jnp.asarray(start, jnp.int32),
                                 jnp.asarray(valid, jnp.int32), jpool[2], jpool[3],
                                 interpret=True)
        for i in range(b):  # rows t < valid only: the rest are unspecified
            assert_close(_np(got)[i, : valid[i]], _np(want)[i, : valid[i]], atol=tol, rtol=tol,
                         msg=f"{kind} layer {layer} slot {i}")


# ---------------------------------------------------------------------------
# K11, K10: one decode step's rows and scales


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8, fp32 q"])
@pytest.mark.parametrize("ps", [16, 128])
def test_write_rows_paged_matches_jax(kind, ps):
    """K11 for each page dtype and K10 on int8 pages, bit for bit against
    the JAX writers (page 128: K10's Pallas kernel; page 16: its XLA
    loop). Slots at offset 0, at an exact page boundary, mid-page, and an
    idle slot whose table names only the trash page."""
    rng = np.random.default_rng(7)
    n_layers, kvh, hs, b, max_pages = 2, 2, 8, 4, 3
    n_pages = b * max_pages + 1
    k, v, ks, vs = _pool(rng, n_layers, kvh, n_pages, ps, hs, kind)
    table = _table(rng, b, max_pages, n_pages)
    table[3] = 0  # an idle slot: its row lands on the trash page
    pos = np.array([0, ps, 2 * ps + 5, 0], np.int32)
    rows = [rng.standard_normal((n_layers, b, kvh, hs)).astype(np.float32) for _ in range(2)]
    pool = _port_pool(k, v, ks, vs, kind)
    pos_t, table_t = torch.from_numpy(pos), torch.from_numpy(table)
    if pool.quantized:
        (kq, ksr), (vq, vsr) = (C.quantize_kv_rows(_t(r)) for r in rows)
        C.kv_write_rows_paged(pool, kq, vq, table_t, pos_t)
        C.scale_write_rows_paged(pool, ksr, vsr, table_t, pos_t)
        new = [kq.numpy(), vq.numpy()]
        for plane, old, sr in ((pool.k_scale, ks, ksr), (pool.v_scale, vs, vsr)):
            want = jax_scale_rows_paged(jnp.array(old), jnp.asarray(sr.numpy()), jnp.asarray(table),
                                        jnp.asarray(pos), interpret=True)
            assert np.array_equal(plane.numpy(), np.asarray(want))
    else:
        dt = pool.k.dtype
        new = [_np(_t(r, dt)) for r in rows]
        C.kv_write_rows_paged(pool, _t(rows[0], dt), _t(rows[1], dt), table_t, pos_t)
    jd = PAGES[kind][0]
    for plane, old, r in ((pool.k, k, new[0]), (pool.v, v, new[1])):
        want = jax_write_rows_paged(jnp.array(old, jd), jnp.asarray(r, jd), jnp.asarray(table),
                                    jnp.asarray(pos), interpret=True)
        assert np.array_equal(_np(plane), np.asarray(want, np.float32))
    # the idle slot wrote page 0, offset 0, and nothing else moved there
    assert np.array_equal(_np(pool.k)[:, :, 0, 1:], np.asarray(k)[:, :, 0, 1:])


def test_write_rows_paged_skips_positions_past_the_table():
    pool = PagedKVCache(torch.zeros(1, 1, 3, 4, 8), torch.zeros(1, 1, 3, 4, 8))
    rows = torch.ones(1, 2, 1, 8)
    C.kv_write_rows_paged(pool, rows, rows, torch.tensor([[1], [2]], dtype=torch.int32),
                          torch.tensor([4, 3], dtype=torch.int32))
    assert not pool.k[0, 0, 1].any() and (pool.k[0, 0, 2, 3] == 1).all()


# ---------------------------------------------------------------------------
# K13, K14: one layer's prefill chunk and its scales


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8, fp32 q"])
@pytest.mark.parametrize("ps,t", [(16, 5), (128, 16)])
def test_write_chunk_paged_matches_jax(kind, ps, t):
    """K13 for each page dtype and K14 on int8 pages, bit for bit against
    the JAX writers in interpret mode: a full chunk, a chunk with valid < T,
    a bystander (valid 0) and a second page of a slot."""
    rng = np.random.default_rng(8)
    n_layers, kvh, hs, b, max_pages = 3, 2, 8, 4, 3
    n_pages = b * max_pages + 1
    k, v, ks, vs = _pool(rng, n_layers, kvh, n_pages, ps, hs, kind)
    table = _table(rng, b, max_pages, n_pages)
    start = np.array([0, ps, 0, 2 * ps], np.int32)
    valid = np.array([t, t - 2, 0, 1], np.int32)
    rows = [rng.standard_normal((b, t, kvh, hs)).astype(np.float32) for _ in range(2)]
    pool = _port_pool(k, v, ks, vs, kind)
    args = (torch.from_numpy(table), torch.from_numpy(start), torch.from_numpy(valid))
    jargs = (jnp.asarray(table), jnp.asarray(start), jnp.asarray(valid))
    layer = 1
    if pool.quantized:
        (kq, ksr), (vq, vsr) = (C.quantize_kv_rows(_t(r)) for r in rows)
        C.kv_write_chunk_paged(pool, kq, vq, layer, *args)
        C.scale_write_chunk_paged(pool, ksr, vsr, layer, *args)
        new = [kq.numpy(), vq.numpy()]
        for plane, old, sr in ((pool.k_scale, ks, ksr), (pool.v_scale, vs, vsr)):
            want = jax_scale_chunk_paged(jnp.array(old), jnp.asarray(sr.numpy()), jnp.int32(layer),
                                         *jargs, interpret=True)
            assert np.array_equal(plane.numpy(), np.asarray(want))
    else:
        dt = pool.k.dtype
        new = [_np(_t(r, dt)) for r in rows]
        C.kv_write_chunk_paged(pool, _t(rows[0], dt), _t(rows[1], dt), layer, *args)
    jd = PAGES[kind][0]
    for plane, old, r in ((pool.k, k, new[0]), (pool.v, v, new[1])):
        want = jax_write_chunk_paged(jnp.array(old, jd), jnp.asarray(r, jd), jnp.int32(layer),
                                     *jargs, interpret=True)
        assert np.array_equal(_np(plane), np.asarray(want, np.float32))
    # other layers and the bystander's pages kept their values
    assert np.array_equal(_np(pool.k)[0], np.asarray(k)[0])
    assert np.array_equal(_np(pool.k)[:, :, table[2]], np.asarray(k)[:, :, table[2]])


def test_paged_wrappers_check_operands():
    pool = PagedKVCache(torch.zeros(2, 1, 3, 8, 8), torch.zeros(2, 1, 3, 8, 8))
    table = torch.zeros(1, 2, dtype=torch.int32)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="one page"):
        C.kv_write_chunk_paged(pool, torch.zeros(1, 9, 1, 8), torch.zeros(1, 9, 1, 8), 0, table,
                               z, z)
    with pytest.raises(IndexError):
        A.attention_decode_paged(torch.zeros(1, 2, 8), pool.k, pool.v, table, 2, z,
                                 torch.zeros(1, 1, 8), torch.zeros(1, 1, 8))
    with pytest.raises(ValueError, match="int8 pages"):
        C.scale_write_rows_paged(pool, torch.zeros(2, 1, 1), torch.zeros(2, 1, 1), table, z)
    with pytest.raises(ValueError, match="page_table"):
        A.attention_prefill_paged(torch.zeros(1, 4, 2, 8), pool.k, pool.v, table[0], 0, z, z)

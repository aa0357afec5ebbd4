"""GQA attention over the KV cache: one-token decode (K1), the same decode
reading the head-split QKV projection in place (K5), and chunked prefill
(K4); and decode (K6) and prefill (K7) over the paged pool.

Each is a CUDA kernel (csrc/attention.cu) behind a wrapper that checks its
operands, allocates the output and counts its launches in
`<wrapper>.launches` (fp32 or bf16 cache) or `<wrapper>.launches_int8`
(int8 cache). A CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain PyTorch version beside it, which is also the yardstick the
kernel is held against on the card.

Cast points, as in the JAX kernels (hip_llama_tpu/ops/attention.py:164-241
and :912-940): q is cast to the cache dtype before QK; scores and the
softmax state are fp32; the online softmax's unnormalized probabilities
exp(s - running max) are cast to the V dtype before PV, and the sum is
divided by l at the end; the output is cast to q's dtype.

Shapes served on the card: any head size that is a multiple of 8 up to 256
and any number of query heads per KV head. The kernels are compiled for a
few head sizes (`decode_head_size`, `prefill_head_size`, the rules the
C dispatch shares) and run a head size between two of them zero-padded to
the next, which leaves every score and output the same: the padded q, K
and V columns are zeros and the padded outputs are not written. Decode
tasks take at most KV_GROUP query heads of a KV head; a KV head with more
runs several tasks, each head's arithmetic its own.

With a bf16 cache the rounded probabilities depend on where the running
max is taken, so the plain versions walk a bf16 cache in the JAX kernels'
KV blocks (`decode_block`, `ref_block`; an fp32 cache takes the one-pass
softmax, the same math), and so do the CUDA kernels: each takes a whole
block's max before it rounds any. On the card the fp32/bf16 decode task
streams the block's K and V tiles through a shared-memory ring (cp.async,
several tiles in flight), holds the block's scores in shared memory, and
walks a block past its shared memory in chunks (its K tiles once more, for
the block's max), so no block is refused.

Prefill takes one of three routes by the cache's dtype, a dispatch by
type as the JAX kernels' `quantized` branch: a bf16 cache (C entry
`attention_prefill`) and an int8 cache (`attention_prefill_int8`) run the
tensor-core kernel (mma.sync bf16 products, K and V copied by cp.async in
the cache's dtype, two passes over each block: its max, then p and PV), in
shared memory that does not grow with the block; an fp32 cache
(`attention_prefill_f32`) runs the fp32 CUDA-core kernel, which holds the
block's scores in shared memory (`check_prefill_block` bounds the block),
so that the fp32 outputs stay byte-identical to the CPU's. The paged
entries follow the same rule (`attention_prefill_paged`, `_int8`, `_f32`).
All three count in `attention_prefill.launches` (int8:
`.launches_int8`).

An int8 cache holds one fp32 scale per row in `k_scale` / `v_scale` (B, L,
KVH, S). Decode follows the JAX kernels' int8 dots (attention.py:88-93,
:300-383, the default HIPLLAMA_ATTN_I8MXU=1): q, widened to fp32, is
quantized by row (max|q| * (1/127)); scores are int32(qi . k) * (sq *
scale) * ks; per block, (p * vs) is quantized by row over the block's rows
and dotted as int32 with the int8 V rows, one int32 per (head, dim) a
block and then one fp32 update. The block decides which probabilities
share a scale, so the kernels take the JAX block whole
(`decode_block(s, quantized=True)`). The current row stays unquantized. On
the card the int8 decode task streams the block's K and V tiles through a
shared-memory ring (cp.async, several tiles in flight) and dots them with
dp4a. It holds the block's scores, v scales and packed probabilities in
shared memory, and walks a block past a CTA's shared memory in chunks (its
K tiles three times), so no block is refused.
Prefill (attention.py:891-940) has no int8 dots: q is rounded to bf16, K
and V widened exactly, scores * scale * ks, and (p * vs) rounded to bf16
before PV.

The paged kernels (attention.py:1663-1868) take the pool (L, KVH, P, PS,
HS) and a page table (B, MAX_PAGES) int32 in place of the dense cache; row r
of slot b lives in page table[b, r // PS] at offset r % PS. Their JAX block
is the page (block_k = PS), so the plain versions gather a slot's pages
into rows and take the dense plain math at block PS; the CUDA kernels run
the dense kernels' code with a paged row address, at block PS.
"""

from __future__ import annotations

import math

import torch

from hip_llama_tpu_torch.ops import _build
from hip_llama_tpu_torch.ops.cache import (
    _DTYPES,
    _count,
    _stream,
    check_cache,
    check_operand,
    check_pages,
    check_scales,
    check_table,
)

MAX_HEAD_SIZE = 256
KV_GROUP = 8  # query heads of one decode task (csrc/decode_attention.cuh kMaxM)
# the JAX kernels' masked score (attention.py:40): finite, so a fully
# masked row of a block gives p = 0 and leaves the running max alone
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
DECODE_BLOCK = 1024  # the JAX decode kernels' KV block target
PREFILL_BLOCK = 512  # the JAX prefill kernels' KV block target
# shared memory a CTA may take on an H100 (csrc/attention.cu's prefill kernels)
SMEM_PER_CTA = 232448
_PF_ROWS = _PF_TILE = 64  # query rows per prefill CTA, cache rows per tile
_TC_STAGES = 2  # the tensor-core prefill's ring of K/V tiles (kTcStages)


def decode_head_size(hs: int) -> int:
    """The head size the decode kernels are compiled for that serves head
    size hs (csrc/decode_attention.cuh::decode_hs_pad): the next power of
    two from 8; 0 where hs is no multiple of 8 or above MAX_HEAD_SIZE. The
    decode tasks are bound by the K/V bytes, which padding does not add."""
    if hs < 8 or hs % 8 or hs > MAX_HEAD_SIZE:
        return 0
    return max(8, 1 << (hs - 1).bit_length())


def prefill_head_size(hs: int) -> int:
    """The head size the prefill kernels are compiled for that serves head
    size hs (csrc/attention.cu::prefill_hs_pad): the next of 8, 16, 32, 48,
    64, 96, 128 and 256; 0 where hs is no multiple of 8 or above
    MAX_HEAD_SIZE. 48 and 96 are compiled, where padding to 64 and 128 would
    add a third to the tensor cores' work."""
    if hs < 8 or hs % 8 or hs > MAX_HEAD_SIZE:
        return 0
    return next(c for c in (8, 16, 32, 48, 64, 96, 128, 256) if c >= hs)


def check_head_size(what: str, hs: int) -> None:
    if not decode_head_size(hs):
        raise ValueError(f"{what} takes head sizes that are multiples of 8 up to "
                         f"{MAX_HEAD_SIZE}, got {hs}")


def ref_block(s: int, target: int) -> int:
    """The KV block the JAX kernels take for a cache of s rows
    (attention.py:736-740)."""
    for bk in (target, 128, 64, 32, 16, 8):
        if bk <= s and s % bk == 0:
            return bk
    return s


def decode_block(s: int, quantized: bool = False) -> int:
    """The KV block of the JAX decode kernels K1 and K5 for a cache of s
    rows (attention.py:1215-1222, :1545-1549): `ref_block(s, 1024)`; on an
    int8 cache a block that is no multiple of 128 becomes 128 where s is
    one, else s."""
    bk = ref_block(s, DECODE_BLOCK)
    if quantized and bk % 128 and bk != s:
        bk = 128 if s % 128 == 0 else s
    return bk


def prefill_smem_bytes(hs: int, bk: int, cache_dtype) -> int:
    """Shared memory of the prefill kernel a cache of `cache_dtype` takes at
    head size hs (csrc/attention.cu: TcLayout for bf16 and int8,
    prefill_smem_bytes for fp32), at the compiled head size HS =
    prefill_head_size(hs). The tensor-core kernel's does not depend on the
    block: a ring of _TC_STAGES stages, each a K and a V tile of 64 rows as
    copied (bf16 rows of HS rounded up to 16, in a power of two of 16-byte
    chunks, or int8 rows of HS bytes and the two tiles' fp32 row scales), and
    on int8 the two tiles widened to bf16. The fp32 kernel holds its 64 query
    rows' scores over the block (rounded up to 64-row tiles) beside a q
    tile, a K/V tile and the softmax state."""
    hs = prefill_head_size(hs)
    if cache_dtype == torch.float32:
        cols = -(-bk // _PF_TILE) * _PF_TILE
        return 4 * (_PF_ROWS * hs + _PF_TILE * (hs + 1) + _PF_ROWS * (cols + 1) + 3 * _PF_ROWS)
    chunks = 1 << (-(-hs // 16) * 2 - 1).bit_length()  # 16-byte chunks of a bf16 row
    wide = _PF_TILE * chunks * 16
    if cache_dtype == torch.int8:
        return _TC_STAGES * (2 * _PF_TILE * hs + 2 * _PF_TILE * 4) + 2 * wide
    return _TC_STAGES * 2 * wide


def check_prefill_block(hs: int, bk: int, cache_dtype) -> None:
    """The prefill kernel's shared memory fits a CTA (`prefill_smem_bytes`):
    on an fp32 cache it bounds the block, on bf16 and int8 it never does."""
    need = prefill_smem_bytes(hs, bk, cache_dtype)
    if need > SMEM_PER_CTA:
        raise ValueError(f"prefill attention at a KV block of {bk} rows needs {need} bytes of "
                         f"shared memory, more than {SMEM_PER_CTA}")


_PREFILL_ENTRY = {torch.bfloat16: "", torch.int8: "_int8", torch.float32: "_f32"}


def _quant_rows(x):
    """Rowwise (last-axis) int8 quantization of fp32 x as the JAX kernels'
    _quant_rows_i8 (attention.py:88-93): scale = max|x| * (1/127), 1 where
    zero; returns (round(x / scale) as fp32 integers, scale like x[...,
    :1])."""
    sc = x.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0)
    sc = torch.where(sc == 0, torch.ones_like(sc), sc)
    return torch.round(x / sc), sc


def _int_dot(a, b):
    """a @ b of integer-valued fp32 operands, exact (in fp64): the int32
    dots of the kernels."""
    return (a.double() @ b.double()).float()


def _online_softmax_pv(scores, v, live_block, bk: int, pv_fn):
    """The blocked online softmax of the JAX kernels over the last axis of
    fp32 `scores` (..., S) (masked entries hold MASK_VALUE) against v
    (..., S, HS) in fp32: blocks of bk rows, each taken where live_block(i0)
    (a mask broadcastable to scores[..., :1]) holds; pv_fn(p, v_block, i0)
    gives a block's fp32 PV term from its fp32 probabilities p. Returns the
    running max, l and the unnormalized fp32 sum, as the kernels keep
    them."""
    s = scores.shape[-1]
    shape = scores.shape[:-1] + (1,)
    m = torch.full(shape, float("-inf"), device=scores.device)
    l = torch.zeros(shape, device=scores.device)
    acc = torch.zeros(scores.shape[:-1] + (v.shape[-1],), device=scores.device)
    for i0 in range(0, s, bk):
        sb = scores[..., i0:i0 + bk]
        m_next = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(sb - m_next)
        live = live_block(i0)
        l = torch.where(live, alpha * l + p.sum(dim=-1, keepdim=True), l)
        pv = pv_fn(p, v[..., i0:i0 + bk, :], i0)
        acc = torch.where(live, acc * alpha + pv, acc)
        m = torch.where(live, m_next, m)
    return m, l, acc


def _check_shapes(q, k_cache, v_cache, layer):
    bsz, n_layers, kvh, s, hs = check_cache(k_cache, v_cache)
    h = q.shape[-2]
    if h % kvh:
        raise ValueError(f"{h} query heads not a multiple of {kvh} KV heads")
    if q.shape[-1] != hs:
        raise ValueError(f"q head size {q.shape[-1]} != cache head size {hs}")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range [0, {n_layers})")
    return bsz, n_layers, kvh, s, hs, h


# ---------------------------------------------------------------------------
# K1: decode


def attention_decode_plain(q, k_cache, v_cache, layer: int, pos, k_cur, v_cur, k_scale=None,
                           v_scale=None, *, block: int | None = None):
    """Plain version of `attention_decode`: the JAX decode kernel's math
    (attention.py:244-395) with its KV blocks of `block` rows (default:
    `decode_block`, K1's and K5's); the current row folds in last with an
    fp32 probability."""
    b, h, hs = q.shape
    kvh, s = k_cache.shape[2], k_cache.shape[3]
    m = h // kvh
    scale = 1.0 / math.sqrt(hs)
    quantized = k_cache.dtype == torch.int8
    bk = block or decode_block(s, quantized)
    qs = q.reshape(b, kvh, m, hs)
    col = torch.arange(s, device=q.device)
    pos4 = pos[:, None, None, None]
    cur = torch.einsum("bgmd,bgd->bgm", qs.float(), k_cur.to(q.dtype).float())[..., None] * scale
    if quantized:
        # int8 dots (attention.py:300-357): q and each block's p * vs by row
        qi, sq = _quant_rows(qs.float())
        scores = (_int_dot(qi, k_cache[:, layer].float().transpose(-1, -2)) * (sq * scale)
                  * k_scale[:, layer][:, :, None, :])
        vs = v_scale[:, layer][:, :, None, :]  # (B, KVH, 1, S)

        def pv_fn(p, vb, i0):
            pi, sp = _quant_rows(p * vs[..., i0:i0 + bk])
            return _int_dot(pi, vb) * sp
    else:
        kc = k_cache[:, layer].float()  # (B, KVH, S, HS)
        scores = torch.einsum("bgmd,bgsd->bgms", qs.to(k_cache.dtype).float(), kc) * scale

        def pv_fn(p, vb, i0):
            return p.to(v_cache.dtype).float() @ vb
    if v_cache.dtype == torch.float32:
        # unrounded probabilities: the one-pass softmax is the same math
        att = torch.softmax(torch.cat([scores.masked_fill(col >= pos4, float("-inf")), cur],
                                      dim=-1), dim=-1)
        out = torch.einsum("bgms,bgsd->bgmd", att[..., :s], v_cache[:, layer])
        out = out + att[..., s:] * v_cur.float()[:, :, None, :]
        return out.reshape(b, h, hs).to(q.dtype)
    scores = torch.where(col < pos4, scores, MASK_VALUE)
    m_h, l_h, acc = _online_softmax_pv(
        scores, v_cache[:, layer].float(), lambda i0: i0 < pos4, bk, pv_fn)
    m_next = torch.maximum(m_h, cur)
    alpha = torch.exp(m_h - m_next)
    p_cur = torch.exp(cur - m_next)
    l = alpha * l_h + p_cur
    out = acc * alpha + p_cur * v_cur.float()[:, :, None, :]
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(b, h, hs).to(q.dtype)


def _act_dtype(x, k_cache, quantized: bool):
    """The dtype of q, the current rows and the output: the cache's, or on
    an int8 cache x's own (fp32 or bf16)."""
    dt = x.dtype if quantized else k_cache.dtype
    if dt not in _DTYPES:
        raise TypeError(f"attention takes fp32 or bf16 activations, got {dt}")
    return dt


def check_slot_rows(name: str, t: torch.Tensor, shape, dtype, device) -> int:
    """Validate a decode operand (B, heads, HS) whose heads of one slot are
    contiguous, with any slot stride (a column slice of a flat QKV row, read
    in place); returns the slot stride in elements."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, cache on {device}")
    heads, hs = shape[1], shape[2]
    if t.stride(2) != 1 or t.stride(1) != hs or (shape[0] > 1 and t.stride(0) < heads * hs):
        raise ValueError(f"{name}: a slot's heads must be contiguous, got strides {t.stride()}")
    return t.stride(0) if shape[0] > 1 else heads * hs


def attention_decode(q, k_cache, v_cache, layer: int, pos, k_cur, v_cur, k_scale=None,
                     v_scale=None):
    """One-token GQA attention for each slot: q (B, H, HS) over rows
    0..pos[b]-1 of layer `layer` of the cache (B, L, KVH, S, HS), plus the
    current k_cur/v_cur (B, KVH, HS) row folded in last (pos[b] == 0 means
    the current row only). An int8 cache comes with its scale planes
    k_scale/v_scale (B, L, KVH, S). Returns (B, H, HS) in q's dtype. q,
    k_cur and v_cur may be column slices of the flat QKV projection (B,
    (H + 2 KVH) HS) viewed as heads: the kernel reads them in place through
    their slot strides (k_cur's and v_cur's must be equal).
    Replaces hip_llama_tpu/ops/attention.py::attention_decode_pallas (all
    of its bfold/bvec/dyn schedules compute this one function)."""
    bsz, _, kvh, s, hs, h = _check_shapes(q, k_cache, v_cache, layer)
    quantized = check_scales(k_cache, k_scale, v_scale)
    dev = k_cache.device
    if dev.type == "cpu":
        return attention_decode_plain(q, k_cache, v_cache, layer, pos, k_cur, v_cur, k_scale,
                                      v_scale)
    if dev.type != "cuda":
        raise ValueError(f"attention_decode: unsupported device {dev}")
    check_head_size("attention_decode", hs)
    dt = _act_dtype(q, k_cache, quantized)
    q_bs = check_slot_rows("q", q, (bsz, h, hs), dt, dev)
    cur_bs = check_slot_rows("k_cur", k_cur, (bsz, kvh, hs), dt, dev)
    if check_slot_rows("v_cur", v_cur, (bsz, kvh, hs), dt, dev) != cur_bs:
        raise ValueError(f"k_cur and v_cur: slot strides {k_cur.stride(0)} and "
                         f"{v_cur.stride(0)} differ")
    check_operand("pos", pos, (bsz,), torch.int32, dev)
    out = torch.empty((bsz, h, hs), dtype=dt, device=dev)
    bk = decode_block(s, quantized)
    if quantized:
        fn = _build.bind("attention", "attention_decode_int8", "ppppppppp" + "i" * 11 + "p")
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), pos.data_ptr(), k_cur.data_ptr(), v_cur.data_ptr(),
                out.data_ptr(), bsz, h, kvh, s, hs, k_cache.shape[1], layer, q_bs, cur_bs,
                _DTYPES[dt], bk, _stream())
    else:
        fn = _build.bind("attention", "attention_decode", "ppppppp" + "i" * 11 + "p")
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
                k_cur.data_ptr(), v_cur.data_ptr(), out.data_ptr(),
                bsz, h, kvh, s, hs, k_cache.shape[1], layer, q_bs, cur_bs, _DTYPES[dt], bk,
                _stream())
    _build.check(rc, "attention", "attention_decode")
    _count(attention_decode, quantized)
    return out


attention_decode.launches = 0
attention_decode.launches_int8 = 0


# ---------------------------------------------------------------------------
# K5: decode over the head-split QKV projection


def _split_qkv(qkv, n_heads: int, kvh: int):
    return qkv[:, :n_heads], qkv[:, n_heads:n_heads + kvh], qkv[:, n_heads + kvh:]


def attention_decode_fused_plain(qkv, k_cache, v_cache, layer: int, pos, n_heads: int,
                                 k_scale=None, v_scale=None, *, block: int | None = None):
    """Plain version of `attention_decode_fused`: K1's plain version on the
    three head blocks of qkv, with KV blocks of `block` rows (default:
    `decode_block`)."""
    q, k_cur, v_cur = _split_qkv(qkv, n_heads, k_cache.shape[2])
    return attention_decode_plain(q, k_cache, v_cache, layer, pos, k_cur, v_cur, k_scale,
                                  v_scale, block=block)


def attention_decode_fused(qkv, k_cache, v_cache, layer: int, pos, n_heads: int, k_scale=None,
                           v_scale=None):
    """`attention_decode` with its operands read in place from the
    head-split QKV projection qkv (B, H + 2 KVH, HS): q = rows 0..H-1,
    k_cur = rows H..H+KVH-1, v_cur = the rest. An int8 cache comes with its
    scale planes. Returns (B, H, HS) in qkv's dtype. Replaces
    hip_llama_tpu/ops/attention.py::attention_decode_fused."""
    bsz, n_layers, kvh, s, hs = check_cache(k_cache, v_cache)
    quantized = check_scales(k_cache, k_scale, v_scale)
    h = n_heads
    dev = k_cache.device
    if qkv.dim() != 3 or qkv.shape[1] != h + 2 * kvh or qkv.shape[2] != hs:
        raise ValueError(f"qkv: expected (B, {h} + 2 x {kvh}, {hs}), got {tuple(qkv.shape)}")
    if dev.type == "cpu":
        return attention_decode_fused_plain(qkv, k_cache, v_cache, layer, pos, n_heads, k_scale,
                                            v_scale)
    if dev.type != "cuda":
        raise ValueError(f"attention_decode_fused: unsupported device {dev}")
    if h % kvh or not 0 <= layer < n_layers:
        raise ValueError(f"{h} query heads over {kvh} KV heads, layer {layer} of {n_layers}")
    check_head_size("attention_decode_fused", hs)
    dt = _act_dtype(qkv, k_cache, quantized)
    check_operand("qkv", qkv, (bsz, h + 2 * kvh, hs), dt, dev)
    check_operand("pos", pos, (bsz,), torch.int32, dev)
    out = torch.empty((bsz, h, hs), dtype=dt, device=dev)
    bk = decode_block(s, quantized)
    if quantized:
        fn = _build.bind("attention", "attention_decode_fused_int8", "ppppppp" + "iiiiiiiii" + "p")
        rc = fn(qkv.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), pos.data_ptr(), out.data_ptr(), bsz, h, kvh, s, hs,
                n_layers, layer, _DTYPES[dt], bk, _stream())
    else:
        fn = _build.bind("attention", "attention_decode_fused", "ppppp" + "iiiiiiiii" + "p")
        rc = fn(qkv.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
                out.data_ptr(), bsz, h, kvh, s, hs, n_layers, layer, _DTYPES[dt], bk, _stream())
    _build.check(rc, "attention", "attention_decode_fused")
    _count(attention_decode_fused, quantized)
    return out


attention_decode_fused.launches = 0
attention_decode_fused.launches_int8 = 0


# ---------------------------------------------------------------------------
# K4: prefill


def attention_prefill_plain(q, k_cache, v_cache, layer: int, start, valid, k_scale=None,
                            v_scale=None, *, block: int | None = None):
    """Plain version of `attention_prefill`: the JAX prefill kernel's math
    (attention.py:743-940) with its KV blocks of `block` rows (default:
    `ref_block(S, 512)`, K4's)."""
    b, t, h, hs = q.shape
    kvh, s = k_cache.shape[2], k_cache.shape[3]
    m = h // kvh
    scale = 1.0 / math.sqrt(hs)
    quantized = k_cache.dtype == torch.int8
    # q in the cache dtype; bf16 for an int8 cache (attention.py:912)
    qs = q.reshape(b, t, kvh, m, hs).to(torch.bfloat16 if quantized else k_cache.dtype).float()
    scores = torch.einsum(
        "btgmd,bgsd->btgms", qs, k_cache[:, layer].float()
    ) * scale
    if quantized:
        scores = scores * k_scale[:, layer][:, None, :, None, :]
        vs = v_scale[:, layer][:, None, :, None, :]  # (B, 1, KVH, 1, S)

        def pv_fn(p, vb, i0):
            return (p * vs[..., i0:i0 + bk]).to(torch.bfloat16).float() @ vb
    else:
        def pv_fn(p, vb, i0):
            return p.to(v_cache.dtype).float() @ vb
    bk = block or ref_block(s, PREFILL_BLOCK)
    qpos = (start[:, None] + torch.arange(t, device=q.device)[None, :])[:, :, None, None, None]
    col = torch.arange(s, device=q.device)
    if v_cache.dtype == torch.float32:
        # unrounded probabilities: the one-pass softmax is the same math
        att = torch.softmax(scores.masked_fill(col > qpos, float("-inf")), dim=-1)
        out = torch.einsum("btgms,bgsd->btgmd", att, v_cache[:, layer])
        return out.reshape(b, t, h, hs).to(q.dtype)
    scores = torch.where(col <= qpos, scores, MASK_VALUE)
    _, l, acc = _online_softmax_pv(
        scores, v_cache[:, layer].float()[:, None], lambda i0: i0 <= qpos, bk, pv_fn)
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(b, t, h, hs).to(q.dtype)


def attention_prefill(q, k_cache, v_cache, layer: int, start, valid, k_scale=None,
                      v_scale=None):
    """Flash attention for a T-token chunk, q (B, T, H, HS), over layer
    `layer` of a cache that already holds the chunk's rows: query t of slot
    b sees cache rows 0..start[b]+t. Rows t >= valid[b] are unspecified
    (the kernel writes zeros there). An int8 cache comes with its scale
    planes. Returns (B, T, H, HS) in q's dtype. The cache's dtype picks the
    kernel: bf16 and int8 caches multiply on the tensor cores, an fp32 cache
    on the fp32 CUDA cores (the module's docstring). Replaces
    hip_llama_tpu/ops/attention.py::attention_prefill_pallas (T-major and
    head-major schedules alike)."""
    bsz, _, kvh, s, hs, h = _check_shapes(q, k_cache, v_cache, layer)
    quantized = check_scales(k_cache, k_scale, v_scale)
    dev = k_cache.device
    if dev.type == "cpu":
        return attention_prefill_plain(q, k_cache, v_cache, layer, start, valid, k_scale, v_scale)
    if dev.type != "cuda":
        raise ValueError(f"attention_prefill: unsupported device {dev}")
    check_head_size("attention_prefill", hs)
    t = q.shape[1]
    dt = _act_dtype(q, k_cache, quantized)
    check_operand("q", q, (bsz, t, h, hs), dt, dev)
    check_operand("start", start, (bsz,), torch.int32, dev)
    check_operand("valid", valid, (bsz,), torch.int32, dev)
    out = torch.empty_like(q)
    bk = ref_block(s, PREFILL_BLOCK)
    check_prefill_block(hs, bk, k_cache.dtype)
    entry = "attention_prefill" + _PREFILL_ENTRY[k_cache.dtype]
    dims = (bsz, t, h, kvh, s, hs, k_cache.shape[1], layer, _DTYPES[dt], bk)
    if quantized:
        fn = _build.bind("attention", entry, "pppppppp" + "iiiiiiiiii" + "p")
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), start.data_ptr(), valid.data_ptr(), out.data_ptr(), *dims,
                _stream())
    else:
        fn = _build.bind("attention", entry, "pppppp" + "iiiiiiiiii" + "p")
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), start.data_ptr(),
                valid.data_ptr(), out.data_ptr(), *dims, _stream())
    _build.check(rc, "attention", entry)
    _count(attention_prefill, quantized)
    return out


attention_prefill.launches = 0
attention_prefill.launches_int8 = 0


# ---------------------------------------------------------------------------
# K6 and K7: decode and prefill over the paged pool


def gather_pages(pages, page_table, layer: int):
    """Layer `layer` of the pool's plane (L, KVH, P, PS, ...) as each slot's
    rows in order, (B, 1, KVH, MAX_PAGES * PS, ...): a dense cache of one
    layer for the plain versions."""
    g = pages[layer][:, page_table.long()]  # (KVH, B, MAX_PAGES, PS, ...)
    b, n = page_table.shape
    return g.transpose(0, 1).reshape(b, g.shape[0], n * g.shape[3], *g.shape[4:])[:, None]


def _gathered(k_pages, v_pages, page_table, layer, k_scale, v_scale):
    planes = [gather_pages(x, page_table, layer) for x in (k_pages, v_pages)]
    if k_scale is None:
        return planes + [None, None]
    return planes + [gather_pages(x, page_table, layer) for x in (k_scale, v_scale)]


def _check_paged(q, k_pages, v_pages, page_table, layer: int, k_scale, v_scale):
    """Validate the paged operands; returns (L, KVH, P, PS, HS, H,
    MAX_PAGES, quantized)."""
    n_layers, kvh, n_pages, ps, hs = check_pages(k_pages, v_pages)
    quantized = check_scales(k_pages, k_scale, v_scale)
    h = q.shape[-2]
    if h % kvh:
        raise ValueError(f"{h} query heads not a multiple of {kvh} KV heads")
    if q.shape[-1] != hs:
        raise ValueError(f"q head size {q.shape[-1]} != page head size {hs}")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range [0, {n_layers})")
    if page_table.dim() != 2 or page_table.shape[0] != q.shape[0]:
        raise ValueError(f"page_table: expected ({q.shape[0]}, MAX_PAGES), got "
                         f"{tuple(page_table.shape)}")
    return n_layers, kvh, n_pages, ps, hs, h, page_table.shape[1], quantized


def attention_decode_paged_plain(q, k_pages, v_pages, page_table, layer: int, pos, k_cur, v_cur,
                                 k_scale=None, v_scale=None, *, block: int | None = None):
    """Plain version of `attention_decode_paged`: K1's plain math over the
    slot's gathered pages, with KV blocks of `block` rows (default: the
    page, the JAX kernel's block)."""
    kg, vg, ksg, vsg = _gathered(k_pages, v_pages, page_table, layer, k_scale, v_scale)
    return attention_decode_plain(q, kg, vg, 0, pos, k_cur, v_cur, ksg, vsg,
                                  block=block or k_pages.shape[3])


def attention_decode_paged(q, k_pages, v_pages, page_table, layer: int, pos, k_cur, v_cur,
                           k_scale=None, v_scale=None):
    """`attention_decode` over the paged pool: q (B, H, HS) over rows
    0..pos[b]-1 of slot b, row r in page page_table[b, r // PS] of layer
    `layer` of the pool (L, KVH, P, PS, HS), then the current k_cur/v_cur
    (B, KVH, HS) row. int8 pages come with their scale planes (L, KVH, P,
    PS). Returns (B, H, HS) in q's dtype. Replaces hip_llama_tpu/ops/
    attention.py::attention_decode_paged."""
    _, kvh, n_pages, ps, hs, h, max_pages, quantized = _check_paged(
        q, k_pages, v_pages, page_table, layer, k_scale, v_scale)
    dev = k_pages.device
    if dev.type == "cpu":
        return attention_decode_paged_plain(q, k_pages, v_pages, page_table, layer, pos, k_cur,
                                            v_cur, k_scale, v_scale)
    if dev.type != "cuda":
        raise ValueError(f"attention_decode_paged: unsupported device {dev}")
    check_head_size("attention_decode_paged", hs)
    bsz = q.shape[0]
    dt = _act_dtype(q, k_pages, quantized)
    check_operand("q", q, (bsz, h, hs), dt, dev)
    check_operand("k_cur", k_cur, (bsz, kvh, hs), dt, dev)
    check_operand("v_cur", v_cur, (bsz, kvh, hs), dt, dev)
    check_operand("pos", pos, (bsz,), torch.int32, dev)
    check_table(page_table, bsz, dev)
    out = torch.empty_like(q)
    dims = (bsz, h, kvh, n_pages, ps, max_pages, hs, layer, _DTYPES[dt], ps)
    if quantized:
        fn = _build.bind("attention", "attention_decode_paged_int8", "p" * 10 + "i" * 10 + "p")
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), page_table.data_ptr(), pos.data_ptr(), k_cur.data_ptr(),
                v_cur.data_ptr(), out.data_ptr(), *dims, _stream())
    else:
        fn = _build.bind("attention", "attention_decode_paged", "p" * 8 + "i" * 10 + "p")
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
                pos.data_ptr(), k_cur.data_ptr(), v_cur.data_ptr(), out.data_ptr(), *dims,
                _stream())
    _build.check(rc, "attention", "attention_decode_paged")
    _count(attention_decode_paged, quantized)
    return out


attention_decode_paged.launches = 0
attention_decode_paged.launches_int8 = 0


def attention_prefill_paged_plain(q, k_pages, v_pages, page_table, layer: int, start, valid,
                                  k_scale=None, v_scale=None, *, block: int | None = None):
    """Plain version of `attention_prefill_paged`: K4's plain math over the
    slots' gathered pages with KV blocks of `block` rows (default: the
    page). Its cast points are those of the JAX paged kernel's body,
    _prefill_kernel (attention.py:743-841), which K4's T-major body shares
    (tests/test_torch_paged.py)."""
    kg, vg, ksg, vsg = _gathered(k_pages, v_pages, page_table, layer, k_scale, v_scale)
    return attention_prefill_plain(q, kg, vg, 0, start, valid, ksg, vsg,
                                   block=block or k_pages.shape[3])


def attention_prefill_paged(q, k_pages, v_pages, page_table, layer: int, start, valid,
                            k_scale=None, v_scale=None):
    """`attention_prefill` over the paged pool: a chunk q (B, T, H, HS) whose
    rows are already written; query t of slot b sees rows 0..start[b]+t,
    row r in page page_table[b, r // PS] of layer `layer`. Rows t >=
    valid[b] are unspecified (the kernel writes zeros there). int8 pages
    come with their scale planes. Returns (B, T, H, HS) in q's dtype. The
    pages' dtype picks the kernel, as `attention_prefill`'s. Replaces
    hip_llama_tpu/ops/attention.py::attention_prefill_paged."""
    _, kvh, n_pages, ps, hs, h, max_pages, quantized = _check_paged(
        q, k_pages, v_pages, page_table, layer, k_scale, v_scale)
    dev = k_pages.device
    if dev.type == "cpu":
        return attention_prefill_paged_plain(q, k_pages, v_pages, page_table, layer, start, valid,
                                             k_scale, v_scale)
    if dev.type != "cuda":
        raise ValueError(f"attention_prefill_paged: unsupported device {dev}")
    check_head_size("attention_prefill_paged", hs)
    bsz, t = q.shape[:2]
    dt = _act_dtype(q, k_pages, quantized)
    check_operand("q", q, (bsz, t, h, hs), dt, dev)
    check_operand("start", start, (bsz,), torch.int32, dev)
    check_operand("valid", valid, (bsz,), torch.int32, dev)
    check_table(page_table, bsz, dev)
    out = torch.empty_like(q)
    check_prefill_block(hs, ps, k_pages.dtype)
    entry = "attention_prefill_paged" + _PREFILL_ENTRY[k_pages.dtype]
    dims = (bsz, t, h, kvh, n_pages, ps, max_pages, hs, layer, _DTYPES[dt], ps)
    if quantized:
        fn = _build.bind("attention", entry, "p" * 9 + "i" * 11 + "p")
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), page_table.data_ptr(), start.data_ptr(), valid.data_ptr(),
                out.data_ptr(), *dims, _stream())
    else:
        fn = _build.bind("attention", entry, "p" * 7 + "i" * 11 + "p")
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
                start.data_ptr(), valid.data_ptr(), out.data_ptr(), *dims, _stream())
    _build.check(rc, "attention", entry)
    _count(attention_prefill_paged, quantized)
    return out


attention_prefill_paged.launches = 0
attention_prefill_paged.launches_int8 = 0

"""GQA attention over the KV cache: one-token decode (K1), the same decode
reading the head-split QKV projection in place (K5), and chunked prefill
(K4).

Each is a CUDA kernel (csrc/attention.cu) behind a wrapper that checks its
operands, allocates the output and counts its launches in
`<wrapper>.launches`. A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain PyTorch version beside it, which is also the
yardstick the kernel is held against on the card.

Cast points, as in the JAX kernels (hip_llama_tpu/ops/attention.py:164-241
and :912-940): q is cast to the cache dtype before QK; scores and the
softmax state are fp32; the online softmax's unnormalized probabilities
exp(s - running max) are cast to the V dtype before PV, and the sum is
divided by l at the end; the output is cast to q's dtype. Supported head
sizes: 8, 16, 32, 64, 128.

With a bf16 cache the rounded probabilities depend on where the running
max is taken, so the plain versions walk a bf16 cache in the JAX kernels'
KV blocks (`ref_block`; an fp32 cache takes the one-pass softmax, the same
math), and so do the CUDA kernels where such a block fits
their 64-row tiles (`kernel_block`); past that they agree to a bf16 ulp.
"""

from __future__ import annotations

import math

import torch

from hip_llama_tpu_torch.ops import _build
from hip_llama_tpu_torch.ops.cache import _DTYPES, _stream, check_cache, check_operand

HEAD_SIZES = (8, 16, 32, 64, 128)
MAX_KV_MUL = 8  # query heads per KV head the decode kernel holds in registers
# the JAX kernels' masked score (attention.py:40): finite, so a fully
# masked row of a block gives p = 0 and leaves the running max alone
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
DECODE_BLOCK = 1024  # the JAX decode kernels' KV block target
PREFILL_BLOCK = 512  # the JAX prefill kernels' KV block target
KERNEL_TILE = 64  # cache rows per tile of the CUDA kernels (csrc/attention.cu)


def ref_block(s: int, target: int) -> int:
    """The KV block the JAX kernels take for a cache of s rows
    (attention.py:736-740)."""
    for bk in (target, 128, 64, 32, 16, 8):
        if bk <= s and s % bk == 0:
            return bk
    return s


def kernel_block(s: int, target: int) -> int:
    """Cache rows per online-softmax block of the CUDA kernels: the JAX
    kernels' block where it fits the kernels' 64-row tiles, else 64."""
    return min(ref_block(s, target), KERNEL_TILE)


def _online_softmax_pv(scores, v, live_block, v_dtype, bk: int):
    """The blocked online softmax of the JAX kernels over the last axis of
    fp32 `scores` (..., S) (masked entries hold MASK_VALUE) against v
    (..., S, HS) in fp32: blocks of bk rows, each taken where live_block(i0)
    (a mask broadcastable to scores[..., :1]) holds. Returns the running
    max, l and the unnormalized fp32 sum, as the kernels keep them."""
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
        pv = p.to(v_dtype).float() @ v[..., i0:i0 + bk, :]
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


def attention_decode_plain(q, k_cache, v_cache, layer: int, pos, k_cur, v_cur):
    """Plain version of `attention_decode`: the JAX decode kernel's math
    (attention.py:244-395) with its KV blocks; the current row folds in
    last with an fp32 probability."""
    b, h, hs = q.shape
    kvh, s = k_cache.shape[2], k_cache.shape[3]
    m = h // kvh
    scale = 1.0 / math.sqrt(hs)
    qs = q.reshape(b, kvh, m, hs)
    kc = k_cache[:, layer].float()  # (B, KVH, S, HS)
    scores = torch.einsum("bgmd,bgsd->bgms", qs.to(k_cache.dtype).float(), kc) * scale
    col = torch.arange(s, device=q.device)
    pos4 = pos[:, None, None, None]
    cur = torch.einsum("bgmd,bgd->bgm", qs.float(), k_cur.to(q.dtype).float())[..., None] * scale
    if v_cache.dtype == torch.float32:
        # unrounded probabilities: the one-pass softmax is the same math
        att = torch.softmax(torch.cat([scores.masked_fill(col >= pos4, float("-inf")), cur],
                                      dim=-1), dim=-1)
        out = torch.einsum("bgms,bgsd->bgmd", att[..., :s], v_cache[:, layer])
        out = out + att[..., s:] * v_cur.float()[:, :, None, :]
        return out.reshape(b, h, hs).to(q.dtype)
    scores = torch.where(col < pos4, scores, MASK_VALUE)
    m_h, l_h, acc = _online_softmax_pv(
        scores, v_cache[:, layer].float(), lambda i0: i0 < pos4, v_cache.dtype,
        ref_block(s, DECODE_BLOCK))
    m_next = torch.maximum(m_h, cur)
    alpha = torch.exp(m_h - m_next)
    p_cur = torch.exp(cur - m_next)
    l = alpha * l_h + p_cur
    out = acc * alpha + p_cur * v_cur.float()[:, :, None, :]
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(b, h, hs).to(q.dtype)


def attention_decode(q, k_cache, v_cache, layer: int, pos, k_cur, v_cur):
    """One-token GQA attention for each slot: q (B, H, HS) over rows
    0..pos[b]-1 of layer `layer` of the cache (B, L, KVH, S, HS), plus the
    current k_cur/v_cur (B, KVH, HS) row folded in last (pos[b] == 0 means
    the current row only). Returns (B, H, HS) in q's dtype. Replaces
    hip_llama_tpu/ops/attention.py::attention_decode_pallas (all of its
    bfold/bvec/dyn schedules compute this one function)."""
    bsz, _, kvh, s, hs, h = _check_shapes(q, k_cache, v_cache, layer)
    dev = k_cache.device
    if dev.type == "cpu":
        return attention_decode_plain(q, k_cache, v_cache, layer, pos, k_cur, v_cur)
    if dev.type != "cuda":
        raise ValueError(f"attention_decode: unsupported device {dev}")
    if hs not in HEAD_SIZES or h // kvh > MAX_KV_MUL:
        raise ValueError(f"attention_decode takes head sizes {HEAD_SIZES} and up to "
                         f"{MAX_KV_MUL} query heads per KV head, got {hs} and {h // kvh}")
    dt = k_cache.dtype
    check_operand("q", q, (bsz, h, hs), dt, dev)
    check_operand("k_cur", k_cur, (bsz, kvh, hs), dt, dev)
    check_operand("v_cur", v_cur, (bsz, kvh, hs), dt, dev)
    check_operand("pos", pos, (bsz,), torch.int32, dev)
    out = torch.empty_like(q)
    fn = _build.bind("attention", "attention_decode", "ppppppp" + "iiiiiiiii" + "p")
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
            k_cur.data_ptr(), v_cur.data_ptr(), out.data_ptr(),
            bsz, h, kvh, s, hs, k_cache.shape[1], layer, _DTYPES[dt],
            kernel_block(s, DECODE_BLOCK), _stream())
    _build.check(rc, "attention", "attention_decode")
    attention_decode.launches += 1
    return out


attention_decode.launches = 0


# ---------------------------------------------------------------------------
# K5: decode over the head-split QKV projection


def _split_qkv(qkv, n_heads: int, kvh: int):
    return qkv[:, :n_heads], qkv[:, n_heads:n_heads + kvh], qkv[:, n_heads + kvh:]


def attention_decode_fused_plain(qkv, k_cache, v_cache, layer: int, pos, n_heads: int):
    """Plain version of `attention_decode_fused`: K1's plain version on the
    three head blocks of qkv."""
    q, k_cur, v_cur = _split_qkv(qkv, n_heads, k_cache.shape[2])
    return attention_decode_plain(q, k_cache, v_cache, layer, pos, k_cur, v_cur)


def attention_decode_fused(qkv, k_cache, v_cache, layer: int, pos, n_heads: int):
    """`attention_decode` with its operands read in place from the
    head-split QKV projection qkv (B, H + 2 KVH, HS): q = rows 0..H-1,
    k_cur = rows H..H+KVH-1, v_cur = the rest. Returns (B, H, HS) in qkv's
    dtype. Replaces hip_llama_tpu/ops/attention.py::attention_decode_fused."""
    bsz, n_layers, kvh, s, hs = check_cache(k_cache, v_cache)
    h = n_heads
    dev = k_cache.device
    if qkv.dim() != 3 or qkv.shape[1] != h + 2 * kvh or qkv.shape[2] != hs:
        raise ValueError(f"qkv: expected (B, {h} + 2 x {kvh}, {hs}), got {tuple(qkv.shape)}")
    if dev.type == "cpu":
        return attention_decode_fused_plain(qkv, k_cache, v_cache, layer, pos, n_heads)
    if dev.type != "cuda":
        raise ValueError(f"attention_decode_fused: unsupported device {dev}")
    if h % kvh or not 0 <= layer < n_layers:
        raise ValueError(f"{h} query heads over {kvh} KV heads, layer {layer} of {n_layers}")
    if hs not in HEAD_SIZES or h // kvh > MAX_KV_MUL:
        raise ValueError(f"attention_decode_fused takes head sizes {HEAD_SIZES} and up to "
                         f"{MAX_KV_MUL} query heads per KV head, got {hs} and {h // kvh}")
    dt = k_cache.dtype
    check_operand("qkv", qkv, (bsz, h + 2 * kvh, hs), dt, dev)
    check_operand("pos", pos, (bsz,), torch.int32, dev)
    out = torch.empty((bsz, h, hs), dtype=dt, device=dev)
    fn = _build.bind("attention", "attention_decode_fused", "ppppp" + "iiiiiiiii" + "p")
    rc = fn(qkv.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
            out.data_ptr(), bsz, h, kvh, s, hs, n_layers, layer, _DTYPES[dt],
            kernel_block(s, DECODE_BLOCK), _stream())
    _build.check(rc, "attention", "attention_decode_fused")
    attention_decode_fused.launches += 1
    return out


attention_decode_fused.launches = 0


# ---------------------------------------------------------------------------
# K4: prefill


def attention_prefill_plain(q, k_cache, v_cache, layer: int, start, valid):
    """Plain version of `attention_prefill`: the JAX prefill kernel's math
    (attention.py:743-852) with its KV blocks."""
    b, t, h, hs = q.shape
    kvh, s = k_cache.shape[2], k_cache.shape[3]
    m = h // kvh
    scale = 1.0 / math.sqrt(hs)
    qs = q.reshape(b, t, kvh, m, hs).to(k_cache.dtype).float()
    scores = torch.einsum(
        "btgmd,bgsd->btgms", qs, k_cache[:, layer].float()
    ) * scale
    qpos = (start[:, None] + torch.arange(t, device=q.device)[None, :])[:, :, None, None, None]
    col = torch.arange(s, device=q.device)
    if v_cache.dtype == torch.float32:
        # unrounded probabilities: the one-pass softmax is the same math
        att = torch.softmax(scores.masked_fill(col > qpos, float("-inf")), dim=-1)
        out = torch.einsum("btgms,bgsd->btgmd", att, v_cache[:, layer])
        return out.reshape(b, t, h, hs).to(q.dtype)
    scores = torch.where(col <= qpos, scores, MASK_VALUE)
    _, l, acc = _online_softmax_pv(
        scores, v_cache[:, layer].float()[:, None], lambda i0: i0 <= qpos,
        v_cache.dtype, ref_block(s, PREFILL_BLOCK))
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(b, t, h, hs).to(q.dtype)


def attention_prefill(q, k_cache, v_cache, layer: int, start, valid):
    """Flash attention for a T-token chunk, q (B, T, H, HS), over layer
    `layer` of a cache that already holds the chunk's rows: query t of slot
    b sees cache rows 0..start[b]+t. Rows t >= valid[b] are unspecified
    (the kernel writes zeros there). Returns (B, T, H, HS) in q's dtype.
    Replaces hip_llama_tpu/ops/attention.py::attention_prefill_pallas
    (T-major and head-major schedules alike)."""
    bsz, _, kvh, s, hs, h = _check_shapes(q, k_cache, v_cache, layer)
    dev = k_cache.device
    if dev.type == "cpu":
        return attention_prefill_plain(q, k_cache, v_cache, layer, start, valid)
    if dev.type != "cuda":
        raise ValueError(f"attention_prefill: unsupported device {dev}")
    if hs not in HEAD_SIZES or 64 % (h // kvh):
        raise ValueError(f"attention_prefill takes head sizes {HEAD_SIZES} and a "
                         f"divisor of 64 query heads per KV head, got {hs} and {h // kvh}")
    t = q.shape[1]
    dt = k_cache.dtype
    check_operand("q", q, (bsz, t, h, hs), dt, dev)
    check_operand("start", start, (bsz,), torch.int32, dev)
    check_operand("valid", valid, (bsz,), torch.int32, dev)
    out = torch.empty_like(q)
    fn = _build.bind("attention", "attention_prefill", "pppppp" + "iiiiiiiiii" + "p")
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), start.data_ptr(),
            valid.data_ptr(), out.data_ptr(),
            bsz, t, h, kvh, s, hs, k_cache.shape[1], layer, _DTYPES[dt],
            kernel_block(s, PREFILL_BLOCK), _stream())
    _build.check(rc, "attention", "attention_prefill")
    attention_prefill.launches += 1
    return out


attention_prefill.launches = 0

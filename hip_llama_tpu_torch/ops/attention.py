"""GQA attention over the KV cache: one-token decode (K1) and chunked
prefill (K4).

Each is a CUDA kernel (csrc/attention.cu) behind a wrapper that checks its
operands, allocates the output and counts its launches in
`<wrapper>.launches`. A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain PyTorch version beside it, which is also the
yardstick the kernel is held against on the card.

Cast points, as in the JAX kernels (hip_llama_tpu/ops/attention.py:164-241
and :912-940): q is cast to the cache dtype before QK; scores and the
softmax state are fp32; probabilities are cast to the V dtype before PV;
the output is cast to q's dtype. Supported head sizes: 8, 16, 32, 64, 128.
"""

from __future__ import annotations

import math

import torch

from hip_llama_tpu_torch.ops import _build
from hip_llama_tpu_torch.ops.cache import _DTYPES, _stream, check_cache, check_operand

HEAD_SIZES = (8, 16, 32, 64, 128)
MAX_KV_MUL = 8  # query heads per KV head the decode kernel holds in registers


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
    """Plain version of `attention_decode`, following the XLA math of
    hip_llama_tpu/models/llama.py:506-597 with the kernel's cast points."""
    b, h, hs = q.shape
    kvh, s = k_cache.shape[2], k_cache.shape[3]
    m = h // kvh
    scale = 1.0 / math.sqrt(hs)
    qs = q.reshape(b, kvh, m, hs)
    kc = k_cache[:, layer].float()  # (B, KVH, S, HS)
    scores = torch.einsum("bgmd,bgsd->bgms", qs.to(k_cache.dtype).float(), kc) * scale
    hist = torch.arange(s, device=q.device)[None, None, None, :] < pos[:, None, None, None]
    scores = scores.masked_fill(~hist, float("-inf"))
    cur = torch.einsum(
        "bgmd,bgd->bgm", qs.float(), k_cur.to(q.dtype).float()
    ) * scale
    att = torch.softmax(torch.cat([scores, cur[..., None]], dim=-1), dim=-1)
    p_hist = att[..., :s].to(v_cache.dtype).float()
    out = torch.einsum("bgms,bgsd->bgmd", p_hist, v_cache[:, layer].float())
    out = out + att[..., s:] * v_cur.float()[:, :, None, :]
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
    fn = _build.bind("attention", "attention_decode", "ppppppp" + "iiiiiiii" + "p")
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
            k_cur.data_ptr(), v_cur.data_ptr(), out.data_ptr(),
            bsz, h, kvh, s, hs, k_cache.shape[1], layer, _DTYPES[dt], _stream())
    _build.check(rc, "attention", "attention_decode")
    attention_decode.launches += 1
    return out


attention_decode.launches = 0


# ---------------------------------------------------------------------------
# K4: prefill


def attention_prefill_plain(q, k_cache, v_cache, layer: int, start, valid):
    """Plain version of `attention_prefill`, following the XLA math of
    hip_llama_tpu/models/llama.py:1093-1130 with the kernel's cast points."""
    b, t, h, hs = q.shape
    kvh, s = k_cache.shape[2], k_cache.shape[3]
    m = h // kvh
    scale = 1.0 / math.sqrt(hs)
    qs = q.reshape(b, t, kvh, m, hs).to(k_cache.dtype).float()
    scores = torch.einsum(
        "btgmd,bgsd->btgms", qs, k_cache[:, layer].float()
    ) * scale
    qpos = start[:, None] + torch.arange(t, device=q.device)[None, :]  # (B, T)
    live = torch.arange(s, device=q.device)[None, None, :] <= qpos[:, :, None]
    scores = scores.masked_fill(~live[:, :, None, None, :], float("-inf"))
    att = torch.softmax(scores, dim=-1).to(v_cache.dtype).float()
    out = torch.einsum("btgms,bgsd->btgmd", att, v_cache[:, layer].float())
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
    fn = _build.bind("attention", "attention_prefill", "pppppp" + "iiiiiiiii" + "p")
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), start.data_ptr(),
            valid.data_ptr(), out.data_ptr(),
            bsz, t, h, kvh, s, hs, k_cache.shape[1], layer, _DTYPES[dt], _stream())
    _build.check(rc, "attention", "attention_prefill")
    attention_prefill.launches += 1
    return out


attention_prefill.launches = 0

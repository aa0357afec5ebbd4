"""One whole Q8_0 decoder layer of a decode step in one kernel (K23):
QKV (rmsnorm prologue, RoPE epilogue) -> decode attention over the cache ->
Wo with the residual -> the FFN with its rmsnorm and residual.

The kernel (csrc/layer_fused.cu) runs the tasks of q8_matmul, attention_
decode_fused and q8_matmul_ffn on a persistent grid with grid-wide barriers
between the phases, with the same plans as those kernels, so the layer
rounds exactly as the four of them in a row. The wrapper checks its
operands, allocates the output and the workspaces, and counts its launches
in `q8_layer_fused.launches`; a CUDA tensor launches the kernel or raises,
a CPU tensor takes the plain version: the four plain versions in a row.
"""

from __future__ import annotations

import torch

from hip_llama_tpu_torch.ops import _build
from hip_llama_tpu_torch.ops import attention as _attn
from hip_llama_tpu_torch.ops import quant as _quant
from hip_llama_tpu_torch.ops.cache import _stream, check_cache, check_operand


def q8_layer_fused_plain(x, wqkv, wo, w13, w2, g1, g2, k_cache, v_cache, layer: int, pos, *,
                         n_heads: int, norm_eps: float = 1e-5, theta: float = 10000.0):
    """Plain version of `q8_layer_fused`."""
    b, d = x.shape
    kvh, hs = k_cache.shape[2], k_cache.shape[4]
    qkv = _quant.q8_matmul_plain(x, wqkv, norm_weight=g1, norm_eps=norm_eps, rope_pos=pos,
                                 rope_limit=(n_heads + kvh) * hs, rope_head=hs, rope_theta=theta)
    qkv3 = qkv.view(b, n_heads + 2 * kvh, hs)
    att = _attn.attention_decode_fused_plain(qkv3, k_cache, v_cache, layer, pos, n_heads)
    x2 = _quant.q8_matmul_plain(att.reshape(b, d), wo, residual=x)
    out = _quant.q8_matmul_ffn_plain(x2, w13, w2, x2, g2, norm_eps=norm_eps)
    return out, qkv3[:, n_heads:]


def q8_layer_fused(x, wqkv, wo, w13, w2, g1, g2, k_cache, v_cache, layer: int, pos, *,
                   n_heads: int, norm_eps: float = 1e-5, theta: float = 10000.0):
    """One decoder layer for the decode step's rows x (B, D) bf16 at
    positions pos (B,) int32 over layer `layer` of the bf16 cache (B, L,
    KVH, S, HS), which it reads and does not write. Weights in the fused
    layout: wqkv (D, (H + 2 KVH) HS), wo (D, D), w13 = W1|W3 (D, 2 HID), w2
    (HID, D); g1, g2 (D,) fp32. Returns (x_out (B, D), kv_rows (B, 2 KVH,
    HS)): the layer output and this step's k|v rows for the cache commit.
    Replaces hip_llama_tpu/ops/layer_fused.py::q8_layer_fused."""
    kw = dict(n_heads=n_heads, norm_eps=norm_eps, theta=theta)
    dev = _quant._device(x, "q8_layer_fused")
    if dev.type == "cpu":
        return q8_layer_fused_plain(x, wqkv, wo, w13, w2, g1, g2, k_cache, v_cache, layer, pos,
                                    **kw)
    bsz, n_layers, kvh, s, hs = check_cache(k_cache, v_cache)
    h = n_heads
    b, d = _quant._check_x("x", x)
    if b != bsz or d != h * hs or h % kvh or not 0 <= layer < n_layers:
        raise ValueError(f"x {tuple(x.shape)} against a cache {tuple(k_cache.shape)} with "
                         f"{h} heads, layer {layer}")
    if k_cache.dtype != torch.bfloat16:
        raise ValueError(f"q8_layer_fused takes a bf16 cache, got {k_cache.dtype}")
    if hs not in _attn.HEAD_SIZES or h // kvh > _attn.MAX_KV_MUL:
        raise ValueError(f"q8_layer_fused takes head sizes {_attn.HEAD_SIZES} and up to "
                         f"{_attn.MAX_KV_MUL} query heads per KV head, got {hs} and {h // kvh}")
    nqkv = (h + 2 * kvh) * hs
    if _quant._check_weight("wqkv", wqkv, d, dev) != nqkv:
        raise ValueError(f"wqkv: expected N {nqkv}, got {wqkv.q.shape[1]}")
    if _quant._check_weight("wo", wo, d, dev) != d:
        raise ValueError(f"wo: expected N {d}, got {wo.q.shape[1]}")
    hidden = _quant._check_weight("w13", w13, d, dev) // 2
    if hidden % 16 or _quant._check_weight("w2", w2, hidden, dev) != d:
        raise ValueError(f"w13 {tuple(w13.q.shape)} and w2 {tuple(w2.q.shape)} do not pair")
    for name, g in (("g1", g1), ("g2", g2)):
        check_operand(name, g, (d,), torch.float32, dev)
    check_operand("pos", pos, (b,), torch.int32, dev)
    (split_q, kslice_q), (split_o, kslice_o) = _quant.gemv_plan(d, nqkv), _quant.gemv_plan(d, d)
    nstrips = -(-hidden // _quant.FFN_STRIP)
    out, xn, att, x2 = (torch.empty((b, d), dtype=torch.bfloat16, device=dev) for _ in range(4))
    qkv = torch.empty((b, h + 2 * kvh, hs), dtype=torch.bfloat16, device=dev)
    part = torch.empty(max(split_q * b * nqkv, split_o * b * d, nstrips * b * d),
                       dtype=torch.float32, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    fn = _build.bind("layer_fused", "q8_layer_fused", "p" * 21 + "i" * 18 + "ff" + "p")
    rc = fn(x.data_ptr(), wqkv.q.data_ptr(), wqkv.s.data_ptr(), g1.data_ptr(), pos.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), wo.q.data_ptr(), wo.s.data_ptr(),
            w13.q.data_ptr(), w13.s.data_ptr(), w2.q.data_ptr(), w2.s.data_ptr(), g2.data_ptr(),
            out.data_ptr(), xn.data_ptr(), qkv.data_ptr(), att.data_ptr(), x2.data_ptr(),
            part.data_ptr(), bar.data_ptr(),
            b, d, h, kvh, s, hs, n_layers, layer, hidden, wqkv.group_size, wo.group_size,
            w13.group_size, w2.group_size, split_q, kslice_q, split_o, kslice_o,
            _attn.kernel_block(s, _attn.DECODE_BLOCK),
            _quant.rope_coef(theta, hs), norm_eps, _stream())
    _build.check(rc, "layer_fused", "q8_layer_fused")
    q8_layer_fused.launches += 1
    return out, qkv[:, h:]


q8_layer_fused.launches = 0

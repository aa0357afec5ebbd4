"""One whole Q8_0 decoder layer of a decode step in one kernel (K23):
QKV (rmsnorm prologue, RoPE epilogue) -> decode attention over the cache ->
Wo with the residual -> the FFN with its rmsnorm and residual.

The kernel (csrc/layer_fused.cu) runs the tasks of q8_matmul, attention_
decode_fused and q8_matmul_ffn on a persistent grid with grid-wide barriers
between the phases, with the same plans as those kernels (the four
products on the tensor-core GEMV at `gemv_plan`'s splits), so the layer
rounds exactly as the four of them in a row. The wrapper checks its
operands, allocates the output and the workspaces, and counts its launches
in `q8_layer_fused.launches` (bf16 cache) or `.launches_int8` (int8 cache
with its scale planes); a CUDA tensor launches the kernel or raises, a CPU
tensor takes the plain version: the four plain versions in a row, with the
attention at the layer's own KV block (`layer_block`).
"""

from __future__ import annotations

import torch

from hip_llama_tpu_torch.ops import _build
from hip_llama_tpu_torch.ops import attention as _attn
from hip_llama_tpu_torch.ops import quant as _quant
from hip_llama_tpu_torch.ops.cache import _count, _stream, check_cache, check_operand, check_scales


def layer_block(s: int, n_heads: int, kvh: int, hs: int, quantized: bool) -> int:
    """The KV block of the decode layer's attention over a cache of s rows.
    Where the JAX package's q8_layer_fused takes these heads (head size a
    multiple of 128, query and KV heads multiples of 8: layer_fused.py:
    407-420), its own block: 128 rows where s % 128 == 0, else s (:362-364),
    which also meets the int8 rule. Where it declines, the JAX step runs
    attention_decode_fused instead, and the port's layer, which does not
    decline, stands in for it with that kernel's block (`decode_block`)."""
    if hs % 128 == 0 and n_heads % 8 == 0 and kvh % 8 == 0:
        return 128 if s % 128 == 0 else s
    return _attn.decode_block(s, quantized)


def q8_layer_fused_plain(x, wqkv, wo, w13, w2, g1, g2, k_cache, v_cache, layer: int, pos,
                         k_scale=None, v_scale=None, *, n_heads: int, norm_eps: float = 1e-5,
                         theta: float = 10000.0):
    """Plain version of `q8_layer_fused`."""
    b, d = x.shape
    kvh, s, hs = k_cache.shape[2], k_cache.shape[3], k_cache.shape[4]
    qkv = _quant.q8_matmul_plain(x, wqkv, norm_weight=g1, norm_eps=norm_eps, rope_pos=pos,
                                 rope_limit=(n_heads + kvh) * hs, rope_head=hs, rope_theta=theta)
    qkv3 = qkv.view(b, n_heads + 2 * kvh, hs)
    bk = layer_block(s, n_heads, kvh, hs, k_cache.dtype == torch.int8)
    att = _attn.attention_decode_fused_plain(qkv3, k_cache, v_cache, layer, pos, n_heads,
                                             k_scale, v_scale, block=bk)
    x2 = _quant.q8_matmul_plain(att.reshape(b, d), wo, residual=x)
    out = _quant.q8_matmul_ffn_plain(x2, w13, w2, x2, g2, norm_eps=norm_eps)
    return out, qkv3[:, n_heads:]


def q8_layer_fused(x, wqkv, wo, w13, w2, g1, g2, k_cache, v_cache, layer: int, pos, k_scale=None,
                   v_scale=None, *, n_heads: int, norm_eps: float = 1e-5,
                   theta: float = 10000.0):
    """One decoder layer for the decode step's rows x (B, D) bf16 at
    positions pos (B,) int32 over layer `layer` of the cache (B, L, KVH, S,
    HS), bf16 or int8 with its scale planes k_scale/v_scale (B, L, KVH, S),
    which it reads and does not write. Weights in the fused
    layout: wqkv (D, (H + 2 KVH) HS), wo (D, D), w13 = W1|W3 (D, 2 HID), w2
    (HID, D); g1, g2 (D,) fp32. Returns (x_out (B, D), kv_rows (B, 2 KVH,
    HS)): the layer output and this step's k|v rows for the cache commit.
    Replaces hip_llama_tpu/ops/layer_fused.py::q8_layer_fused."""
    kw = dict(n_heads=n_heads, norm_eps=norm_eps, theta=theta)
    dev = _quant._device(x, "q8_layer_fused")
    bsz, n_layers, kvh, s, hs = check_cache(k_cache, v_cache)
    quantized = check_scales(k_cache, k_scale, v_scale)
    if dev.type == "cpu":
        return q8_layer_fused_plain(x, wqkv, wo, w13, w2, g1, g2, k_cache, v_cache, layer, pos,
                                    k_scale, v_scale, **kw)
    h = n_heads
    b, d = _quant._check_x("x", x)
    if b != bsz or d != h * hs or h % kvh or not 0 <= layer < n_layers:
        raise ValueError(f"x {tuple(x.shape)} against a cache {tuple(k_cache.shape)} with "
                         f"{h} heads, layer {layer}")
    if k_cache.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"q8_layer_fused takes a bf16 or int8 cache, got {k_cache.dtype}")
    _attn.check_head_size("q8_layer_fused", hs)
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
    # the products' slices of their contraction: the standalone kernels' own
    plans = ((nqkv, _quant.gemv_plan(d, nqkv, b)), (d, _quant.gemv_plan(d, d, b)),
             (2 * hidden, _quant.gemv_plan(d, 2 * hidden, b)), (d, _quant.gemv_plan(hidden, d, b)))
    out, xn, att, x2 = (torch.empty((b, d), dtype=torch.bfloat16, device=dev) for _ in range(4))
    qkv = torch.empty((b, h + 2 * kvh, hs), dtype=torch.bfloat16, device=dev)
    hb = torch.empty((b, hidden), dtype=torch.bfloat16, device=dev)
    part = torch.empty(max(sp * b * n for n, sp in plans), dtype=torch.float32, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    bk = layer_block(s, h, kvh, hs, quantized)
    fn = _build.bind("layer_fused", "q8_layer_fused", "p" * 24 + "i" * 19 + "ff" + "p")
    rc = fn(x.data_ptr(), wqkv.q.data_ptr(), wqkv.s.data_ptr(), g1.data_ptr(), pos.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), 0 if k_scale is None else k_scale.data_ptr(),
            0 if v_scale is None else v_scale.data_ptr(), wo.q.data_ptr(), wo.s.data_ptr(),
            w13.q.data_ptr(), w13.s.data_ptr(), w2.q.data_ptr(), w2.s.data_ptr(), g2.data_ptr(),
            out.data_ptr(), xn.data_ptr(), qkv.data_ptr(), att.data_ptr(), x2.data_ptr(),
            hb.data_ptr(), part.data_ptr(), bar.data_ptr(),
            b, d, h, kvh, s, hs, n_layers, layer, hidden, wqkv.group_size, wo.group_size,
            w13.group_size, w2.group_size, *(sp for _, sp in plans), bk,
            int(quantized), _quant.rope_coef(theta, hs), norm_eps, _stream())
    _build.check(rc, "layer_fused", "q8_layer_fused")
    _count(q8_layer_fused, quantized)
    return out, qkv[:, h:]


q8_layer_fused.launches = 0
q8_layer_fused.launches_int8 = 0


def grid_barrier_probe(n: int, ctas: int, dev) -> None:
    """Launch a cooperative grid of `ctas` CTAs (at most two an SM: K23's
    grid up to 8 rows) that passes n of K23's grid barriers and does nothing
    else (csrc/layer_fused.cu::barrier_probe_kernel); timed at two n, it
    gives what one barrier costs the layer. Counts in
    `grid_barrier_probe.launches`; card only."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        raise ValueError(f"grid_barrier_probe runs on the card, not {dev}")
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    fn = _build.bind("layer_fused", "q8_layer_barrier_probe", "piip")
    _build.check(fn(bar.data_ptr(), n, ctas, _stream()), "layer_fused", "grid_barrier_probe")
    grid_barrier_probe.launches += 1


grid_barrier_probe.launches = 0

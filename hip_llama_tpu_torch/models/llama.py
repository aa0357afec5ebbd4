"""Llama-2 forward in PyTorch: the decode step and chunked prefill over a
preallocated KV cache — the port of hip_llama_tpu/models/llama.py's dense
path (fp32 or bf16 params) and of its Q8_0 and int4 paths
(`QuantLlamaParams` in the unrolled fused layout, bf16 activations), chosen
by the params' type.

- KV cache layout (B, L, KVH, S, HS), as in the reference; the step and the
  prefill write it IN PLACE (the JAX functions donate it and return a new
  one) and return the same cache object. An int8 cache (`quantized=True`)
  holds int8 rows and one fp32 scale per row in (B, L, KVH, S) planes,
  whatever the activation dtype: the decode step's commit quantizes its
  rows in the kernel, the prefill quantizes each chunk's rows
  (quantize_kv_rows) before the chunk writer and its scale companion, and
  every attention kernel takes the scale planes (llama.py:713-826,
  :1029-1150). The KV heads are stored unpadded: the JAX package pads them
  to a multiple of 8 for its TPU DMAs only.
- The batch is a fixed slot array; raggedness is a per-slot `pos` / `start`
  / `valid` vector, exactly as in the JAX step, so the engine's scheduler
  is unchanged.
- Dense matrix products are `x @ W` in the param dtype with fp32
  accumulation (TF32 and bf16 reduced-precision reductions off). The
  kernels of the dense path — decode attention, the decode-step KV commit,
  the prefill chunk writer and prefill attention — go through the ops/
  wrappers, which launch the CUDA kernels for CUDA tensors.
- The Q8 path (hip_llama_tpu/models/llama.py:702-763 decode, :966-978 and
  :1132-1139 prefill) runs each decode-step layer as ONE q8_layer_fused
  kernel, as the JAX step does by default; HIPLLAMA_LAYER_FUSE=0 (read when
  the step is made) takes the four-kernel layer the JAX package has under
  the same switch: QKV (q8_matmul with the norm prologue, RoPE epilogue and
  head-split view), attention_decode_fused, wo (q8_matmul with the
  residual) and the FFN, which rounds alike. Prefill layers are QKV, the
  chunk writer, prefill attention, wo and the FFN (q8_matmul_ffn for up to
  256 rows, else q8_matmul_silu and q8_matmul with the residual); the
  classifier is q8_matmul with the norm prologue, rounded to bf16 before it
  is widened to fp32.
- The int4 path (Q4Tensor weights) has no whole-layer and no whole-FFN
  kernel: the JAX step takes q8_layer_fused and q8_matmul_ffn for QTensors
  only (llama.py:702-709, :318). Its decode layer is always four kernels,
  whatever HIPLLAMA_LAYER_FUSE says: q4_matmul with the norm prologue and
  RoPE epilogue (the head-split view of its flat output, llama.py:214-225),
  attention_decode_fused, q4_matmul with the residual on wo, and the FFN as
  q4_matmul_silu with the norm prologue then q4_matmul with the residual on
  W2, at every row count (llama.py:253-261). The prefill and the classifier
  run the same products as the Q8 path's; the embedding is Q8_0 rows.
- `plain=True` runs every kernel's plain PyTorch version instead, whatever
  the device: the yardstick the kernel path is held against on the card.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.nn.functional as F

from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.models.params import LlamaParams, QuantLlamaParams, resolve_device
from hip_llama_tpu_torch.ops import attention as _attn
from hip_llama_tpu_torch.ops import cache as _cache
from hip_llama_tpu_torch.ops import layer_fused as _layer
from hip_llama_tpu_torch.ops import quant as _quant
from hip_llama_tpu_torch.ops import quant4 as _quant4


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (B, L, KVH, S, HS)
    v: torch.Tensor  # (B, L, KVH, S, HS)
    # int8 caches: one fp32 scale per cached row, (B, L, KVH, S)
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_cache(
    cfg: ModelConfig,
    batch: int,
    dtype=torch.float32,
    seq_len: int | None = None,
    device="cuda",
    quantized: bool = False,
) -> KVCache:
    """Zeroed cache planes of `dtype`, or with `quantized=True` int8 planes
    with scale planes of ones (dtype is then not read)."""
    s = seq_len or cfg.seq_len
    shape = (batch, cfg.n_layers, cfg.n_kv_heads, s, cfg.head_size)
    dev = resolve_device(device)
    if quantized:
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=dev),
                       torch.zeros(shape, dtype=torch.int8, device=dev),
                       torch.ones(shape[:-1], device=dev), torch.ones(shape[:-1], device=dev))
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))


def _exact_matmuls() -> None:
    """fp32 products in full fp32 and bf16 products with fp32 reductions —
    the JAX step's precision="highest" / fp32-accumulation contract."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# ---------------------------------------------------------------------------
# building blocks


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Always computed in fp32 (the reference keeps norms fp32, runq.c:383)."""
    xf = x.float()
    ss = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ss + eps) * weight.float()).to(x.dtype)


def rope_tables(pos: torch.Tensor, head_size: int, theta: float = 10000.0):
    """cos and sin of the RoPE angles, fp32 (..., 1, head_size) for pos of
    shape (...), each angle repeated for its (even, odd) pair. A step
    computes them once for all layers and for both q and k."""
    half = head_size // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=pos.device)
                            * 2.0 / head_size))
    ang = pos.float()[..., None, None] * freq  # (..., 1, half)
    return (torch.repeat_interleave(torch.cos(ang), 2, dim=-1),
            torch.repeat_interleave(torch.sin(ang), 2, dim=-1))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate consecutive (even, odd) pairs per head — the llama2.c
    convention (src/seq.cpp:86-100), not the HF half rotation. x: (...,
    n_heads, head_size); computed in fp32, returned in x's dtype."""
    xf = x.float()
    # partner[2i] = -x[2i+1], partner[2i+1] = x[2i]
    partner = torch.stack((-xf[..., 1::2], xf[..., 0::2]), dim=-1).reshape(xf.shape)
    return (xf * cos + partner * sin).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """RoPE of x (..., n_heads, head_size) at positions pos (x's leading
    dims)."""
    return apply_rope(x, *rope_tables(pos, x.shape[-1], theta))


@dataclasses.dataclass(frozen=True)
class _Kernels:
    attn_decode: object
    attn_prefill: object
    commit: object
    write_chunk: object
    scale_chunk: object  # scale_write_chunk
    attn_decode_fused: object
    mm: object  # q8_matmul
    mm_silu: object
    mm_ffn: object
    layer: object  # q8_layer_fused
    mm4: object  # q4_matmul
    mm4_silu: object


def _kernels(plain: bool) -> _Kernels:
    if plain:
        return _Kernels(_attn.attention_decode_plain, _attn.attention_prefill_plain,
                        _cache.kv_commit_rows_plain, _cache.kv_write_chunk_plain,
                        _cache.scale_write_chunk_plain,
                        _attn.attention_decode_fused_plain, _quant.q8_matmul_plain,
                        _quant.q8_matmul_silu_plain, _quant.q8_matmul_ffn_plain,
                        _layer.q8_layer_fused_plain, _quant4.q4_matmul_plain,
                        _quant4.q4_matmul_silu_plain)
    return _Kernels(_attn.attention_decode, _attn.attention_prefill,
                    _cache.kv_commit_rows, _cache.kv_write_chunk, _cache.scale_write_chunk,
                    _attn.attention_decode_fused, _quant.q8_matmul,
                    _quant.q8_matmul_silu, _quant.q8_matmul_ffn, _layer.q8_layer_fused,
                    _quant4.q4_matmul, _quant4.q4_matmul_silu)


@dataclasses.dataclass(frozen=True)
class _Products:
    """The weight products of quantized params: mm (K15 or K21), silu (K17
    or K22) and ffn (K18, or None for int4, which has no whole-FFN
    kernel)."""

    mm: object
    silu: object
    ffn: object


def _products(k: _Kernels, params: QuantLlamaParams) -> _Products:
    if params.int4:
        return _Products(k.mm4, k.mm4_silu, None)
    return _Products(k.mm, k.mm_silu, k.mm_ffn)


def act_dtype(params) -> torch.dtype:
    """The activation dtype, and that of a cache that is not int8: bf16 for
    quantized params (norms stay fp32 inside the kernels), else the dense
    param dtype."""
    if isinstance(params, QuantLlamaParams):
        return torch.bfloat16
    return params.dtype


def _embed_q8(params: QuantLlamaParams, tokens: torch.Tensor) -> torch.Tensor:
    """Gather int8 rows and their group scales, dequantize only those rows
    (runq.c:360-364), bf16."""
    q = params.tok_emb_q[tokens.long()]
    s = params.tok_emb_s[tokens.long()]
    gs = params.group_size
    g = q.float().reshape(*q.shape[:-1], q.shape[-1] // gs, gs)
    return (g * s[..., None]).reshape(q.shape).to(torch.bfloat16)


def _quant_ffn(pr: _Products, x2: torch.Tensor, params: QuantLlamaParams, l: int, eps: float):
    """x2 + FFN(rmsnorm(x2)) for rows x2 (M, D): q8_matmul_ffn where the
    JAX package takes its kernel by row count, else (and always for int4)
    the gate and W2 with the residual (llama.py:312-329, quant.py:921-938)."""
    if pr.ffn is not None and _quant.ffn_takes_kernel(*x2.shape):
        return pr.ffn(x2, params.w1[l], params.w2[l], x2, params.rms_ffn[l], norm_eps=eps)
    h = pr.silu(x2, params.w1[l], norm_weight=params.rms_ffn[l], norm_eps=eps)
    return pr.mm(h, params.w2[l], residual=x2)


def _quant_qkv(pr: _Products, x2, params: QuantLlamaParams, l: int, pos, cfg: ModelConfig):
    """Norm + fused QKV + RoPE on q|k for rows x2 (M, D) at positions pos
    (M,); returns the head-split (M, H + 2 KVH, HS) view."""
    c = cfg
    y = pr.mm(x2, params.wq[l], norm_weight=params.rms_att[l], norm_eps=c.norm_eps,
              rope_pos=pos, rope_limit=(c.n_heads + c.n_kv_heads) * c.head_size,
              rope_head=c.head_size, rope_theta=c.rope_theta)
    return y.view(x2.shape[0], c.n_heads + 2 * c.n_kv_heads, c.head_size)


def _quant_logits(pr: _Products, x2, params: QuantLlamaParams, cfg: ModelConfig):
    # the classifier's bf16 output widened to fp32 (llama.py:827-829)
    return pr.mm(x2, params.wcls, norm_weight=params.rms_final, norm_eps=cfg.norm_eps).float()


def _ffn(x: torch.Tensor, params: LlamaParams, l: int, eps: float) -> torch.Tensor:
    xn = rmsnorm(x, params.rms_ffn[l], eps)
    h = F.silu(xn @ params.w1[l]) * (xn @ params.w3[l])
    return x + h @ params.w2[l]


def _qkv(x, params, l, cfg: ModelConfig, rot):
    """rmsnorm + the three projections + RoPE (rot = rope_tables(...)) on q
    and k; x (..., D) -> q (..., H, HS), k and v (..., KVH, HS)."""
    c = cfg
    lead = x.shape[:-1]
    xn = rmsnorm(x, params.rms_att[l], c.norm_eps)
    q = apply_rope((xn @ params.wq[l]).view(*lead, c.n_heads, c.head_size), *rot)
    k = apply_rope((xn @ params.wk[l]).view(*lead, c.n_kv_heads, c.head_size), *rot)
    v = (xn @ params.wv[l]).view(*lead, c.n_kv_heads, c.head_size)
    return q, k, v


# ---------------------------------------------------------------------------
# decode step


def make_decode_step(cfg: ModelConfig, plain: bool = False):
    """Returns step(params, cache, tokens (B,), pos (B,) int32) -> (logits
    fp32 (B, V), cache). With Q8 params each layer is one q8_layer_fused
    unless HIPLLAMA_LAYER_FUSE=0; with int4 params it is four kernels. The
    cache is read-only inside the layer loop — the current token's K/V rows
    ride into attention as explicit operands — and the whole step's rows
    are committed in place by ONE kv_commit_rows launch after the loop, as
    in the JAX step."""
    kn = _kernels(plain)
    c = cfg
    h, kvh = c.n_heads, c.n_kv_heads
    layer_fuse = os.environ.get("HIPLLAMA_LAYER_FUSE", "1") == "1"
    _exact_matmuls()

    def step_quant(params: QuantLlamaParams, cache: KVCache, tokens, pos):
        x = _embed_q8(params, tokens)  # (B, D) bf16
        b = x.shape[0]
        pr = _products(kn, params)
        k_list, v_list = [], []
        for l in range(c.n_layers):
            if layer_fuse and not params.int4:
                x, kv = kn.layer(x, params.wq[l], params.wo[l], params.w1[l], params.w2[l],
                                 params.rms_att[l], params.rms_ffn[l], cache.k, cache.v, l, pos,
                                 cache.k_scale, cache.v_scale, n_heads=h, norm_eps=c.norm_eps,
                                 theta=c.rope_theta)
            else:
                qkv3 = _quant_qkv(pr, x, params, l, pos, c)  # (B, H + 2 KVH, HS)
                att = kn.attn_decode_fused(qkv3, cache.k, cache.v, l, pos, h, cache.k_scale,
                                           cache.v_scale)
                x = pr.mm(att.view(b, c.dim), params.wo[l], residual=x)
                x = _quant_ffn(pr, x, params, l, c.norm_eps)
                kv = qkv3[:, h:]
            k_list.append(kv[:, :kvh])  # (B, KVH, HS) each
            v_list.append(kv[:, kvh:])
        kn.commit(cache, torch.stack(k_list), torch.stack(v_list), pos)
        return _quant_logits(pr, x, params, c), cache

    def step(params, cache: KVCache, tokens: torch.Tensor, pos: torch.Tensor):
        if isinstance(params, QuantLlamaParams):
            return step_quant(params, cache, tokens, pos)
        x = params.tok_emb[tokens.long()]  # (B, D)
        b = x.shape[0]
        rot = rope_tables(pos, c.head_size, c.rope_theta)
        k_list, v_list = [], []
        for l in range(c.n_layers):
            q, k, v = _qkv(x, params, l, c, rot)
            att = kn.attn_decode(q, cache.k, cache.v, l, pos, k, v, cache.k_scale, cache.v_scale)
            x = x + att.reshape(b, c.dim) @ params.wo[l]
            x = _ffn(x, params, l, c.norm_eps)
            k_list.append(k)
            v_list.append(v)
        kn.commit(cache, torch.stack(k_list), torch.stack(v_list), pos)
        logits = (rmsnorm(x, params.rms_final, c.norm_eps) @ params.wcls).float()
        return logits, cache

    return step


# ---------------------------------------------------------------------------
# chunked prefill


def make_prefill(cfg: ModelConfig, last_only: bool = False, plain: bool = False):
    """Returns prefill(params, cache, tokens (B, T), start (B,), valid_len
    (B,)) -> (logits fp32 (B, T, V), cache).

    Processes up to T prompt tokens per slot in one pass (positions
    start..start+valid_len-1): causal within the chunk, full attention over
    the existing cache. Each layer writes its chunk rows into the cache
    (kv_write_chunk; rows past a slot's valid_len keep the old contents, so
    valid_len=0 slots are bystanders; an int8 cache takes the rows
    quantized and their scales through scale_write_chunk) and then attends
    over it (attention_prefill).

    `last_only=True` returns logits fp32 (B, V) for each slot's LAST valid
    position only: the x rows are gathered before the final norm and the
    classifier, so the (B, T, V) logits are never computed."""
    kn = _kernels(plain)
    c = cfg
    h, kvh = c.n_heads, c.n_kv_heads
    _exact_matmuls()

    def last_rows(x, valid_len):
        # valid_len=0 bystanders gather row 0; callers ignore them
        idx = torch.clamp(valid_len.long() - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device), idx]  # (B, D)

    def write_and_attend(cache: KVCache, q, k, v, l, start, valid_len):
        """Write the chunk's k/v (B, T, KVH, HS) into layer l, then attend
        over it with q (B, T, H, HS)."""
        if cache.quantized:
            (kq, ks), (vq, vs) = _cache.quantize_kv_rows(k), _cache.quantize_kv_rows(v)
            kn.write_chunk(cache, kq, vq, l, start, valid_len)
            kn.scale_chunk(cache, ks, vs, l, start, valid_len)
        else:
            kn.write_chunk(cache, k, v, l, start, valid_len)
        return kn.attn_prefill(q, cache.k, cache.v, l, start, valid_len, cache.k_scale,
                               cache.v_scale)

    def prefill_quant(params: QuantLlamaParams, cache: KVCache, tokens, start, valid_len, pos):
        b, t = tokens.shape
        x = _embed_q8(params, tokens).view(b * t, c.dim)  # (B*T, D) bf16
        pos = pos.reshape(-1)
        pr = _products(kn, params)
        for l in range(c.n_layers):
            qkv = _quant_qkv(pr, x, params, l, pos, c).view(b, t, h + 2 * kvh, c.head_size)
            att = write_and_attend(cache, qkv[:, :, :h].contiguous(),
                                   qkv[:, :, h:h + kvh].contiguous(),
                                   qkv[:, :, h + kvh:].contiguous(), l, start, valid_len)
            x = pr.mm(att.view(b * t, c.dim), params.wo[l], residual=x)
            x = _quant_ffn(pr, x, params, l, c.norm_eps)
        x = x.view(b, t, c.dim)
        if last_only:
            x = last_rows(x, valid_len)
        logits = _quant_logits(pr, x.reshape(-1, c.dim), params, c)
        return logits.view(*x.shape[:-1], -1), cache

    def prefill(params, cache: KVCache, tokens: torch.Tensor,
                start: torch.Tensor, valid_len: torch.Tensor):
        b, t = tokens.shape
        pos = start[:, None] + torch.arange(t, dtype=torch.int32, device=tokens.device)[None, :]
        if isinstance(params, QuantLlamaParams):
            return prefill_quant(params, cache, tokens, start, valid_len, pos)
        x = params.tok_emb[tokens.long()]  # (B, T, D)
        rot = rope_tables(pos, c.head_size, c.rope_theta)
        for l in range(c.n_layers):
            q, k, v = _qkv(x, params, l, c, rot)
            att = write_and_attend(cache, q, k, v, l, start, valid_len)
            x = x + att.reshape(b, t, c.dim) @ params.wo[l]
            x = _ffn(x, params, l, c.norm_eps)
        if last_only:
            x = last_rows(x, valid_len)
        logits = (rmsnorm(x, params.rms_final, c.norm_eps) @ params.wcls).float()
        return logits, cache

    return prefill


# ---------------------------------------------------------------------------
# sampling


def make_logit_sampler(temperature: float, topp: float = 0.9):
    """Sampler over (B, V) fp32 logits on their device. Temperature 0 is
    argmax (the first index among equal maxima, as jnp.argmax and
    np.argmax). The stochastic branch of the JAX sampler draws from JAX's
    PRNG and is not ported yet."""
    if temperature != 0.0:
        raise NotImplementedError(
            "device sampling at temperature > 0 is not yet ported; "
            "the engine samples on the host"
        )

    def sample_logits(logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return sample_logits

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
- The products' dequant mode is read when the step or the prefill is made,
  as HIPLLAMA_LAYER_FUSE is: HIPLLAMA_Q8_MODE (`reshape`, or `a8` for the
  reference int8 engine's w8a8 arithmetic) and HIPLLAMA_Q4_MODE (`dequant`,
  or `a8`), passed down to the products as `mode=` (`dequant_modes`); the
  JAX package's other values are not yet ported and raise. Under a Q8 mode
  other than `reshape` the decode layer is the four-kernel one, never
  q8_layer_fused, whose math is reshape's (llama.py:282-285), and the FFN
  takes q8_matmul_ffn only where the JAX kernel does not decline
  (ops/quant.py::ffn_takes_kernel), since its fallback's products run `a8`
  and the kernel keeps reshape math.
- Q8 params in the stacked layout (`--layout stacked`,
  params.fuse_stacked_quant_params) take the JAX package's stacked decode
  branch (llama.py:618-683), which comes before every other Q8 choice: per
  layer q8_matmul_layered (K20) on QKV with the norm prologue and RoPE
  epilogue, attention_decode (K1) reading q, k and v in place from the flat
  QKV rows, K20 on wo with the residual, K20 on W1|W3 with the norm
  prologue, the bf16 gate `silu_gate_bf16` and K20 on W2 with the residual;
  never K23, K5, K17 or K18. Their prefill is the unrolled one on per-layer
  views of the stacked tensors (params.layer_views), as the JAX prefill's
  scan slices each layer (llama.py:929-942).
- The decode step commits its rows with kv_commit_rows (K2) unless
  HIPLLAMA_KV_COMMIT=0 (read when the step is made): then with the JAX
  step's four writes (llama.py:477-491), quantize_kv_rows on an int8 cache,
  kv_write_rows (K8) on each plane and scale_write_rows (K9) on each scale
  plane, which write the same values. The JAX package's TPU tile rules
  that also send it there (llama.py:467-473) are not copied.
- Two prefill knobs of the JAX package, read when the prefill is made
  (`prefill_knobs`; any value but "1" is off, as there):
  HIPLLAMA_PREFILL_MINNER=1 lets the Q8 products take K19
  (`q8_matmul_minner`, `q8_matmul_silu_minner`) where the JAX wrappers take
  theirs (quant.py:1386-1406, :677-684: above 512 rows, reshape math, no
  norm prologue left, flat output), and HIPLLAMA_PREFILL_XHEADS=1 makes the
  contiguous Q8 prefill's wo K16 (`q8_matmul_xheads`) on the attention
  output's head-split view where the head size is a multiple of 128
  (llama.py:1080-1092). HIPLLAMA_PREFILL_HEADS (default 1) is read only for
  the K19 decision: the JAX prefill's QKV emits head-split rows by default
  (llama.py:966-978), which never take K19; with 0 they are flat and may.
  The decode step reads none of them: K19 needs more than 512 rows, and
  its arithmetic is K15's and K17's in any case.
- Sampling on the device (llama.py:1197-1310 of the JAX package):
  make_logit_sampler (argmax, or temperature and the top-p nucleus with
  draws from a caller's torch.Generator), make_sampling_decode_step and
  make_chunked_sampling_step, N decode steps whose sampled tokens feed the
  next on the device. They add no kernel: the steps run the kernels above.
- `plain=True` runs every kernel's plain PyTorch version instead, whatever
  the device: the yardstick the kernel path is held against on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import torch
import torch.nn.functional as F

from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.models.params import (
    LlamaParams,
    QuantLlamaParams,
    layer_views,
    resolve_device,
)
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
    mm_layered: object  # q8_matmul_layered
    write_rows: object  # kv_write_rows
    scale_rows: object  # scale_write_rows
    mm_xheads: object  # q8_matmul_xheads


def _kernels(plain: bool) -> _Kernels:
    if plain:
        return _Kernels(_attn.attention_decode_plain, _attn.attention_prefill_plain,
                        _cache.kv_commit_rows_plain, _cache.kv_write_chunk_plain,
                        _cache.scale_write_chunk_plain,
                        _attn.attention_decode_fused_plain, _quant.q8_matmul_plain,
                        _quant.q8_matmul_silu_plain, _quant.q8_matmul_ffn_plain,
                        _layer.q8_layer_fused_plain, _quant4.q4_matmul_plain,
                        _quant4.q4_matmul_silu_plain, _quant.q8_matmul_layered_plain,
                        _cache.kv_write_rows_plain, _cache.scale_write_rows_plain,
                        _quant.q8_matmul_xheads_plain)
    return _Kernels(_attn.attention_decode, _attn.attention_prefill,
                    _cache.kv_commit_rows, _cache.kv_write_chunk, _cache.scale_write_chunk,
                    _attn.attention_decode_fused, _quant.q8_matmul,
                    _quant.q8_matmul_silu, _quant.q8_matmul_ffn, _layer.q8_layer_fused,
                    _quant4.q4_matmul, _quant4.q4_matmul_silu, _quant.q8_matmul_layered,
                    _cache.kv_write_rows, _cache.scale_write_rows, _quant.q8_matmul_xheads)


def _step_commit(kn: _Kernels):
    """The decode step's commit of its rows k_rows/v_rows (L, B, KVH, HS):
    kv_commit_rows (K2), or with HIPLLAMA_KV_COMMIT=0 (read now) the JAX
    step's four writes, which write the same values (llama.py:477-491)."""
    if os.environ.get("HIPLLAMA_KV_COMMIT", "1") == "1":
        return kn.commit

    def four_writes(cache: KVCache, k_rows, v_rows, pos):
        if cache.quantized:
            (kq, ks), (vq, vs) = _cache.quantize_kv_rows(k_rows), _cache.quantize_kv_rows(v_rows)
            kn.write_rows(cache.k, kq, pos)
            kn.write_rows(cache.v, vq, pos)
            kn.scale_rows(cache.k_scale, ks, pos)
            kn.scale_rows(cache.v_scale, vs, pos)
        else:
            kn.write_rows(cache.k, k_rows.to(cache.k.dtype), pos)
            kn.write_rows(cache.v, v_rows.to(cache.v.dtype), pos)
        return cache

    return four_writes


def silu_gate_bf16(h1: torch.Tensor, h3: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu(h1) * h3 on bf16 h1 and h3 with XLA's rounding. XLA
    lowers silu(x) to x * (1 / (1 + exp(-x))) and, on bf16 operands, rounds
    to bf16 after every op: exp, the add, the divide, x * sigmoid and the
    product with h3 — as PyTorch's bf16 ops do, each computing in fp32. Found
    by matching the jitted JAX function on the CPU: this rounding agrees bit
    for bit on 65536 bf16 draws, where rounding after logistic, x * logistic
    and the product only agrees on 74% of 4096 draws, and rounding after
    logistic alone on 57%."""
    return h1 * torch.reciprocal(1.0 + torch.exp(-h1)) * h3


@dataclasses.dataclass(frozen=True)
class DequantModes:
    """HIPLLAMA_Q8_MODE and HIPLLAMA_Q4_MODE: the arithmetic of the Q8 and
    int4 weight products."""

    q8: str = "reshape"
    q4: str = "dequant"


def dequant_modes() -> DequantModes:
    """The two knobs as the JAX package reads them (quant.py:28,
    quant4.py:48); raises NotImplementedError on a value the port does not
    serve (the JAX package's group_dot, bf16, f32dot, repeat)."""
    m = DequantModes(os.environ.get("HIPLLAMA_Q8_MODE", "reshape"),
                     os.environ.get("HIPLLAMA_Q4_MODE", "dequant"))
    _quant.check_mode(m.q8, _quant.Q8_MODES, "HIPLLAMA_Q8_MODE")
    _quant.check_mode(m.q4, _quant4.Q4_MODES, "HIPLLAMA_Q4_MODE")
    return m


@dataclasses.dataclass(frozen=True)
class PrefillKnobs:
    """HIPLLAMA_PREFILL_MINNER, HIPLLAMA_PREFILL_XHEADS and
    HIPLLAMA_PREFILL_HEADS: K19 on the large-M Q8 products, K16 on the
    contiguous prefill's wo, and the JAX QKV's head-split emission (which
    only the K19 decision reads)."""

    minner: bool
    xheads: bool
    heads: bool


def prefill_knobs() -> PrefillKnobs:
    """The three knobs as the JAX package reads them (quant.py:43,
    llama.py:292-295): "1" is on, any other value off."""
    on = lambda name, default: os.environ.get(name, default) == "1"  # noqa: E731
    return PrefillKnobs(on("HIPLLAMA_PREFILL_MINNER", "0"), on("HIPLLAMA_PREFILL_XHEADS", "0"),
                        on("HIPLLAMA_PREFILL_HEADS", "1"))


@dataclasses.dataclass(frozen=True)
class _Products:
    """The weight products of quantized params in their dequant mode: mm
    (K15 or K21), silu (K17 or K22) and ffn (K18, or None for int4, which
    has no whole-FFN kernel); with `minner` the Q8 mm and silu take K19
    where the JAX wrappers would."""

    mm: object
    silu: object
    ffn: object
    mode: str
    minner: bool = False


def _products(k: _Kernels, params: QuantLlamaParams, modes: DequantModes,
              minner: bool = False) -> _Products:
    if params.int4:
        return _Products(functools.partial(k.mm4, mode=modes.q4),
                         functools.partial(k.mm4_silu, mode=modes.q4), None, modes.q4)
    return _Products(functools.partial(k.mm, mode=modes.q8, minner=minner),
                     functools.partial(k.mm_silu, mode=modes.q8, minner=minner), k.mm_ffn,
                     modes.q8, minner)


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
    JAX package takes its kernel, else (and always for int4) the gate and W2
    with the residual (llama.py:312-329, quant.py:921-938)."""
    w1 = params.w1[l]
    if pr.ffn is not None and _quant.ffn_takes_kernel(*x2.shape, w1.q.shape[1] // 2,
                                                      w1.group_size, pr.mode):
        return pr.ffn(x2, params.w1[l], params.w2[l], x2, params.rms_ffn[l], norm_eps=eps)
    h = pr.silu(x2, params.w1[l], norm_weight=params.rms_ffn[l], norm_eps=eps)
    return pr.mm(h, params.w2[l], residual=x2)


def _quant_qkv(pr: _Products, x2, params: QuantLlamaParams, l: int, pos, cfg: ModelConfig,
               widths=None, out_heads: int = 0):
    """Norm + fused QKV + RoPE on q|k for rows x2 (M, D) at positions pos
    (M,); returns the head-split (M, H + 2 KVH, HS) view. widths: the
    output widths of the JAX products the fused one stands for, where they
    are separate; out_heads: the head size where the JAX product emits
    head-split rows (read by the K19 decision only)."""
    c = cfg
    kw = dict(out_heads=out_heads) if pr.minner else {}
    y = pr.mm(x2, params.wq[l], norm_weight=params.rms_att[l], norm_eps=c.norm_eps,
              rope_pos=pos, rope_limit=(c.n_heads + c.n_kv_heads) * c.head_size,
              rope_head=c.head_size, rope_theta=c.rope_theta, widths=widths, **kw)
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
    unless HIPLLAMA_LAYER_FUSE=0 or HIPLLAMA_Q8_MODE is not `reshape`; with
    int4 params it is four kernels; stacked Q8 params take four
    q8_matmul_layered products and attention_decode per layer. The
    cache is read-only inside the layer loop — the current token's K/V rows
    ride into attention as explicit operands — and the whole step's rows
    are committed in place by ONE kv_commit_rows launch after the loop, as
    in the JAX step (or, with HIPLLAMA_KV_COMMIT=0, by its four writes)."""
    kn = _kernels(plain)
    c = cfg
    h, kvh = c.n_heads, c.n_kv_heads
    modes = dequant_modes()
    layer_fuse = os.environ.get("HIPLLAMA_LAYER_FUSE", "1") == "1" and modes.q8 == "reshape"
    commit = _step_commit(kn)
    _exact_matmuls()

    def step_stacked(params: QuantLlamaParams, cache: KVCache, tokens, pos):
        x = _embed_q8(params, tokens)  # (B, D) bf16
        b = x.shape[0]
        d, kvd, hid = c.dim, c.kv_dim, c.hidden_dim
        mm = functools.partial(kn.mm_layered, mode=modes.q8)
        k_list, v_list = [], []
        for l in range(c.n_layers):
            qkv = mm(x, params.wq, l, norm_weight=params.rms_att, norm_eps=c.norm_eps,
                     rope_pos=pos, rope_limit=d + kvd, rope_head=c.head_size,
                     rope_theta=c.rope_theta)  # (B, D + 2 KVD), flat
            # column views: K1 reads them in place through their slot stride
            q = qkv[:, :d].unflatten(1, (h, c.head_size))
            k = qkv[:, d:d + kvd].unflatten(1, (kvh, c.head_size))
            v = qkv[:, d + kvd:].unflatten(1, (kvh, c.head_size))
            att = kn.attn_decode(q, cache.k, cache.v, l, pos, k, v, cache.k_scale,
                                 cache.v_scale)
            x = mm(att.view(b, d), params.wo, l, residual=x)
            h13 = mm(x, params.w1, l, norm_weight=params.rms_ffn, norm_eps=c.norm_eps)
            x = mm(silu_gate_bf16(h13[:, :hid], h13[:, hid:]), params.w2, l, residual=x)
            k_list.append(k)
            v_list.append(v)
        commit(cache, torch.stack(k_list), torch.stack(v_list), pos)
        return _quant_logits(_products(kn, params, modes), x, params, c), cache

    def step_quant(params: QuantLlamaParams, cache: KVCache, tokens, pos):
        if params.stacked:
            return step_stacked(params, cache, tokens, pos)
        x = _embed_q8(params, tokens)  # (B, D) bf16
        b = x.shape[0]
        pr = _products(kn, params, modes)
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
        commit(cache, torch.stack(k_list), torch.stack(v_list), pos)
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
        commit(cache, torch.stack(k_list), torch.stack(v_list), pos)
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
    classifier, so the (B, T, V) logits are never computed.

    The Q8 products follow the prefill knobs (`prefill_knobs`, read now):
    K19 where the JAX wrappers take it, and with HIPLLAMA_PREFILL_XHEADS=1
    wo as q8_matmul_xheads (K16) on the attention output's (B*T, H, HS) view
    at head sizes that are a multiple of 128, as the JAX prefill calls it
    (llama.py:1080-1092)."""
    kn = _kernels(plain)
    c = cfg
    h, kvh = c.n_heads, c.n_kv_heads
    modes = dequant_modes()
    knobs = prefill_knobs()
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
        params = layer_views(params)
        b, t = tokens.shape
        x = _embed_q8(params, tokens).view(b * t, c.dim)  # (B*T, D) bf16
        pos = pos.reshape(-1)
        pr = _products(kn, params, modes, knobs.minner)
        xheads = knobs.xheads and not params.int4 and c.head_size % 128 == 0
        for l in range(c.n_layers):
            qkv = _quant_qkv(pr, x, params, l, pos, c,
                             out_heads=c.head_size if knobs.heads else 0)
            qkv = qkv.view(b, t, h + 2 * kvh, c.head_size)
            att = write_and_attend(cache, qkv[:, :, :h].contiguous(),
                                   qkv[:, :, h:h + kvh].contiguous(),
                                   qkv[:, :, h + kvh:].contiguous(), l, start, valid_len)
            if xheads:
                x = kn.mm_xheads(att.view(b * t, h, c.head_size), params.wo[l], residual=x,
                                 mode=modes.q8, minner=knobs.minner)
            else:
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
# sampling on the device (llama.py:1197-1310 of the JAX package)


def make_logit_sampler(temperature: float, topp: float = 0.9):
    """Sampler over (B, V) fp32 logits on their device: sample_logits(logits,
    generator=None) -> (B,) int32. Temperature 0 is argmax (the first index
    among equal maxima, as jnp.argmax and np.argmax). Otherwise the JAX
    sampler's rule: the logits divided by the temperature, then, for 0 <
    topp < 1, softmax, and only the tokens whose probability is at least the
    nucleus threshold kept (the threshold is the smallest sorted probability
    p with csum - p < topp), then one categorical draw per row (Gumbel-max
    over the kept scaled logits). The distribution is softmax(scaled logits)
    on the kept set, which engine/speculative.py::_warp recomputes on the
    host.

    The draw takes its uniforms from `generator` (a torch.Generator on the
    logits' device, which the caller seeds); it never touches the global
    RNG. JAX's PRNG stream (jax.random.categorical) is not reproduced: the
    same seed gives the same tokens here, not the JAX package's tokens."""

    def sample_logits(logits: torch.Tensor, generator: torch.Generator | None = None
                      ) -> torch.Tensor:
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if generator is None:
            raise ValueError("stochastic device sampling needs a torch.Generator")
        scaled = warp_logits(logits, temperature, topp)
        u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)

    return sample_logits


def warp_logits(logits: torch.Tensor, temperature: float, topp: float) -> torch.Tensor:
    """The fp32 logits the stochastic sampler draws from: divided by the
    temperature, and for 0 < topp < 1 -inf outside the nucleus (llama.py:
    1208-1220 of the JAX package)."""
    scaled = logits.float() / temperature
    if 0.0 < topp < 1.0:
        probs = torch.softmax(scaled, dim=-1)
        sorted_p = torch.sort(probs, dim=-1, descending=True).values
        csum = torch.cumsum(sorted_p, dim=-1)
        keep = csum - sorted_p < topp  # the first one always kept
        thresh = torch.where(keep, sorted_p, torch.inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(probs >= thresh, scaled, -torch.inf)
    return scaled


def make_sampling_decode_step(cfg: ModelConfig, temperature: float = 0.0, topp: float = 0.9,
                              plain: bool = False):
    """Decode step that samples on the device: sstep(params, cache, tokens,
    pos, generator=None) -> (next tokens (B,) int32, cache). The host then
    fetches 4 bytes a slot instead of the (B, V) logits. Greedy is the host
    sampler's argmax of the same logits; stochastic draws are
    make_logit_sampler's, not the reference's xorshift64* stream, so golden
    parity runs sample on the host."""
    step = make_decode_step(cfg, plain=plain)
    sample_logits = make_logit_sampler(temperature, topp)

    def sstep(params, cache: KVCache, tokens, pos, generator=None):
        logits, cache = step(params, cache, tokens, pos)
        return sample_logits(logits, generator), cache

    return sstep


def make_chunked_sampling_step(cfg: ModelConfig, n_steps: int, temperature: float = 0.0,
                               topp: float = 0.9, return_logits: bool = False,
                               plain: bool = False):
    """Multi-step scheduling: chunk(params, cache, tokens (B,), pos (B,),
    generator=None) -> (tokens (B, n_steps) int32, cache) runs `n_steps`
    decode steps, each sampling on the device and feeding the next, with no
    host synchronisation inside the chunk (the sampled tokens and pos + 1
    stay on the device).

    A slot that emits EOS mid-chunk keeps decoding until the chunk ends; the
    host scheduler discards those tokens, and the cache rows they wrote sit
    at or past the slot's next position, which nothing reads before it is
    written again. Greedy chunks equal the single-step loop token for token.

    With return_logits=True the chunk also returns each step's fp32 logits
    (B, n_steps, V): the speculative verifier needs the draft's proposal
    distributions."""
    step = make_decode_step(cfg, plain=plain)
    sample_logits = make_logit_sampler(temperature, topp)

    def chunk(params, cache: KVCache, tokens, pos, generator=None):
        return run_sampling_chunk(lambda c, t, p: step(params, c, t, p), cache, tokens, pos,
                                  generator, n_steps, sample_logits, return_logits)

    return chunk


def run_sampling_chunk(step1, cache, tokens, pos, generator, n_steps: int, sample_logits,
                       return_logits: bool):
    """The loop the chunked sampling steps share (contiguous and paged,
    models/paged.py): n_steps of step1(cache, tokens, pos) -> (logits,
    cache), each sampled on the device and fed to the next. Returns (tokens
    (B, n_steps)[, logits (B, n_steps, V)], cache)."""
    toks, logits_all = [], []
    for _ in range(n_steps):
        logits, cache = step1(cache, tokens, pos)
        tokens = sample_logits(logits, generator)
        pos = pos + 1
        toks.append(tokens)
        if return_logits:
            logits_all.append(logits)
    if return_logits:
        return torch.stack(toks, dim=1), torch.stack(logits_all, dim=1), cache
    return torch.stack(toks, dim=1), cache

"""Llama-2 forward in PyTorch: the dense decode step and chunked prefill over
a preallocated KV cache — the port of hip_llama_tpu/models/llama.py's dense
path (fp32 or bf16 params, no quantization).

- KV cache layout (B, L, KVH, S, HS), as in the reference; the step and the
  prefill write it IN PLACE (the JAX functions donate it and return a new
  one) and return the same cache object.
- The batch is a fixed slot array; raggedness is a per-slot `pos` / `start`
  / `valid` vector, exactly as in the JAX step, so the engine's scheduler
  is unchanged.
- Matrix products are `x @ W` in the param dtype with fp32 accumulation
  (TF32 and bf16 reduced-precision reductions off). The four kernels of the
  path — decode attention, the decode-step KV commit, the prefill chunk
  writer and prefill attention — go through the ops/ wrappers, which launch
  the CUDA kernels for CUDA tensors. `plain=True` runs every kernel's plain
  PyTorch version instead, whatever the device: the yardstick the kernel
  path is held against on the card.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.models.params import LlamaParams, resolve_device
from hip_llama_tpu_torch.ops import attention as _attn
from hip_llama_tpu_torch.ops import cache as _cache


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (B, L, KVH, S, HS)
    v: torch.Tensor  # (B, L, KVH, S, HS)


def init_kv_cache(
    cfg: ModelConfig,
    batch: int,
    dtype=torch.float32,
    seq_len: int | None = None,
    device="cuda",
) -> KVCache:
    s = seq_len or cfg.seq_len
    shape = (batch, cfg.n_layers, cfg.n_kv_heads, s, cfg.head_size)
    dev = resolve_device(device)
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


def _kernels(plain: bool):
    if plain:
        return (_attn.attention_decode_plain, _attn.attention_prefill_plain,
                _cache.kv_commit_rows_plain, _cache.kv_write_chunk_plain)
    return (_attn.attention_decode, _attn.attention_prefill,
            _cache.kv_commit_rows, _cache.kv_write_chunk)


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
    fp32 (B, V), cache). The cache is read-only inside the layer loop — the
    current token's K/V rows ride into attention as explicit operands — and
    the whole step's rows are committed in place by ONE kv_commit_rows
    launch after the loop, as in the JAX step."""
    attn_decode, _, commit, _ = _kernels(plain)
    c = cfg
    _exact_matmuls()

    def step(params: LlamaParams, cache: KVCache, tokens: torch.Tensor, pos: torch.Tensor):
        x = params.tok_emb[tokens.long()]  # (B, D)
        b = x.shape[0]
        rot = rope_tables(pos, c.head_size, c.rope_theta)
        k_list, v_list = [], []
        for l in range(c.n_layers):
            q, k, v = _qkv(x, params, l, c, rot)
            att = attn_decode(q, cache.k, cache.v, l, pos, k, v)
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
    valid_len=0 slots are bystanders) and then attends over it
    (attention_prefill).

    `last_only=True` returns logits fp32 (B, V) for each slot's LAST valid
    position only: the x rows are gathered before the final norm and the
    classifier, so the (B, T, V) logits are never computed."""
    _, attn_prefill, _, write_chunk = _kernels(plain)
    c = cfg
    _exact_matmuls()

    def prefill(params: LlamaParams, cache: KVCache, tokens: torch.Tensor,
                start: torch.Tensor, valid_len: torch.Tensor):
        b, t = tokens.shape
        x = params.tok_emb[tokens.long()]  # (B, T, D)
        pos = start[:, None] + torch.arange(t, dtype=torch.int32, device=x.device)[None, :]
        rot = rope_tables(pos, c.head_size, c.rope_theta)
        for l in range(c.n_layers):
            q, k, v = _qkv(x, params, l, c, rot)
            write_chunk(cache, k, v, l, start, valid_len)
            att = attn_prefill(q, cache.k, cache.v, l, start, valid_len)
            x = x + att.reshape(b, t, c.dim) @ params.wo[l]
            x = _ffn(x, params, l, c.norm_eps)
        if last_only:
            # valid_len=0 bystanders gather row 0; callers ignore them
            idx = torch.clamp(valid_len.long() - 1, min=0)
            x = x[torch.arange(b, device=x.device), idx]  # (B, D)
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

"""Paged-KV Llama forward: the decode step and page-aligned prefill — the port
of hip_llama_tpu/models/paged.py.

The device half of the paged KV design (host half: engine/block_manager.py).
Physical pages (L, KVH, P, PS, HS) are shared by every slot; a per-slot page
table (B, MAX_PAGES) int32 maps logical pages to physical ones, and row r
of slot b lives in page table[b, r // PS] at offset r % PS. Compared with
the dense cache (models/llama.py), KV memory scales with the tokens in
flight, not slots x window.

- The step and the prefill write the pool IN PLACE (the JAX functions
  donate it) and return the same cache object. The decode step commits all
  layers' rows after the layer loop, with ONE kv_write_rows_paged launch
  (K11) and on int8 pages one scale_write_rows_paged (K10) after
  quantize_kv_rows (paged.py:125-142); each prefill layer writes its chunk
  with kv_write_chunk_paged (K13) and on int8 pages scale_write_chunk_paged
  (K14), then attends with attention_prefill_paged (K7). Decode attention
  is attention_decode_paged (K6).
- Dense params take the layer of the JAX package's stacked path
  (paged.py:230-257), which is models/llama.py's dense layer.
- Quantized params (Q8_0 or int4) take the JAX package's unfused layer,
  which its CLI runs for --paged (run.py:409-417; paged.py:180-205 and
  :379-414): never the whole-layer, whole-FFN or fused-attention kernels.
  The port keeps its fused QKV and W1|W3 weights: one product over a
  concatenated weight gives each column the sums of the separate product
  (tests/test_torch_paged_model.py). The gate runs on h1 and h3 rounded to
  bf16, in plain PyTorch as XLA runs it (`silu_gate_bf16`). Under `a8` a
  product's arithmetic is decided from the shapes of the separate JAX
  products (q, k and v; W1 and W3) that the fused one stands for.
- HIPLLAMA_PREFILL_MINNER=1 (read when the prefill is made) lets the
  quantized prefill's Q8 products take K19 where the JAX paged prefill's
  separate products would (at 7B width and T-128 chunks of 8 slots, 1024
  rows, every one of them); the paged prefill never calls K16
  (HIPLLAMA_PREFILL_XHEADS is a contiguous-prefill knob).
- Prefill chunks must be page-aligned and at most one page long (the
  engine's prefill bucket is the page size), so each chunk writes one page
  per slot.
- `plain=True` runs every kernel's plain PyTorch version instead, whatever
  the device: the yardstick the kernel path is held against on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.models.llama import (
    _embed_q8,
    _exact_matmuls,
    _ffn,
    _kernels,
    _products,
    _qkv,
    _quant_logits,
    _quant_qkv,
    dequant_modes,
    make_logit_sampler,
    prefill_knobs,
    rmsnorm,
    rope_tables,
    run_sampling_chunk,
    silu_gate_bf16,
)
from hip_llama_tpu_torch.models.params import QuantLlamaParams, resolve_device
from hip_llama_tpu_torch.ops import attention as _attn
from hip_llama_tpu_torch.ops import cache as _cache


@dataclasses.dataclass
class PagedKVCache:
    k: torch.Tensor  # (L, KVH, P, PS, HS)
    v: torch.Tensor  # (L, KVH, P, PS, HS)
    # int8 pages: one fp32 scale per row, (L, KVH, P, PS)
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_paged_kv_cache(cfg: ModelConfig, num_pages: int, page_size: int = 128,
                        dtype=torch.float32, quantized: bool = False,
                        device="cuda") -> PagedKVCache:
    """A pool of `num_pages` zeroed pages of `dtype`, or with `quantized=True`
    int8 pages with scale planes of ones (paged.py:64-76)."""
    shape = (cfg.n_layers, cfg.n_kv_heads, num_pages, page_size, cfg.head_size)
    dev = resolve_device(device)
    if quantized:
        return PagedKVCache(torch.zeros(shape, dtype=torch.int8, device=dev),
                            torch.zeros(shape, dtype=torch.int8, device=dev),
                            torch.ones(shape[:-1], device=dev), torch.ones(shape[:-1], device=dev))
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=dev),
                        torch.zeros(shape, dtype=dtype, device=dev))


@dataclasses.dataclass(frozen=True)
class _PagedKernels:
    attn_decode: object  # K6
    attn_prefill: object  # K7
    write_rows: object  # K11
    scale_rows: object  # K10
    write_chunk: object  # K13
    scale_chunk: object  # K14


def _paged_kernels(plain: bool) -> _PagedKernels:
    if plain:
        return _PagedKernels(_attn.attention_decode_paged_plain,
                             _attn.attention_prefill_paged_plain,
                             _cache.kv_write_rows_paged_plain, _cache.scale_write_rows_paged_plain,
                             _cache.kv_write_chunk_paged_plain,
                             _cache.scale_write_chunk_paged_plain)
    return _PagedKernels(_attn.attention_decode_paged, _attn.attention_prefill_paged,
                         _cache.kv_write_rows_paged, _cache.scale_write_rows_paged,
                         _cache.kv_write_chunk_paged, _cache.scale_write_chunk_paged)


def _gate_ffn(pr, x2: torch.Tensor, params: QuantLlamaParams, l: int, cfg: ModelConfig):
    """x2 + W2 silu_gate_bf16(h1, h3) for rows x2 (M, D), where h1|h3 is one
    product over W1|W3 with the norm prologue, rounded to bf16 (the JAX
    package's unfused FFN, paged.py:202-205 and :411-414)."""
    y = pr.mm(x2, params.w1[l], norm_weight=params.rms_ffn[l], norm_eps=cfg.norm_eps,
              widths=(cfg.hidden_dim, cfg.hidden_dim))
    h = silu_gate_bf16(y[:, :cfg.hidden_dim], y[:, cfg.hidden_dim:])
    return pr.mm(h, params.w2[l], residual=x2)


def _paged_qkv(pr, x2, params: QuantLlamaParams, l: int, pos, cfg: ModelConfig):
    """_quant_qkv for the unfused layer, whose q, k and v are separate JAX
    products (paged.py:179-188)."""
    return _quant_qkv(pr, x2, params, l, pos, cfg, widths=(cfg.dim, cfg.kv_dim, cfg.kv_dim))


def _split_heads(qkv: torch.Tensor, h: int, kvh: int):
    """q, k and v of the head-split projection (..., H + 2 KVH, HS), each
    contiguous."""
    return (qkv[..., :h, :].contiguous(), qkv[..., h:h + kvh, :].contiguous(),
            qkv[..., h + kvh:, :].contiguous())


# ---------------------------------------------------------------------------
# decode step


def make_paged_decode_step(cfg: ModelConfig, plain: bool = False):
    """Returns step(params, cache, page_table (B, MAX_PAGES) int32, tokens
    (B,), pos (B,) int32) -> (logits fp32 (B, V), cache). The pool is
    read-only inside the layer loop — the current token's K/V rows ride into
    attention as explicit operands — and all layers' rows are committed in
    place after it (paged.py:145-270)."""
    kn = _kernels(plain)
    pk = _paged_kernels(plain)
    c = cfg
    h, kvh = c.n_heads, c.n_kv_heads
    modes = dequant_modes()
    _exact_matmuls()

    def commit(cache: PagedKVCache, k_list, v_list, table, pos):
        k_rows, v_rows = torch.stack(k_list), torch.stack(v_list)  # (L, B, KVH, HS)
        if cache.quantized:
            (kq, ks), (vq, vs) = _cache.quantize_kv_rows(k_rows), _cache.quantize_kv_rows(v_rows)
            pk.write_rows(cache, kq, vq, table, pos)
            pk.scale_rows(cache, ks, vs, table, pos)
        else:
            pk.write_rows(cache, k_rows, v_rows, table, pos)

    def step_quant(params: QuantLlamaParams, cache: PagedKVCache, table, tokens, pos):
        x = _embed_q8(params, tokens)  # (B, D) bf16
        b = x.shape[0]
        pr = _products(kn, params, modes)
        k_list, v_list = [], []
        for l in range(c.n_layers):
            q, k, v = _split_heads(_paged_qkv(pr, x, params, l, pos, c), h, kvh)
            att = pk.attn_decode(q, cache.k, cache.v, table, l, pos, k, v, cache.k_scale,
                                 cache.v_scale)
            x = pr.mm(att.view(b, c.dim), params.wo[l], residual=x)
            x = _gate_ffn(pr, x, params, l, c)
            k_list.append(k)
            v_list.append(v)
        commit(cache, k_list, v_list, table, pos)
        return _quant_logits(pr, x, params, c), cache

    def step(params, cache: PagedKVCache, table: torch.Tensor, tokens: torch.Tensor,
             pos: torch.Tensor):
        if isinstance(params, QuantLlamaParams):
            return step_quant(params, cache, table, tokens, pos)
        x = params.tok_emb[tokens.long()]  # (B, D)
        b = x.shape[0]
        rot = rope_tables(pos, c.head_size, c.rope_theta)
        k_list, v_list = [], []
        for l in range(c.n_layers):
            q, k, v = _qkv(x, params, l, c, rot)
            att = pk.attn_decode(q, cache.k, cache.v, table, l, pos, k, v, cache.k_scale,
                                 cache.v_scale)
            x = x + att.reshape(b, c.dim) @ params.wo[l]
            x = _ffn(x, params, l, c.norm_eps)
            k_list.append(k)
            v_list.append(v)
        commit(cache, k_list, v_list, table, pos)
        logits = (rmsnorm(x, params.rms_final, c.norm_eps) @ params.wcls).float()
        return logits, cache

    return step


def make_paged_chunked_sampling_step(cfg: ModelConfig, n_steps: int, temperature: float = 0.0,
                                     topp: float = 0.9, return_logits: bool = False,
                                     plain: bool = False):
    """Multi-step scheduling over the paged pool (paged.py:273-302 of the JAX
    package): chunk(params, cache, page_table, tokens, pos, generator=None)
    -> (tokens (B, n_steps) int32, cache), `n_steps` decode steps each
    sampling on the device and feeding the next (models/llama.py::
    make_chunked_sampling_step).

    The page table is fixed for the whole chunk, so the host reserves pages
    covering positions [pos, pos + n_steps) of every active slot before the
    call (the engine's ensure_capacity). A slot that retires mid-chunk keeps
    writing into its still-reserved pages; an idle slot's table row is all
    trash page (block_manager.TRASH_PAGE), where its writes land."""
    step = make_paged_decode_step(cfg, plain=plain)
    sample_logits = make_logit_sampler(temperature, topp)

    def chunk(params, cache: PagedKVCache, page_table, tokens, pos, generator=None):
        return run_sampling_chunk(lambda c, t, p: step(params, c, page_table, t, p), cache,
                                  tokens, pos, generator, n_steps, sample_logits, return_logits)

    return chunk


# ---------------------------------------------------------------------------
# prefill


def make_paged_prefill(cfg: ModelConfig, last_only: bool = False, plain: bool = False):
    """Returns prefill(params, cache, page_table (B, MAX_PAGES), tokens (B,
    T), start (B,), valid (B,)) -> (logits fp32 (B, T, V), cache); (B, V)
    logits of each slot's last valid row with `last_only=True`.

    REQUIRES page-aligned starts and T <= page size (paged.py:305-322): the
    chunk's rows j < valid[b] land in page table[b, start[b] // PS] at
    offset j; valid[b] == 0 makes slot b a bystander."""
    kn = _kernels(plain)
    pk = _paged_kernels(plain)
    c = cfg
    h, kvh = c.n_heads, c.n_kv_heads
    modes = dequant_modes()
    minner = prefill_knobs().minner
    _exact_matmuls()

    def last_rows(x, valid):
        # valid=0 bystanders gather row 0; callers ignore them
        idx = torch.clamp(valid.long() - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device), idx]  # (B, D)

    def write_and_attend(cache: PagedKVCache, table, q, k, v, l, start, valid):
        """Write the chunk's k/v (B, T, KVH, HS) into layer l's pages, then
        attend over them with q (B, T, H, HS)."""
        if cache.quantized:
            (kq, ks), (vq, vs) = _cache.quantize_kv_rows(k), _cache.quantize_kv_rows(v)
            pk.write_chunk(cache, kq, vq, l, table, start, valid)
            pk.scale_chunk(cache, ks, vs, l, table, start, valid)
        else:
            pk.write_chunk(cache, k, v, l, table, start, valid)
        return pk.attn_prefill(q, cache.k, cache.v, table, l, start, valid, cache.k_scale,
                               cache.v_scale)

    def prefill_quant(params: QuantLlamaParams, cache, table, tokens, start, valid, pos):
        b, t = tokens.shape
        x = _embed_q8(params, tokens).view(b * t, c.dim)  # (B*T, D) bf16
        pos = pos.reshape(-1)
        pr = _products(kn, params, modes, minner)
        for l in range(c.n_layers):
            qkv = _paged_qkv(pr, x, params, l, pos, c).view(b, t, h + 2 * kvh, c.head_size)
            att = write_and_attend(cache, table, *_split_heads(qkv, h, kvh), l, start, valid)
            x = pr.mm(att.view(b * t, c.dim), params.wo[l], residual=x)
            x = _gate_ffn(pr, x, params, l, c)
        x = x.view(b, t, c.dim)
        if last_only:
            x = last_rows(x, valid)
        logits = _quant_logits(pr, x.reshape(-1, c.dim), params, c)
        return logits.view(*x.shape[:-1], -1), cache

    def prefill(params, cache: PagedKVCache, table: torch.Tensor, tokens: torch.Tensor,
                start: torch.Tensor, valid: torch.Tensor):
        b, t = tokens.shape
        if t > cache.page_size:
            raise ValueError(f"a paged prefill chunk of {t} tokens must fit one page of "
                             f"{cache.page_size}")
        pos = start[:, None] + torch.arange(t, dtype=torch.int32, device=tokens.device)[None, :]
        if isinstance(params, QuantLlamaParams):
            return prefill_quant(params, cache, table, tokens, start, valid, pos)
        x = params.tok_emb[tokens.long()]  # (B, T, D)
        rot = rope_tables(pos, c.head_size, c.rope_theta)
        for l in range(c.n_layers):
            q, k, v = _qkv(x, params, l, c, rot)
            att = write_and_attend(cache, table, q, k, v, l, start, valid)
            x = x + att.reshape(b, t, c.dim) @ params.wo[l]
            x = _ffn(x, params, l, c.norm_eps)
        if last_only:
            x = last_rows(x, valid)
        logits = (rmsnorm(x, params.rms_final, c.norm_eps) @ params.wcls).float()
        return logits, cache

    return prefill

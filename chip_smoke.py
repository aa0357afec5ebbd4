#!/usr/bin/env python3
"""Smoke test of hip_llama_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; each raises on failure and none is caught:
  1. the card: its name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every csrc/*.cu kernel compiled from source with nvcc (sm_90a);
  3. each kernel against its plain PyTorch version on the card at Llama-2-7B
     shapes (B 8, L 32, KVH 32, HS 128, S 512; prefill T 256), in bf16 and
     fp32, with its time, the plain version's time, the time of one PyTorch
     library call doing the same work where there is one, and its bound;
  3b. the Q8 kernels (q8_matmul, q8_matmul_silu, q8_matmul_ffn,
     attention_decode_fused, q8_layer_fused) against their plain versions at
     7B shapes in bf16, with the same timings;
  4. the committed golden fixture through the port's CLI (fp32, greedy,
     -b 4) on all five *_in_8 corpora: byte-identical to assets/out/cpu_f32;
  4b. the same with --quant q8, scored against the JAX package's Q8 outputs
     assets/out/cpu_q8 at the golden bars (3 corpora at 1.0, average 0.75),
     once with the decode layer as one q8_layer_fused kernel (the default)
     and once as four kernels (HIPLLAMA_LAYER_FUSE=0), each run's kernel
     launches counted;
  5. a Llama-2-7B-width model (random bf16 weights made on the card from a
     seed, depth uncut) served through InferenceEngine.serve: 16 requests at
     batch 8, window 512, greedy; the first prefill and decode logits held
     against the plain path; the dense path's kernel launches counted;
  5b. the same serve with Q8_0 weights (quantized layer by layer on the
     card) through the Q8 path, its kernel launches counted; a control (the
     plain path with layer 0's FFN dropped) must read above the logit
     tolerance;
  6. the int8 KV cache (--kv int8): the int8 branches of K1-K5 and K23 and
     the scale writer K12 against their plain versions at 7B shapes (K2,
     K3 and K12 bit-exact); the golden fixture with --kv int8, dense fp32
     and Q8 with the fused and the four-kernel layer, scored against the
     JAX package's assets/out/cpu_f32_kv8 and cpu_q8_kv8; and the 7B-width
     Q8 serve of phase 5b on an int8 cache, with its logit check, control
     and launches (K23 32 per decode step);
  7. int4 weights (--quant q4, v4 files): K21 q4_matmul and K22
     q4_matmul_silu against their plain versions at 7B shapes (group size
     32), with the same timings; the golden fixture with --quant q4 (bf16
     and int8 cache) scored against the JAX package's assets/out/cpu_q4 and
     cpu_q4_kv8, a v4 file of it written by the port (byte-identical to the
     --quant q4 outputs) and a --dequant run of that file; and the 7B-width
     serve of phase 5 with int4 weights quantized on the card, with its
     logit check, control, launches (K21 97, K22 32, K5 32, K2 1 per decode
     step, no Q8 kernel) and profile.
The last two lines are the card line and {"ok": true, "device": ...}. With no
CUDA card, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from hip_llama_tpu_torch import run as port_run
from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.engine import InferenceEngine, Requests, read_inputfile
from hip_llama_tpu_torch.io.checkpoint import load_checkpoint, write_v4
from hip_llama_tpu_torch.io.tokenizer_io import read_tokenizer_bin, write_tokenizer_bin
from hip_llama_tpu_torch.models.llama import KVCache, init_kv_cache, make_decode_step, make_prefill
from hip_llama_tpu_torch.models.params import LlamaParams, QuantLlamaParams
from hip_llama_tpu_torch.ops import _build, launch_counts, reset_launches
from hip_llama_tpu_torch.ops import attention as A
from hip_llama_tpu_torch.ops import cache as C
from hip_llama_tpu_torch.ops import layer_fused as LF
from hip_llama_tpu_torch.ops import quant as Q
from hip_llama_tpu_torch.ops import quant4 as Q4
from hip_llama_tpu_torch.sampler import Sampler
from hip_llama_tpu_torch.tokenizer import Tokenizer

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "assets", "golden")
CORPORA = ("gen", "sciq", "tinystories", "truthful_qa", "wikipedia")

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
# kernel vs plain version: fp32 differs in summation order only (512-row
# sums of O(1) terms); bf16 by about one ulp of an O(1) output, as
# tests/test_attention_pallas.py:83-85 allows
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# first-decode-step logits of the 7B-width model, kernel path vs plain path:
# O(1) logits from 4096-long bf16 products after 32 bf16 layers, where the
# two paths differ only in attention's summation order and rounding
LOGIT_TOL = 0.25
# the same for the Q8 path, where every product of every layer also sums in
# another order (split-K GEMV or tensor-core tiles against fp32 matmuls of
# the dequantized weights) before its bf16 rounding. The logits are about
# N(0, 1); sound runs of this script read about 0.08 on a bf16 cache and
# 0.096 on an int8 one (where a k or v element a bf16 ulp apart can round
# to the next int8 value), and the control (the plain path with layer 0's
# FFN dropped) must read above the limit
Q8_LOGIT_TOL = 0.2
# the same for the int4 path: the same cast points as Q8 (weights
# dequantized to bf16 before the products), the sums in another order
Q4_LOGIT_TOL = 0.2
# Q8 product outputs vs plain: bf16 values of magnitude up to ~8 from the
# same cast points with fp32 sums in another order, one bf16 ulp apart at
# most (tests/test_torch_cuda.py)
Q8_ATOL = Q8_RTOL = 2e-2
# K5 outputs vs plain: attention averages of 0.05 to 1 in magnitude whose
# bf16 probabilities round after a running max taken over 64-row blocks
# (kernel) or 128-row blocks (plain): a few ulps relative
ATTN_ATOL, ATTN_RTOL = 4e-3, 2e-2
# int8-cache attention vs plain: the int8 dots are exact on both sides and
# the blocks are the JAX blocks on both, so the bf16 outputs read 1.5e-5
# apart at most; an ulp of expf could still move one quantized probability
# by one int8 step (up to 1/127 of an output) and round it to the next bf16
INT8_ATTN_ATOL, INT8_ATTN_RTOL = 2e-3, 1e-2

SEED = 1234
LLAMA2_7B = ModelConfig(dim=4096, hidden_dim=11008, n_layers=32, n_heads=32,
                        n_kv_heads=32, vocab_size=32000, seq_len=2048)
KERNEL_SOURCES = {
    "attention_decode": ("hip_llama_tpu_torch/csrc/attention.cu",
                         "hip_llama_tpu/ops/attention.py:1163"),
    "kv_commit_rows": ("hip_llama_tpu_torch/csrc/cache.cu",
                       "hip_llama_tpu/ops/cache.py:304"),
    "kv_write_chunk": ("hip_llama_tpu_torch/csrc/cache.cu",
                       "hip_llama_tpu/ops/cache.py:747"),
    "attention_prefill": ("hip_llama_tpu_torch/csrc/attention.cu",
                          "hip_llama_tpu/ops/attention.py:957"),
    "q8_matmul": ("hip_llama_tpu_torch/csrc/quant.cu", "hip_llama_tpu/ops/quant.py:1213"),
    "attention_decode_fused": ("hip_llama_tpu_torch/csrc/attention.cu",
                               "hip_llama_tpu/ops/attention.py:1486"),
    "q8_matmul_ffn": ("hip_llama_tpu_torch/csrc/quant.cu", "hip_llama_tpu/ops/quant.py:894"),
    "q8_matmul_silu": ("hip_llama_tpu_torch/csrc/quant.cu", "hip_llama_tpu/ops/quant.py:609"),
    "q8_layer_fused": ("hip_llama_tpu_torch/csrc/layer_fused.cu",
                       "hip_llama_tpu/ops/layer_fused.py:316"),
    # the int8 KV cache: the int8 branches of six kernels, and K12
    "attention_decode_int8": ("hip_llama_tpu_torch/csrc/attention.cu",
                              "hip_llama_tpu/ops/attention.py:1163"),
    "kv_commit_rows_int8": ("hip_llama_tpu_torch/csrc/cache.cu",
                            "hip_llama_tpu/ops/cache.py:304"),
    "kv_write_chunk_int8": ("hip_llama_tpu_torch/csrc/cache.cu",
                            "hip_llama_tpu/ops/cache.py:747"),
    "scale_write_chunk": ("hip_llama_tpu_torch/csrc/cache.cu",
                          "hip_llama_tpu/ops/cache.py:845"),
    "attention_prefill_int8": ("hip_llama_tpu_torch/csrc/attention.cu",
                               "hip_llama_tpu/ops/attention.py:957"),
    "attention_decode_fused_int8": ("hip_llama_tpu_torch/csrc/attention.cu",
                                    "hip_llama_tpu/ops/attention.py:1486"),
    "q8_layer_fused_int8": ("hip_llama_tpu_torch/csrc/layer_fused.cu",
                            "hip_llama_tpu/ops/layer_fused.py:316"),
    # int4 weights
    "q4_matmul": ("hip_llama_tpu_torch/csrc/quant4.cu", "hip_llama_tpu/ops/quant4.py:299"),
    "q4_matmul_silu": ("hip_llama_tpu_torch/csrc/quant4.cu", "hip_llama_tpu/ops/quant4.py:547"),
}
# the kernels each serving path must launch
DENSE_PATH = ("attention_decode", "kv_commit_rows", "kv_write_chunk", "attention_prefill")
Q8_PATH = ("q8_matmul", "q8_layer_fused", "q8_matmul_ffn", "q8_matmul_silu",
           "kv_commit_rows", "kv_write_chunk", "attention_prefill")
# the golden fixture's Q8 runs: prefill chunks of at most 256 rows take K18
GOLDEN_Q8_RUNS = {
    "q8, fused layer": (["--quant", "q8"], "1", "cpu_q8",
                        ("q8_layer_fused", "q8_matmul", "q8_matmul_ffn", "kv_commit_rows",
                         "kv_write_chunk", "attention_prefill"), True),
    "q8, four-kernel layer": (["--quant", "q8"], "0", "cpu_q8",
                              ("attention_decode_fused", "q8_matmul", "q8_matmul_ffn",
                               "kv_commit_rows", "kv_write_chunk", "attention_prefill"), True),
}
# the same on an int8 cache, and the dense fp32 fixture with it
INT8_CACHE_PATH = ("kv_commit_rows_int8", "kv_write_chunk_int8", "scale_write_chunk",
                   "attention_prefill_int8")
# The Q8 int8 runs are held to the average bar only: a bf16 ulp where the
# card and XLA round differently can move a cached value to the next int8
# value, and greedy decoding forks at the next near-tie of the bf16 logits
# (tests/test_torch_kv_int8_model.py::test_q8_int8_serve_forks_from_jax_only
# _at_near_ties).
GOLDEN_INT8_RUNS = {
    "fp32 --kv int8": (["--dtype", "float32", "--kv", "int8"], "1", "cpu_f32_kv8",
                       ("attention_decode_int8",) + INT8_CACHE_PATH, True),
    "q8 --kv int8, fused layer": (["--quant", "q8", "--kv", "int8"], "1", "cpu_q8_kv8",
                                  ("q8_layer_fused_int8", "q8_matmul", "q8_matmul_ffn")
                                  + INT8_CACHE_PATH, False),
    "q8 --kv int8, four-kernel layer": (["--quant", "q8", "--kv", "int8"], "0", "cpu_q8_kv8",
                                        ("attention_decode_fused_int8", "q8_matmul",
                                         "q8_matmul_ffn") + INT8_CACHE_PATH, False),
}
Q8_INT8_PATH = ("q8_matmul", "q8_layer_fused_int8", "q8_matmul_ffn", "q8_matmul_silu",
                "kv_commit_rows_int8", "kv_write_chunk_int8", "scale_write_chunk",
                "attention_prefill_int8")
# the int4 path: K21 and K22 carry every product, whatever the row count
# and HIPLLAMA_LAYER_FUSE say; the decode layer is four kernels
Q4_PATH = ("q4_matmul", "q4_matmul_silu", "attention_decode_fused", "kv_commit_rows",
           "kv_write_chunk", "attention_prefill")
# the wrapper launches of one 7B decode step on each path
_L = LLAMA2_7B.n_layers
DENSE_STEP = {"attention_decode": _L, "kv_commit_rows": 1}
Q8_STEP = {"q8_layer_fused": _L, "q8_matmul": 1, "kv_commit_rows": 1}
Q8_INT8_STEP = {"q8_layer_fused_int8": _L, "q8_matmul": 1, "kv_commit_rows_int8": 1}
Q4_STEP = {"q4_matmul": 3 * _L + 1, "q4_matmul_silu": _L, "attention_decode_fused": _L,
           "kv_commit_rows": 1}
# int4 on the fixture, at the bars of the Q8 runs (bf16 cache: both; int8
# cache: the average)
GOLDEN_Q4_RUNS = {
    "q4": (["--quant", "q4"], "1", "cpu_q4", Q4_PATH, True),
    "q4 --kv int8": (["--quant", "q4", "--kv", "int8"], "1", "cpu_q4_kv8",
                     ("q4_matmul", "q4_matmul_silu", "attention_decode_fused_int8",
                      "kv_commit_rows_int8", "kv_write_chunk_int8", "scale_write_chunk",
                      "attention_prefill_int8"), False),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 16, warmup: int = 3, graph: bool = False) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls.
    With `graph`, the calls are captured in one CUDA graph and the events
    time its replay: for a kernel whose device time is below its wrapper's
    host cost, which back-to-back calls would time instead."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(i)
        g.replay()
        torch.cuda.synchronize()
        e0.record()
        g.replay()
        e1.record()
    else:
        e0.record()
        for i in range(iters):
            fn(i)
        e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple[float, str]:
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at 7B shapes


def phase_kernels(dtype) -> dict[str, dict]:
    """Each kernel vs its plain version on the same inputs; times rotate over
    8 layers of the cache (8 x 33 MB in bf16) so each call finds its rows
    cold in the 50 MB L2, as a decode step does."""
    dev = torch.device("cuda")
    b, n_layers, kvh, h, s, hs, t = 8, 32, 32, 32, 512, 128, 256
    e = torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    cache = KVCache(rnd(b, n_layers, kvh, s, hs), rnd(b, n_layers, kvh, s, hs))
    rot = 8
    out: dict[str, dict] = {}

    # K1 decode: ragged positions including 0 and S-1
    pos_l = [0, 1, 100, 255, 256, 300, 450, s - 1]
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    q = rnd(b, h, hs)
    kc, vc = rnd(b, kvh, hs), rnd(b, kvh, hs)
    err = max(max_err(A.attention_decode(q, cache.k, cache.v, l, pos, kc, vc),
                      A.attention_decode_plain(q, cache.k, cache.v, l, pos, kc, vc))
              for l in (0, n_layers - 1))
    ms = cuda_ms(lambda i: A.attention_decode(q, cache.k, cache.v, i % rot, pos, kc, vc))
    plain = cuda_ms(lambda i: A.attention_decode_plain(q, cache.k, cache.v, i % rot, pos, kc, vc))
    # library: SDPA over [history rows | current row] with the same mask
    kf = [torch.cat([cache.k[:, l], kc[:, :, None]], dim=2) for l in range(rot)]
    vf = [torch.cat([cache.v[:, l], vc[:, :, None]], dim=2) for l in range(rot)]
    col = torch.arange(s + 1, device=dev)
    mask = ((col[None, :] < pos[:, None]) | (col[None, :] == s))[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = cuda_ms(lambda i: F.scaled_dot_product_attention(q4, kf[i % rot], vf[i % rot], attn_mask=mask))
    n_bytes = (2 * b * h * hs + 2 * b * kvh * hs + 2 * sum(pos_l) * kvh * hs) * e + 4 * b
    flops = 4 * h * hs * sum(p + 1 for p in pos_l)
    out["attention_decode"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                   bound=bound_ms(n_bytes, flops, dtype))
    del kf, vf

    # K2 commit: every slot (then a valid mask) at ragged positions
    kr, vr = rnd(n_layers, b, kvh, hs), rnd(n_layers, b, kvh, hs)
    err = 0.0
    for valid in (None, torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.int32, device=dev)):
        c1 = KVCache(cache.k.clone(), cache.v.clone())
        c2 = KVCache(cache.k.clone(), cache.v.clone())
        C.kv_commit_rows(c1, kr, vr, pos, valid)
        C.kv_commit_rows_plain(c2, kr, vr, pos, valid)
        err = max(err, max_err(c1.k, c2.k), max_err(c1.v, c2.v))
        del c1, c2
    ms = cuda_ms(lambda i: C.kv_commit_rows(cache, kr, vr, pos), graph=True)
    plain = cuda_ms(lambda i: C.kv_commit_rows_plain(cache, kr, vr, pos))
    n_bytes = 2 * 2 * n_layers * b * kvh * hs * e + 4 * b
    out["kv_commit_rows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                                 bound=bound_ms(n_bytes, 0, dtype))

    # K3 chunk writer: ragged valid, one bystander, windows past S
    start_l = [0, 40, 128, 256, 300, 5, 400, 200]
    valid_l = [256, 200, 64, 256, 100, 0, 112, 1]
    start = torch.tensor(start_l, dtype=torch.int32, device=dev)
    cvalid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
    ck, cv = rnd(b, t, kvh, hs), rnd(b, t, kvh, hs)
    c1 = KVCache(cache.k.clone(), cache.v.clone())
    c2 = KVCache(cache.k.clone(), cache.v.clone())
    C.kv_write_chunk(c1, ck, cv, 3, start, cvalid)
    C.kv_write_chunk_plain(c2, ck, cv, 3, start, cvalid)
    err = max(max_err(c1.k, c2.k), max_err(c1.v, c2.v))
    del c1, c2
    ms = cuda_ms(lambda i: C.kv_write_chunk(cache, ck, cv, i % rot, start, cvalid), graph=True)
    plain = cuda_ms(lambda i: C.kv_write_chunk_plain(cache, ck, cv, i % rot, start, cvalid))
    rows = sum(max(0, min(v, s - st)) for st, v in zip(start_l, valid_l))
    n_bytes = 2 * 2 * rows * kvh * hs * e + 8 * b
    out["kv_write_chunk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                                 bound=bound_ms(n_bytes, 0, dtype))

    # K4 prefill over the chunk just written (rows t < valid compared)
    qp = rnd(b, t, h, hs)
    live = torch.arange(t, device=dev)[None, :] < cvalid[:, None]
    err = max(max_err(A.attention_prefill(qp, cache.k, cache.v, l, start, cvalid)[live],
                      A.attention_prefill_plain(qp, cache.k, cache.v, l, start, cvalid)[live])
              for l in (0, 3))
    ms = cuda_ms(lambda i: A.attention_prefill(qp, cache.k, cache.v, i % rot, start, cvalid))
    plain = cuda_ms(lambda i: A.attention_prefill_plain(qp, cache.k, cache.v, i % rot, start, cvalid),
                    iters=4)
    colp = torch.arange(s, device=dev)
    qpos = start[:, None] + torch.arange(t, device=dev)[None, :]
    pmask = (colp[None, None, :] <= qpos[:, :, None])[:, None]  # (B, 1, T, S)
    qt = qp.transpose(1, 2)
    lib = cuda_ms(lambda i: F.scaled_dot_product_attention(
        qt, cache.k[:, i % rot], cache.v[:, i % rot], attn_mask=pmask))
    n_rows = sum(v for v in valid_l)
    kv_rows = sum(min(st + v, s) for st, v in zip(start_l, valid_l) if v)
    n_bytes = (2 * n_rows * h * hs + 2 * kv_rows * kvh * hs) * e + 8 * b
    flops = 4 * h * hs * sum(min(st + j, s - 1) + 1 for st, v in zip(start_l, valid_l)
                             for j in range(v))
    out["attention_prefill"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                    bound=bound_ms(n_bytes, flops, dtype))

    for name, r in out.items():
        ok = r["max_abs_err"] <= TOL[dtype]
        lib_s = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {name} {str(dtype)[6:]}: max_abs_err {r['max_abs_err']:.3g} "
              f"(tol {TOL[dtype]:g}) {'ok' if ok else 'FAIL'}; ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} library_ms {lib_s} "
              f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]})", flush=True)
        if not ok:
            raise AssertionError(f"{name} ({dtype}) disagrees with its plain version")
    return out


# ---------------------------------------------------------------------------
# phase 3b: the Q8 kernels against their plain versions at 7B shapes


def q8_kernel_case(name: str, label: str, fn, plain_fn, lib_fn, n_bytes: float,
                   flops: float, atol: float = Q8_ATOL, rtol: float = Q8_RTOL) -> dict:
    """One kernel case: fn(i) and plain_fn(i) on the same inputs (i rotates
    over weight copies so that each call finds its weights cold in L2),
    compared elementwise at atol + rtol * |plain| (each output of a tuple),
    then timed. lib_fn None: no single library call does this work."""
    got, want = fn(0), plain_fn(0)
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = max(max_err(a, b) for a, b in pairs)
    ok = all(bool(((a.float() - b.float()).abs() <= atol + rtol * b.float().abs()).all())
             for a, b in pairs)
    del got, want, pairs
    ms = cuda_ms(fn)
    plain = cuda_ms(plain_fn, iters=4, warmup=1)
    lib = None if lib_fn is None else cuda_ms(lib_fn)
    bound = bound_ms(n_bytes, flops, torch.bfloat16)
    lib_s = "n/a" if lib is None else f"{lib:.4f}"
    print(f"kernel {name} [{label}] bfloat16: max_abs_err {err:.3g} (atol {atol:g} + rtol "
          f"{rtol:g} x |plain|) {'ok' if ok else 'FAIL'}; ms {ms:.4f} plain_ms {plain:.4f} "
          f"library_ms {lib_s} bound_ms {bound[0]:.4f} ({bound[1]})", flush=True)
    if not ok:
        raise AssertionError(f"{name} [{label}] disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound=bound)


def phase_q8_kernels() -> dict[str, dict]:
    """K15, K17, K18, K5 and K23 at Llama-2-7B shapes, bf16 activations,
    Q8_0 weights of group size 64. Library yardstick for the products:
    cuBLAS `x @ w` on the weight dequantized to bf16 beforehand (twice the
    weight bytes); for K5, SDPA as for K1; none for the whole layer. Bytes
    count int8 weights, fp32 scales, live cache rows, activations in and out
    once each."""
    dev = torch.device("cuda")
    d, hid, voc, gs = 4096, 11008, 32000, 64
    nqkv = 3 * d
    g = torch.Generator(device=dev).manual_seed(SEED + 2)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    def weights(k, n, copies):
        return [Q.q8_quantize_weights(rnd(k, n, dtype=torch.float32).mul_(k ** -0.5), gs)
                for _ in range(copies)]

    def wbytes(k, n):
        return k * n + (k // gs) * n * 4

    def deq(ws):
        return [Q.q8_dequantize(w).to(torch.bfloat16) for w in ws]

    norm = (1 + 0.1 * rnd(d, dtype=torch.float32)).contiguous()
    out: dict[str, list] = {}

    def case(name, label, fn, plain_fn, lib_fn, n_bytes, flops, **tol):
        out.setdefault(name, []).append(
            q8_kernel_case(name, label, fn, plain_fn, lib_fn, n_bytes, flops, **tol))

    # K15: QKV with norm + RoPE at decode and prefill rows, wo with the
    # residual, the classifier with the norm
    wq = weights(d, nqkv, 2)
    wqb = deq(wq)
    rope = dict(rope_limit=2 * d, rope_head=128, rope_theta=10000.0)
    for m in (8, 2048):
        x = rnd(m, d)
        pos = (torch.tensor([0, 1, 100, 255, 256, 300, 450, 511], dtype=torch.int32, device=dev)
               if m == 8 else torch.arange(m, dtype=torch.int32, device=dev) % 512)
        case("q8_matmul", f"QKV M {m}, norm + RoPE",
             lambda i: Q.q8_matmul(x, wq[i % 2], norm_weight=norm, rope_pos=pos, **rope),
             lambda i: Q.q8_matmul_plain(x, wq[i % 2], norm_weight=norm, rope_pos=pos, **rope),
             lambda i: x @ wqb[i % 2],
             wbytes(d, nqkv) + m * d * 2 + m * nqkv * 2 + d * 4 + m * 4, 2 * m * d * nqkv)
    del wq, wqb
    wo = weights(d, d, 4)
    wob = deq(wo)
    x, res = rnd(8, d), rnd(8, d)
    case("q8_matmul", "wo M 8, residual",
         lambda i: Q.q8_matmul(x, wo[i % 4], residual=res),
         lambda i: Q.q8_matmul_plain(x, wo[i % 4], residual=res),
         lambda i: x @ wob[i % 4], wbytes(d, d) + 3 * 8 * d * 2, 2 * 8 * d * d)
    del wo, wob
    wc = weights(d, voc, 1)
    wcb = deq(wc)
    case("q8_matmul", "classifier M 8, norm",
         lambda i: Q.q8_matmul(x, wc[0], norm_weight=norm),
         lambda i: Q.q8_matmul_plain(x, wc[0], norm_weight=norm),
         lambda i: x @ wcb[0], wbytes(d, voc) + 8 * d * 2 + 8 * voc * 2 + d * 4,
         2 * 8 * d * voc)
    del wc, wcb

    # K17 at prefill rows, K18 at decode and T-16 chunk rows
    w13, w2 = weights(d, 2 * hid, 2), weights(hid, d, 2)
    w13b, w2b = deq(w13), deq(w2)
    for m in (512, 2048):
        x = rnd(m, d)
        case("q8_matmul_silu", f"W1|W3 gate M {m}, norm",
             lambda i: Q.q8_matmul_silu(x, w13[i % 2], norm_weight=norm),
             lambda i: Q.q8_matmul_silu_plain(x, w13[i % 2], norm_weight=norm),
             lambda i: x @ w13b[i % 2],
             wbytes(d, 2 * hid) + m * d * 2 + m * hid * 2 + d * 4, 2 * m * d * 2 * hid)
    for m in (8, 128):
        x, hb = rnd(m, d), rnd(m, hid)
        case("q8_matmul_ffn", f"FFN M {m}",
             lambda i: Q.q8_matmul_ffn(x, w13[i % 2], w2[i % 2], x, norm),
             lambda i: Q.q8_matmul_ffn_plain(x, w13[i % 2], w2[i % 2], x, norm),
             lambda i: (x @ w13b[i % 2], hb @ w2b[i % 2]),
             wbytes(d, 2 * hid) + wbytes(hid, d) + 3 * m * d * 2 + d * 4,
             2 * m * d * 2 * hid + 2 * m * hid * d)
    del w13, w2, w13b, w2b

    # K5 over a 7B-shaped cache, layers rotating as for K1
    b, n_layers, kvh, h, s, hs, rot = 8, 32, 32, 32, 512, 128, 8
    cache = KVCache(rnd(b, n_layers, kvh, s, hs), rnd(b, n_layers, kvh, s, hs))
    pos_l = [0, 1, 100, 255, 256, 300, 450, s - 1]
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    qkv = rnd(b, h + 2 * kvh, hs)
    kf = [torch.cat([cache.k[:, l], qkv[:, h:h + kvh, None]], dim=2) for l in range(rot)]
    vf = [torch.cat([cache.v[:, l], qkv[:, h + kvh:, None]], dim=2) for l in range(rot)]
    col = torch.arange(s + 1, device=dev)
    mask = ((col[None, :] < pos[:, None]) | (col[None, :] == s))[:, None, None, :]
    q4 = qkv[:, :h, None, :]
    case("attention_decode_fused", "B 8, H 32, KVH 32, S 512, HS 128",
         lambda i: A.attention_decode_fused(qkv, cache.k, cache.v, i % rot, pos, h),
         lambda i: A.attention_decode_fused_plain(qkv, cache.k, cache.v, i % rot, pos, h),
         lambda i: F.scaled_dot_product_attention(q4, kf[i % rot], vf[i % rot], attn_mask=mask),
         (b * (h + 2 * kvh) * hs + b * h * hs + 2 * sum(pos_l) * kvh * hs) * 2 + 4 * b,
         4 * h * hs * sum(p + 1 for p in pos_l), atol=ATTN_ATOL, rtol=ATTN_RTOL)
    del kf, vf

    # K23: one whole decode layer over the same cache, weights rotating over
    # two copies
    lw = [dict(wqkv=weights(d, nqkv, 1)[0], wo=weights(d, d, 1)[0],
               w13=weights(d, 2 * hid, 1)[0], w2=weights(hid, d, 1)[0]) for _ in range(2)]
    g2 = (1 + 0.1 * rnd(d, dtype=torch.float32)).contiguous()
    x = rnd(b, d)

    def layer(fn, i):
        w = lw[i % 2]
        return fn(x, w["wqkv"], w["wo"], w["w13"], w["w2"], norm, g2, cache.k, cache.v, i % rot,
                  pos, n_heads=h)

    case("q8_layer_fused", "B 8, 7B layer, S 512",
         lambda i: layer(LF.q8_layer_fused, i), lambda i: layer(LF.q8_layer_fused_plain, i), None,
         wbytes(d, nqkv) + wbytes(d, d) + wbytes(d, 2 * hid) + wbytes(hid, d)
         + 2 * sum(pos_l) * kvh * hs * 2 + (2 * b * d + b * 2 * kvh * hs) * 2 + 2 * d * 4 + 4 * b,
         2 * b * (d * nqkv + d * d + 3 * d * hid) + 4 * h * hs * sum(p + 1 for p in pos_l))
    del lw, cache
    # the kernels line carries each kernel's decode case (the prefill case
    # for K17, which serves prefill rows only); max_abs_err over all cases
    first = {"q8_matmul": 0, "q8_matmul_silu": 1, "q8_matmul_ffn": 0,
             "attention_decode_fused": 0, "q8_layer_fused": 0}
    return {name: dict(rs[first[name]], max_abs_err=max(r["max_abs_err"] for r in rs))
            for name, rs in out.items()}


# ---------------------------------------------------------------------------
# phase 6a: the int8 cache's kernels against their plain versions at 7B shapes


def dequant_cache(q: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    return (q.float() * sc[..., None]).to(torch.bfloat16)


def phase_kernels_int8() -> dict[str, dict]:
    """The int8 branches of K1, K2, K3, K4, K5 and K23, and K12, at
    Llama-2-7B shapes (B 8, L 32, KVH 32, HS 128, S 512, ragged positions,
    T 256) with bf16 activations, on an int8 cache quantized from seeded
    draws. The writers must match their plain versions bit for bit. Bytes
    count int8 rows plus their 4-byte scales, activations in and out once
    each; the library yardstick is SDPA on K/V dequantized to bf16
    beforehand (and so reading twice the bytes)."""
    dev = torch.device("cuda")
    b, n_layers, kvh, h, s, hs, t, rot = 8, 32, 32, 32, 512, 128, 256, 8
    d, hid, gs = 4096, 11008, 64
    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    planes = [C.quantize_kv_rows(rnd(b, n_layers, kvh, s, hs)) for _ in range(2)]
    cache = KVCache(planes[0][0], planes[1][0], planes[0][1], planes[1][1])
    del planes
    out: dict[str, dict] = {}

    def case(name, label, fn, plain_fn, lib_fn, n_bytes, flops, atol=INT8_ATTN_ATOL,
             rtol=INT8_ATTN_RTOL):
        out[name] = q8_kernel_case(name, label, fn, plain_fn, lib_fn, n_bytes, flops, atol, rtol)

    def clone():
        return KVCache(*(x.clone() for x in (cache.k, cache.v, cache.k_scale, cache.v_scale)))

    def writer_case(name, label, write, plain_write, n_bytes):
        """A writer: into two copies of the cache, which must then be equal
        bit for bit; then timed into the cache itself."""
        c1, c2 = clone(), clone()
        write(c1, 3)
        plain_write(c2, 3)
        torch.cuda.synchronize()
        planes = [(x, y) for x, y in zip((c1.k, c1.v, c1.k_scale, c1.v_scale),
                                         (c2.k, c2.v, c2.k_scale, c2.v_scale))]
        err = max(max_err(x, y) for x, y in planes)
        ok = all(torch.equal(x, y) for x, y in planes)
        del c1, c2, planes
        ms = cuda_ms(lambda i: write(cache, i % rot), graph=True)
        plain = cuda_ms(lambda i: plain_write(cache, i % rot), iters=4, warmup=1)
        bound = bound_ms(n_bytes, 0, torch.int8)
        print(f"kernel {name} [{label}]: max_abs_err {err:.3g} (bit-exact) "
              f"{'ok' if ok else 'FAIL'}; ms {ms:.4f} plain_ms {plain:.4f} library_ms n/a "
              f"bound_ms {bound[0]:.4f} ({bound[1]})", flush=True)
        if not ok:
            raise AssertionError(f"{name} [{label}] differs from its plain version")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None, bound=bound)

    pos_l = [0, 1, 100, 255, 256, 300, 450, s - 1]
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    live_rows = sum(pos_l)
    sc = (cache.k_scale, cache.v_scale)
    col = torch.arange(s + 1, device=dev)
    mask = ((col[None, :] < pos[:, None]) | (col[None, :] == s))[:, None, None, :]
    # K1 and K5 with bf16 activations
    q, kc, vc = rnd(b, h, hs), rnd(b, kvh, hs), rnd(b, kvh, hs)
    kf = [torch.cat([dequant_cache(cache.k[:, l], cache.k_scale[:, l]), kc[:, :, None]], dim=2)
          for l in range(rot)]
    vf = [torch.cat([dequant_cache(cache.v[:, l], cache.v_scale[:, l]), vc[:, :, None]], dim=2)
          for l in range(rot)]
    q4 = q[:, :, None, :]
    dec_bytes = 2 * b * h * hs * 2 + 2 * b * kvh * hs * 2 + 2 * live_rows * kvh * (hs + 4) + 4 * b
    dec_flops = 4 * h * hs * sum(p + 1 for p in pos_l)
    case("attention_decode_int8", "B 8, H 32, KVH 32, S 512, HS 128, bf16 q",
         lambda i: A.attention_decode(q, cache.k, cache.v, i % rot, pos, kc, vc, *sc),
         lambda i: A.attention_decode_plain(q, cache.k, cache.v, i % rot, pos, kc, vc, *sc),
         lambda i: F.scaled_dot_product_attention(q4, kf[i % rot], vf[i % rot], attn_mask=mask),
         dec_bytes, dec_flops)
    qkv = torch.cat([q, kc, vc], dim=1)
    case("attention_decode_fused_int8", "B 8, H 32, KVH 32, S 512, HS 128",
         lambda i: A.attention_decode_fused(qkv, cache.k, cache.v, i % rot, pos, h, *sc),
         lambda i: A.attention_decode_fused_plain(qkv, cache.k, cache.v, i % rot, pos, h, *sc),
         lambda i: F.scaled_dot_product_attention(q4, kf[i % rot], vf[i % rot], attn_mask=mask),
         dec_bytes, dec_flops)
    # fp32 activations (the dense fp32 path) take the same kernel: a check
    q32, kc32, vc32 = q.float(), kc.float(), vc.float()
    err = max_err(A.attention_decode(q32, cache.k, cache.v, 3, pos, kc32, vc32, *sc),
                  A.attention_decode_plain(q32, cache.k, cache.v, 3, pos, kc32, vc32, *sc))
    # the fp32 outputs read 4.8e-7 apart: the fp32 kernels' bound
    print(f"kernel attention_decode_int8 [fp32 q]: max_abs_err {err:.3g} (tol "
          f"{TOL[torch.float32]:g})", flush=True)
    if err > TOL[torch.float32]:
        raise AssertionError("attention_decode_int8 with fp32 q disagrees with its plain version")
    del kf, vf

    # K2: every slot, then a valid mask, at ragged positions
    kr, vr = rnd(n_layers, b, kvh, hs), rnd(n_layers, b, kvh, hs)
    valid = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.int32, device=dev)
    writer_case("kv_commit_rows_int8", "L 32, B 8, KVH 32, HS 128, bf16 rows, a valid mask",
                lambda c, i: C.kv_commit_rows(c, kr, vr, pos, valid),
                lambda c, i: C.kv_commit_rows_plain(c, kr, vr, pos, valid),
                2 * n_layers * 6 * kvh * (hs * 2 + hs + 4) + 8 * b)
    writer_case("kv_commit_rows_int8", "L 32, B 8, KVH 32, HS 128, bf16 rows",
                lambda c, i: C.kv_commit_rows(c, kr, vr, pos),
                lambda c, i: C.kv_commit_rows_plain(c, kr, vr, pos),
                2 * n_layers * b * kvh * (hs * 2 + hs + 4) + 4 * b)

    # K3 and K12: ragged valid, one bystander, windows past S
    start_l = [0, 40, 128, 256, 300, 5, 400, 200]
    valid_l = [256, 200, 64, 256, 100, 0, 112, 1]
    start = torch.tensor(start_l, dtype=torch.int32, device=dev)
    cvalid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
    (ckq, cks), (cvq, cvs) = (C.quantize_kv_rows(rnd(b, t, kvh, hs)) for _ in range(2))
    rows = sum(max(0, min(v, s - st)) for st, v in zip(start_l, valid_l))
    writer_case("kv_write_chunk_int8", "B 8, T 256, KVH 32, HS 128",
                lambda c, i: C.kv_write_chunk(c, ckq, cvq, i, start, cvalid),
                lambda c, i: C.kv_write_chunk_plain(c, ckq, cvq, i, start, cvalid),
                2 * 2 * rows * kvh * hs + 8 * b)
    writer_case("scale_write_chunk", "B 8, T 256, KVH 32",
                lambda c, i: C.scale_write_chunk(c, cks, cvs, i, start, cvalid),
                lambda c, i: C.scale_write_chunk_plain(c, cks, cvs, i, start, cvalid),
                2 * 2 * rows * kvh * 4 + 8 * b)

    # K4 over the chunk just written, bf16 q (rows t < valid compared)
    qp = rnd(b, t, h, hs)
    live = torch.arange(t, device=dev)[None, :] < cvalid[:, None]
    colp = torch.arange(s, device=dev)
    qpos = start[:, None] + torch.arange(t, device=dev)[None, :]
    pmask = (colp[None, None, :] <= qpos[:, :, None])[:, None]
    qt = qp.transpose(1, 2)
    kd = [dequant_cache(cache.k[:, l], cache.k_scale[:, l]) for l in range(rot)]
    vd = [dequant_cache(cache.v[:, l], cache.v_scale[:, l]) for l in range(rot)]
    n_rows = sum(valid_l)
    kv_rows = sum(min(st + v, s) for st, v in zip(start_l, valid_l) if v)
    err = max(max_err(A.attention_prefill(qp, cache.k, cache.v, l, start, cvalid, *sc)[live],
                      A.attention_prefill_plain(qp, cache.k, cache.v, l, start, cvalid, *sc)[live])
              for l in (0, 3))
    ms = cuda_ms(lambda i: A.attention_prefill(qp, cache.k, cache.v, i % rot, start, cvalid, *sc))
    plain = cuda_ms(lambda i: A.attention_prefill_plain(qp, cache.k, cache.v, i % rot, start,
                                                        cvalid, *sc), iters=4, warmup=1)
    lib = cuda_ms(lambda i: F.scaled_dot_product_attention(qt, kd[i % rot], vd[i % rot],
                                                           attn_mask=pmask))
    bound = bound_ms((2 * n_rows * h * hs) * 2 + 2 * kv_rows * kvh * (hs + 4) + 8 * b,
                     4 * h * hs * sum(min(st + j, s - 1) + 1 for st, v in zip(start_l, valid_l)
                                      for j in range(v)), torch.bfloat16)
    ok = err <= TOL[torch.bfloat16]
    print(f"kernel attention_prefill_int8 [B 8, T 256, H 32, KVH 32, S 512, HS 128, bf16 q]: "
          f"max_abs_err {err:.3g} (tol {TOL[torch.bfloat16]:g}) {'ok' if ok else 'FAIL'}; "
          f"ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms {bound[0]:.4f} "
          f"({bound[1]})", flush=True)
    if not ok:
        raise AssertionError("attention_prefill_int8 disagrees with its plain version")
    out["attention_prefill_int8"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                         bound=bound)
    del kd, vd

    # K23 on the int8 cache, weights rotating over two copies; and bit-equal
    # to the four kernels it fuses
    def weights(k, n):
        return Q.q8_quantize_weights(rnd(k, n, dtype=torch.float32).mul_(k ** -0.5), gs)

    def wbytes(k, n):
        return k * n + (k // gs) * n * 4

    lw = [dict(wqkv=weights(d, 3 * d), wo=weights(d, d), w13=weights(d, 2 * hid),
               w2=weights(hid, d)) for _ in range(2)]
    g1, g2 = ((1 + 0.1 * rnd(d, dtype=torch.float32)).contiguous() for _ in range(2))
    x = rnd(b, d)

    def layer(fn, i):
        w = lw[i % 2]
        return fn(x, w["wqkv"], w["wo"], w["w13"], w["w2"], g1, g2, cache.k, cache.v, i % rot,
                  pos, *sc, n_heads=h)

    case("q8_layer_fused_int8", "B 8, 7B layer, S 512",
         lambda i: layer(LF.q8_layer_fused, i), lambda i: layer(LF.q8_layer_fused_plain, i), None,
         wbytes(d, 3 * d) + wbytes(d, d) + wbytes(d, 2 * hid) + wbytes(hid, d)
         + 2 * live_rows * kvh * (hs + 4) + (2 * b * d + b * 2 * kvh * hs) * 2 + 2 * d * 4 + 4 * b,
         2 * b * (d * 3 * d + d * d + 3 * d * hid) + 4 * h * hs * sum(p + 1 for p in pos_l),
         atol=Q8_ATOL, rtol=Q8_RTOL)
    w = lw[0]
    got, kv = layer(LF.q8_layer_fused, 0)
    qkv = Q.q8_matmul(x, w["wqkv"], norm_weight=g1, rope_pos=pos, rope_limit=2 * d,
                      rope_head=hs).view(b, h + 2 * kvh, hs)
    att = A.attention_decode_fused(qkv, cache.k, cache.v, 0, pos, h, *sc)
    x2 = Q.q8_matmul(att.reshape(b, d), w["wo"], residual=x)
    four = Q.q8_matmul_ffn(x2, w["w13"], w["w2"], x2, g2)
    torch.cuda.synchronize()
    same = torch.equal(got, four) and torch.equal(kv, qkv[:, h:])
    print(f"kernel q8_layer_fused_int8 [B 8]: bit-equal to the four-kernel int8 layer: {same}",
          flush=True)
    if not same:
        raise AssertionError("q8_layer_fused_int8 differs from the four-kernel int8 layer")
    del lw, cache
    return out


# ---------------------------------------------------------------------------
# phase 7a: the int4 kernels against their plain versions at 7B shapes


def phase_q4_kernels() -> dict[str, dict]:
    """K21 and K22 at Llama-2-7B shapes, bf16 activations, int4 weights of
    group size 32. Library yardstick: cuBLAS `x @ w` on the weight
    dequantized to bf16 beforehand (four times the packed weight bytes).
    Bytes count the packed weights (K/2 x N), fp32 scales, activations in
    and out once each. Weights rotate over enough copies (at least 56 MB)
    that each call finds its weights cold in the 50 MB L2."""
    dev = torch.device("cuda")
    d, hid, voc, gs = 4096, 11008, 32000, 32
    nqkv = 3 * d
    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    def weights(k, n, copies):
        return [Q4.q4_quantize_weights(rnd(k, n, dtype=torch.float32).mul_(k ** -0.5), gs)
                for _ in range(copies)]

    def wbytes(k, n):
        return (k // 2) * n + (k // gs) * n * 4

    def deq(ws):
        return [Q4.q4_dequantize(w).to(torch.bfloat16) for w in ws]

    norm = (1 + 0.1 * rnd(d, dtype=torch.float32)).contiguous()
    out: dict[str, list] = {}

    def case(name, label, fn, plain_fn, lib_fn, n_bytes, flops):
        out.setdefault(name, []).append(
            q8_kernel_case(name, label, fn, plain_fn, lib_fn, n_bytes, flops))

    # K21: QKV with norm + RoPE at decode and prefill rows, wo and W2 with
    # the residual, the classifier with the norm
    wq = weights(d, nqkv, 2)
    wqb = deq(wq)
    rope = dict(rope_limit=2 * d, rope_head=128, rope_theta=10000.0)
    for m in (8, 2048):
        x = rnd(m, d)
        pos = (torch.tensor([0, 1, 100, 255, 256, 300, 450, 511], dtype=torch.int32, device=dev)
               if m == 8 else torch.arange(m, dtype=torch.int32, device=dev) % 512)
        case("q4_matmul", f"QKV M {m}, norm + RoPE",
             lambda i: Q4.q4_matmul(x, wq[i % 2], norm_weight=norm, rope_pos=pos, **rope),
             lambda i: Q4.q4_matmul_plain(x, wq[i % 2], norm_weight=norm, rope_pos=pos, **rope),
             lambda i: x @ wqb[i % 2],
             wbytes(d, nqkv) + m * d * 2 + m * nqkv * 2 + d * 4 + m * 4, 2 * m * d * nqkv)
    del wq, wqb
    x = rnd(8, d)
    for label, k, copies in (("wo", d, 6), ("W2", hid, 2)):
        w = weights(k, d, copies)
        wb = deq(w)
        xk, res = rnd(8, k), rnd(8, d)
        case("q4_matmul", f"{label} M 8, K {k}, residual",
             lambda i: Q4.q4_matmul(xk, w[i % copies], residual=res),
             lambda i: Q4.q4_matmul_plain(xk, w[i % copies], residual=res),
             lambda i: xk @ wb[i % copies], wbytes(k, d) + 8 * k * 2 + 2 * 8 * d * 2,
             2 * 8 * k * d)
        del w, wb
    wc = weights(d, voc, 1)
    wcb = deq(wc)
    case("q4_matmul", "classifier M 8, norm",
         lambda i: Q4.q4_matmul(x, wc[0], norm_weight=norm),
         lambda i: Q4.q4_matmul_plain(x, wc[0], norm_weight=norm),
         lambda i: x @ wcb[0], wbytes(d, voc) + 8 * d * 2 + 8 * voc * 2 + d * 4,
         2 * 8 * d * voc)
    del wc, wcb

    # K22 at decode and prefill rows
    w13 = weights(d, 2 * hid, 2)
    w13b = deq(w13)
    for m in (8, 2048):
        x = rnd(m, d)
        case("q4_matmul_silu", f"W1|W3 gate M {m}, norm",
             lambda i: Q4.q4_matmul_silu(x, w13[i % 2], norm_weight=norm),
             lambda i: Q4.q4_matmul_silu_plain(x, w13[i % 2], norm_weight=norm),
             lambda i: x @ w13b[i % 2],
             wbytes(d, 2 * hid) + m * d * 2 + m * hid * 2 + d * 4, 2 * m * d * 2 * hid)
    del w13, w13b
    # the kernels line carries each kernel's first decode case; max_abs_err
    # over all cases
    return {name: dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
            for name, rs in out.items()}


# ---------------------------------------------------------------------------
# phase 4: the golden fixture through the CLI


def phase_goldens() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        for c in CORPORA:
            out = os.path.join(tmp, f"{c}.out")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = port_run.main([
                    "run", os.path.join(GOLDEN, "model.bin"),
                    "-z", os.path.join(GOLDEN, "tokenizer.bin"), "-m", "test",
                    "-f", os.path.join(REPO, "assets", "in", f"{c}_in_8.txt"),
                    "-o", out, "-b", "4", "--dtype", "float32", "-t", "0.0",
                    "--device", "cuda",
                ])
            if rc != 0:
                raise AssertionError(f"run.main failed on {c} (rc {rc})")
            with open(out, "rb") as f:
                got = f.read()
            with open(os.path.join(REPO, "assets", "out", "cpu_f32", f"{c}_in_8.out"), "rb") as f:
                want = f.read()
            if got != want:
                diff = [i for i, (a, b) in enumerate(zip(got.splitlines(), want.splitlines()))
                        if a != b]
                raise AssertionError(f"golden corpus {c} forked on the card at lines {diff}")
            print(f"golden {c}_in_8: byte-identical to assets/out/cpu_f32", flush=True)


def phase_golden_runs(runs: dict, model: str | None = None
                      ) -> tuple[dict[str, dict[str, int]], dict[str, dict[str, bytes]]]:
    """Each run of `runs` (label -> (CLI arguments, HIPLLAMA_LAYER_FUSE,
    golden directory, the kernels its path must launch, whether the bar of
    3 corpora at 1.0 applies)) of `model` on the card, greedy at -b 4,
    scored against the JAX package's outputs in assets/out/<directory> as
    the fraction of requests whose generations are byte-identical, at the
    bars of tests/test_goldens.py:84-100; returns each run's kernel
    launches and its output files."""
    model = model or os.path.join(GOLDEN, "model.bin")
    launches, outputs = {}, {}
    for label, (args, fuse, golden, path, corpora_bar) in runs.items():
        os.environ["HIPLLAMA_LAYER_FUSE"] = fuse
        try:
            reset_launches()
            outputs[label] = golden_run(label, args, golden, corpora_bar, model)
            launches[label] = launch_counts()
        finally:
            del os.environ["HIPLLAMA_LAYER_FUSE"]
        dead = [n for n in path if launches[label][n] == 0]
        print(f"golden ({label}) launches: "
              f"{ {n: c for n, c in launches[label].items() if c} }", flush=True)
        if dead:
            raise AssertionError(f"kernels never launched on the golden {label} path: {dead}")
    return launches, outputs


def golden_run(label: str, args: list[str], golden: str, corpora_bar: bool,
               model: str) -> dict[str, bytes]:
    scores = {}
    same = 0
    outputs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for c in CORPORA:
            out = os.path.join(tmp, f"{c}.out")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = port_run.main([
                    "run", model,
                    "-z", os.path.join(GOLDEN, "tokenizer.bin"), "-m", "test",
                    "-f", os.path.join(REPO, "assets", "in", f"{c}_in_8.txt"),
                    "-o", out, "-b", "4", "-t", "0.0", *args, "--device", "cuda",
                ])
            if rc != 0:
                raise AssertionError(f"run.main {args} failed on {c} (rc {rc})")
            want_path = os.path.join(REPO, "assets", "out", golden, f"{c}_in_8.out")
            got, want = read_inputfile(out), read_inputfile(want_path)
            if got.num_reqs != want.num_reqs:
                raise AssertionError(f"{c}: {got.num_reqs} generations, want {want.num_reqs}")
            scores[c] = sum(a == b for a, b in zip(got.prompts, want.prompts)) / want.num_reqs
            with open(out, "rb") as f, open(want_path, "rb") as g:
                outputs[c] = f.read()
                identical = outputs[c] == g.read()
            same += identical
            print(f"golden ({label}) {c}_in_8: {scores[c]:.4f} of requests byte-identical "
                  f"to assets/out/{golden}{'; the file byte-identical' if identical else ''}",
                  flush=True)
    full = sum(1 for v in scores.values() if v == 1.0)
    avg = sum(scores.values()) / len(scores)
    print(f"golden ({label}): {full} corpora at 1.0 (bar {3 if corpora_bar else 'none'}), "
          f"average {avg:.4f} (bar 0.75), {same} of {len(CORPORA)} files byte-identical",
          flush=True)
    if (corpora_bar and full < 3) or avg < 0.75:
        raise AssertionError(f"golden coverage of {label} below the bars: {scores}")
    return outputs


def phase_q4_goldens() -> dict[str, dict[str, int]]:
    """The fixture with --quant q4 on a bf16 and an int8 cache (scored
    against the JAX package's int4 outputs; no Q8 kernel may launch), a v4
    file of it written by the port (its outputs must be the --quant q4
    outputs byte for byte, on both caches: both quantize with the same
    function), and one --dequant run of that file through the dense path;
    returns each run's launches."""
    launches, outputs = phase_golden_runs(GOLDEN_Q4_RUNS)
    with tempfile.TemporaryDirectory() as tmp:
        v4 = os.path.join(tmp, "model_v4.bin")
        write_v4(v4, *load_checkpoint(os.path.join(GOLDEN, "model.bin")))
        runs = {f"{label}, v4 file": (args[2:], *rest) for label, (args, *rest)
                in GOLDEN_Q4_RUNS.items()}
        l4, o4 = phase_golden_runs(runs, model=v4)
        launches.update(l4)
        for label in GOLDEN_Q4_RUNS:
            if o4[f"{label}, v4 file"] != outputs[label]:
                raise AssertionError(f"the v4 file's outputs differ from {label}'s")
            print(f"golden ({label}, v4 file): byte-identical to the {label} run", flush=True)
        reset_launches()
        out = os.path.join(tmp, "dequant.out")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = port_run.main(["run", v4, "-z", os.path.join(GOLDEN, "tokenizer.bin"),
                                "-m", "test", "-o", out, "-b", "4", "-t", "0.0", "--dequant",
                                "-f", os.path.join(REPO, "assets", "in", "gen_in_8.txt"),
                                "--device", "cuda"])
        launches["v4 --dequant"] = launch_counts()
        if rc != 0 or read_inputfile(out).num_reqs != 8:
            raise AssertionError(f"--dequant of the v4 file failed (rc {rc})")
        print(f"golden (v4 --dequant) gen_in_8: served through the dense path; launches "
              f"{ {n: c for n, c in launches['v4 --dequant'].items() if c} }", flush=True)
    for label, counts in launches.items():
        q8 = {n: c for n, c in counts.items() if n.startswith("q8_") and c}
        if q8 and label != "v4 --dequant":
            raise AssertionError(f"Q8 kernels launched on the int4 golden run {label}: {q8}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: full-width serve


def random_7b_params(cfg: ModelConfig, dev) -> LlamaParams:
    """bf16 weights from a seeded generator on the card, scaled like a
    trained init (std 1/sqrt(fan_in)) so activations stay O(1). The
    classifier columns of BOS and EOS are zero, so greedy decoding never
    stops a request early and every request runs to its step budget."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    c = cfg

    def mat(*shape, fan_in):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16).mul_(fan_in ** -0.5)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=torch.bfloat16)

    tok_emb = mat(c.vocab_size, c.dim, fan_in=c.dim)
    wcls = tok_emb.t().contiguous()
    wcls[:, 1:3] = 0
    return LlamaParams(
        tok_emb=tok_emb, rms_att=ones(c.n_layers, c.dim),
        wq=mat(c.n_layers, c.dim, c.dim, fan_in=c.dim),
        wk=mat(c.n_layers, c.dim, c.kv_dim, fan_in=c.dim),
        wv=mat(c.n_layers, c.dim, c.kv_dim, fan_in=c.dim),
        wo=mat(c.n_layers, c.dim, c.dim, fan_in=c.dim),
        rms_ffn=ones(c.n_layers, c.dim),
        w1=mat(c.n_layers, c.dim, c.hidden_dim, fan_in=c.dim),
        w2=mat(c.n_layers, c.hidden_dim, c.dim, fan_in=c.hidden_dim),
        w3=mat(c.n_layers, c.dim, c.hidden_dim, fan_in=c.dim),
        rms_final=ones(c.dim), wcls=wcls,
    )


def llama_sized_tokenizer(tmp: str, vocab_size: int) -> Tokenizer:
    """The golden tokenizer's 512 pieces plus synthetic pieces up to
    `vocab_size`, written as a tokenizer.bin and read back."""
    _, vocab, scores = read_tokenizer_bin(os.path.join(GOLDEN, "tokenizer.bin"), 512)
    vocab += [f"<w{i:05d}>".encode() for i in range(len(vocab), vocab_size)]
    scores += [-1e6] * (vocab_size - len(scores))
    path = os.path.join(tmp, "tokenizer.bin")
    write_tokenizer_bin(path, vocab, scores)
    return Tokenizer.from_file(path, vocab_size)


def make_prompts(tok: Tokenizer, targets: list[int]) -> list[str]:
    """Prompts of about `targets` tokens each, from the corpora's words
    (counted word by word: BPE merges rarely cross a word boundary)."""
    words = []
    for c in CORPORA:
        with open(os.path.join(REPO, "assets", "in", f"{c}_in_512.txt"), errors="replace") as f:
            words += f.read().split()[1:]
    rng = np.random.default_rng(SEED)
    n_tok: dict[str, int] = {}
    prompts = []
    for n in targets:
        ws, count = [], 1  # BOS
        while count < n:
            w = words[int(rng.integers(len(words)))]
            if w not in n_tok:
                n_tok[w] = len(tok.encode(w, bos=False))
            ws.append(w)
            count += n_tok[w]
        prompts.append(" ".join(ws))
    return prompts


def random_7b_qparams(cfg: ModelConfig, dev, int4: bool = False) -> QuantLlamaParams:
    """Q8_0 params (group size 64), or with `int4` int4 params (group size
    32, the embedding Q8_0 of group size 64), of seeded bf16 draws scaled as
    in random_7b_params, quantized on the card one layer's weight at a time,
    so no full-precision copy of the model exists. The classifier is the
    quantized transposed embedding with the BOS and EOS columns zero."""
    g = torch.Generator(device=dev).manual_seed(SEED + (4 if int4 else 1))
    c = cfg

    def mat(*shape, fan_in):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16).mul_(fan_in ** -0.5)

    def qt(*ws):
        w = torch.cat(ws, dim=1)
        return Q4.q4_quantize_weights(w, 32) if int4 else Q.q8_quantize_weights(w, 64)

    def ones(n):
        return torch.ones(n, device=dev, dtype=torch.float32)

    layers = {"wq": [], "wo": [], "w1": [], "w2": []}
    for _ in range(c.n_layers):
        layers["wq"].append(qt(mat(c.dim, c.dim, fan_in=c.dim), mat(c.dim, c.kv_dim, fan_in=c.dim),
                               mat(c.dim, c.kv_dim, fan_in=c.dim)))
        layers["wo"].append(qt(mat(c.dim, c.dim, fan_in=c.dim)))
        layers["w1"].append(qt(mat(c.dim, c.hidden_dim, fan_in=c.dim),
                               mat(c.dim, c.hidden_dim, fan_in=c.dim)))
        layers["w2"].append(qt(mat(c.hidden_dim, c.dim, fan_in=c.hidden_dim)))
    tok_emb = mat(c.vocab_size, c.dim, fan_in=c.dim)
    emb = Q.q8_quantize_weights(tok_emb.t(), 64)  # groups along each row of tok_emb
    wcls = tok_emb.t().contiguous()
    wcls[:, 1:3] = 0
    return QuantLlamaParams(
        tok_emb_q=emb.q.t().contiguous(), tok_emb_s=emb.s.t().contiguous(),
        rms_att=tuple(ones(c.dim) for _ in range(c.n_layers)),
        wq=tuple(layers["wq"]), wk=(), wv=(), wo=tuple(layers["wo"]),
        rms_ffn=tuple(ones(c.dim) for _ in range(c.n_layers)),
        w1=tuple(layers["w1"]), w2=tuple(layers["w2"]), w3=(),
        rms_final=ones(c.dim), wcls=qt(wcls),
    )


def without_ffn0(params: QuantLlamaParams) -> QuantLlamaParams:
    """The control of the logit check: layer 0's FFN adds nothing (W2 zero:
    int8 codes 0, or int4 nibbles 8, the code 0, in both halves of a byte)."""
    w2 = list(params.w2)
    w2[0] = type(w2[0])(torch.full_like(w2[0].q, -120 if params.int4 else 0), w2[0].s)
    return dataclasses.replace(params, w2=tuple(w2))


def phase_serve(label: str, params, logit_tol: float, path: tuple[str, ...], per_step: dict,
                control=None, kv_quant: bool = False) -> dict:
    """Serve the 16 requests at batch 8, window 512 through the engine with
    `params` (on an int8 cache with `kv_quant`), after holding the first
    prefill and decode logits of the kernel path against the plain path
    (and, given `control`, checking that the plain path on control(params)
    reads above the tolerance, and for Q8 params profiling a decode step of
    the four-kernel layer beside the default one); `per_step`: the wrapper
    launches one decode step must make, exactly. Returns the launches of the
    serve."""
    dev = torch.device("cuda")
    cfg = LLAMA2_7B
    batch, window, steps = 8, 512, 352
    with tempfile.TemporaryDirectory() as tmp:
        tok = llama_sized_tokenizer(tmp, cfg.vocab_size)
    # first wave fills all 8 slots (multi-chunk 256+64 prefills); later
    # requests arrive alone as slots retire, hitting the 16/64/256 buckets
    targets = [300, 20, 150, 60, 280, 100, 30, 200, 266, 14, 90, 300, 40, 180, 25, 120]
    prompts = make_prompts(tok, targets)
    lens = [len(tok.encode(p)) for p in prompts]
    print(f"{label} prompt tokens: {lens}", flush=True)

    # kernel path vs plain path: prefill the first wave, then one decode step
    ids = [tok.encode(p)[:257] for p in prompts[:batch]]
    toks = np.zeros((batch, 256), np.int32)
    for i, t in enumerate(ids):
        toks[i, : len(t) - 1] = t[:-1]
    valid = torch.tensor([len(t) - 1 for t in ids], dtype=torch.int32, device=dev)
    start = torch.zeros(batch, dtype=torch.int32, device=dev)
    cur = torch.tensor([t[-1] for t in ids], dtype=torch.int32, device=dev)
    toks_d = torch.from_numpy(toks).to(dev)

    def first_step(p, plain):
        cache = init_kv_cache(cfg, batch, dtype=torch.bfloat16, seq_len=window, device=dev,
                              quantized=kv_quant)
        pf, _ = make_prefill(cfg, last_only=True, plain=plain)(p, cache, toks_d, start, valid)
        lg, _ = make_decode_step(cfg, plain=plain)(p, cache, cur, valid)
        return pf, lg

    logits = {plain: first_step(params, plain) for plain in (False, True)}
    pf_err = max_err(logits[False][0], logits[True][0])
    lg_err = max_err(logits[False][1], logits[True][1])
    lk, lp = logits[False][1], logits[True][1]
    top2 = torch.topk(lp, 2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).tolist()
    agree = (lk.argmax(-1) == lp.argmax(-1)).tolist()
    print(f"{label} first step, kernel vs plain path: prefill logits max_abs_err {pf_err:.4g}, "
          f"decode logits max_abs_err {lg_err:.4g} (tol {logit_tol}); top-1 agree {agree}; "
          f"plain top-2 gaps {[round(x, 4) for x in gap]}", flush=True)
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError(f"non-finite logits at {label}")
    if max(pf_err, lg_err) > logit_tol:
        raise AssertionError(f"kernel path and plain path logits disagree at {label}")
    if control is not None:
        ctl = max_err(first_step(control(params), True)[1], logits[True][1])
        print(f"{label} control, plain path with layer 0's FFN dropped: decode logits "
              f"max_abs_err {ctl:.4g} (must exceed tol {logit_tol})", flush=True)
        if ctl <= logit_tol:
            raise AssertionError(f"the logit tolerance {logit_tol} does not catch a dropped FFN")
    # a top-1 flip is allowed only at a near-tie: a top-2 gap inside the
    # measured logit difference
    for a, gp in zip(agree, gap):
        if not a and gp > 2 * lg_err:
            raise AssertionError(f"top-1 flip at a top-2 gap of {gp} > 2 x {lg_err}")
    del logits, lk, lp

    engine = InferenceEngine(cfg, params, tok, batch_size=batch, max_seq_len=window,
                             kv_quant=kv_quant)
    nonfinite = [0]
    do_step = engine._do_step

    def checked_step(cache, tokens, pos):
        lg, cache = do_step(cache, tokens, pos)
        nonfinite[0] += int((~np.isfinite(lg)).sum())
        return lg, cache

    engine._do_step = checked_step
    requests = Requests(prompts=prompts, generations=[""] * len(prompts))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stats: dict = {}
    # greedy (temperature 0): the BOS and EOS logits are exactly 0 and never
    # the largest, where sampling at temperature 1 could draw them
    greedy = [Sampler(cfg.vocab_size, temperature=0.0) for _ in prompts]
    n_gen = engine.serve(requests, steps=steps, stats=stats, samplers=greedy)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} serve: {len(prompts)} requests, {stats['total_tokens']} tokens in "
          f"{stats['elapsed_s']:.3f} s = {stats['tok_per_s']:.2f} tok/s; ttft p50 "
          f"{stats['ttft_p50_s'] * 1e3:.1f} ms, p95 {stats['ttft_p95_s'] * 1e3:.1f} ms; "
          f"{stats['scheduler_iters']} scheduler iterations; prefill chunks by T "
          f"{dict(sorted(engine.prefill_chunks.items()))}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; launches { {n: c for n, c in launches.items() if c} }; "
          f"card {card_line()}", flush=True)
    if any(g == "" for g in requests.generations):
        raise AssertionError("a request did not finish")
    if n_gen != len(prompts) * (steps - 1):
        raise AssertionError(f"requests stopped short of the step budget: {n_gen} tokens")
    if min(steps - n for n in lens) < 32:
        raise AssertionError("a request generated fewer than 32 tokens")
    if nonfinite[0]:
        raise AssertionError(f"{nonfinite[0]} non-finite logits while serving")
    if set(engine.prefill_chunks) != {16, 64, 256}:
        raise AssertionError(f"prefill buckets hit: {dict(engine.prefill_chunks)}")
    dead = [n for n in path if launches[n] == 0]
    if dead:
        raise AssertionError(f"kernels never launched on the {label} path: {dead}")

    # where a step's time goes: wrapper calls of one decode step, then device
    # time by kernel over a short window
    cache = engine.new_cache()
    toks = np.array([t[-1] for t in ids], np.int32)
    pos0 = np.array([len(t) - 1 for t in ids], np.int32)
    before = launch_counts()
    engine._do_step(cache, toks, pos0)
    step_counts = {n: c - before[n] for n, c in launch_counts().items() if c > before[n]}
    print(f"{label} wrapper launches per decode step (batch 8): {sum(step_counts.values())} "
          f"{step_counts}", flush=True)
    if step_counts != per_step:
        raise AssertionError(f"{label}: launches per decode step {step_counts}, want {per_step}")
    profile_window(f"{label} decode step (batch 8)", 4,
                   lambda i: engine._do_step(cache, toks, pos0 + i))
    if control is not None and not params.int4:
        os.environ["HIPLLAMA_LAYER_FUSE"] = "0"
        try:
            four = make_decode_step(cfg)
        finally:
            del os.environ["HIPLLAMA_LAYER_FUSE"]
        toks_t = torch.from_numpy(toks).to(dev)
        profile_window(f"{label} decode step, four-kernel layer (batch 8)", 4,
                       lambda i: four(params, cache, toks_t, torch.from_numpy(pos0 + i).to(dev)))
    chunk = [t[:-1][:256] for t in ids]
    profile_window(f"{label} prefill chunk (batch 8, T 256)", 2,
                   lambda i: engine._prefill_tokens(cache, batch, dict(enumerate(chunk)),
                                                    {s: 0 for s in range(batch)}))
    return launches


def profile_window(what: str, n: int, fn) -> None:
    """Device time by kernel over n calls of fn (after one warm call), from
    torch.profiler, beside the host wall time of the same window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile {what}: wall {wall_us / n / 1e3:.3f} ms/call, device busy "
          f"{dev_us / n / 1e3:.3f} ms/call ({100 * dev_us / wall_us:.1f}%), "
          f"{sum(e.count for e in kern) / n:.0f} kernel launches/call", flush=True)
    for e in top:
        print(f"  {e.self_device_time_total / n / 1e3:8.3f} ms/call  {e.count / n:6.0f} x  "
              f"{e.key[:90]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False

    _build.build_all()
    print(f"build: {_build.build_seconds:.1f} s (nvcc, {_build.NVCC_FLAGS[1]})", flush=True)

    res = {dt: phase_kernels(dt) for dt in (torch.bfloat16, torch.float32)}
    res_q8 = phase_q8_kernels()
    torch.cuda.empty_cache()
    res_int8 = phase_kernels_int8()
    torch.cuda.empty_cache()
    phase_goldens()
    launches_golden = phase_golden_runs(GOLDEN_Q8_RUNS)[0]
    launches_golden.update(phase_golden_runs(GOLDEN_INT8_RUNS)[0])

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = random_7b_params(LLAMA2_7B, dev)
    torch.cuda.synchronize()
    print(f"7b-width params: {sum(getattr(params, f).numel() for f in params.__dataclass_fields__) / 1e9:.2f}"
          f" G bf16 values made in {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {"dense": phase_serve("7b", params, LOGIT_TOL, DENSE_PATH, DENSE_STEP)}
    del params
    gc.collect()  # the served engine sits in a reference cycle (its patched step)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qparams = random_7b_qparams(LLAMA2_7B, dev)
    torch.cuda.synchronize()
    q_bytes = sum(t.numel() * t.element_size() for qt in (*qparams.wq, *qparams.wo, *qparams.w1,
                                                          *qparams.w2, qparams.wcls)
                  for t in (qt.q, qt.s))
    print(f"7b-width Q8 params: {q_bytes / 1e9:.2f} GB of int8 weights and fp32 scales "
          f"quantized on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    launches["q8"] = phase_serve("7b q8", qparams, Q8_LOGIT_TOL, Q8_PATH, Q8_STEP,
                                 control=without_ffn0)
    gc.collect()
    torch.cuda.empty_cache()
    launches["q8 int8"] = phase_serve("7b q8 int8-kv", qparams, Q8_LOGIT_TOL, Q8_INT8_PATH,
                                      Q8_INT8_STEP, control=without_ffn0, kv_quant=True)
    del qparams

    # phase 7: int4 weights
    gc.collect()
    torch.cuda.empty_cache()
    res_q4 = phase_q4_kernels()
    torch.cuda.empty_cache()
    launches_golden.update(phase_q4_goldens())
    t0 = time.perf_counter()
    q4params = random_7b_qparams(LLAMA2_7B, dev, int4=True)
    torch.cuda.synchronize()
    q_bytes = sum(t.numel() * t.element_size() for qt in (*q4params.wq, *q4params.wo,
                                                          *q4params.w1, *q4params.w2,
                                                          q4params.wcls)
                  for t in (qt.q, qt.s))
    print(f"7b-width int4 params: {q_bytes / 1e9:.2f} GB of packed int4 weights and fp32 scales "
          f"quantized on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    launches["q4"] = phase_serve("7b q4", q4params, Q4_LOGIT_TOL, Q4_PATH, Q4_STEP,
                                 control=without_ffn0)
    del q4params

    # each kernel's count from the first serving path that runs it: the 7B
    # serves, then the golden runs (K5 and its int8 branch run only in the
    # four-kernel layer, K1's int8 branch in the dense fp32 --kv int8 run;
    # K21 and K22 count from the int4 serve)
    runs = [launches["dense"], launches["q8"], launches["q8 int8"], launches["q4"],
            launches_golden["q8, four-kernel layer"], launches_golden["fp32 --kv int8"],
            launches_golden["q8 --kv int8, four-kernel layer"]]
    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        r = (res[torch.bfloat16].get(name) or res_q8.get(name) or res_int8.get(name)
             or res_q4[name])
        n = next((run[name] for run in runs if run.get(name)), 0)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"],
        ))
        if n == 0:
            raise AssertionError(f"{name} was launched on no path of this run")
    print(f"total: {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

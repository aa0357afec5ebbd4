#!/usr/bin/env python3
"""Smoke test of hip_llama_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; each raises on failure and none is caught:
  1. the card: its name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every csrc/*.cu kernel compiled from source with nvcc (sm_90a);
  3. each kernel against its plain PyTorch version on the card at Llama-2-7B
     shapes (B 8, L 32, KVH 32, HS 128, S 512; prefill T 256), in bf16 and
     fp32, with its time, the plain version's time, the time of one PyTorch
     library call doing the same work where there is one (for the cache
     writers here and in phases 6 and 8: index_put_ on each plane, the rows
     gathered or quantized beforehand, as CUDA-graph replays; for K1, K5
     and K6 here and in phases 3b and 8: SDPA, the kernel and SDPA both as
     CUDA-graph replays), and its bound;
     then K4 at the port bench's ttft shape (T 512 over S 1024, two JAX
     blocks), here in bf16 and after phase 6a on an int8 cache;
  3b. the Q8 kernels (q8_matmul and q8_matmul_silu at M 8 on the GEMV and
     above 16 rows on the wgmma tiles: QKV with the norm and RoPE at M 2048
     and the bench's 4088, wo and W2 at M 2048 with the residual, the gate at
     M 512, 2048 and 4088, and the row rule's rows 16, 17, 32, 128 and 512;
     q8_matmul_ffn at M 8 on the GEMV and at M 32 and 128 on its
     tensor-core kernel, attention_decode_fused, q8_layer_fused) against
     their plain versions at 7B shapes in bf16, with the same timings (the
     decode rows' as CUDA-graph replays, below the wrappers' host cost); and
     the `mainloop` lines: the wgmma mainloop's products alone (no copy, no
     dequantization), each step drained before the consumers' barrier and
     kept in flight across it, as a share of the 989 TFLOP/s bf16 peak;
  4. the committed golden fixture through the port's CLI (fp32, greedy,
     -b 4) on all five *_in_8 corpora: byte-identical to assets/out/cpu_f32;
  4b. the same with --quant q8, scored against the JAX package's Q8 outputs
     assets/out/cpu_q8 at the golden bars (3 corpora at 1.0, average 0.75),
     once with the decode layer as one q8_layer_fused kernel (the default)
     and once as four kernels (HIPLLAMA_LAYER_FUSE=0), each run's kernel
     launches counted; then (after phase 6's int8-cache runs) every corpus
     served by the card's Q8 engine beside the port's plain path on the
     CPU, bf16 and int8 cache: each slot's first fork is a near-tie;
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
     K3 and K12 bit-exact), and the `parts` line: K23 int8 beside the
     standalone kernels of its phases (tools/ab_trees.py::layer_parts);
     the golden fixture with --kv int8, dense fp32
     and Q8 with the fused and the four-kernel layer, scored against the
     JAX package's assets/out/cpu_f32_kv8 and cpu_q8_kv8; and the 7B-width
     Q8 serve of phase 5b on an int8 cache, with its logit check, control
     and launches (K23 32 per decode step);
  7. int4 weights (--quant q4, v4 files): K21 q4_matmul and K22
     q4_matmul_silu against their plain versions at 7B shapes (group size
     32; M 8 on the tensor-core GEMV, timed as CUDA-graph replays with
     cuBLAS, M 128 and 2048 on the wgmma tiles: QKV with the norm and RoPE,
     wo and W2 with the residual, the gate), with the same timings; the
     golden fixture with --quant q4 (bf16 and int8 cache) scored against
     the JAX package's assets/out/cpu_q4 and cpu_q4_kv8, a v4 file of it
     written by the port (byte-identical to the --quant q4 outputs) and a
     --dequant run of that file; every fork of the fixture's int4 serve
     (both caches) checked to be a near-tie against the CPU's plain path,
     as phase 4's Q8 forks; and the 7B-width
     serve of phase 5 with int4 weights quantized on the card, with its
     logit check, control, launches (K21 97, K22 32, K5 32, K2 1 per decode
     step, no Q8 kernel) and profile; then, on its params, two T-16 and two
     T-32 prefill chunks over 8 slots in `a8` (HIPLLAMA_Q4_MODE=a8) profiled,
     K21's and K22's int4 `a8` wgmma tiles launched;
  8. the paged KV cache (--paged): K6 attention_decode_paged and K7
     attention_prefill_paged (bf16 and int8 pages) and the paged writers K11,
     K10, K13 and K14 (bit-exact) against their plain versions at 7B shapes
     (pages of 128, 4 per slot scattered over a 33-page pool), with the same
     timings (the library yardstick: SDPA over the pages gathered into
     contiguous K/V beforehand); the golden fixture with --paged 16 (fp32:
     byte-identical to assets/out/cpu_f32; fp32 --kv int8, --quant q8 and
     --quant q8 --kv int8 scored against the JAX package's *_paged outputs)
     and a --prefix-cache run byte-identical to --paged with prefix hits; the
     7B-width Q8 serve of phase 5b on int8 pages of 128 rows, with its logit
     check, control, launches (K6 32, K11 1, K10 1, K15 129 per decode step)
     and profile; and the same requests behind a shared 256-token prefix,
     served with and without the prefix cache: the same generations, hits;
  9. the `a8` modes (HIPLLAMA_Q8_MODE=a8, HIPLLAMA_Q4_MODE=a8): the `a8`
     kernels of K15, K17, K21 and K22 against their plain versions at 7B
     shapes (K15 QKV M 8 with norm and RoPE, wo with the residual, the
     classifier; K17 M 8: the int8 tensor-core GEMV, `..._a8_tc`, and on
     the same inputs the dp4a GEMV through ops/quant.py::a8_gemv_probe, both
     as CUDA-graph replays; the int8 wgmma tiles of K15 at QKV M 2048, 128
     and 4088 and wo M 2048 with the residual, of K17 at M 2048, 512 and
     4088; K21 and K22 M 8 and their int8 wgmma tiles, one nibble plane a
     CTA, at QKV M 256 and 128, wo M 256 and the gate M 256 and 128, group
     size 32), each tile kernel equal bit for bit to a8.cuh's mma.sync
     tiles on the same quantized rows (the `probe a8 tiles` lines: K15's
     and K17's at M 2048, K21's and K22's at QKV, wo and the gate M 256 and
     W2 M 64, each kernel's time beside), and the tensor-core GEMV equal bit
     for bit to the dp4a GEMV (the `probe a8 gemv` lines: Q8_0 and int4 at
     QKV, wo, the gate and W2 M 8 and 16, each GEMV's time beside);
     with the same timings and the reshape or dequant kernel's time beside
     (bound: the int8 peak for operations; bytes of the weights, scales, x,
     the quantized xi and sx, and the outputs); the golden fixture with
     each mode (Q8, Q8 --kv int8, int4; block_n 64, as the JAX goldens were
     made) scored against the JAX package's assets/out/cpu_q8_a8,
     cpu_q8_kv8_a8 and cpu_q4_a8, `a8` launched and q8_layer_fused never;
     and the 7B-width Q8 + int8-KV serve of phase 6 in `a8`, the reference
     int8 engine's configuration, with its logit check, control, launches
     (K15 a8 65, K5 int8 32, K18 32 per decode step; no K23) and profile;
  10. --layout stacked and the four-write KV commit (HIPLLAMA_KV_COMMIT=0):
     K20 q8_matmul_layered in reshape and `a8` (QKV M 8 with norm and RoPE,
     wo with the residual, W1|W3 with the norm, W2 with the residual, on
     the last layer of the 7B-width stacked weights) against their plain
     versions, with the time, the plain time, cuBLAS on the layer
     dequantized to bf16, the bound and K15's time on the layer's view
     beside; K8 kv_write_rows (bf16 and int8 planes) and K9
     scale_write_rows at 7B shapes, bit-exact, beside one index_put_ doing
     the same write; the probe of tools/kv_direct_probe.py (K8 writes a row
     at every position of a slot, directly, bit-exact); the golden fixture
     with --layout stacked (Q8 on both caches, and `a8`), scored against the
     JAX package's assets/out/cpu_q8_stacked, cpu_q8_kv8_stacked and
     cpu_q8_a8_stacked, K20 launched and K23 and K5 never; the fixture
     under HIPLLAMA_KV_COMMIT=0 (fp32 byte-identical to assets/out/cpu_f32,
     Q8 --kv int8 byte-identical to its default-commit run), K8 and K9
     launched and K2 never; and the 7B-width Q8 + int8-KV serve with
     --layout stacked in reshape and in `a8`, with its logit check,
     control, launches (K20 128, K1 int8 32, K2 1, K15 1 per decode step)
     and profile;
  11. the prefill variants (HIPLLAMA_PREFILL_MINNER=1, HIPLLAMA_PREFILL_XHEADS=1):
     K19 q8_matmul_minner (wo M 2048 with the residual, q M 1024 with the
     norm and RoPE as the paged prefill's, W2 M 2048 K 11008), K19
     q8_matmul_silu_minner (M 2048, H 11008, norm) and K16 q8_matmul_xheads
     (wo M 2048 over 32 heads of 128) against their plain versions at 7B
     shapes, each beside the K15/K17 tile on the same inputs (the K19
     lines give K19's launch plan from its launcher: grid, tile, raster
     order, cluster),
     cuBLAS on the weight dequantized to bf16, and the bound; the probe of
     tools/probe_xheads.py (K16 and K15 on the flat view of the same rows
     against the probe's fp32 product, K4 reading T-major q); two T-256
     prefill chunks of the 7B Q8 + int8-KV model profiled on the default
     route and with each knob (launches per chunk, device time, and one
     line of the three device times); and that model's
     serve with both knobs, with its logit check against the plain path,
     launches (K16, K19, K19 silu) and TTFT beside phase 6's default-route
     serve;
  12. the port bench (hip_llama_tpu_torch/bench.py) and its bandwidth probes:
     K24 dma_read, K25 dma_copy, K26 wshape_read and K27 deep_read against
     their plain versions at the probes' default 6 GiB (bit-exact), with the
     time, plain time, library time (x.sum(dtype=torch.int32); out.copy_(x))
     and bound; then, launches counted from 0: the hbm_bw ladders (dma,
     copy, wshape, dmadeep, xreduce) and the achievable bandwidth; the
     graph decode chain (16 steps, 7B-width Q8 + int8 KV, b8, window 512)
     token for token against the eager chain; bench.main in process for the
     default decode, --loop host, --mode ttft, --mode serve and --mode serve
     --paged --prefix-cache (each line: bench.py's metric, a value above 0,
     vs_baseline and vs_achievable in (0, 1.05]); and one
     `python -m hip_llama_tpu_torch.bench --steps 16` in its own process;
  13. every shape the JAX package serves: K1, K5, K4, K6 and K7 (bf16, int8
     and fp32 caches) against their plain versions at head sizes 48 and 96
     with 3 and 16 query heads per KV head, K23 at stories15M's layer (dim
     288, 6 heads of 48 over 2 KV heads), the `a8` kernels of K15, K17, K21
     and K22 at groups of 16 and 48 (8 and 128 rows), K16 at groups of 4;
     blocks past the fp32/bf16 decode task's shared memory, walked in
     chunks: K1, K5 and K6 (pages of the window) on bf16 and fp32 caches
     whose JAX block is the window itself, 6404 rows at 8 query heads per
     KV head (Llama-2-70B's grouping) and 51204 at one, and K23 on the bf16
     6404-row cache, each launched once and held to its plain version;
     and a stories15M-shaped model (random weights, 2 layers) served
     through the CLI on the card and on the CPU in fp32, fp32 --kv int8 and
     int4 with HIPLLAMA_Q4_MODE=a8 (groups of 16), the card's kernel path
     and the CPU's plain path logits compared, the path's launches counted;
  14. the engine's other dispatch schedules: the fixture through the CLI in
     fp32 with --chunk 4, --device-sampling, --chunk 4 --paged 16, --chunk 4
     --prefix-cache, --spec 4 and --spec 4 --draft (byte-identical to
     cpu_f32), and with --quant q8 --kv int8 --chunk 4 (against cpu_q8_kv8)
     and --spec 4 (against the JAX CLI's --spec 4 outputs, cpu_q8_kv8_spec4)
     at the average bar; the fixture's Q8 + int8-KV chunked and speculative
     serves against the card's plain serve, every fork a near-tie (top-2
     gap at most 0.1); phase 6's 7B-width Q8 + int8-KV serve at
     chunk_steps=8 with device sampling against a plain serve (forks inside
     twice the kernel path's logit tolerance; K23 32 times a decode step),
     its tok/s and TTFT beside phase 6's, one chunk's host enqueue against
     its wall time, the device argmax against the host's on the step's
     logits (raw, bf16-rounded, tied rows), the chunked serve of the 8
     shortest prompts at temperature 0.8 twice with seed 7 and once with
     seed 8, and a prompt-lookup spec_lookup=4 serve of the first 8
     requests with its acceptance, against the plain serve's first 8.
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

from hip_llama_tpu_torch import bench as port_bench
from hip_llama_tpu_torch import run as port_run
from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.engine import InferenceEngine, Requests, read_inputfile
from hip_llama_tpu_torch.io.checkpoint import load_checkpoint, write_v4
from hip_llama_tpu_torch.io.tokenizer_io import read_tokenizer_bin, write_tokenizer_bin
from hip_llama_tpu_torch.models.llama import (
    KVCache,
    init_kv_cache,
    make_decode_step,
    make_logit_sampler,
    make_prefill,
)
from hip_llama_tpu_torch.models.paged import (
    PagedKVCache,
    init_paged_kv_cache,
    make_paged_decode_step,
    make_paged_prefill,
)
from hip_llama_tpu_torch.models.params import (
    LlamaParams,
    QuantLlamaParams,
    quantize_params_q4,
    quantize_params_q8,
)
from hip_llama_tpu_torch.ops import _build, launch_counts, reset_launches
from hip_llama_tpu_torch.ops import attention as A
from hip_llama_tpu_torch.ops import cache as C
from hip_llama_tpu_torch.ops import hbm_bw as HK
from hip_llama_tpu_torch.ops import layer_fused as LF
from hip_llama_tpu_torch.ops import quant as Q
from hip_llama_tpu_torch.ops import quant4 as Q4
from hip_llama_tpu_torch.sampler import Sampler
from hip_llama_tpu_torch.tokenizer import Tokenizer
from hip_llama_tpu_torch.tools import hbm_bw as HT
from hip_llama_tpu_torch.tools.ab_trees import layer_parts

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "assets", "golden")
CORPORA = ("gen", "sciq", "tinystories", "truthful_qa", "wikipedia")

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
# kernel vs plain version: fp32 differs in summation order only (512-row
# sums of O(1) terms); bf16 (the writers and everything but attention, which
# ATTN_ATOL/RTOL bound) by about one ulp of an O(1) output, as
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
# bf16 attention (K1, K4-K7, the int8 prefill's bf16 probabilities) vs
# plain: both round the probabilities at the same running max, taken over
# the JAX block, and differ in the fp32 order of the scores' and the
# outputs' sums, which can move a probability or an output by a bf16 ulp:
# one ulp of an output below 1 in magnitude. Sound runs read 0.00195 at
# most (0.0039 before the kernels took the JAX block, when the bound was 2e-2
# for K1 and K4 and 4e-3 + 2e-2 |plain| for K5 and K6). The prefill kernels
# on bf16 and int8 caches multiply on the tensor cores, whose fp32 sums run
# in another order and rounding than the plain version's fp32 matmuls (the
# CUDA-core kernels' sequential FMA chains tracked those almost bit for
# bit), so one ulp can move an output of magnitude 1 or more too (K7 on bf16
# pages read 0.00781 at [1, 2)): attn_check's bound is one bf16 ulp of the
# plain output, and never less than ATTN_ATOL + ATTN_RTOL |plain|
ATTN_ATOL, ATTN_RTOL = 2.0 ** -8, 0.0
TC_ATTN_TOL = (f"atol {ATTN_ATOL:g} + rtol {ATTN_RTOL:g} x |plain|, at least one bf16 ulp of "
               "|plain|")
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
    # K18 above 16 rows: the tensor-core kernel (a T-16 chunk of 8 slots)
    "q8_matmul_ffn_tc": ("hip_llama_tpu_torch/csrc/ffn.cu", "hip_llama_tpu/ops/quant.py:894"),
    "q8_matmul_silu": ("hip_llama_tpu_torch/csrc/quant.cu", "hip_llama_tpu/ops/quant.py:609"),
    # K15 and K17 above 16 rows: the tiles on q8_wgmma.cuh's pipelined mainloop
    "q8_matmul_wgmma": ("hip_llama_tpu_torch/csrc/quant.cu", "hip_llama_tpu/ops/quant.py:1213"),
    "q8_matmul_silu_wgmma": ("hip_llama_tpu_torch/csrc/quant.cu",
                             "hip_llama_tpu/ops/quant.py:609"),
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
    # K21 and K22 above 16 rows: the int4 format of q8_wgmma.cuh's tiles
    "q4_matmul_wgmma": ("hip_llama_tpu_torch/csrc/quant4.cu", "hip_llama_tpu/ops/quant4.py:299"),
    "q4_matmul_silu_wgmma": ("hip_llama_tpu_torch/csrc/quant4.cu",
                             "hip_llama_tpu/ops/quant4.py:547"),
    # the paged KV cache: K6, K7, K11 and K13 with their int8 branches, K10
    # and K14
    "attention_decode_paged": ("hip_llama_tpu_torch/csrc/attention.cu",
                               "hip_llama_tpu/ops/attention.py:1664"),
    "attention_decode_paged_int8": ("hip_llama_tpu_torch/csrc/attention.cu",
                                    "hip_llama_tpu/ops/attention.py:1664"),
    "attention_prefill_paged": ("hip_llama_tpu_torch/csrc/attention.cu",
                                "hip_llama_tpu/ops/attention.py:1772"),
    "attention_prefill_paged_int8": ("hip_llama_tpu_torch/csrc/attention.cu",
                                     "hip_llama_tpu/ops/attention.py:1772"),
    "kv_write_rows_paged": ("hip_llama_tpu_torch/csrc/cache.cu",
                            "hip_llama_tpu/ops/cache.py:633"),
    "kv_write_rows_paged_int8": ("hip_llama_tpu_torch/csrc/cache.cu",
                                 "hip_llama_tpu/ops/cache.py:633"),
    "scale_write_rows_paged": ("hip_llama_tpu_torch/csrc/cache.cu",
                               "hip_llama_tpu/ops/cache.py:503"),
    "kv_write_chunk_paged": ("hip_llama_tpu_torch/csrc/cache.cu",
                             "hip_llama_tpu/ops/cache.py:933"),
    "kv_write_chunk_paged_int8": ("hip_llama_tpu_torch/csrc/cache.cu",
                                  "hip_llama_tpu/ops/cache.py:933"),
    "scale_write_chunk_paged": ("hip_llama_tpu_torch/csrc/cache.cu",
                                "hip_llama_tpu/ops/cache.py:1012"),
    # the `a8` modes: the `a8` branches of K15, K17, K21 and K22
    "q8_matmul_a8": ("hip_llama_tpu_torch/csrc/quant.cu", "hip_llama_tpu/ops/quant.py:250"),
    "q8_matmul_silu_a8": ("hip_llama_tpu_torch/csrc/quant.cu", "hip_llama_tpu/ops/quant.py:541"),
    # K15 and K17 `a8` above 16 rows at group sizes that are multiples of
    # 32: the int8 wgmma tiles of a8_wgmma.cuh
    "q8_matmul_a8_wgmma": ("hip_llama_tpu_torch/csrc/quant.cu",
                           "hip_llama_tpu/ops/quant.py:250"),
    "q8_matmul_silu_a8_wgmma": ("hip_llama_tpu_torch/csrc/quant.cu",
                                "hip_llama_tpu/ops/quant.py:541"),
    # K15, K17, K21 and K22 `a8` up to 16 rows at group sizes that are
    # multiples of 32: a8.cuh's int8 tensor-core GEMV (the base names above
    # and below: the dp4a GEMV, timed through a8_gemv_probe; their launches
    # are the wrappers' `a8` launches, of which `_tc` and `_wgmma` are shares)
    "q8_matmul_a8_tc": ("hip_llama_tpu_torch/csrc/quant.cu", "hip_llama_tpu/ops/quant.py:250"),
    "q8_matmul_silu_a8_tc": ("hip_llama_tpu_torch/csrc/quant.cu",
                             "hip_llama_tpu/ops/quant.py:541"),
    "q4_matmul_a8_tc": ("hip_llama_tpu_torch/csrc/quant4.cu", "hip_llama_tpu/ops/quant4.py:218"),
    "q4_matmul_silu_a8_tc": ("hip_llama_tpu_torch/csrc/quant4.cu",
                             "hip_llama_tpu/ops/quant4.py:494"),
    "q4_matmul_a8": ("hip_llama_tpu_torch/csrc/quant4.cu", "hip_llama_tpu/ops/quant4.py:218"),
    "q4_matmul_silu_a8": ("hip_llama_tpu_torch/csrc/quant4.cu",
                          "hip_llama_tpu/ops/quant4.py:494"),
    # K21 and K22 `a8` above 16 rows at group sizes that are multiples of
    # 32: a8_wgmma.cuh's int8 wgmma tiles, one nibble plane a CTA
    "q4_matmul_a8_wgmma": ("hip_llama_tpu_torch/csrc/quant4.cu",
                           "hip_llama_tpu/ops/quant4.py:218"),
    "q4_matmul_silu_a8_wgmma": ("hip_llama_tpu_torch/csrc/quant4.cu",
                                "hip_llama_tpu/ops/quant4.py:494"),
    # --layout stacked (K20 and its `a8` branch) and the four-write commit
    # (K8 with its int8 planes, K9)
    "q8_matmul_layered": ("hip_llama_tpu_torch/csrc/quant.cu",
                          "hip_llama_tpu/ops/quant.py:1567"),
    "q8_matmul_layered_a8": ("hip_llama_tpu_torch/csrc/quant.cu",
                             "hip_llama_tpu/ops/quant.py:1660"),
    "kv_write_rows": ("hip_llama_tpu_torch/csrc/cache.cu", "hip_llama_tpu/ops/cache.py:140"),
    "kv_write_rows_int8": ("hip_llama_tpu_torch/csrc/cache.cu",
                           "hip_llama_tpu/ops/cache.py:140"),
    "scale_write_rows": ("hip_llama_tpu_torch/csrc/cache.cu", "hip_llama_tpu/ops/cache.py:427"),
    # the prefill variants: K19 and its gate twin, K16
    "q8_matmul_minner": ("hip_llama_tpu_torch/csrc/prefill.cu",
                         "hip_llama_tpu/ops/quant.py:1126"),
    "q8_matmul_silu_minner": ("hip_llama_tpu_torch/csrc/prefill.cu",
                              "hip_llama_tpu/ops/quant.py:677"),
    "q8_matmul_xheads": ("hip_llama_tpu_torch/csrc/prefill.cu", "hip_llama_tpu/ops/quant.py:424"),
    # the bandwidth probes of tools/hbm_bw.py, the port bench's denominator
    "dma_read": ("hip_llama_tpu_torch/csrc/hbm_bw.cu", "tools/hbm_bw.py:125"),
    "dma_copy": ("hip_llama_tpu_torch/csrc/hbm_bw.cu", "tools/hbm_bw.py:93"),
    "wshape_read": ("hip_llama_tpu_torch/csrc/hbm_bw.cu", "tools/hbm_bw.py:185"),
    "deep_read": ("hip_llama_tpu_torch/csrc/hbm_bw.cu", "tools/hbm_bw.py:261"),
}
# the kernels each serving path must launch
DENSE_PATH = ("attention_decode", "kv_commit_rows", "kv_write_chunk", "attention_prefill")
# (K18 on a T-16 chunk of 8 slots, 128 rows, runs its tensor-core kernel;
# the decode FFN is inside K23)
Q8_PATH = ("q8_matmul", "q8_matmul_wgmma", "q8_layer_fused", "q8_matmul_ffn_tc",
           "q8_matmul_silu", "q8_matmul_silu_wgmma", "kv_commit_rows", "kv_write_chunk",
           "attention_prefill")
# the golden fixture's Q8 runs: prefill chunks of at most 256 rows (more than
# 16 at -b 4) take K18's tensor-core kernel, the four-kernel decode layer its
# GEMV route
GOLDEN_Q8_RUNS = {
    "q8, fused layer": (["--quant", "q8"], "1", "cpu_q8",
                        ("q8_layer_fused", "q8_matmul", "q8_matmul_ffn_tc", "kv_commit_rows",
                         "kv_write_chunk", "attention_prefill"), True),
    "q8, four-kernel layer": (["--quant", "q8"], "0", "cpu_q8",
                              ("attention_decode_fused", "q8_matmul", "q8_matmul_ffn",
                               "q8_matmul_ffn_tc", "kv_commit_rows", "kv_write_chunk",
                               "attention_prefill"), True),
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
                                  ("q8_layer_fused_int8", "q8_matmul", "q8_matmul_ffn_tc")
                                  + INT8_CACHE_PATH, False),
    "q8 --kv int8, four-kernel layer": (["--quant", "q8", "--kv", "int8"], "0", "cpu_q8_kv8",
                                        ("attention_decode_fused_int8", "q8_matmul",
                                         "q8_matmul_ffn", "q8_matmul_ffn_tc")
                                        + INT8_CACHE_PATH, False),
}
Q8_INT8_PATH = ("q8_matmul", "q8_matmul_wgmma", "q8_layer_fused_int8", "q8_matmul_ffn_tc",
                "q8_matmul_silu", "q8_matmul_silu_wgmma", "kv_commit_rows_int8",
                "kv_write_chunk_int8", "scale_write_chunk", "attention_prefill_int8")
# the int4 path: K21 and K22 carry every product, whatever the row count
# and HIPLLAMA_LAYER_FUSE say (the prefill chunks' on the wgmma tiles); the
# decode layer is four kernels
Q4_PATH = ("q4_matmul", "q4_matmul_wgmma", "q4_matmul_silu", "q4_matmul_silu_wgmma",
           "attention_decode_fused", "kv_commit_rows", "kv_write_chunk", "attention_prefill")
# the wrapper launches of one 7B decode step on each path
_L = LLAMA2_7B.n_layers
DENSE_STEP = {"attention_decode": _L, "kv_commit_rows": 1}
Q8_STEP = {"q8_layer_fused": _L, "q8_matmul": 1, "kv_commit_rows": 1}
Q8_INT8_STEP = {"q8_layer_fused_int8": _L, "q8_matmul": 1, "kv_commit_rows_int8": 1}
Q4_STEP = {"q4_matmul": 3 * _L + 1, "q4_matmul_silu": _L, "attention_decode_fused": _L,
           "kv_commit_rows": 1}
# the paged cache: the kernels the paged path must launch, and those it
# never does (its quantized layer is the JAX package's unfused one)
PAGED_PATH = ("attention_decode_paged", "attention_prefill_paged", "kv_write_rows_paged",
              "kv_write_chunk_paged")
PAGED_INT8_PATH = ("attention_decode_paged_int8", "attention_prefill_paged_int8",
                   "kv_write_rows_paged_int8", "scale_write_rows_paged",
                   "kv_write_chunk_paged_int8", "scale_write_chunk_paged")
NOT_PAGED = ("attention_decode", "attention_decode_fused", "attention_prefill", "kv_commit_rows",
             "kv_write_chunk", "q8_layer_fused", "q8_matmul_ffn", "q8_matmul_ffn_tc",
             "q8_matmul_silu", "scale_write_chunk")
# the fixture with --paged 16, at the bars of the dense runs against the JAX
# package's paged outputs (fp32: byte-identical to cpu_f32, checked apart;
# Q8 on bf16 pages: the average, tests/test_torch_paged_model.py::
# test_q8_paged_serve_forks_from_jax_only_at_near_ties)
GOLDEN_PAGED_RUNS = {
    "fp32 --paged 16": (["--dtype", "float32", "--paged", "16"], "1", "cpu_f32", PAGED_PATH,
                        True),
    "fp32 --kv int8 --paged 16": (["--dtype", "float32", "--kv", "int8", "--paged", "16"], "1",
                                  "cpu_f32_kv8_paged", PAGED_INT8_PATH, True),
    "q8 --paged 16": (["--quant", "q8", "--paged", "16"], "1", "cpu_q8_paged",
                      ("q8_matmul",) + PAGED_PATH, False),
    "q8 --kv int8 --paged 16": (["--quant", "q8", "--kv", "int8", "--paged", "16"], "1",
                                "cpu_q8_kv8_paged", ("q8_matmul",) + PAGED_INT8_PATH, False),
}
Q8_INT8_PAGED_PATH = ("q8_matmul",) + PAGED_INT8_PATH
# the `a8` modes on the fixture, at the bars of their reshape runs, with the
# JAX package's block_n 64 (its FFN kernels run at hidden 192 and its
# q8_matmul_ffn declines there, so under a8 the FFN is K17 and K15)
A8_KNOBS = {"q8": {"HIPLLAMA_Q8_MODE": "a8", "HIPLLAMA_Q8_BLOCK_N": "64"},
            "q4": {"HIPLLAMA_Q4_MODE": "a8", "HIPLLAMA_Q4_BLOCK_N": "64"}}
GOLDEN_A8_RUNS = {
    "q8": {"q8 a8": (["--quant", "q8"], "1", "cpu_q8_a8",
                     ("q8_matmul_a8", "q8_matmul_a8_tc", "q8_matmul_silu_a8",
                      "q8_matmul_silu_a8_tc", "attention_decode_fused", "kv_commit_rows",
                      "kv_write_chunk", "attention_prefill"), True),
           "q8 --kv int8 a8": (["--quant", "q8", "--kv", "int8"], "1", "cpu_q8_kv8_a8",
                               ("q8_matmul_a8", "q8_matmul_a8_tc", "q8_matmul_silu_a8",
                                "q8_matmul_silu_a8_tc", "attention_decode_fused_int8")
                               + INT8_CACHE_PATH, False)},
    "q4": {"q4 a8": (["--quant", "q4"], "1", "cpu_q4_a8",
                     ("q4_matmul_a8", "q4_matmul_a8_tc", "q4_matmul_a8_wgmma", "q4_matmul_silu_a8",
                      "q4_matmul_silu_a8_tc", "q4_matmul_silu_a8_wgmma", "attention_decode_fused",
                      "kv_commit_rows",
                      "kv_write_chunk", "attention_prefill"), True)},
}
# the 7B-width Q8 + int8-KV serve in a8: the prefill W2 (172 groups) keeps
# reshape math, as the JAX decision says; the decode FFN is K18's GEMV route,
# a T-16 chunk's its tensor-core kernel; the prefill's QKV, wo and gate run
# the int8 wgmma tiles
Q8_A8_PATH = ("q8_matmul_a8", "q8_matmul_a8_tc", "q8_matmul_a8_wgmma", "q8_matmul_silu_a8",
              "q8_matmul_silu_a8_wgmma", "q8_matmul", "q8_matmul_ffn", "q8_matmul_ffn_tc",
              "attention_decode_fused_int8", "kv_commit_rows_int8", "kv_write_chunk_int8",
              "scale_write_chunk", "attention_prefill_int8")
Q8_A8_STEP = {"q8_matmul_a8": 2 * _L + 1, "q8_matmul_a8_tc": 2 * _L + 1,
              "attention_decode_fused_int8": _L, "q8_matmul_ffn": _L, "kv_commit_rows_int8": 1}
# --layout stacked: the decode layer is four K20 products and K1 on the
# flat QKV rows, never K23, K5 or K18 (the prefill is the unrolled one on
# the layers' views, K18 included); the fixture's reshape runs fork at
# exact bf16 logit ties and are held to the average bar
# (tests/test_torch_stacked.py::test_stacked_serve_forks_from_jax_only_at_near_ties)
NOT_STACKED = ("q8_layer_fused", "q8_layer_fused_int8", "attention_decode_fused",
               "attention_decode_fused_int8")
GOLDEN_STACKED_RUNS = {
    "q8 stacked": (["--quant", "q8", "--layout", "stacked"], "1", "cpu_q8_stacked",
                   ("q8_matmul_layered", "attention_decode", "q8_matmul", "q8_matmul_ffn_tc",
                    "kv_commit_rows", "kv_write_chunk", "attention_prefill"), False),
    "q8 --kv int8 stacked": (["--quant", "q8", "--kv", "int8", "--layout", "stacked"], "1",
                             "cpu_q8_kv8_stacked",
                             ("q8_matmul_layered", "attention_decode_int8", "q8_matmul",
                              "q8_matmul_ffn_tc") + INT8_CACHE_PATH, False),
}
GOLDEN_STACKED_A8_RUNS = {
    "q8 stacked a8": (["--quant", "q8", "--layout", "stacked"], "1", "cpu_q8_a8_stacked",
                      ("q8_matmul_layered_a8", "q8_matmul_layered_a8_tc", "attention_decode",
                       "q8_matmul_a8", "q8_matmul_silu_a8", "kv_commit_rows", "kv_write_chunk",
                       "attention_prefill"), True),
}
# HIPLLAMA_KV_COMMIT=0: the four writes, never K2
GOLDEN_KV_COMMIT_RUNS = {
    "fp32, four-write commit": (["--dtype", "float32"], "1", "cpu_f32",
                                ("attention_decode", "kv_write_rows", "kv_write_chunk",
                                 "attention_prefill"), True),
    "q8 --kv int8, four-write commit": (["--quant", "q8", "--kv", "int8"], "1", "cpu_q8_kv8",
                                        ("q8_layer_fused_int8", "kv_write_rows_int8",
                                         "scale_write_rows") + INT8_CACHE_PATH[1:], False),
}
Q8_STACKED_PATH = ("q8_matmul_layered", "attention_decode_int8", "q8_matmul", "q8_matmul_ffn_tc",
                   "q8_matmul_silu", "kv_commit_rows_int8", "kv_write_chunk_int8",
                   "scale_write_chunk", "attention_prefill_int8")
Q8_STACKED_STEP = {"q8_matmul_layered": 4 * _L, "attention_decode_int8": _L,
                   "kv_commit_rows_int8": 1, "q8_matmul": 1}
Q8_STACKED_A8_PATH = ("q8_matmul_layered_a8", "q8_matmul_layered_a8_tc", "attention_decode_int8",
                      "q8_matmul_a8", "q8_matmul_a8_tc",
                      "q8_matmul_a8_wgmma", "q8_matmul_silu_a8", "q8_matmul_silu_a8_wgmma",
                      "q8_matmul", "q8_matmul_ffn_tc", "kv_commit_rows_int8",
                      "kv_write_chunk_int8", "scale_write_chunk", "attention_prefill_int8")
Q8_STACKED_A8_STEP = {"q8_matmul_layered_a8": 4 * _L, "q8_matmul_layered_a8_tc": 4 * _L,
                      "attention_decode_int8": _L, "kv_commit_rows_int8": 1, "q8_matmul_a8": 1,
                      "q8_matmul_a8_tc": 1}
Q8_INT8_PAGED_STEP = {"attention_decode_paged_int8": _L, "kv_write_rows_paged_int8": 1,
                      "scale_write_rows_paged": 1, "q8_matmul": 4 * _L + 1}
# the 7B-width Q8 + int8-KV serve with both prefill knobs: T-256 chunks
# (2048 rows) take K16 on wo, K19 on W2 and K19 silu on the gate; T-64
# chunks K16 on wo and K17 + K15 on the FFN (512 rows: no K19); T-16 chunks
# K16 and K18 (its tensor-core kernel); the decode step is phase 6's
PREFILL_KNOBS = {"HIPLLAMA_PREFILL_MINNER": "1", "HIPLLAMA_PREFILL_XHEADS": "1"}
Q8_KNOBS_PATH = ("q8_matmul_xheads", "q8_matmul_minner", "q8_matmul_silu_minner",
                 "q8_matmul_silu", "q8_matmul", "q8_matmul_ffn_tc", "q8_layer_fused_int8",
                 "kv_commit_rows_int8", "kv_write_chunk_int8", "scale_write_chunk",
                 "attention_prefill_int8")
# int4 on the fixture, at the bars of the Q8 runs (bf16 cache: both; int8
# cache: the average)
GOLDEN_Q4_RUNS = {
    "q4": (["--quant", "q4"], "1", "cpu_q4", Q4_PATH, True),
    "q4 --kv int8": (["--quant", "q4", "--kv", "int8"], "1", "cpu_q4_kv8",
                     ("q4_matmul", "q4_matmul_wgmma", "q4_matmul_silu",
                      "q4_matmul_silu_wgmma", "attention_decode_fused_int8",
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


def step_index(b: int, n_layers: int, kvh: int, pos: torch.Tensor) -> tuple:
    """index_put_ indices of a decode step's rows in a (B, L, KVH, S, ...)
    plane: (b, l, h, pos[b]) broadcast to (B, L, KVH)."""
    dev = pos.device
    return (torch.arange(b, device=dev)[:, None, None],
            torch.arange(n_layers, device=dev)[None, :, None],
            torch.arange(kvh, device=dev)[None, None, :], pos.long()[:, None, None])


def chunk_index(start_l, valid_l, s: int, kvh: int, dev, *chunks) -> tuple:
    """index_put_ indices of a prefill chunk's live rows (j < valid[b],
    start[b] + j < S) in one layer's (B, KVH, S, ...) view, and each chunk
    (B, T, KVH, ...) gathered to those rows (N, KVH, ...)."""
    bi, ti = map(list, zip(*[(b, j) for b, (st, v) in enumerate(zip(start_l, valid_l))
                             for j in range(v) if st + j < s]))
    bt = torch.tensor(bi, device=dev)
    tt = torch.tensor(ti, device=dev)
    st = torch.tensor(start_l, device=dev)[bt]
    idx = (bt[:, None], torch.arange(kvh, device=dev)[None, :], (st + tt)[:, None])
    return idx, tuple(c[bt, tt] for c in chunks)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the magnitude of each element of x."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126))) - 7)


def attn_check(pairs, dtype, tensor_cores: bool = False) -> tuple[float, bool]:
    """max |kernel - plain| over the (kernel, plain) pairs of an attention
    kernel's outputs, and whether every output is within its tolerance:
    TOL in fp32, ATTN_ATOL + ATTN_RTOL |plain| in bf16, and for the
    tensor-core prefill (bf16 and int8 caches) at least one bf16 ulp of
    |plain|."""
    pairs = list(pairs)

    def bound(b):
        if dtype == torch.float32:
            return TOL[dtype]
        tol = ATTN_ATOL + ATTN_RTOL * b.float().abs()
        return torch.maximum(tol, bf16_ulp(b)) if tensor_cores else tol

    ok = all(bool(((a.float() - b.float()).abs() <= bound(b)).all()) for a, b in pairs)
    return max(max_err(a, b) for a, b in pairs), ok


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
    err, ok = attn_check(((A.attention_decode(q, cache.k, cache.v, l, pos, kc, vc),
                           A.attention_decode_plain(q, cache.k, cache.v, l, pos, kc, vc))
                          for l in (0, n_layers - 1)), dtype)
    # the kernel and SDPA as CUDA-graph replays: their device time is below
    # the wrappers' host cost
    ms = cuda_ms(lambda i: A.attention_decode(q, cache.k, cache.v, i % rot, pos, kc, vc),
                 graph=True)
    plain = cuda_ms(lambda i: A.attention_decode_plain(q, cache.k, cache.v, i % rot, pos, kc, vc))
    # library: SDPA over [history rows | current row] with the same mask
    kf = [torch.cat([cache.k[:, l], kc[:, :, None]], dim=2) for l in range(rot)]
    vf = [torch.cat([cache.v[:, l], vc[:, :, None]], dim=2) for l in range(rot)]
    col = torch.arange(s + 1, device=dev)
    mask = ((col[None, :] < pos[:, None]) | (col[None, :] == s))[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = cuda_ms(lambda i: F.scaled_dot_product_attention(q4, kf[i % rot], vf[i % rot],
                                                           attn_mask=mask), graph=True)
    n_bytes = (2 * b * h * hs + 2 * b * kvh * hs + 2 * sum(pos_l) * kvh * hs) * e + 4 * b
    flops = 4 * h * hs * sum(p + 1 for p in pos_l)
    out["attention_decode"] = dict(max_abs_err=err, ok=ok, ms=ms, plain_ms=plain, library_ms=lib,
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
    # library: one index_put_ per plane, the rows (B, L, KVH, HS) at pos
    idx = step_index(b, n_layers, kvh, pos)
    krp, vrp = kr.permute(1, 0, 2, 3), vr.permute(1, 0, 2, 3)
    lib = cuda_ms(lambda i: (cache.k.index_put_(idx, krp), cache.v.index_put_(idx, vrp)),
                  graph=True)
    n_bytes = 2 * 2 * n_layers * b * kvh * hs * e + 4 * b
    out["kv_commit_rows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
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
    # library: one index_put_ per plane of the layer, the live rows gathered
    # beforehand
    idx, (ckg, cvg) = chunk_index(start_l, valid_l, s, kvh, dev, ck, cv)
    lib = cuda_ms(lambda i: (cache.k[:, i % rot].index_put_(idx, ckg),
                             cache.v[:, i % rot].index_put_(idx, cvg)), graph=True)
    rows = sum(max(0, min(v, s - st)) for st, v in zip(start_l, valid_l))
    n_bytes = 2 * 2 * rows * kvh * hs * e + 8 * b
    out["kv_write_chunk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                 bound=bound_ms(n_bytes, 0, dtype))

    # K4 prefill over the chunk just written (rows t < valid compared)
    qp = rnd(b, t, h, hs)
    live = torch.arange(t, device=dev)[None, :] < cvalid[:, None]
    err, ok = attn_check(((A.attention_prefill(qp, cache.k, cache.v, l, start, cvalid)[live],
                           A.attention_prefill_plain(qp, cache.k, cache.v, l, start, cvalid)[live])
                          for l in (0, 3)), dtype, tensor_cores=True)
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
    out["attention_prefill"] = dict(max_abs_err=err, ok=ok, ms=ms, plain_ms=plain,
                                    library_ms=lib, bound=bound_ms(n_bytes, flops, dtype))

    for name, r in out.items():
        ok = r.pop("ok", r["max_abs_err"] <= TOL[dtype])
        tol = (f"atol {ATTN_ATOL:g} + rtol {ATTN_RTOL:g} x |plain|"
               if name.startswith("attention") and dtype == torch.bfloat16 else f"{TOL[dtype]:g}")
        if name == "attention_prefill" and dtype == torch.bfloat16:
            tol = TC_ATTN_TOL
        lib_s = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        if name.startswith("kv_"):
            lib_s += " (index_put_)"
        print(f"kernel {name} {str(dtype)[6:]}: max_abs_err {r['max_abs_err']:.3g} "
              f"(tol {tol}) {'ok' if ok else 'FAIL'}; ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} library_ms {lib_s} "
              f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]})", flush=True)
        if not ok:
            raise AssertionError(f"{name} ({dtype}) disagrees with its plain version")
    return out


def prefill_ttft_case(int8: bool) -> None:
    """K4 on a bf16 or an int8 cache at the port bench's ttft shape (bench.py
    --mode ttft: B 8, a fresh 512-token prompt a slot, window 1024, 7B
    heads): T 512 from start 0 over S 1024, two JAX blocks of 512 of which
    the chunk's causal frontier reaches the first. Against its plain
    version, SDPA (on the dequantized planes for int8) and its bound; four
    layers rotate so each call finds its rows cold in L2."""
    dev = torch.device("cuda")
    b, rot, kvh, h, s, hs, t = 8, 4, 32, 32, 1024, 128, 512
    g = torch.Generator(device=dev).manual_seed(SEED + 21)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

    k, v = rnd(b, rot, kvh, s, hs), rnd(b, rot, kvh, s, hs)
    sc: tuple = ()
    kd, vd = k, v
    if int8:
        (k, ks), (v, vs) = C.quantize_kv_rows(k.float()), C.quantize_kv_rows(v.float())
        sc = (ks, vs)
        kd = torch.stack([dequant_cache(k[:, l], ks[:, l]) for l in range(rot)], dim=1)
        vd = torch.stack([dequant_cache(v[:, l], vs[:, l]) for l in range(rot)], dim=1)
    start = torch.zeros(b, dtype=torch.int32, device=dev)
    valid = torch.full((b,), t, dtype=torch.int32, device=dev)
    q = rnd(b, t, h, hs)
    err, ok = attn_check([(A.attention_prefill(q, k, v, 1, start, valid, *sc),
                           A.attention_prefill_plain(q, k, v, 1, start, valid, *sc))],
                         torch.bfloat16, tensor_cores=True)
    ms = cuda_ms(lambda i: A.attention_prefill(q, k, v, i % rot, start, valid, *sc))
    plain = cuda_ms(lambda i: A.attention_prefill_plain(q, k, v, i % rot, start, valid, *sc),
                    iters=2, warmup=1)
    col = torch.arange(s, device=dev)
    mask = (col[None, :] <= torch.arange(t, device=dev)[:, None])[None, None]  # (1, 1, T, S)
    qt = q.transpose(1, 2)
    lib = cuda_ms(lambda i: F.scaled_dot_product_attention(qt, kd[:, i % rot], vd[:, i % rot],
                                                           attn_mask=mask))
    row_bytes = hs + 4 if int8 else hs * 2
    bound = bound_ms(2 * b * t * h * hs * 2 + 2 * b * t * kvh * row_bytes + 8 * b,
                     4 * h * hs * b * t * (t + 1) // 2, torch.bfloat16)
    name = "attention_prefill_int8" if int8 else "attention_prefill"
    print(f"kernel {name} at the bench's ttft shape [B 8, T 512 from start 0, H 32, KVH 32, "
          f"S 1024 (two JAX blocks of 512), HS 128]: max_abs_err {err:.3g} ({TC_ATTN_TOL}) "
          f"{'ok' if ok else 'FAIL'}; ms {ms:.4f} "
          f"plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms {bound[0]:.4f} ({bound[1]})",
          flush=True)
    if not ok:
        raise AssertionError(f"{name} at the ttft shape disagrees with its plain version")


# ---------------------------------------------------------------------------
# phase 3b: the Q8 kernels against their plain versions at 7B shapes


def q8_kernel_case(name: str, label: str, fn, plain_fn, lib_fn, n_bytes: float,
                   flops: float, atol: float = Q8_ATOL, rtol: float = Q8_RTOL,
                   op_dtype=torch.bfloat16, graph: bool = False) -> dict:
    """One kernel case: fn(i) and plain_fn(i) on the same inputs (i rotates
    over weight copies so that each call finds its weights cold in L2),
    compared elementwise at atol + rtol * |plain| (each output of a tuple),
    then timed (with `graph`, fn and lib_fn as a CUDA graph's replay).
    lib_fn None: no single library call does this work; op_dtype: the type
    whose peak rate bounds the operations."""
    got, want = fn(0), plain_fn(0)
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = max(max_err(a, b) for a, b in pairs)
    ok = all(bool(((a.float() - b.float()).abs() <= atol + rtol * b.float().abs()).all())
             for a, b in pairs)
    del got, want, pairs
    ms = cuda_ms(fn, graph=graph)
    plain = cuda_ms(plain_fn, iters=4, warmup=1)
    lib = None if lib_fn is None else cuda_ms(lib_fn, graph=graph)
    bound = bound_ms(n_bytes, flops, op_dtype)
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

    # the mainloop's products alone (no copy, no dequantization): 8 waves of
    # 132 CTAs of 128 x 128 tiles over K 4096, each step's wgmmas drained
    # before the consumers' barrier (the schedule before the pipelining) and
    # kept in flight across it (q8_wgmma.cuh's), as a share of the bf16 peak
    ctas, steps = 8 * 132, 4096 // Q.WGMMA_STEP_K
    flops = 2 * 128 * 128 * Q.WGMMA_STEP_K * steps * ctas
    for in_flight in (0, 1):
        t = cuda_ms(lambda i: Q.wgmma_mainloop_probe(ctas, steps, in_flight, dev))
        MAINLOOP[in_flight] = flops / t / 1e9
        print(f"mainloop products only, wgmma.wait_group {in_flight} before the consumers' "
              f"barrier ({ctas} CTAs of {steps} {Q.WGMMA_STEP_K}-deep steps of a 128 x 128 "
              f"tile): {t:.4f} ms, "
              f"{flops / t / 1e9:.1f} TFLOP/s = {flops / t / 1e9 / 989:.3f} of the 989 TFLOP/s "
              f"bf16 peak", flush=True)

    # K15: QKV with norm + RoPE at decode and prefill rows (the GEMV up to
    # 16 rows, the wgmma tiles above: q8_rows_kernel), wo with the residual,
    # W2 with the residual at K 11008, the classifier with the norm
    def k15(m):
        return "q8_matmul" if Q.q8_rows_kernel(m) == "gemv" else "q8_matmul_wgmma"

    wq = weights(d, nqkv, 2)
    wqb = deq(wq)
    rope = dict(rope_limit=2 * d, rope_head=128, rope_theta=10000.0)
    # 2048 and 4088: a T-256 chunk of 8 slots, the port bench's ttft prefill
    # (8 x 511); then the routing rule's rows on both sides of 16
    for m in (8, 2048, 4088, 16, 17, 32, 128, 512):
        x = rnd(m, d)
        pos = (torch.tensor([0, 1, 100, 255, 256, 300, 450, 511], dtype=torch.int32, device=dev)
               if m == 8 else torch.arange(m, dtype=torch.int32, device=dev) % 512)
        label = f"QKV M {m}, norm + RoPE" + ("" if m in (8, 2048, 4088) else
                                              f"; rule row: {Q.q8_rows_kernel(m)}")
        case(k15(m), label,
             lambda i: Q.q8_matmul(x, wq[i % 2], norm_weight=norm, rope_pos=pos, **rope),
             lambda i: Q.q8_matmul_plain(x, wq[i % 2], norm_weight=norm, rope_pos=pos, **rope),
             lambda i: x @ wqb[i % 2],
             wbytes(d, nqkv) + m * d * 2 + m * nqkv * 2 + d * 4 + m * 4, 2 * m * d * nqkv,
             graph=m <= Q.GEMV_MAX_M)
    del wq, wqb
    wo = weights(d, d, 4)
    wob = deq(wo)
    for m in (8, 2048):
        x, res = rnd(m, d), rnd(m, d)
        case(k15(m), f"wo M {m}, residual",
             lambda i: Q.q8_matmul(x, wo[i % 4], residual=res),
             lambda i: Q.q8_matmul_plain(x, wo[i % 4], residual=res),
             lambda i: x @ wob[i % 4], wbytes(d, d) + 3 * m * d * 2, 2 * m * d * d,
             graph=m <= Q.GEMV_MAX_M)
    del wo, wob
    w2 = weights(hid, d, 2)
    w2b = deq(w2)
    m = 2048
    xh, res = rnd(m, hid), rnd(m, d)
    case(k15(m), f"W2 M {m}, K {hid}, residual",
         lambda i: Q.q8_matmul(xh, w2[i % 2], residual=res),
         lambda i: Q.q8_matmul_plain(xh, w2[i % 2], residual=res),
         lambda i: xh @ w2b[i % 2], wbytes(hid, d) + m * hid * 2 + 2 * m * d * 2,
         2 * m * hid * d)
    del w2, w2b, xh
    x = rnd(8, d)
    wc = weights(d, voc, 1)
    wcb = deq(wc)
    case("q8_matmul", "classifier M 8, norm",
         lambda i: Q.q8_matmul(x, wc[0], norm_weight=norm),
         lambda i: Q.q8_matmul_plain(x, wc[0], norm_weight=norm),
         lambda i: x @ wcb[0], wbytes(d, voc) + 8 * d * 2 + 8 * voc * 2 + d * 4,
         2 * 8 * d * voc, graph=True)
    del wc, wcb

    # K17 at decode rows (the GEMV) and prefill rows (the wgmma tiles; 4088
    # the bench's ttft prefill); K18 at decode rows (the GEMV route) and
    # at a T-4 and a T-16 chunk of 8 slots (its tensor-core kernel)
    w13, w2 = weights(d, 2 * hid, 2), weights(hid, d, 2)
    w13b, w2b = deq(w13), deq(w2)
    for m in (8, 2048, 512, 4088, 32, 128):
        x = rnd(m, d)
        case("q8_matmul_silu" if Q.q8_rows_kernel(m) == "gemv" else "q8_matmul_silu_wgmma",
             f"W1|W3 gate M {m}, norm",
             lambda i: Q.q8_matmul_silu(x, w13[i % 2], norm_weight=norm),
             lambda i: Q.q8_matmul_silu_plain(x, w13[i % 2], norm_weight=norm),
             lambda i: x @ w13b[i % 2],
             wbytes(d, 2 * hid) + m * d * 2 + m * hid * 2 + d * 4, 2 * m * d * 2 * hid,
             graph=m <= Q.GEMV_MAX_M)
    for m in (8, 32, 128):
        x, hb = rnd(m, d), rnd(m, hid)
        case("q8_matmul_ffn" if m <= Q.GEMV_MAX_M else "q8_matmul_ffn_tc", f"FFN M {m}",
             lambda i: Q.q8_matmul_ffn(x, w13[i % 2], w2[i % 2], x, norm),
             lambda i: Q.q8_matmul_ffn_plain(x, w13[i % 2], w2[i % 2], x, norm),
             lambda i: (x @ w13b[i % 2], hb @ w2b[i % 2]),
             wbytes(d, 2 * hid) + wbytes(hid, d) + 3 * m * d * 2 + d * 4,
             2 * m * d * 2 * hid + 2 * m * hid * d, graph=m <= Q.GEMV_MAX_M)
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
         4 * h * hs * sum(p + 1 for p in pos_l), atol=ATTN_ATOL, rtol=ATTN_RTOL, graph=True)
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
    # the kernels line carries each kernel's decode case (M 2048, a T-256
    # chunk of 8 slots, for the wgmma tiles; M 128, a T-16 chunk of 8 slots,
    # for K18's tensor-core kernel); max_abs_err over all cases
    first = {"q8_matmul": 0, "q8_matmul_wgmma": 0, "q8_matmul_silu": 0,
             "q8_matmul_silu_wgmma": 0, "q8_matmul_ffn": 0, "q8_matmul_ffn_tc": 1,
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
    beforehand (and so reading twice the bytes). K1 and K5 (and SDPA beside
    them) time as CUDA-graph replays: their device time is below the
    wrappers' host cost."""
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
             rtol=INT8_ATTN_RTOL, graph=False):
        out[name] = q8_kernel_case(name, label, fn, plain_fn, lib_fn, n_bytes, flops, atol, rtol,
                                   graph=graph)

    def clone():
        return KVCache(*(x.clone() for x in (cache.k, cache.v, cache.k_scale, cache.v_scale)))

    def writer_case(name, label, write, plain_write, lib_write, n_bytes):
        """A writer: into two copies of the cache, which must then be equal
        bit for bit; then timed into the cache itself, beside index_put_
        calls making the same write (lib_write)."""
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
        lib = cuda_ms(lambda i: lib_write(cache, i % rot), graph=True)
        bound = bound_ms(n_bytes, 0, torch.int8)
        print(f"kernel {name} [{label}]: max_abs_err {err:.3g} (bit-exact) "
              f"{'ok' if ok else 'FAIL'}; ms {ms:.4f} plain_ms {plain:.4f} library_ms "
              f"(index_put_) {lib:.4f} bound_ms {bound[0]:.4f} ({bound[1]})", flush=True)
        if not ok:
            raise AssertionError(f"{name} [{label}] differs from its plain version")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound=bound)

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
         dec_bytes, dec_flops, graph=True)
    qkv = torch.cat([q, kc, vc], dim=1)
    case("attention_decode_fused_int8", "B 8, H 32, KVH 32, S 512, HS 128",
         lambda i: A.attention_decode_fused(qkv, cache.k, cache.v, i % rot, pos, h, *sc),
         lambda i: A.attention_decode_fused_plain(qkv, cache.k, cache.v, i % rot, pos, h, *sc),
         lambda i: F.scaled_dot_product_attention(q4, kf[i % rot], vf[i % rot], attn_mask=mask),
         dec_bytes, dec_flops, graph=True)
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
    # library: index_put_ of the rows quantized beforehand and their scales,
    # one call per plane (the valid slots only, with the mask)
    rows_q = [t for r in (kr, vr) for t in C.quantize_kv_rows(r.permute(1, 0, 2, 3))]
    keep = valid.bool()
    all_idx = step_index(b, n_layers, kvh, pos)
    kept_idx = tuple(t[keep] if t.shape[0] == b else t for t in all_idx)
    kept_rows = [t[keep] for t in rows_q]  # masked here: a mask syncs inside a capture

    def commit_lib(c, idx, vals):
        for plane, v in zip((c.k, c.k_scale, c.v, c.v_scale), vals):
            plane.index_put_(idx, v)

    writer_case("kv_commit_rows_int8", "L 32, B 8, KVH 32, HS 128, bf16 rows, a valid mask",
                lambda c, i: C.kv_commit_rows(c, kr, vr, pos, valid),
                lambda c, i: C.kv_commit_rows_plain(c, kr, vr, pos, valid),
                lambda c, i: commit_lib(c, kept_idx, kept_rows),
                2 * n_layers * 6 * kvh * (hs * 2 + hs + 4) + 8 * b)
    writer_case("kv_commit_rows_int8", "L 32, B 8, KVH 32, HS 128, bf16 rows",
                lambda c, i: C.kv_commit_rows(c, kr, vr, pos),
                lambda c, i: C.kv_commit_rows_plain(c, kr, vr, pos),
                lambda c, i: commit_lib(c, all_idx, rows_q),
                2 * n_layers * b * kvh * (hs * 2 + hs + 4) + 4 * b)

    # K3 and K12: ragged valid, one bystander, windows past S
    start_l = [0, 40, 128, 256, 300, 5, 400, 200]
    valid_l = [256, 200, 64, 256, 100, 0, 112, 1]
    start = torch.tensor(start_l, dtype=torch.int32, device=dev)
    cvalid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
    (ckq, cks), (cvq, cvs) = (C.quantize_kv_rows(rnd(b, t, kvh, hs)) for _ in range(2))
    rows = sum(max(0, min(v, s - st)) for st, v in zip(start_l, valid_l))
    cidx, (ckg, cvg, cksg, cvsg) = chunk_index(start_l, valid_l, s, kvh, dev, ckq, cvq, cks, cvs)
    writer_case("kv_write_chunk_int8", "B 8, T 256, KVH 32, HS 128",
                lambda c, i: C.kv_write_chunk(c, ckq, cvq, i, start, cvalid),
                lambda c, i: C.kv_write_chunk_plain(c, ckq, cvq, i, start, cvalid),
                lambda c, i: (c.k[:, i].index_put_(cidx, ckg), c.v[:, i].index_put_(cidx, cvg)),
                2 * 2 * rows * kvh * hs + 8 * b)
    writer_case("scale_write_chunk", "B 8, T 256, KVH 32",
                lambda c, i: C.scale_write_chunk(c, cks, cvs, i, start, cvalid),
                lambda c, i: C.scale_write_chunk_plain(c, cks, cvs, i, start, cvalid),
                lambda c, i: (c.k_scale[:, i].index_put_(cidx, cksg),
                              c.v_scale[:, i].index_put_(cidx, cvsg)),
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
    err, ok = attn_check(((A.attention_prefill(qp, cache.k, cache.v, l, start, cvalid, *sc)[live],
                           A.attention_prefill_plain(qp, cache.k, cache.v, l, start, cvalid,
                                                     *sc)[live])
                          for l in (0, 3)), torch.bfloat16, tensor_cores=True)
    ms = cuda_ms(lambda i: A.attention_prefill(qp, cache.k, cache.v, i % rot, start, cvalid, *sc))
    plain = cuda_ms(lambda i: A.attention_prefill_plain(qp, cache.k, cache.v, i % rot, start,
                                                        cvalid, *sc), iters=4, warmup=1)
    lib = cuda_ms(lambda i: F.scaled_dot_product_attention(qt, kd[i % rot], vd[i % rot],
                                                           attn_mask=pmask))
    bound = bound_ms((2 * n_rows * h * hs) * 2 + 2 * kv_rows * kvh * (hs + 4) + 8 * b,
                     4 * h * hs * sum(min(st + j, s - 1) + 1 for st, v in zip(start_l, valid_l)
                                      for j in range(v)), torch.bfloat16)
    print(f"kernel attention_prefill_int8 [B 8, T 256, H 32, KVH 32, S 512, HS 128, bf16 q]: "
          f"max_abs_err {err:.3g} ({TC_ATTN_TOL}) "
          f"{'ok' if ok else 'FAIL'}; "
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
    # K23 int8 beside the standalone kernels of its phases, and what is left
    layer_parts(cuda_ms)
    return out


# ---------------------------------------------------------------------------
# phase 7a: the int4 kernels against their plain versions at 7B shapes


def phase_q4_kernels() -> dict[str, dict]:
    """K21 and K22 at Llama-2-7B shapes, bf16 activations, int4 weights of
    group size 32: the GEMV up to 16 rows (timed as CUDA-graph replays,
    cuBLAS too), the wgmma tiles above (q4_rows_kernel; M 2048 a T-256
    chunk of 8 slots, M 128 a T-16 one).
    Library yardstick: cuBLAS `x @ w` on the weight dequantized to bf16
    beforehand (four times the packed weight bytes). Bytes count the packed
    weights (K/2 x N), fp32 scales, activations in and out once each.
    Weights rotate over enough copies (at least 56 MB) that each call finds
    its weights cold in the 50 MB L2."""
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

    def k21(m, name="q4_matmul"):
        return name if Q4.q4_rows_kernel(m) == "gemv" else f"{name}_wgmma"

    norm = (1 + 0.1 * rnd(d, dtype=torch.float32)).contiguous()
    out: dict[str, list] = {}

    def case(name, label, m, fn, plain_fn, lib_fn, n_bytes, flops):
        # a decode-row GEMV (and cuBLAS beside it) as a CUDA graph's replay:
        # its device time is below the wrapper's host cost
        out.setdefault(name, []).append(
            q8_kernel_case(name, label, fn, plain_fn, lib_fn, n_bytes, flops,
                           graph=Q4.q4_rows_kernel(m) == "gemv"))

    # K21: QKV with norm + RoPE at decode and prefill rows, wo and W2 with
    # the residual, the classifier with the norm
    wq = weights(d, nqkv, 2)
    wqb = deq(wq)
    rope = dict(rope_limit=2 * d, rope_head=128, rope_theta=10000.0)
    for m in (8, 2048, 128):
        x = rnd(m, d)
        pos = (torch.tensor([0, 1, 100, 255, 256, 300, 450, 511], dtype=torch.int32, device=dev)
               if m == 8 else torch.arange(m, dtype=torch.int32, device=dev) % 512)
        case(k21(m), f"QKV M {m}, norm + RoPE", m,
             lambda i: Q4.q4_matmul(x, wq[i % 2], norm_weight=norm, rope_pos=pos, **rope),
             lambda i: Q4.q4_matmul_plain(x, wq[i % 2], norm_weight=norm, rope_pos=pos, **rope),
             lambda i: x @ wqb[i % 2],
             wbytes(d, nqkv) + m * d * 2 + m * nqkv * 2 + d * 4 + m * 4, 2 * m * d * nqkv)
    del wq, wqb
    for label, k, copies in (("wo", d, 6), ("W2", hid, 2)):
        w = weights(k, d, copies)
        wb = deq(w)
        for m in (8, 2048):
            xk, res = rnd(m, k), rnd(m, d)
            case(k21(m), f"{label} M {m}, K {k}, residual", m,
                 lambda i: Q4.q4_matmul(xk, w[i % copies], residual=res),
                 lambda i: Q4.q4_matmul_plain(xk, w[i % copies], residual=res),
                 lambda i: xk @ wb[i % copies], wbytes(k, d) + m * k * 2 + 2 * m * d * 2,
                 2 * m * k * d)
        del w, wb
    x = rnd(8, d)
    wc = weights(d, voc, 1)
    wcb = deq(wc)
    case("q4_matmul", "classifier M 8, norm", 8,
         lambda i: Q4.q4_matmul(x, wc[0], norm_weight=norm),
         lambda i: Q4.q4_matmul_plain(x, wc[0], norm_weight=norm),
         lambda i: x @ wcb[0], wbytes(d, voc) + 8 * d * 2 + 8 * voc * 2 + d * 4,
         2 * 8 * d * voc)
    del wc, wcb

    # K22 at decode and prefill rows
    w13 = weights(d, 2 * hid, 2)
    w13b = deq(w13)
    for m in (8, 2048, 128):
        x = rnd(m, d)
        case(k21(m, "q4_matmul_silu"), f"W1|W3 gate M {m}, norm", m,
             lambda i: Q4.q4_matmul_silu(x, w13[i % 2], norm_weight=norm),
             lambda i: Q4.q4_matmul_silu_plain(x, w13[i % 2], norm_weight=norm),
             lambda i: x @ w13b[i % 2],
             wbytes(d, 2 * hid) + m * d * 2 + m * hid * 2 + d * 4, 2 * m * d * 2 * hid)
    del w13, w13b
    # the kernels line carries each kernel's first case (QKV and the gate:
    # M 8 on the GEMV, M 2048 on the tiles); max_abs_err over all cases
    return {name: dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
            for name, rs in out.items()}


# ---------------------------------------------------------------------------
# phase 8a: the paged kernels against their plain versions at 7B shapes


def phase_paged_kernels() -> dict[str, dict]:
    """K6 and K7 on bf16 and int8 pages, K11 and K13 on both, K10 and K14,
    at Llama-2-7B shapes (L 32, KVH 32, HS 128) with pages of 128 rows: B 8,
    4 pages per slot scattered over a 33-page pool (page 0 the trash page),
    ragged positions below 512, prefill chunks of T 128 at page-aligned
    starts. The writers must match their plain versions bit for bit. The
    kernels and the plain attention walk the JAX block, the page
    (ATTN_ATOL/RTOL on bf16 pages). Bytes count live rows (and their 4-byte scales on int8 pages),
    activations in and out and the table once each; the library yardstick
    is SDPA over the pages gathered into contiguous K/V (dequantized to bf16
    for int8 pages) beforehand."""
    dev = torch.device("cuda")
    b, n_layers, kvh, h, hs, mp, t, rot = 8, 32, 32, 32, 128, 4, 128, 8
    n_pages, s = b * mp + 1, mp * PAGE
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    rng = np.random.default_rng(SEED + 6)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    table = torch.tensor(rng.permutation(np.arange(1, n_pages)).reshape(b, mp), dtype=torch.int32,
                         device=dev)
    pos_l = [0, 1, 127, 128, 255, 300, 450, s - 1]
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    start_l = [0, 128, 256, 384, 0, 128, 256, 384]
    valid_l = [128, 128, 100, 128, 0, 64, 1, 128]
    start = torch.tensor(start_l, dtype=torch.int32, device=dev)
    cvalid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
    live = torch.arange(t, device=dev)[None, :] < cvalid[:, None]
    out: dict[str, dict] = {}
    for int8 in (False, True):
        sfx, label = ("_int8", "int8 pages") if int8 else ("", "bf16 pages")
        shape = (n_layers, kvh, n_pages, PAGE, hs)
        if int8:
            planes = [C.quantize_kv_rows(rnd(*shape)) for _ in range(2)]
            pool = PagedKVCache(planes[0][0], planes[1][0], planes[0][1], planes[1][1])
            del planes
        else:
            pool = PagedKVCache(rnd(*shape), rnd(*shape))
        sc = (pool.k_scale, pool.v_scale)
        row_b = hs * (1 if int8 else 2) + (4 if int8 else 0)  # a cached row and its scale
        tol = (dict(atol=INT8_ATTN_ATOL, rtol=INT8_ATTN_RTOL) if int8
               else dict(atol=ATTN_ATOL, rtol=ATTN_RTOL))

        def gathered(plane, sc_plane, l):
            x = A.gather_pages(plane, table, l)[:, 0]  # (B, KVH, S, HS)
            if sc_plane is None:
                return x
            return dequant_cache(x, A.gather_pages(sc_plane, table, l)[:, 0])

        # K6: decode, the current row folded in last
        q, kc, vc = rnd(b, h, hs), rnd(b, kvh, hs), rnd(b, kvh, hs)
        kf = [torch.cat([gathered(pool.k, pool.k_scale, l), kc[:, :, None]], dim=2)
              for l in range(rot)]
        vf = [torch.cat([gathered(pool.v, pool.v_scale, l), vc[:, :, None]], dim=2)
              for l in range(rot)]
        col = torch.arange(s + 1, device=dev)
        mask = ((col[None, :] < pos[:, None]) | (col[None, :] == s))[:, None, None, :]
        q4 = q[:, :, None, :]
        out["attention_decode_paged" + sfx] = q8_kernel_case(
            "attention_decode_paged" + sfx, f"B 8, H 32, KVH 32, PS 128, HS 128, {label}",
            lambda i: A.attention_decode_paged(q, pool.k, pool.v, table, i % rot, pos, kc, vc, *sc),
            lambda i: A.attention_decode_paged_plain(q, pool.k, pool.v, table, i % rot, pos, kc,
                                                     vc, *sc),
            lambda i: F.scaled_dot_product_attention(q4, kf[i % rot], vf[i % rot], attn_mask=mask),
            2 * b * h * hs * 2 + 2 * b * kvh * hs * 2 + 2 * sum(pos_l) * kvh * row_b + 4 * b
            + 4 * b * mp, 4 * h * hs * sum(p + 1 for p in pos_l), graph=True, **tol)
        del kf, vf

        # K7: a chunk of T 128 over the pages (rows t < valid compared)
        qp = rnd(b, t, h, hs)
        err, ok = attn_check(((A.attention_prefill_paged(qp, pool.k, pool.v, table, l, start,
                                                         cvalid, *sc)[live],
                               A.attention_prefill_paged_plain(qp, pool.k, pool.v, table, l, start,
                                                               cvalid, *sc)[live])
                              for l in (0, 3)), torch.bfloat16, tensor_cores=True)
        ms = cuda_ms(lambda i: A.attention_prefill_paged(qp, pool.k, pool.v, table, i % rot, start,
                                                         cvalid, *sc))
        plain = cuda_ms(lambda i: A.attention_prefill_paged_plain(
            qp, pool.k, pool.v, table, i % rot, start, cvalid, *sc), iters=4, warmup=1)
        kd = [gathered(pool.k, pool.k_scale, l) for l in range(rot)]
        vd = [gathered(pool.v, pool.v_scale, l) for l in range(rot)]
        colp = torch.arange(s, device=dev)
        qpos = start[:, None] + torch.arange(t, device=dev)[None, :]
        pmask = (colp[None, None, :] <= qpos[:, :, None])[:, None]
        qt = qp.transpose(1, 2)
        lib = cuda_ms(lambda i: F.scaled_dot_product_attention(qt, kd[i % rot], vd[i % rot],
                                                               attn_mask=pmask))
        del kd, vd
        bound = bound_ms(2 * sum(valid_l) * h * hs * 2
                         + 2 * sum(st + v for st, v in zip(start_l, valid_l) if v) * kvh * row_b
                         + 12 * b + 4 * b * mp,
                         4 * h * hs * sum(st + j + 1 for st, v in zip(start_l, valid_l)
                                          for j in range(v)), torch.bfloat16)
        print(f"kernel attention_prefill_paged{sfx} [B 8, T 128, H 32, KVH 32, PS 128, HS 128, "
              f"{label}]: max_abs_err {err:.3g} ({TC_ATTN_TOL}) "
              f"{'ok' if ok else 'FAIL'}; ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
              f"bound_ms {bound[0]:.4f} ({bound[1]})", flush=True)
        if not ok:
            raise AssertionError(f"attention_prefill_paged{sfx} disagrees with its plain version")
        out["attention_prefill_paged" + sfx] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                    library_ms=lib, bound=bound)

        # the writers: into two copies of the pool, bit for bit, then timed
        def clone():
            return PagedKVCache(*(None if x is None else x.clone()
                                  for x in (pool.k, pool.v, pool.k_scale, pool.v_scale)))

        def writer_case(name, what, write, plain_write, lib_write, n_bytes):
            c1, c2 = clone(), clone()
            write(c1, 3)
            plain_write(c2, 3)
            torch.cuda.synchronize()
            pairs = [(x, y) for x, y in zip((c1.k, c1.v, c1.k_scale, c1.v_scale),
                                            (c2.k, c2.v, c2.k_scale, c2.v_scale)) if x is not None]
            err = max(max_err(x, y) for x, y in pairs)
            ok = all(torch.equal(x, y) for x, y in pairs)
            del c1, c2, pairs
            ms = cuda_ms(lambda i: write(pool, i % rot), graph=True)
            plain = cuda_ms(lambda i: plain_write(pool, i % rot), iters=4, warmup=1)
            lib = cuda_ms(lambda i: lib_write(pool, i % rot), graph=True)
            bound = bound_ms(n_bytes, 0, torch.int8)
            print(f"kernel {name} [{what}]: max_abs_err {err:.3g} (bit-exact) "
                  f"{'ok' if ok else 'FAIL'}; ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                  f"(index_put_) {lib:.4f} bound_ms {bound[0]:.4f} ({bound[1]})", flush=True)
            if not ok:
                raise AssertionError(f"{name} [{what}] differs from its plain version")
            out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound=bound)

        # library: index_put_ per plane at the rows' pages and offsets; a
        # step's rows (L, B, KVH, ...) land at [l, h, page[b], offset[b]]
        ar = torch.arange(max(n_layers, kvh), device=dev)
        page = table[torch.arange(b, device=dev), (pos // PAGE).long()].long()
        step_idx = (ar[:n_layers, None, None], ar[None, None, :kvh], page[None, :, None],
                    (pos % PAGE).long()[None, :, None])
        cbi, cti = map(list, zip(*[(bb, j) for bb, v in enumerate(valid_l) for j in range(v)]))
        cbt, ctt = torch.tensor(cbi, device=dev), torch.tensor(cti, device=dev)
        cpage = table[cbt, (start[cbt] // PAGE).long()].long()
        chunk_idx = (ar[None, :kvh], cpage[:, None], ctt[:, None])

        # K11 (and K10): one decode step's rows of all layers at the slots' positions
        rows = [rnd(n_layers, b, kvh, hs) for _ in range(2)]
        if int8:
            (kr, ksr), (vr, vsr) = (C.quantize_kv_rows(r) for r in rows)
        else:
            kr, vr = rows
        eb = 1 if int8 else 2
        writer_case("kv_write_rows_paged" + sfx, f"L 32, B 8, KVH 32, HS 128, {label}",
                    lambda c, i: C.kv_write_rows_paged(c, kr, vr, table, pos),
                    lambda c, i: C.kv_write_rows_paged_plain(c, kr, vr, table, pos),
                    lambda c, i: (c.k.index_put_(step_idx, kr), c.v.index_put_(step_idx, vr)),
                    2 * 2 * n_layers * b * kvh * hs * eb + 4 * b + 4 * b * mp)
        if int8:
            writer_case("scale_write_rows_paged", "L 32, B 8, KVH 32",
                        lambda c, i: C.scale_write_rows_paged(c, ksr, vsr, table, pos),
                        lambda c, i: C.scale_write_rows_paged_plain(c, ksr, vsr, table, pos),
                        lambda c, i: (c.k_scale.index_put_(step_idx, ksr),
                                      c.v_scale.index_put_(step_idx, vsr)),
                        2 * 2 * n_layers * b * kvh * 4 + 4 * b + 4 * b * mp)
        # K13 (and K14): one layer's chunk of T 128, a bystander, valid < T
        crows = [rnd(b, t, kvh, hs) for _ in range(2)]
        if int8:
            (ck, cks), (cv, cvs) = (C.quantize_kv_rows(r) for r in crows)
        else:
            ck, cv = crows
        n_rows = sum(valid_l)
        ckg, cvg = ck[cbt, ctt], cv[cbt, ctt]  # (N, KVH, HS): the live rows
        writer_case("kv_write_chunk_paged" + sfx, f"B 8, T 128, KVH 32, HS 128, {label}",
                    lambda c, i: C.kv_write_chunk_paged(c, ck, cv, i, table, start, cvalid),
                    lambda c, i: C.kv_write_chunk_paged_plain(c, ck, cv, i, table, start, cvalid),
                    lambda c, i: (c.k[i].index_put_(chunk_idx, ckg),
                                  c.v[i].index_put_(chunk_idx, cvg)),
                    2 * 2 * n_rows * kvh * hs * eb + 8 * b + 4 * b * mp)
        if int8:
            cksg, cvsg = cks[cbt, ctt], cvs[cbt, ctt]
            writer_case("scale_write_chunk_paged", "B 8, T 128, KVH 32",
                        lambda c, i: C.scale_write_chunk_paged(c, cks, cvs, i, table, start,
                                                               cvalid),
                        lambda c, i: C.scale_write_chunk_paged_plain(c, cks, cvs, i, table, start,
                                                                     cvalid),
                        lambda c, i: (c.k_scale[i].index_put_(chunk_idx, cksg),
                                      c.v_scale[i].index_put_(chunk_idx, cvsg)),
                        2 * 2 * n_rows * kvh * 4 + 8 * b + 4 * b * mp)
        del pool, sc
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8b: the golden fixture on the paged pool


def shared_prefix_requests(path: str) -> None:
    """The gen corpus's prompts behind a shared prefix of 26 tokens (the
    first tinystories prompt: more than one page of 16, each prompt under
    the fixture's 96-token window), as a request file."""
    inp = os.path.join(REPO, "assets", "in")
    prefix = read_inputfile(os.path.join(inp, "tinystories_in_8.txt")).prompts[0] + " "
    prompts = [prefix + p for p in read_inputfile(os.path.join(inp, "gen_in_8.txt")).prompts]
    with open(path, "w") as f:
        f.write(f"{len(prompts)}\n" + "".join(p + "\n" for p in prompts))


def phase_paged_goldens() -> dict[str, dict[str, int]]:
    """The fixture with --paged 16: fp32 byte-identical to assets/out/cpu_f32,
    fp32 --kv int8 and --quant q8 (bf16 and int8 pages) scored against the
    JAX package's paged outputs, no dense-cache kernel launched; then
    --prefix-cache on a shared-prefix request file, byte-identical to
    --paged 16, with prefix hits. Returns each run's launches."""
    launches, outputs = phase_golden_runs(GOLDEN_PAGED_RUNS)
    for c in CORPORA:
        with open(os.path.join(REPO, "assets", "out", "cpu_f32", f"{c}_in_8.out"), "rb") as f:
            if outputs["fp32 --paged 16"][c] != f.read():
                raise AssertionError(f"golden {c} with --paged 16 forked on the card")
    print("golden (fp32 --paged 16): all five corpora byte-identical to assets/out/cpu_f32",
          flush=True)
    for label, counts in launches.items():
        dense = {n: counts[n] + counts.get(f"{n}_int8", 0) for n in NOT_PAGED
                 if counts[n] + counts.get(f"{n}_int8", 0)}
        if dense:
            raise AssertionError(f"dense-cache kernels launched on the paged run {label}: {dense}")
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "shared.txt")
        shared_prefix_requests(inp)
        outs, hits = {}, {}
        for tag, flags in (("paged", []), ("prefix", ["--prefix-cache"])):
            out = os.path.join(tmp, f"{tag}.out")
            err = io.StringIO()
            with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
                rc = port_run.main(["run", os.path.join(GOLDEN, "model.bin"),
                                    "-z", os.path.join(GOLDEN, "tokenizer.bin"), "-m", "test",
                                    "-f", inp, "-o", out, "-b", "4", "-t", "0.0", "--dtype",
                                    "float32", "--paged", "16", *flags, "--device", "cuda"])
            if rc != 0:
                raise AssertionError(f"the shared-prefix run ({tag}) failed (rc {rc})")
            with open(out, "rb") as f:
                outs[tag] = f.read()
            line = [ln for ln in err.getvalue().splitlines() if ln.startswith("prefix cache:")]
            hits[tag] = int(line[0].split()[2]) if line else 0
    print(f"golden (fp32 --paged 16 --prefix-cache) shared-prefix requests: "
          f"byte-identical to --paged 16: {outs['paged'] == outs['prefix']}; prefix hits "
          f"{hits['prefix']} tokens (uncached {hits['paged']})", flush=True)
    if outs["paged"] != outs["prefix"] or hits["prefix"] == 0 or hits["paged"]:
        raise AssertionError("the prefix cache changed the output or never hit")
    return launches


# ---------------------------------------------------------------------------
# phase 8d: the 7B-width prefix-cache serve


def phase_prefix_serve(params) -> None:
    """The phase-5 requests (their prompts cut to half length) behind a
    shared 256-token prefix, Q8 on int8 pages of PAGE rows at batch 8,
    window 512, greedy: served with and without the prefix cache, the same
    generations, and prefix hits."""
    cfg = LLAMA2_7B
    with tempfile.TemporaryDirectory() as tmp:
        tok = llama_sized_tokenizer(tmp, cfg.vocab_size)
    targets = [300, 20, 150, 60, 280, 100, 30, 200, 266, 14, 90, 300, 40, 180, 25, 120]
    prefix = make_prompts(tok, [256])[0]
    prompts = [prefix + " " + p for p in make_prompts(tok, [n // 2 for n in targets])]
    lens = [len(tok.encode(p)) for p in prompts]
    gens, stats = {}, {}
    for cached in (False, True):
        engine = InferenceEngine(cfg, params, tok, batch_size=8, max_seq_len=512, kv_quant=True,
                                 paged=True, page_size=PAGE, prefix_cache=cached)
        req = Requests(prompts=list(prompts), generations=[""] * len(prompts))
        st: dict = {}
        engine.serve(req, steps=512, stats=st,
                     samplers=[Sampler(cfg.vocab_size, temperature=0.0) for _ in prompts])
        torch.cuda.synchronize()
        gens[cached], stats[cached] = req.generations, st
        print(f"7b q8 int8-kv paged {'prefix-cache' if cached else 'uncached'} serve: "
              f"{len(prompts)} requests of {min(lens)}-{max(lens)} prompt tokens behind a shared "
              f"prefix of {len(tok.encode(prefix))}, {st['total_tokens']} tokens in "
              f"{st['elapsed_s']:.3f} s = {st['tok_per_s']:.2f} tok/s; ttft p50 "
              f"{st['ttft_p50_s'] * 1e3:.1f} ms; prefix hits {st['prefix_hit_tokens']} tokens; "
              f"prefill chunks {dict(engine.prefill_chunks)}", flush=True)
        del engine
        gc.collect()
    same = sum(a == b for a, b in zip(gens[False], gens[True]))
    print(f"7b q8 int8-kv paged prefix-cache serve: {same} of {len(prompts)} generations "
          f"byte-identical to the uncached serve", flush=True)
    if same != len(prompts) or stats[True]["prefix_hit_tokens"] == 0:
        raise AssertionError("the prefix cache changed the 7B-width generations or never hit")


# ---------------------------------------------------------------------------
# phase 9: the `a8` modes


@contextlib.contextmanager
def knobs(env: dict):
    """The environment knobs of `env`, set for the block."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def phase_a8_kernels() -> dict[str, dict]:
    """The `a8` kernels of K15 and K17 (Q8_0, group size 64) and of K21 and
    K22 (int4, group size 32) at Llama-2-7B shapes against their plain
    versions, each beside the reshape (dequant) kernel on the same inputs:
    the GEMV at M 8 as CUDA-graph replays (cuBLAS and the reshape kernel
    too): the int8 tensor-core GEMV the wrappers run at these group sizes
    (`..._a8_tc`) and, on the same inputs through ops/quant.py::
    a8_gemv_probe, the dp4a GEMV (the base names); K15's and K17's int8
    wgmma tiles (`..._a8_wgmma`) at
    QKV M 128, 2048 and 4088, wo M 2048 and the gate M 512, 2048 and 4088;
    K21's and K22's (one nibble plane a CTA) at QKV M 256 and 128, wo M 256
    and the gate M 256 and 128: 256 is the most rows `q4_a8_engages` gives
    them at K 4096.
    Library yardstick: cuBLAS `x @ w` on the weight dequantized to bf16, as
    for the reshape products. Bound: the int8 peak for the operations; the
    bytes of the weights and scales, x, the quantized xi (M x K int8) and sx
    (M x K/gs fp32), the norm weight and residual, and the outputs."""
    dev = torch.device("cuda")
    d, hid, voc = 4096, 11008, 32000
    g = torch.Generator(device=dev).manual_seed(SEED + 9)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    out: dict[str, list] = {}
    norm = (1 + 0.1 * rnd(d, dtype=torch.float32)).contiguous()
    rope = dict(rope_limit=2 * d, rope_head=128, rope_theta=10000.0)

    def case(name, label, mod, fn, plain_fn, reshape_fn, lib_fn, w_bytes, m, k, n_out, gs,
             flops, extra=0):
        n_bytes = w_bytes + m * k * 2 + m * k + m * (k // gs) * 4 + m * n_out * 2 + extra
        graph = m <= Q.GEMV_MAX_M
        r = q8_kernel_case(name, label, fn, plain_fn, lib_fn, n_bytes, flops,
                           op_dtype=torch.int8, graph=graph)
        r["reshape_ms"] = cuda_ms(reshape_fn, graph=graph)
        print(f"kernel {name} [{label}]: reshape/dequant kernel ms {r['reshape_ms']:.4f} "
              f"beside the a8 kernel's {r['ms']:.4f}", flush=True)
        out.setdefault(name, []).append(r)

    for mod, gs, name in ((Q, 64, "q8_matmul_a8"), (Q4, 32, "q4_matmul_a8")):
        quantize = Q.q8_quantize_weights if mod is Q else Q4.q4_quantize_weights
        deq = Q.q8_dequantize if mod is Q else Q4.q4_dequantize
        mm = Q.q8_matmul if mod is Q else Q4.q4_matmul
        mm_plain = Q.q8_matmul_plain if mod is Q else Q4.q4_matmul_plain
        wb = (lambda k, n: k * n + (k // gs) * n * 4) if mod is Q else (
            lambda k, n: (k // 2) * n + (k // gs) * n * 4)

        def weights(k, n, copies):
            return [quantize(rnd(k, n, dtype=torch.float32).mul_(k ** -0.5), gs)
                    for _ in range(copies)]

        def tile(base, m):  # the kernels-line name of an M-row case
            return base + {"wgmma": "_wgmma", "gemv_tc": "_tc"}.get(Q.a8_rows_kernel(m, gs), "")

        # the kernels line carries each name's first case: M 2048 for the Q8
        # tiles, M 256 for the int4 tiles
        shapes = [("QKV", (8,), d, 3 * d, 2), ("wo", (8,), d, d, 4),
                  ("classifier", (8,), d, voc, 1)]
        if mod is Q:
            shapes += [("QKV", (2048, 128, 4088), d, 3 * d, 2), ("wo", (2048,), d, d, 2)]
        else:
            shapes += [("QKV", (256, 128), d, 3 * d, 2), ("wo", (256,), d, d, 2)]
        for what, ms, k, n, copies in shapes:
            w = weights(k, n, copies)
            wd = [deq(x).to(torch.bfloat16) for x in w]
            for m in ms:
                x = rnd(m, k)
                if what == "QKV":
                    pos = (torch.tensor([0, 1, 100, 255, 256, 300, 450, 511], dtype=torch.int32,
                                        device=dev) if m == 8
                           else torch.arange(m, dtype=torch.int32, device=dev) % 512)
                    kw, extra, label = (dict(norm_weight=norm, rope_pos=pos, **rope),
                                        k * 4 + m * 4, f"QKV M {m}, norm + RoPE")
                elif what == "wo":
                    kw, extra, label = dict(residual=rnd(m, n)), m * n * 2, f"wo M {m}, residual"
                else:
                    kw, extra, label = dict(norm_weight=norm), k * 4, f"classifier M {m}, norm"
                run = [("", lambda i, w=w, x=x, kw=kw: mm(x, w[i % copies], mode="a8", **kw))]
                if m <= Q.GEMV_MAX_M:  # the dp4a GEMV on the same inputs
                    run.append((", dp4a", lambda i, w=w, x=x, kw=kw: Q.a8_gemv_probe(
                        x, w[i % copies], False, 1, **kw)))
                for suffix, fn in run:
                    case(tile(name, m) if not suffix else name, label + suffix, mod, fn,
                         lambda i, w=w, x=x, kw=kw: mm_plain(x, w[i % copies], mode="a8", **kw),
                         lambda i, w=w, x=x, kw=kw: mm(x, w[i % copies], **kw),
                         lambda i, wd=wd, x=x: x @ wd[i % copies],
                         wb(k, n), m, k, n, gs, 2 * m * k * n, extra)
                del x
            del w, wd
        silu, silu_plain = ((Q.q8_matmul_silu, Q.q8_matmul_silu_plain) if mod is Q
                            else (Q4.q4_matmul_silu, Q4.q4_matmul_silu_plain))
        w13 = weights(d, 2 * hid, 2)
        w13d = [deq(x).to(torch.bfloat16) for x in w13]
        for m in (8, 2048, 512, 4088) if mod is Q else (8, 256, 128):
            x = rnd(m, d)
            gname = name.replace("matmul", "matmul_silu")
            run = [("", lambda i, x=x: silu(x, w13[i % 2], norm_weight=norm, mode="a8"))]
            if m <= Q.GEMV_MAX_M:  # the dp4a GEMV on the same inputs
                run.append((", dp4a", lambda i, x=x: Q.a8_gemv_probe(x, w13[i % 2], True, 1,
                                                                     norm_weight=norm)))
            for suffix, fn in run:
                case(tile(gname, m) if not suffix else gname, f"W1|W3 gate M {m}, norm{suffix}",
                     mod, fn, lambda i, x=x: silu_plain(x, w13[i % 2], norm_weight=norm, mode="a8"),
                     lambda i, x=x: silu(x, w13[i % 2], norm_weight=norm),
                     lambda i, x=x: x @ w13d[i % 2],
                     wb(d, 2 * hid), m, d, hid, gs, 2 * m * d * 2 * hid, d * 4)
            del x
        del w13, w13d
    probe_a8_tiles()
    probe_a8_gemv()
    # the kernels line carries each kernel's first case; max_abs_err over all
    return {name: dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
            for name, rs in out.items()}


def probe_a8_tiles() -> None:
    """The `a8` tile kernels, the int8 wgmma tiles against a8.cuh's mma.sync
    tiles on the same quantized rows, whose outputs they must equal bit for
    bit: Q8_0 (ops/quant.py::q8_a8_tiles_probe: the tiles alone, no
    quantizer pass, no epilogue) at QKV and the W1|W3 gate, M 2048, group
    size 64; int4 (ops/quant4.py::q4_a8_tiles_probe: the quantizer pass,
    the tiles and, for the wgmma tiles, the pass that adds the nibble
    planes, with each product's epilogue) at QKV with the norm and RoPE, wo
    with the residual and the gate with the norm at M 256, and W2 with the
    residual at M 64 (K 11008), group size 32. Each kernel's time beside."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    d, hid, m, gs = 4096, 11008, 2048, 64
    names = {0: "wgmma", 1: "mma.sync"}

    def check(what, run):
        outs = {v: run(0, v) for v in names}
        torch.cuda.synchronize()
        equal = torch.equal(outs[0], outs[1])
        times = [f"{name} {cuda_ms(lambda i, v=v: run(i, v)):.4f}" for v, name in names.items()]
        print(f"probe a8 tiles [{what}] ms: {'; '.join(times)}; outputs equal to "
              f"mma.sync's: {equal}", flush=True)
        if not equal:
            raise AssertionError(f"a8 wgmma tiles differ from the mma.sync tiles ({what})")

    for what, n, gate in (("QKV", 3 * d, False), ("W1|W3 gate", 2 * hid, True)):
        w = [Q.q8_quantize_weights(torch.randn((d, n), generator=g, device=dev)
                                   .mul_(d ** -0.5), gs) for _ in range(2)]
        xi, sx = Q.a8_quantize_rows(torch.randn((m, d), generator=g, device=dev)
                                    .to(torch.bfloat16).float(), gs)
        xi = xi.to(torch.int8).contiguous()
        check(f"{what} M {m}",
              lambda i, v, w=w, xi=xi, sx=sx, gate=gate: Q.q8_a8_tiles_probe(
                  xi, sx, w[i % 2], gate, v))
        del w
    norm = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).contiguous()
    for what, m, k, n, gate in (("QKV", 256, d, 3 * d, False), ("wo", 256, d, d, False),
                                ("W1|W3 gate", 256, d, 2 * hid, True),
                                ("W2", 64, hid, d, False)):
        w = [Q4.q4_quantize_weights(torch.randn((k, n), generator=g, device=dev)
                                    .mul_(k ** -0.5), 32) for _ in range(2)]
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        if what == "QKV":
            kw = dict(norm_weight=norm, rope_pos=torch.arange(m, dtype=torch.int32, device=dev),
                      rope_limit=2 * d, rope_head=128)
        elif gate:
            kw = dict(norm_weight=norm)
        else:
            kw = dict(residual=torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16))
        check(f"int4 {what} M {m}",
              lambda i, v, w=w, x=x, kw=kw, gate=gate: Q4.q4_a8_tiles_probe(
                  x, w[i % 2], gate, v, **kw))
        del w


def probe_a8_gemv() -> None:
    """The `a8` GEMVs, the int8 tensor-core GEMV against a8.cuh's dp4a GEMV
    (ops/quant.py::a8_gemv_probe: the same quantizer pass before either,
    the same split pass after), whose outputs it must equal bit for bit:
    Q8_0 at group size 64 and int4 at 32, QKV with the norm and RoPE, wo
    with the residual, the W1|W3 gate with the norm and W2 with the
    residual (K 11008), at M 8 and 16. Each GEMV's time beside, as CUDA-graph
    replays."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    d, hid = 4096, 11008
    norm = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).contiguous()
    names = {0: "tensor cores", 1: "dp4a"}
    for int4, gs in ((False, 64), (True, 32)):
        quantize = Q4.q4_quantize_weights if int4 else Q.q8_quantize_weights
        for what, k, n, gate in (("QKV", d, 3 * d, False), ("wo", d, d, False),
                                 ("W1|W3 gate", d, 2 * hid, True), ("W2", hid, d, False)):
            w = [quantize(torch.randn((k, n), generator=g, device=dev).mul_(k ** -0.5), gs)
                 for _ in range(2)]
            for m in (8, 16):
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                if what == "QKV":
                    kw = dict(norm_weight=norm, rope_limit=2 * d, rope_head=128,
                              rope_pos=torch.arange(m, dtype=torch.int32, device=dev) * 37 % 512)
                elif gate:
                    kw = dict(norm_weight=norm)
                else:
                    kw = dict(residual=torch.randn((m, n), generator=g, device=dev)
                              .to(torch.bfloat16))
                outs = {v: Q.a8_gemv_probe(x, w[0], gate, v, **kw) for v in names}
                torch.cuda.synchronize()
                equal = torch.equal(outs[0], outs[1])
                times = [f"{nm} {cuda_ms(lambda i, v=v: Q.a8_gemv_probe(x, w[i % 2], gate, v, **kw), graph=True):.4f}"
                         for v, nm in names.items()]
                label = f"{'int4' if int4 else 'Q8'} {what} M {m}"
                print(f"probe a8 gemv [{label}] ms: {'; '.join(times)}; outputs equal to "
                      f"dp4a's: {equal}", flush=True)
                if not equal:
                    raise AssertionError(f"the a8 tensor-core GEMV differs from dp4a ({label})")
            del w


def profile_q4_a8_chunks(params: QuantLlamaParams) -> None:
    """Two T-16 and T-32 prefill chunks of the 7B-width int4 params over 8
    slots in `a8` (HIPLLAMA_Q4_MODE=a8; 128 and 256 rows: the most that
    `q4_a8_engages` gives QKV, wo and the gate at K 4096, whose int4 `a8`
    wgmma tiles they run; W2 at K 11008 keeps dequant math above 95 rows),
    profiled; the engine's buckets set to (16, 32) for the T-32 chunk."""
    cfg = LLAMA2_7B
    toks = np.random.default_rng(SEED).integers(3, cfg.vocab_size, (8, 32)).tolist()
    with knobs({"HIPLLAMA_Q4_MODE": "a8"}):
        engine = InferenceEngine(cfg, params, None, batch_size=8, max_seq_len=512)
        engine.prefill_buckets = (16, 32)
        cache = engine.new_cache()
        for t in (16, 32):
            before = launch_counts()
            profile_window(f"7b q4 a8 prefill chunk (batch 8, T {t})", 2,
                           lambda i, t=t: engine._prefill_tokens(
                               cache, 8, {s: toks[s][:t] for s in range(8)},
                               {s: 0 for s in range(8)}, bm=None))
            after = launch_counts()
            tiles = {n: after[n] - before[n] for n in ("q4_matmul_a8_wgmma",
                                                      "q4_matmul_silu_a8_wgmma")}
            print(f"7b q4 a8 prefill chunk (batch 8, T {t}): int4 a8 wgmma tile launches over "
                  f"the 3 chunks {tiles}", flush=True)
            if not all(tiles.values()):
                raise AssertionError(f"the int4 a8 T-{t} chunk ran no int4 a8 wgmma tiles")
    del engine, cache


def phase_a8_goldens() -> dict[str, dict[str, int]]:
    """The fixture in each `a8` mode, scored against the JAX package's
    outputs made with the same knobs; `a8` kernels launched, q8_layer_fused
    never (its math is reshape's)."""
    launches = {}
    for kind, runs in GOLDEN_A8_RUNS.items():
        with knobs(A8_KNOBS[kind]):
            launches.update(phase_golden_runs(runs)[0])
    for label, counts in launches.items():
        fused = counts["q8_layer_fused"] + counts["q8_layer_fused_int8"]
        if fused:
            raise AssertionError(f"q8_layer_fused launched {fused} times under a8 ({label})")
    return launches


# ---------------------------------------------------------------------------
# phase 10: --layout stacked and the four-write KV commit


def phase_stacked_kernels(params: QuantLlamaParams) -> dict[str, dict]:
    """K20 in reshape and `a8` on the last layer of the 7B-width stacked
    weights of `params` (batch 8; the timed calls walk the layers down from
    the last, so each finds its layer cold in L2), against their plain
    versions, each beside K15 on the layer's view (the same device code on
    the same addresses), in turns. A decode product's device time is below
    its wrapper's host time, so the kernels and the library call are timed
    as a CUDA graph's replay. Library yardstick: cuBLAS `x @ w` on the
    layer dequantized to bf16. Bound: the weight, scale, activation, norm,
    residual and output bytes once each (and for `a8` the quantized xi and
    sx), or the operations at the bf16 (reshape) or int8 (`a8`) peak."""
    dev = torch.device("cuda")
    c = LLAMA2_7B
    n_layers, d, kvd, gs, m = c.n_layers, c.dim, c.kv_dim, 64, 8
    last = n_layers - 1
    g = torch.Generator(device=dev).manual_seed(SEED + 10)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

    pos = torch.tensor([0, 1, 100, 255, 256, 300, 450, 511], dtype=torch.int32, device=dev)
    rope = dict(rope_pos=pos, rope_limit=d + kvd, rope_head=c.head_size, rope_theta=c.rope_theta)
    res = rnd(m, d)
    # (label, stacked weight, stacked norm weight, other kwargs, extra bytes)
    cases = [("QKV M 8, norm + RoPE", params.wq, params.rms_att, rope, d * 4 + m * 4),
             ("wo M 8, residual", params.wo, None, dict(residual=res), m * d * 2),
             ("W1|W3 M 8, norm", params.w1, params.rms_ffn, {}, d * 4),
             ("W2 M 8, residual", params.w2, None, dict(residual=res), m * d * 2)]
    out: dict[str, list] = {}
    for mode, name in (("reshape", "q8_matmul_layered"), ("a8", "q8_matmul_layered_a8")):
        for label, w, norm, kw, extra in cases:
            _, k, n = w.q.shape
            if mode == "a8" and not Q.q8_layered_a8_engages(m, k, n, gs):
                raise AssertionError(f"K20 keeps reshape math at {label}")
            x = rnd(m, k)
            wd = [Q.q8_dequantize(Q.layer_of(w, l)).to(torch.bfloat16) for l in (last, last - 1)]

            def layer(i):
                return (last - i) % n_layers

            def k15(i, w=w, norm=norm, kw=kw, x=x, mode=mode):
                l = layer(i)
                return Q.q8_matmul(x, Q.layer_of(w, l), mode=mode, **kw,
                                   norm_weight=None if norm is None else norm[l])

            n_bytes = k * n + (k // gs) * n * 4 + m * k * 2 + m * n * 2 + extra
            if mode == "a8":
                n_bytes += m * k + m * (k // gs) * 4
            r = q8_kernel_case(
                name, label,
                lambda i, w=w, norm=norm, kw=kw, x=x, mode=mode: Q.q8_matmul_layered(
                    x, w, layer(i), norm_weight=norm, mode=mode, **kw),
                lambda i, w=w, norm=norm, kw=kw, x=x, mode=mode: Q.q8_matmul_layered_plain(
                    x, w, layer(i), norm_weight=norm, mode=mode, **kw),
                lambda i, x=x, wd=wd: x @ wd[i % 2], n_bytes, 2 * m * k * n,
                op_dtype=torch.int8 if mode == "a8" else torch.bfloat16, graph=True)
            # in turns, K20 (timed above), K15, K15, K20: one ordering
            # effect on both sides
            k15_ms = (cuda_ms(k15, graph=True), cuda_ms(k15, graph=True))
            k20_ms = (r["ms"], cuda_ms(lambda i, w=w, norm=norm, kw=kw, x=x, mode=mode:
                                       Q.q8_matmul_layered(x, w, layer(i), norm_weight=norm,
                                                           mode=mode, **kw), graph=True))
            r["ms"], r["k15_ms"] = sum(k20_ms) / 2, sum(k15_ms) / 2
            print(f"kernel {name} [{label}]: in turns, K20 ms {k20_ms[0]:.4f} and "
                  f"{k20_ms[1]:.4f} (mean {r['ms']:.4f}), K15 on the layer's view ms "
                  f"{k15_ms[0]:.4f} and {k15_ms[1]:.4f} (mean {r['k15_ms']:.4f})", flush=True)
            out.setdefault(name, []).append(r)
            del wd
    return {name: dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
            for name, rs in out.items()}


def phase_kv_commit_kernels() -> dict[str, dict]:
    """K8 kv_write_rows on a bf16 and an int8 plane and K9 scale_write_rows
    at 7B shapes (B 8, L 32, KVH 32, S 512, HS 128), bit-exact against their
    plain versions with and without a valid mask and with positions -1 and
    S (which write nothing), then timed at ragged positions inside the
    cache; library: one index_put_ making the same write. Bound: the rows
    read once and written once, and the positions."""
    dev = torch.device("cuda")
    b, n_layers, kvh, s, hs = 8, 32, 32, 512, 128
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    pos = torch.tensor([0, 1, 100, 255, 256, 300, 450, s - 1], dtype=torch.int32, device=dev)
    edge = torch.tensor([-1, s, 100, 255, 256, 300, 450, s - 1], dtype=torch.int32, device=dev)
    valid = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.int32, device=dev)
    idx = (torch.arange(b, device=dev)[:, None, None],
           torch.arange(n_layers, device=dev)[None, :, None],
           torch.arange(kvh, device=dev)[None, None, :], pos.long()[:, None, None])
    out = {}

    def case(name, plane, rows, write, plain, vals, with_valid):
        err = 0.0
        for p, v in ((pos, None), (edge, None)) + (((pos, valid),) if with_valid else ()):
            args = (p, v) if with_valid else (p,)
            a, w = write(plane.clone(), rows, *args), plain(plane.clone(), rows, *args)
            torch.cuda.synchronize()
            if not torch.equal(a, w):
                raise AssertionError(f"{name} differs from its plain version")
            err = max(err, max_err(a, w))
        ms = cuda_ms(lambda i: write(plane, rows, pos), graph=True)
        plain_ms = cuda_ms(lambda i: plain(plane, rows, pos))
        lib = cuda_ms(lambda i: plane.index_put_(idx, vals), graph=True)
        n_bytes = 2 * rows.numel() * rows.element_size() + 4 * b
        bound = bound_ms(n_bytes, 0, torch.bfloat16)
        print(f"kernel {name}: max_abs_err {err:.3g} (bit-exact) ok; ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms (index_put_) {lib:.4f} bound_ms {bound[0]:.5f} "
              f"({bound[1]})", flush=True)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib, bound=bound)

    plane = torch.randn((b, n_layers, kvh, s, hs), generator=g, device=dev, dtype=torch.bfloat16)
    rows = torch.randn((n_layers, b, kvh, hs), generator=g, device=dev, dtype=torch.bfloat16)
    case("kv_write_rows", plane, rows, C.kv_write_rows, C.kv_write_rows_plain,
         rows.permute(1, 0, 2, 3), True)
    del plane
    plane = torch.randint(-127, 128, (b, n_layers, kvh, s, hs), generator=g, device=dev,
                          dtype=torch.int8)
    rows = torch.randint(-127, 128, (n_layers, b, kvh, hs), generator=g, device=dev,
                         dtype=torch.int8)
    case("kv_write_rows_int8", plane, rows, C.kv_write_rows, C.kv_write_rows_plain,
         rows.permute(1, 0, 2, 3), True)
    del plane
    sc = torch.rand((b, n_layers, kvh, s), generator=g, device=dev)
    srows = torch.rand((n_layers, b, kvh), generator=g, device=dev)
    case("scale_write_rows", sc, srows, C.scale_write_rows, C.scale_write_rows_plain,
         srows.permute(1, 0, 2), False)
    return out


def probe_kv_direct() -> None:
    """The question of tools/kv_direct_probe.py (:75), answered on the card
    by K8: each slot of an int8 and a bf16 cache (B 4, L 3, KVH 8, S 256,
    HS 128, as the probe) takes a row at every position 0..S-1 through one
    kv_write_rows launch per position, stored directly (the kernel has no
    window and never reads the cache), and the cache ends bit-exact against
    the plain version's, every row written once."""
    dev = torch.device("cuda")
    b, nl, kvh, s, hs = 4, 3, 8, 256, 128
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    for dtype in (torch.int8, torch.bfloat16):
        if dtype == torch.int8:
            plane = torch.randint(-100, 100, (b, nl, kvh, s, hs), generator=g, device=dev,
                                  dtype=dtype)
            rows = torch.randint(-100, 100, (s, nl, b, kvh, hs), generator=g, device=dev,
                                 dtype=dtype)
        else:
            plane = torch.randn((b, nl, kvh, s, hs), generator=g, device=dev, dtype=dtype)
            rows = torch.randn((s, nl, b, kvh, hs), generator=g, device=dev, dtype=dtype)
        want = plane.clone()
        for p in range(s):
            pos = torch.tensor([(p + 37 * i) % s for i in range(b)], dtype=torch.int32,
                               device=dev)
            C.kv_write_rows(plane, rows[p], pos)
            C.kv_write_rows_plain(want, rows[p], pos)
        torch.cuda.synchronize()
        ok = torch.equal(plane, want)
        every = all(torch.equal(plane[i, :, :, (p + 37 * i) % s], rows[p, :, i])
                    for i in range(b) for p in range(0, s, 17))
        print(f"probe kv_direct (tools/kv_direct_probe.py:75, ported as K8) {str(dtype)[6:]}: "
              f"rows written at every position 0..{s - 1} of {b} slots, one direct store "
              f"each, no window read; bit-exact {ok}, sampled rows in place {every}", flush=True)
        if not (ok and every):
            raise AssertionError(f"kv_write_rows misplaced a row ({dtype})")


def phase_stacked_goldens() -> dict[str, dict[str, int]]:
    """The fixture with --layout stacked (Q8 on both caches, and `a8` with
    block_n 64, as the JAX goldens were made), scored against the JAX
    package's stacked outputs, K20 launched and K23 and K5 never; then under
    HIPLLAMA_KV_COMMIT=0 the fp32 fixture, byte-identical to cpu_f32, and Q8
    --kv int8, byte-identical to its run with the default commit, K8 and
    K9 launched and K2 never."""
    launches = phase_golden_runs(GOLDEN_STACKED_RUNS)[0]
    with knobs(A8_KNOBS["q8"]):
        launches.update(phase_golden_runs(GOLDEN_STACKED_A8_RUNS)[0])
    for label, counts in launches.items():
        bad = {n: counts[n] for n in NOT_STACKED if counts[n]}
        if bad:
            raise AssertionError(f"kernels of the unrolled layer launched on {label}: {bad}")
    with knobs({"HIPLLAMA_KV_COMMIT": "0"}):
        l4, o4 = phase_golden_runs(GOLDEN_KV_COMMIT_RUNS)
    label = "q8 --kv int8, fused layer"
    o2 = phase_golden_runs({label: GOLDEN_INT8_RUNS[label]})[1]
    for c in CORPORA:
        with open(os.path.join(REPO, "assets", "out", "cpu_f32", f"{c}_in_8.out"), "rb") as f:
            if o4["fp32, four-write commit"][c] != f.read():
                raise AssertionError(f"fp32 with the four-write commit forked on {c}")
        if o4["q8 --kv int8, four-write commit"][c] != o2[label][c]:
            raise AssertionError(f"q8 --kv int8: the four-write commit's {c} output differs "
                                 "from the default commit's")
    print("golden (four-write commit): fp32 byte-identical to assets/out/cpu_f32; q8 --kv int8 "
          "byte-identical to the default commit's outputs", flush=True)
    for label, counts in l4.items():
        k2 = counts["kv_commit_rows"] + counts["kv_commit_rows_int8"]
        if k2:
            raise AssertionError(f"kv_commit_rows launched {k2} times under "
                                 f"HIPLLAMA_KV_COMMIT=0 ({label})")
    launches.update(l4)
    return launches


# ---------------------------------------------------------------------------
# phase 11: the prefill variants (K19, K16)


def phase_prefill_kernels() -> dict[str, dict]:
    """K19, K19 silu and K16 at Llama-2-7B prefill shapes (Q8_0, group size
    64, bf16 activations) against their plain versions, each beside the
    reshape tile it replaces (K15, K17) on the same inputs. Library
    yardstick: cuBLAS `x @ w` on the weight dequantized to bf16 beforehand.
    Bound: int8 weights and fp32 scales, x, the norm weight, residual and
    positions, and the output once each, or the operations at the bf16 peak."""
    dev = torch.device("cuda")
    d, hid, gs = 4096, 11008, 64
    g = torch.Generator(device=dev).manual_seed(SEED + 13)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    def weights(k, n):
        w = [Q.q8_quantize_weights(rnd(k, n, dtype=torch.float32).mul_(k ** -0.5), gs)
             for _ in range(2)]
        return w, [Q.q8_dequantize(x).to(torch.bfloat16) for x in w]

    def wbytes(k, n):
        return k * n + (k // gs) * n * 4

    norm = (1 + 0.1 * rnd(d, dtype=torch.float32)).contiguous()
    out: dict[str, list] = {}

    def case(name, label, fn, plain_fn, tile_fn, lib_fn, n_bytes, flops, plan=None):
        if plan is not None:  # K19's (m, n, gate): its launch plan, as prefill.cu builds it
            p = Q.minner_launch_plan(*plan)
            label = (f"{label}; grid {p['grid'][0]} x {p['grid'][1]} of {p['tile'][0]} x "
                     f"{p['tile'][1]} tiles, blockIdx.x over {p['x_over']}, no cluster")
        r = q8_kernel_case(name, label, fn, plain_fn, lib_fn, n_bytes, flops)
        r["tile_ms"] = cuda_ms(tile_fn)
        print(f"kernel {name} [{label}]: the K15/K17 tile on the same inputs ms "
              f"{r['tile_ms']:.4f} beside its {r['ms']:.4f} ({r['ms'] / r['tile_ms']:.3f}x)",
              flush=True)
        out.setdefault(name, []).append(r)

    m = 2048
    wo, wod = weights(d, d)
    x, res = rnd(m, d), rnd(m, d)
    case("q8_matmul_minner", f"wo M {m}, residual",
         lambda i: Q.q8_matmul_minner(x, wo[i % 2], residual=res),
         lambda i: Q.q8_matmul_minner_plain(x, wo[i % 2], residual=res),
         lambda i: Q.q8_matmul(x, wo[i % 2], residual=res), lambda i: x @ wod[i % 2],
         wbytes(d, d) + 3 * m * d * 2, 2 * m * d * d, plan=(m, d, False))
    x3 = x.view(m, 32, 128)
    case("q8_matmul_xheads", f"wo M {m}, 32 heads of 128, residual",
         lambda i: Q.q8_matmul_xheads(x3, wo[i % 2], residual=res),
         lambda i: Q.q8_matmul_xheads_plain(x3, wo[i % 2], residual=res),
         lambda i: Q.q8_matmul(x, wo[i % 2], residual=res), lambda i: x @ wod[i % 2],
         wbytes(d, d) + 3 * m * d * 2, 2 * m * d * d)
    mq = 1024  # the paged prefill's q product: T 128 x 8 slots
    xq = rnd(mq, d)
    pos = torch.arange(mq, dtype=torch.int32, device=dev) % 512
    rope = dict(rope_pos=pos, rope_limit=d, rope_head=128, rope_theta=10000.0)
    case("q8_matmul_minner", f"q M {mq}, norm + RoPE",
         lambda i: Q.q8_matmul_minner(xq, wo[i % 2], norm_weight=norm, **rope),
         lambda i: Q.q8_matmul_minner_plain(xq, wo[i % 2], norm_weight=norm, **rope),
         lambda i: Q.q8_matmul(xq, wo[i % 2], norm_weight=norm, **rope),
         lambda i: xq @ wod[i % 2], wbytes(d, d) + 2 * mq * d * 2 + d * 4 + mq * 4,
         2 * mq * d * d, plan=(mq, d, False))
    del wo, wod
    w2, w2d = weights(hid, d)
    xh = rnd(m, hid)
    case("q8_matmul_minner", f"W2 M {m}, K {hid}, residual",
         lambda i: Q.q8_matmul_minner(xh, w2[i % 2], residual=res),
         lambda i: Q.q8_matmul_minner_plain(xh, w2[i % 2], residual=res),
         lambda i: Q.q8_matmul(xh, w2[i % 2], residual=res), lambda i: xh @ w2d[i % 2],
         wbytes(hid, d) + m * hid * 2 + 2 * m * d * 2, 2 * m * hid * d, plan=(m, d, False))
    del w2, w2d, xh
    w13, w13d = weights(d, 2 * hid)
    case("q8_matmul_silu_minner", f"W1|W3 gate M {m}, norm",
         lambda i: Q.q8_matmul_silu_minner(x, w13[i % 2], norm_weight=norm),
         lambda i: Q.q8_matmul_silu_minner_plain(x, w13[i % 2], norm_weight=norm),
         lambda i: Q.q8_matmul_silu(x, w13[i % 2], norm_weight=norm), lambda i: x @ w13d[i % 2],
         wbytes(d, 2 * hid) + m * d * 2 + m * hid * 2 + d * 4, 2 * m * d * 2 * hid,
         plan=(m, hid, True))
    del w13, w13d
    return {name: dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
            for name, rs in out.items()}


def probe_xheads() -> None:
    """The questions of tools/probe_xheads.py, answered on the card: a
    head-split (M, GH, HS) tile contracts without a relayout as per-head
    partials (`unroll`, :47: K16) or as one product over the flat view of
    the same memory (`multi`: K15), each against the probe's fp32 product
    of the same bf16 rows and bf16 weights (:51-57), at its shapes (m 256,
    gh 8, hs 128, bn 512); and attention takes T-major q (`battn`,
    `headslice`, :89): K4 reads q (B, T, H, HS) as it lies, against its
    plain version, at (bt 256, gh 8, hs 128) over a 512-row cache."""
    dev = torch.device("cuda")
    m, gh, hs, bn = 256, 8, 128, 512
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    x3 = torch.randn((m, gh, hs), generator=g, device=dev).to(torch.bfloat16)
    w = Q.q8_quantize_weights(torch.randn((gh * hs, bn), generator=g, device=dev) * 0.05, 64)
    want = x3.reshape(m, gh * hs).float() @ Q.q8_dequantize(w).to(torch.bfloat16).float()
    for variant, got in (("unroll (K16)", Q.q8_matmul_xheads(x3, w)),
                         ("multi (K15 on the flat view)", Q.q8_matmul(x3.view(m, gh * hs), w))):
        torch.cuda.synchronize()
        d = max_err(got, want)
        rel = d / want.abs().max().item()
        print(f"probe xheads (tools/probe_xheads.py:47) {variant}: max abs {d:.4f} rel "
              f"{rel:.4f} against the fp32 product (the bf16 output's rounding)", flush=True)
        if not rel < 2.0 ** -7:
            raise AssertionError(f"probe xheads {variant}: rel {rel}")
    s = 512
    q = torch.randn((1, m, gh, hs), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, 1, gh, s, hs), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    start = torch.tensor([s - m], dtype=torch.int32, device=dev)
    valid = torch.tensor([m], dtype=torch.int32, device=dev)
    err, ok = attn_check([(A.attention_prefill(q, k, v, 0, start, valid),
                           A.attention_prefill_plain(q, k, v, 0, start, valid))], torch.bfloat16,
                         tensor_cores=True)
    print(f"probe xheads (tools/probe_xheads.py:89) battn/headslice: K4 reads T-major q "
          f"(1, {m}, {gh}, {hs}) in place over {s} rows: max_abs_err vs plain {err:.3g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("K4 on T-major q disagrees with its plain version")


def profile_prefill_knobs(params: QuantLlamaParams) -> None:
    """Two T-256 prefill chunks (8 slots, 2048 rows, every row valid) of the
    7B-width Q8 + int8-KV model on the default route and under each prefill
    knob: the wrapper launches of one chunk and the device time by kernel."""
    cfg = LLAMA2_7B
    rng = np.random.default_rng(SEED)
    chunk = {s: rng.integers(3, cfg.vocab_size, 256).tolist() for s in range(8)}
    device_ms = {}
    for env in ({}, {"HIPLLAMA_PREFILL_MINNER": "1"}, {"HIPLLAMA_PREFILL_XHEADS": "1"}):
        with knobs(env):
            engine = InferenceEngine(cfg, params, None, batch_size=8, max_seq_len=512,
                                     kv_quant=True)
        cache = engine.new_cache()
        before = launch_counts()
        engine._prefill_tokens(cache, 8, chunk, {s: 0 for s in range(8)})
        torch.cuda.synchronize()
        counts = {n: c - before[n] for n, c in launch_counts().items() if c > before[n]}
        print(f"prefill chunk (T 256, 8 slots) with {env}: wrapper launches {counts}",
              flush=True)
        device_ms[" ".join(env) or "default route"] = profile_window(
            f"7b q8 int8-kv prefill chunk with {env} (batch 8, T 256)", 2,
            lambda i: engine._prefill_tokens(cache, 8, chunk, {s: 0 for s in range(8)}))
        del engine, cache
        gc.collect()
        torch.cuda.empty_cache()
    print("prefill chunk (T 256, 8 slots) device time: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in device_ms.items()), flush=True)


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


# a fork of the fixture's Q8 (or int4) serve from the JAX package's outputs
# must be a near-tie (ROADMAP.md section 3): the card's engine and the port's plain
# path on the CPU (which tests/test_torch_kv_int8_model.py::
# test_q8_int8_serve_forks_from_jax_only_at_near_ties holds to the JAX
# engine up to near-ties) serve each corpus side by side, greedy at -b 4; a
# slot's logits agree within Q8_FORK_TOL until its first fork, where the
# CPU's top-2 gap is at most NEAR_TIE
NEAR_TIE = 0.1
Q8_FORK_TOL = (0.15, 0.05)


def host_logits(logits) -> np.ndarray:
    return (logits.float().cpu().numpy() if isinstance(logits, torch.Tensor)
            else np.asarray(logits, np.float32))


def golden_forks_at_near_ties(kv_quant: bool, int4: bool = False) -> None:
    cfg, w = load_checkpoint(os.path.join(GOLDEN, "model.bin"))
    tok = Tokenizer.from_file(os.path.join(GOLDEN, "tokenizer.bin"), cfg.vocab_size)
    quantize = quantize_params_q4 if int4 else quantize_params_q8
    params = {d: quantize(cfg, w, device=torch.device(d)) for d in ("cuda", "cpu")}
    gaps, compared = [], 0
    for c in CORPORA:
        prompts = read_inputfile(os.path.join(REPO, "assets", "in", f"{c}_in_8.txt")).prompts
        log: dict[str, list] = {}
        for d, p in params.items():
            eng = InferenceEngine(cfg, p, tok, batch_size=4, kv_quant=kv_quant)
            log[d] = []
            step, prefill = eng._do_step, eng._prefill_tokens

            def logged_step(cache, tokens, pos, *a, _step=step, _log=log[d], **kw):
                logits, cache = _step(cache, tokens, pos, *a, **kw)
                _log.append(((np.asarray(tokens).tolist(), np.asarray(pos).tolist()),
                             host_logits(logits)))
                return logits, cache

            def logged_prefill(cache, batch, slot_tokens, slot_start, *a, _pf=prefill,
                               _log=log[d], **kw):
                logits, cache = _pf(cache, batch, slot_tokens, slot_start, *a, **kw)
                if logits is not None:
                    _log.append(((sorted(slot_tokens.items()), sorted(slot_start.items())),
                                 host_logits(logits)))
                return logits, cache

            eng._do_step, eng._prefill_tokens = logged_step, logged_prefill
            eng.serve(Requests(prompts=list(prompts), generations=[""] * len(prompts)),
                      steps=cfg.seq_len,
                      samplers=[Sampler(cfg.vocab_size, temperature=0.0) for _ in prompts])
        # slot by slot while both engines feed it the same input; a slot
        # leaves the comparison at its first fork, and it ends where the
        # schedules part
        forked: set = set()
        for (cin, cl), (pin, pl) in zip(log["cuda"], log["cpu"]):
            if len(cin) != len(pin) or len(cin[0]) != len(pin[0]) or cl.shape != pl.shape:
                break
            if isinstance(cin[0][0], tuple):  # a prefill: (slot, tokens) pairs
                same = [s for (s, a), (s2, b) in zip(cin[0], pin[0])
                        if s == s2 and a == b and dict(cin[1])[s] == dict(pin[1])[s]]
            else:
                same = [s for s in range(len(cin[0]))
                        if (cin[0][s], cin[1][s]) == (pin[0][s], pin[1][s])]
            for s in same:
                if s in forked:
                    continue
                compared += 1
                if not np.allclose(cl[s], pl[s], atol=Q8_FORK_TOL[0], rtol=Q8_FORK_TOL[1]):
                    raise AssertionError(f"{c} slot {s}: card logits off the CPU's before a fork")
                if cl[s].argmax() != pl[s].argmax():
                    top2 = np.sort(pl[s])[-2:]
                    gaps.append(float(top2[1] - top2[0]))
                    forked.add(s)
            if len(forked) == 4:
                break
    label = ("q4" if int4 else "q8") + (" --kv int8" if kv_quant else "")
    print(f"golden forks ({label}, card vs the CPU's plain path): {len(gaps)} slot forks over "
          f"{compared} compared slot steps; top-2 gaps at the forks "
          f"{[round(g, 4) for g in gaps]} (bar {NEAR_TIE})", flush=True)
    if compared < 100 or any(g > NEAR_TIE for g in gaps):
        raise AssertionError(f"golden ({label}): a fork that is no near-tie, or too few steps")


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


def random_7b_qparams(cfg: ModelConfig, dev, int4: bool = False,
                      stacked: bool = False) -> QuantLlamaParams:
    """Q8_0 params (group size 64), or with `int4` int4 params (group size
    32, the embedding Q8_0 of group size 64), of seeded bf16 draws scaled as
    in random_7b_params, quantized on the card one layer's weight at a time,
    so no full-precision copy of the model exists. The classifier is the
    quantized transposed embedding with the BOS and EOS columns zero. With
    `stacked`, the same Q8_0 weights in the stacked layout (--layout
    stacked), each layer quantized into its slice of the stacked tensors."""
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

    def add(name: str, l: int, t):
        if not stacked:
            layers[name].append(t)
            return
        if l == 0:
            layers[name] = Q.QTensor(t.q.new_empty((c.n_layers, *t.q.shape)),
                                     t.s.new_empty((c.n_layers, *t.s.shape)))
        layers[name].q[l] = t.q
        layers[name].s[l] = t.s

    for l in range(c.n_layers):
        add("wq", l, qt(mat(c.dim, c.dim, fan_in=c.dim), mat(c.dim, c.kv_dim, fan_in=c.dim),
                        mat(c.dim, c.kv_dim, fan_in=c.dim)))
        add("wo", l, qt(mat(c.dim, c.dim, fan_in=c.dim)))
        add("w1", l, qt(mat(c.dim, c.hidden_dim, fan_in=c.dim),
                        mat(c.dim, c.hidden_dim, fan_in=c.dim)))
        add("w2", l, qt(mat(c.hidden_dim, c.dim, fan_in=c.hidden_dim)))
    tok_emb = mat(c.vocab_size, c.dim, fan_in=c.dim)
    emb = Q.q8_quantize_weights(tok_emb.t(), 64)  # groups along each row of tok_emb
    wcls = tok_emb.t().contiguous()
    wcls[:, 1:3] = 0
    norms = (torch.ones(c.n_layers, c.dim, device=dev) if stacked
             else tuple(ones(c.dim) for _ in range(c.n_layers)))
    return QuantLlamaParams(
        tok_emb_q=emb.q.t().contiguous(), tok_emb_s=emb.s.t().contiguous(),
        rms_att=norms, wk=(), wv=(), rms_ffn=norms, w3=(),
        **{name: w if stacked else tuple(w) for name, w in layers.items()},
        rms_final=ones(c.dim), wcls=qt(wcls),
    )


def without_ffn0(params: QuantLlamaParams) -> QuantLlamaParams:
    """The control of the logit check: layer 0's FFN adds nothing (W2 zero:
    int8 codes 0, or int4 nibbles 8, the code 0, in both halves of a byte)."""
    if params.stacked:
        q = params.w2.q.clone()
        q[0] = 0
        return dataclasses.replace(params, w2=Q.QTensor(q, params.w2.s))
    w2 = list(params.w2)
    w2[0] = type(w2[0])(torch.full_like(w2[0].q, -120 if params.int4 else 0), w2[0].s)
    return dataclasses.replace(params, w2=tuple(w2))


PAGE = 128  # the 7B-width serves' page on the paged pool
SERVES: dict[str, dict] = {}  # each serve's stats by label
MAINLOOP: dict[int, float] = {}  # the products-only mainloop's TFLOP/s by wait_group


def phase_serve(label: str, params, logit_tol: float, path: tuple[str, ...], per_step: dict,
                control=None, kv_quant: bool = False, paged: bool = False) -> dict:
    """Serve the 16 requests at batch 8, window 512 through the engine with
    `params` (on an int8 cache with `kv_quant`; on the paged pool, pages of
    PAGE rows, with `paged`), after holding the first prefill and decode
    logits of the kernel path against the plain path (and, given `control`,
    checking that the plain path on control(params) reads above the
    tolerance, and for Q8 params on the dense cache profiling a decode step
    of the four-kernel layer beside the default one); `per_step`: the
    wrapper launches one decode step must make, exactly. Returns the
    launches of the serve."""
    dev = torch.device("cuda")
    cfg = LLAMA2_7B
    batch, window, steps = 8, 512, 352
    max_pages = window // PAGE
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
        if not paged:
            cache = init_kv_cache(cfg, batch, dtype=torch.bfloat16, seq_len=window, device=dev,
                                  quantized=kv_quant)
            pf, _ = make_prefill(cfg, last_only=True, plain=plain)(p, cache, toks_d, start, valid)
            lg, _ = make_decode_step(cfg, plain=plain)(p, cache, cur, valid)
            return pf, lg
        # slot b's pages, scattered over the pool (page 0 is the trash page)
        cache = init_paged_kv_cache(cfg, batch * max_pages + 1, PAGE, dtype=torch.bfloat16,
                                    quantized=kv_quant, device=dev)
        table = (torch.randperm(batch * max_pages, generator=torch.Generator().manual_seed(SEED))
                 .view(batch, max_pages).to(dev, torch.int32) + 1)
        prefill = make_paged_prefill(cfg, last_only=True, plain=plain)
        pf = None
        for c0 in range(0, 256, PAGE):  # page-aligned chunks of one page
            v = (valid - c0).clamp(0, PAGE).to(torch.int32)
            lg, _ = prefill(p, cache, table, toks_d[:, c0:c0 + PAGE].contiguous(),
                            torch.full_like(start, c0), v)
            pf = lg if pf is None else torch.where((v > 0)[:, None], lg, pf)
        lg, _ = make_paged_decode_step(cfg, plain=plain)(p, cache, table, cur, valid)
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
                             kv_quant=kv_quant, paged=paged, page_size=PAGE)
    nonfinite = [0]
    do_step = engine._do_step

    def checked_step(cache, tokens, pos, *bm):
        lg, cache = do_step(cache, tokens, pos, *bm)
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
    SERVES[label] = stats
    if any(g == "" for g in requests.generations):
        raise AssertionError("a request did not finish")
    if n_gen != len(prompts) * (steps - 1):
        raise AssertionError(f"requests stopped short of the step budget: {n_gen} tokens")
    if min(steps - n for n in lens) < 32:
        raise AssertionError("a request generated fewer than 32 tokens")
    if nonfinite[0]:
        raise AssertionError(f"{nonfinite[0]} non-finite logits while serving")
    if set(engine.prefill_chunks) != ({PAGE} if paged else {16, 64, 256}):
        raise AssertionError(f"prefill buckets hit: {dict(engine.prefill_chunks)}")
    dead = [n for n in path if launches[n] == 0]
    if dead:
        raise AssertionError(f"kernels never launched on the {label} path: {dead}")

    # where a step's time goes: wrapper calls of one decode step, then device
    # time by kernel over a short window
    cache = engine.new_cache()
    bm = engine.new_block_manager()  # None on the dense cache
    toks = np.array([t[-1] for t in ids], np.int32)
    pos0 = np.array([len(t) - 1 for t in ids], np.int32)
    if bm is not None:
        for s, p in enumerate(pos0):
            bm.ensure_capacity(s, int(p) + 8)
    before = launch_counts()
    engine._do_step(cache, toks, pos0, bm)
    step_counts = {n: c - before[n] for n, c in launch_counts().items() if c > before[n]}
    print(f"{label} wrapper launches per decode step (batch 8): {sum(step_counts.values())} "
          f"{step_counts}", flush=True)
    if step_counts != per_step:
        raise AssertionError(f"{label}: launches per decode step {step_counts}, want {per_step}")
    profile_window(f"{label} decode step (batch 8)", 4,
                   lambda i: engine._do_step(cache, toks, pos0 + i, bm))
    if not paged:
        # the host's time to enqueue a decode step (the step itself, which
        # returns device logits: no synchronize inside), beside its wall
        # time, without the profiler: where they meet, the host bounds it
        step = make_decode_step(cfg)
        toks_t, pos_t = torch.from_numpy(toks).to(dev), torch.from_numpy(pos0).to(dev)
        step(params, cache, toks_t, pos_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            step(params, cache, toks_t, pos_t + i)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        print(f"{label} decode step (batch 8), 10 steps without the profiler: host enqueue "
              f"{(t1 - t0) / 10 * 1e3:.3f} ms/step, wall {(time.perf_counter() - t0) / 10 * 1e3:.3f}"
              " ms/step", flush=True)
    if control is not None and not params.int4 and not paged and not params.stacked:
        os.environ["HIPLLAMA_LAYER_FUSE"] = "0"
        try:
            four = make_decode_step(cfg)
        finally:
            del os.environ["HIPLLAMA_LAYER_FUSE"]
        toks_t = torch.from_numpy(toks).to(dev)
        profile_window(f"{label} decode step, four-kernel layer (batch 8)", 4,
                       lambda i: four(params, cache, toks_t, torch.from_numpy(pos0 + i).to(dev)))
    chunk = [t[:-1][:256] for t in ids]
    for t_chunk in ((PAGE,) if paged else (256, 16)):
        # a T-16 chunk of 8 slots (128 rows) is the bucket the serves' late
        # arrivals take, and K18's tensor-core rows
        profile_window(f"{label} prefill chunk (batch 8, T {t_chunk})", 2 if t_chunk > 16 else 4,
                       lambda i, t_c=t_chunk: engine._prefill_tokens(
                           cache, batch, {s: c[:t_c] for s, c in enumerate(chunk)},
                           {s: 0 for s in range(batch)}, bm=bm))
    return launches


# ---------------------------------------------------------------------------
# phase 12: the port bench and its bandwidth probes (K24-K27)

# the in-process bench runs and the metric each must print (bench.py's names)
BENCH_RUNS = (
    ([], "decode_tok_per_s_per_chip_llama2_7b_int8_kv8_b8"),
    (["--loop", "host"], "decode_tok_per_s_per_chip_llama2_7b_int8_kv8_b8"),
    (["--mode", "ttft"], "ttft_p50_ms_llama2_7b_int8_kv8_b8_prompt512"),
    (["--mode", "serve"], "serve_tok_per_s_llama2_7b_int8_kv8_b8_prompt512"),
    (["--mode", "serve", "--paged", "--prefix-cache"],
     "serve_tok_per_s_llama2_7b_int8_kv8_b8_prompt512_paged_pfx"),
)


def phase_probe_kernels() -> dict[str, dict]:
    """K24-K27 against their plain versions at the probes' default sizes: 6
    GiB of seeded random int8 (random, so an indexing fault shows), in
    blocks of 4096 rows over 4 streams for K24 and K25, (4096, 512) tiles
    for K26, depth 8 over blocks of 2048 rows for K27; bit for bit
    (torch.equal: integers in fp32). Timed beside the plain version and one
    library call over the same bytes (x.sum(dtype=torch.int32); for K25
    out.copy_(x)). Bound: the bytes over 3.35 TB/s (K25 reads and writes
    them)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    sz = HT.dma_sizes(6.0, 4, 4096)
    x = torch.empty((sz["n"], 1024), dtype=torch.int8, device=dev).random_(-128, 128, generator=g)
    seed = torch.tensor([SEED], dtype=torch.int32, device=dev)
    out: dict[str, dict] = {}

    def case(name, label, fn, plain_fn, lib_fn, lib_name, n_bytes):
        got, want = fn(), plain_fn()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, list) else [(got, want)]
        ok = len(pairs) > 0 and all(torch.equal(a, b) for a, b in pairs)
        err = max(max_err(a, b) for a, b in pairs)
        del got, want, pairs
        ms = cuda_ms(lambda i: fn(), iters=8, warmup=1)
        plain = cuda_ms(lambda i: plain_fn(), iters=4, warmup=1)
        lib = cuda_ms(lambda i: lib_fn(), iters=4, warmup=1)
        bound = bound_ms(n_bytes, 0, torch.int8)
        print(f"kernel {name} [{label}]: max_abs_err {err:.3g} (bit-exact) "
              f"{'ok' if ok else 'FAIL'}; ms {ms:.4f} plain_ms {plain:.4f} library_ms "
              f"({lib_name}) {lib:.4f} bound_ms {bound[0]:.4f} ({bound[1]})", flush=True)
        if not ok:
            raise AssertionError(f"{name} differs from its plain version")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound=bound)

    bm, rows = sz["bm"], f"x ({sz['n']}, 1024) int8"
    case("dma_read", f"{rows}, blocks of {bm} rows, 4 streams",
         lambda: HK.dma_read(seed, x, bm, 4), lambda: HK.dma_read_plain(seed, x, bm, 4),
         lambda: x.sum(dtype=torch.int32), "x.sum(dtype=torch.int32)", x.numel())
    dst = torch.empty_like(x)
    case("dma_copy", f"{rows}, blocks of {bm} rows, 4 streams",
         lambda: HK.dma_copy(x, bm, 4), lambda: HK.dma_copy_plain(x, bm, 4),
         lambda: dst.copy_(x), "out.copy_(x)", 2 * x.numel())
    del dst
    n_cols = HT.wshape_sizes(6.0, 4096, 512)["n_cols"]
    xw = x.view(-1)[:4096 * n_cols].view(4096, n_cols)
    case("wshape_read", f"x (4096, {n_cols}) int8, (4096, 512) tiles",
         lambda: HK.wshape_read(seed, xw, 512), lambda: HK.wshape_read_plain(seed, xw, 512),
         lambda: xw.sum(dtype=torch.int32), "x.sum(dtype=torch.int32)", xw.numel())
    xd = x[:HT.deep_sizes(6.0, 2048)["n"]]
    case("deep_read", f"x ({xd.shape[0]}, 1024) int8, blocks of 2048 rows, depth 8",
         lambda: HK.deep_read(seed, xd, 2048, 8), lambda: HK.deep_read_plain(seed, xd, 2048, 8),
         lambda: xd.sum(dtype=torch.int32), "x.sum(dtype=torch.int32)", xd.numel())
    return out


def bench_line(rc: int, text: str, metric: str, achievable: bool) -> dict:
    """The bench's result line, checked: rc 0, the metric, a value above 0,
    0 < vs_baseline <= 1.05, and the same for vs_achievable (required with
    `achievable`)."""
    line = json.loads(text.strip().splitlines()[-1])
    if rc != 0 or line.get("metric") != metric:
        raise AssertionError(f"bench printed {text!r} (rc {rc}); expected metric {metric}")
    if not line["value"] > 0 or not 0 < line["vs_baseline"] <= 1.05:
        raise AssertionError(f"bench line out of range: {line}")
    if achievable and "vs_achievable" not in line:
        raise AssertionError(f"bench line without vs_achievable: {line}")
    if "vs_achievable" in line and not 0 < line["vs_achievable"] <= 1.05:
        raise AssertionError(f"bench vs_achievable out of range: {line}")
    return line


def phase_bench() -> dict[str, int]:
    """The port bench's path, its wrapper launches counted from 0: the
    hbm_bw ladders and the achievable bandwidth; the graph decode chain
    (16 steps of the 7B-width Q8 + int8-KV step at batch 8, window 512)
    against the same chain run eagerly, token for token; bench.main in
    process for each of BENCH_RUNS, with HIPLLAMA_ACHIEVABLE_BW set to this
    run's probes; and one `python -m hip_llama_tpu_torch.bench --steps 16`,
    which probes the card itself."""
    dev = torch.device("cuda")
    reset_launches()
    print(f"hbm_bw ladders ({card_line()}):", flush=True)
    for mode in ("dma", "copy", "wshape", "dmadeep", "xreduce"):
        HT.main(["--mode", mode])
        torch.cuda.empty_cache()
    ach = HT.achievable(device=dev, file=sys.stdout)
    torch.cuda.empty_cache()

    cfg = port_bench.CONFIGS["7b"]
    qparams = port_bench.rand_qparams_unrolled_on_device(cfg, dev, seed=SEED)
    step = make_decode_step(cfg)
    cache = init_kv_cache(cfg, 8, dtype=torch.bfloat16, seq_len=512, device=dev, quantized=True)
    tokens = torch.arange(8, dtype=torch.int32, device=dev) * 1009
    base = torch.full((8,), 256, dtype=torch.int32, device=dev)
    eager = port_bench.decode_chain(step, qparams, cache, tokens, base, 16)
    graph, replayed = port_bench.capture_chain(step, qparams, cache, tokens, base, 16)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(replayed, eager):
        raise AssertionError("the graph decode chain's tokens differ from the eager chain's")
    print(f"graph decode chain: 16 steps of the 7B-width Q8 + int8-KV step at b8, window 512, "
          f"{replayed.numel()} tokens equal to the eager chain's", flush=True)
    del graph, replayed, eager, cache, qparams
    gc.collect()
    torch.cuda.empty_cache()

    old = os.environ.get("HIPLLAMA_ACHIEVABLE_BW")
    os.environ["HIPLLAMA_ACHIEVABLE_BW"] = f"{ach:.6e}"
    try:
        for argv, metric in BENCH_RUNS:
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = port_bench.main(argv)
            print(f"bench {' '.join(argv) or '(defaults)'} ({time.perf_counter() - t0:.1f} s): "
                  f"{buf.getvalue().strip()}", flush=True)
            bench_line(rc, buf.getvalue(), metric, achievable=not argv or "decode" in metric)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if old is None:
            del os.environ["HIPLLAMA_ACHIEVABLE_BW"]
        else:
            os.environ["HIPLLAMA_ACHIEVABLE_BW"] = old
    counts = launch_counts()

    # the command line, in its own process: it measures the probes itself
    env = {k: v for k, v in os.environ.items() if k != "HIPLLAMA_ACHIEVABLE_BW"}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "hip_llama_tpu_torch.bench", "--steps", "16"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    for ln in r.stderr.strip().splitlines()[-12:]:
        print(f"  bench stderr: {ln}", flush=True)
    print(f"python -m hip_llama_tpu_torch.bench --steps 16 ({time.perf_counter() - t0:.1f} s): "
          f"{r.stdout.strip()}", flush=True)
    bench_line(r.returncode, r.stdout, BENCH_RUNS[0][1], achievable=True)
    return counts


# ---------------------------------------------------------------------------
# phase 13: every shape the JAX package serves


# (head size, query heads per KV head): stories15M's 48 with its 3, and 96,
# each with 3 and 16
SHAPE_CASES = ((48, 3), (48, 16), (96, 3), (96, 16))
# llama2.c's stories15M shape: 6 heads of 48 over 2 KV heads (cut to 2
# layers, the golden tokenizer's vocabulary); random weights from SEED
DIM288 = ModelConfig(dim=288, hidden_dim=768, n_layers=2, n_heads=6, n_kv_heads=2,
                     vocab_size=512, seq_len=128)
# its serves through the CLI: label -> (CLI arguments, knobs, the kernels
# its path must launch, logit tolerance against the plain path on the CPU).
# fp32: the fp32 attention kernels against the CPU's order of the same sums;
# fp32 on the int8 cache: a k or v element a rounding apart can quantize to
# the next int8 step; int4 `a8` (groups of 16 at K 288): bf16 activations,
# as Q4_LOGIT_TOL
DIM288_RUNS = {
    "fp32": (["--dtype", "float32"], {},
             ("attention_decode", "attention_prefill", "kv_commit_rows", "kv_write_chunk"), 1e-3),
    "fp32 --kv int8": (["--dtype", "float32", "--kv", "int8"], {},
                       ("attention_decode_int8",) + INT8_CACHE_PATH, 0.05),
    "q4 a8": (["--quant", "q4"], {"HIPLLAMA_Q4_MODE": "a8"},
              ("q4_matmul_a8", "q4_matmul_silu_a8", "attention_decode_fused", "kv_commit_rows",
               "kv_write_chunk", "attention_prefill"), Q4_LOGIT_TOL),
}


def shape_check(label: str, pairs, bound) -> None:
    """Raise unless every (kernel, plain) output pair is within bound(plain)."""
    pairs = list(pairs)
    torch.cuda.synchronize()
    err = max(max_err(a, b) for a, b in pairs)
    ok = all(bool(((a.float() - b.float()).abs() <= bound(b)).all()) for a, b in pairs)
    print(f"shape {label}: max_abs_err {err:.3g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")


def phase_shape_kernels() -> None:
    """The kernels that refused these shapes before (K1, K4, K5, K6, K7, K23,
    the `a8` kernels, K16) against their plain versions at head sizes 48
    and 96 with 3 and 16 query heads per KV head, `a8` groups of 16 and 48
    and K16 groups of 4: bf16, int8 and fp32 caches, 8 slots over 512 rows
    (pages of 128), a 64-token chunk."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 13)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    b, kvh, s, t, ps = 8, 2, 512, 64, 128
    pos = torch.tensor([0, 1, 100, 255, 256, 300, 450, s - 1], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 7, 100, 192, 300, 400, s - t, 64], dtype=torch.int32, device=dev)
    valid = torch.tensor([t, t - 5, 1, t, 30, 0, t, 17], dtype=torch.int32, device=dev)
    table = (torch.randperm(b * (s // ps), generator=torch.Generator().manual_seed(SEED))
             .view(b, s // ps).to(dev, torch.int32) + 1)

    def tc_bound(w):  # the tensor-core prefill: an ulp of |plain| at least
        return torch.maximum(ATTN_ATOL + ATTN_RTOL * w.float().abs(), bf16_ulp(w))

    for hs, m in SHAPE_CASES:
        h = m * kvh
        for cache in (torch.bfloat16, torch.int8, torch.float32):
            act = torch.bfloat16 if cache == torch.int8 else cache
            shape = (b, 1, kvh, s, hs)
            if cache == torch.int8:
                (k, ks), (v, vs) = (C.quantize_kv_rows(rnd(*shape, dtype=torch.float32))
                                    for _ in range(2))
                sc = (ks, vs)
                dec_bound = lambda w: INT8_ATTN_ATOL + INT8_ATTN_RTOL * w.float().abs()  # noqa: E731
            else:
                k, v, sc = rnd(*shape, dtype=cache), rnd(*shape, dtype=cache), ()
                dec_bound = (lambda w: TOL[cache]) if cache == torch.float32 else (  # noqa: E731
                    lambda w: ATTN_ATOL + ATTN_RTOL * w.float().abs())
            pf_bound = (lambda w: TOL[cache]) if cache == torch.float32 else tc_bound
            qkv = rnd(b, h + 2 * kvh, hs, dtype=act)
            q, kc, vc = (x.contiguous() for x in (qkv[:, :h], qkv[:, h:h + kvh], qkv[:, h + kvh:]))
            qp = rnd(b, t, h, hs, dtype=act)
            tag = f"HS {hs}, {m} q heads per KV head, {str(cache)[6:]} cache"
            shape_check(f"attention_decode [{tag}]", [
                (A.attention_decode(q, k, v, 0, pos, kc, vc, *sc),
                 A.attention_decode_plain(q, k, v, 0, pos, kc, vc, *sc)),
                (A.attention_decode_fused(qkv, k, v, 0, pos, h, *sc),
                 A.attention_decode_fused_plain(qkv, k, v, 0, pos, h, *sc))], dec_bound)
            live = torch.arange(t, device=dev)[None, :] < valid[:, None]
            shape_check(f"attention_prefill [{tag}, T {t}]", [
                (A.attention_prefill(qp, k, v, 0, start, valid, *sc)[live],
                 A.attention_prefill_plain(qp, k, v, 0, start, valid, *sc)[live])], pf_bound)
            # the same rows laid out on pages of 128 of one pool
            pool = [torch.empty((1, kvh, b * (s // ps) + 1, ps) + x.shape[4:], dtype=x.dtype,
                                device=dev) for x in (k, v) + sc]
            for x, pl in zip((k, v) + sc, pool):
                pl[0][:, table.long()] = x[:, 0].reshape(b, kvh, s // ps, ps, *x.shape[4:]) \
                    .transpose(0, 1)
            kp, vp, *psc = pool
            shape_check(f"attention_decode_paged [{tag}]", [
                (A.attention_decode_paged(q, kp, vp, table, 0, pos, kc, vc, *psc),
                 A.attention_decode_paged_plain(q, kp, vp, table, 0, pos, kc, vc, *psc))],
                dec_bound)
            shape_check(f"attention_prefill_paged [{tag}, T {t}]", [
                (A.attention_prefill_paged(qp, kp, vp, table, 0, start, valid, *psc)[live],
                 A.attention_prefill_paged_plain(qp, kp, vp, table, 0, start, valid,
                                                 *psc)[live])], pf_bound)
            del k, v, sc, pool, kp, vp, psc
    # K23: stories15M's layer (HS 48, 3 query heads per KV head), bf16 and
    # int8 caches
    c = DIM288
    d, hid, hs = c.dim, c.hidden_dim, c.dim // c.n_heads

    def qw(kk, n, gs):
        return Q.q8_quantize_weights(rnd(kk, n, dtype=torch.float32).mul_(kk ** -0.5), gs)

    wl = (qw(d, (c.n_heads + 2 * c.n_kv_heads) * hs, 32), qw(d, d, 32), qw(d, 2 * hid, 32),
          qw(hid, d, 32))
    g1, g2 = ((1 + 0.1 * rnd(d, dtype=torch.float32)).contiguous() for _ in range(2))
    x = rnd(b, d)
    for cache in (torch.bfloat16, torch.int8):
        shape = (b, 1, c.n_kv_heads, s, hs)
        if cache == torch.int8:
            (k, ks), (v, vs) = (C.quantize_kv_rows(rnd(*shape, dtype=torch.float32))
                                for _ in range(2))
            sc = (ks, vs)
        else:
            k, v, sc = rnd(*shape), rnd(*shape), ()
        args = (x, *wl, g1, g2, k, v, 0, pos, *sc)
        got, want = LF.q8_layer_fused(*args, n_heads=c.n_heads), \
            LF.q8_layer_fused_plain(*args, n_heads=c.n_heads)
        shape_check(f"q8_layer_fused [dim 288, HS 48, 3 q heads per KV head, "
                    f"{str(cache)[6:]} cache]", list(zip(got, want)),
                    lambda w: Q8_ATOL + Q8_RTOL * w.float().abs())
    # the a8 kernels at groups of 16 (int4 at K 288) and 48: the GEMV path
    # (8 rows) and the tensor-core tiles (128 rows)
    q8b = lambda w: Q8_ATOL + Q8_RTOL * w.float().abs()  # noqa: E731
    for gs in (16, 48):
        w = rnd(d, 2 * 864, dtype=torch.float32).mul_(d ** -0.5)
        q8w, q8w13 = Q.q8_quantize_weights(w[:, :864], gs), Q.q8_quantize_weights(w, gs)
        w4 = rnd(2 * d, 2 * 864, dtype=torch.float32).mul_((2 * d) ** -0.5)
        q4w, q4w13 = Q4.q4_quantize_weights(w4[:, :864], gs), Q4.q4_quantize_weights(w4, gs)
        for m in (8, 128):
            x8, x4 = rnd(m, d), rnd(m, 2 * d)
            a0 = (Q.q8_matmul.launches_a8, Q.q8_matmul_silu.launches_a8,
                  Q4.q4_matmul.launches_a8, Q4.q4_matmul_silu.launches_a8)
            shape_check(f"a8 products [gs {gs}, M {m}: K15, K17, K21, K22]", [
                (Q.q8_matmul(x8, q8w, mode="a8"), Q.q8_matmul_plain(x8, q8w, mode="a8")),
                (Q.q8_matmul_silu(x8, q8w13, mode="a8"),
                 Q.q8_matmul_silu_plain(x8, q8w13, mode="a8")),
                (Q4.q4_matmul(x4, q4w, mode="a8"), Q4.q4_matmul_plain(x4, q4w, mode="a8")),
                (Q4.q4_matmul_silu(x4, q4w13, mode="a8"),
                 Q4.q4_matmul_silu_plain(x4, q4w13, mode="a8"))], q8b)
            a1 = (Q.q8_matmul.launches_a8, Q.q8_matmul_silu.launches_a8,
                  Q4.q4_matmul.launches_a8, Q4.q4_matmul_silu.launches_a8)
            if any(y - z != 1 for y, z in zip(a1, a0)):
                raise AssertionError(f"the a8 kernels did not run at gs {gs}, M {m}: {a0} {a1}")
    # K16 at groups of 4 (head size 128)
    gh, hs16, n = 32, 128, 4096
    x3 = rnd(256, gh, hs16)
    xq = Q.q8_quantize_weights(rnd(gh * hs16, n, dtype=torch.float32).mul_((gh * hs16) ** -0.5), 4)
    res = rnd(256, n)
    n0 = Q.q8_matmul_xheads.launches
    shape_check("q8_matmul_xheads [gs 4, M 256, 32 heads of 128]", [
        (Q.q8_matmul_xheads(x3, xq, residual=res),
         Q.q8_matmul_xheads_plain(x3, xq, residual=res))], q8b)
    if Q.q8_matmul_xheads.launches != n0 + 1:
        raise AssertionError("q8_matmul_xheads did not run at gs 4")


def phase_long_blocks() -> None:
    """K1, K5 and K6 on bf16 and fp32 caches, and K23 on the bf16 one, over
    windows that no power of two from 8 divides, whose JAX block is the
    window itself, past the fp32/bf16 decode task's shared memory (which
    then walks the block in chunks): 6404 rows at 8 query heads per KV head
    and 51204 at one, head size 128. Tolerance: fp32 TOL; bf16 one bf16 ulp
    of |plain| and at least ATTN_ATOL + ATTN_RTOL |plain| (both sides round
    p at the same block max, their fp32 sums in other orders); K23 Q8_ATOL
    + Q8_RTOL |plain|."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    hs = 128

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    def bound(dtype):
        if dtype == torch.float32:
            return lambda w: TOL[dtype]
        return lambda w: torch.maximum(ATTN_ATOL + ATTN_RTOL * w.float().abs(), bf16_ulp(w))

    wrappers = (A.attention_decode, A.attention_decode_fused, A.attention_decode_paged)
    for s, m, kvh, pos_l in ((6404, 8, 1, [0, 1281, 3000, 6403]),
                             (51204, 1, 2, [0, 10497, 30000, 51203])):
        h, b = m * kvh, len(pos_l)
        assert A.decode_block(s) == s
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        table = torch.arange(1, b + 1, dtype=torch.int32, device=dev)[:, None]
        for dtype in (torch.bfloat16, torch.float32):
            k, v = rnd(b, 1, kvh, s, hs, dtype=dtype), rnd(b, 1, kvh, s, hs, dtype=dtype)
            qkv = rnd(b, h + 2 * kvh, hs, dtype=dtype)
            q, kc, vc = (x.contiguous() for x in (qkv[:, :h], qkv[:, h:h + kvh],
                                                  qkv[:, h + kvh:]))
            # the same rows as pages of the window, page b + 1 slot b's
            kp, vp = (torch.cat([torch.zeros_like(x[:1, 0]), x[:, 0]]).transpose(0, 1)[None]
                      .contiguous() for x in (k, v))
            n0 = [fn.launches for fn in wrappers]
            shape_check(f"attention_decode [{str(dtype)[6:]} cache, block {s} past the task's "
                        f"shared memory, {m} q heads per KV head: K1, K5, K6]", [
                (A.attention_decode(q, k, v, 0, pos, kc, vc),
                 A.attention_decode_plain(q, k, v, 0, pos, kc, vc)),
                (A.attention_decode_fused(qkv, k, v, 0, pos, h),
                 A.attention_decode_fused_plain(qkv, k, v, 0, pos, h)),
                (A.attention_decode_paged(q, kp, vp, table, 0, pos, kc, vc),
                 A.attention_decode_paged_plain(q, kp, vp, table, 0, pos, kc, vc))],
                bound(dtype))
            if [fn.launches - c for fn, c in zip(wrappers, n0)] != [1, 1, 1]:
                raise AssertionError(f"the decode kernels did not run at block {s}")
            if dtype == torch.bfloat16 and m == 8:
                d, hid = h * hs, 256

                def qw(kk, n):
                    return Q.q8_quantize_weights(rnd(kk, n, dtype=torch.float32)
                                                 .mul_(kk ** -0.5), 64)

                wl = (qw(d, (h + 2 * kvh) * hs), qw(d, d), qw(d, 2 * hid), qw(hid, d))
                g1, g2 = ((1 + 0.1 * rnd(d, dtype=torch.float32)).contiguous()
                          for _ in range(2))
                args = (rnd(b, d), *wl, g1, g2, k, v, 0, pos)
                n23 = LF.q8_layer_fused.launches
                got, want = LF.q8_layer_fused(*args, n_heads=h), \
                    LF.q8_layer_fused_plain(*args, n_heads=h)
                shape_check(f"q8_layer_fused [bf16 cache, block {s} past the task's shared "
                            f"memory, {m} q heads per KV head]", list(zip(got, want)),
                            lambda w: Q8_ATOL + Q8_RTOL * w.float().abs())
                if LF.q8_layer_fused.launches != n23 + 1:
                    raise AssertionError(f"q8_layer_fused did not run at block {s}")
            del k, v, kp, vp


def phase_dim288_serves() -> dict[str, dict[str, int]]:
    """A stories15M-shaped model (DIM288, random weights from SEED, a v0
    file) served through the port's CLI on the card and on the CPU (-m test
    on the gen corpus, -b 4, greedy) in each DIM288_RUNS mode; the first
    prefill and three decode steps' logits of the card's kernel path held
    against the CPU's plain path within the run's tolerance, the share of
    identical generations printed. Returns each run's card launches."""
    from hip_llama_tpu_torch.io.checkpoint import random_weights, write_v0
    from hip_llama_tpu_torch.models import params_from_weights

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "dim288.bin")
        write_v0(model, DIM288, random_weights(DIM288, seed=SEED))
        cfg, weights = load_checkpoint(model)
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, (4, 16)).astype(np.int32))
        start, valid = torch.zeros(4, dtype=torch.int32), torch.tensor([16, 9, 1, 16],
                                                                        dtype=torch.int32)
        for label, (args, env, path, tol) in DIM288_RUNS.items():
            outs = {}
            with knobs(env):
                for dev in ("cuda", "cpu"):
                    out = os.path.join(tmp, f"{dev}.out")
                    reset_launches()
                    with contextlib.redirect_stdout(io.StringIO()):
                        rc = port_run.main([
                            "run", model, "-z", os.path.join(GOLDEN, "tokenizer.bin"),
                            "-m", "test", "-f", os.path.join(REPO, "assets", "in", "gen_in_8.txt"),
                            "-o", out, "-b", "4", "-t", "0.0", *args, "--device", dev])
                    if rc != 0:
                        raise AssertionError(f"dim 288 {label} --device {dev}: rc {rc}")
                    if dev == "cuda":
                        launches[label] = launch_counts()
                    outs[dev] = read_inputfile(out).prompts
                # the logits of the kernel path (card) and the plain path (CPU)
                lg = {}
                q4 = "--quant" in args
                dtype = torch.float32 if "float32" in args else torch.bfloat16
                for dev in ("cuda", "cpu"):
                    p = (quantize_params_q4(cfg, weights, device=dev) if q4
                         else params_from_weights(weights, dtype=dtype, device=dev))
                    cache = init_kv_cache(cfg, 4, dtype=dtype, device=dev,
                                          quantized="--kv" in args)
                    pf = make_prefill(cfg)(p, cache, tokens.to(dev), start.to(dev),
                                           valid.to(dev))[0]
                    seq = [pf[(torch.arange(16)[None, :] < valid[:, None]).to(dev)]]
                    step = make_decode_step(cfg)
                    for i in range(3):
                        seq.append(step(p, cache, tokens[:, i].to(dev), (valid + i).to(dev))[0])
                    lg[dev] = [x.float().cpu() for x in seq]
            err = max(max_err(a, b) for a, b in zip(lg["cuda"], lg["cpu"]))
            same = sum(a == b for a, b in zip(outs["cuda"], outs["cpu"]))
            dead = [n for n in path if launches[label][n] == 0]
            print(f"dim 288 ({label}): card vs CPU logits max_abs_err {err:.4g} (tol {tol}); "
                  f"{same} of {len(outs['cpu'])} generations identical; launches "
                  f"{ {n: c for n, c in launches[label].items() if c} }", flush=True)
            if not all(torch.isfinite(x).all() for x in lg["cuda"]) or err > tol:
                raise AssertionError(f"dim 288 {label}: card and CPU logits disagree")
            if dead:
                raise AssertionError(f"kernels never launched on the dim 288 {label} path: "
                                     f"{dead}")
    return launches


# ---------------------------------------------------------------------------
# phase 14: multi-step chunks, device sampling and speculation

# the fp32 fixture under each of the engine's dispatch schedules, through the
# CLI, byte-identical to cpu_f32, with the kernels each path must launch (the
# verify prefill's K4 and K3 at starts that are not page-aligned; the paged
# chunks' K6 and K11)
GOLDEN_SCHEDULE_RUNS = {
    f"fp32 {' '.join(flags)}": (["--dtype", "float32", *flags], "1", "cpu_f32", path, True)
    for flags, path in (
        (["--chunk", "4"], DENSE_PATH),
        (["--device-sampling"], DENSE_PATH),
        (["--chunk", "4", "--paged", "16"], PAGED_PATH),
        (["--chunk", "4", "--prefix-cache"], PAGED_PATH),
        (["--spec", "4"], DENSE_PATH),
        (["--spec", "4", "--draft", os.path.join(GOLDEN, "model.bin")], DENSE_PATH),
    )
}
# Q8 + int8 KV: chunks run the plain loop's decode step, so they meet its bar
# against cpu_q8_kv8; the verify prefill rounds otherwise than decode steps,
# and the JAX package's own --spec 4 serve forks from its plain one at
# near-ties too, so --spec 4 is held to that serve's outputs
# (cpu_q8_kv8_spec4), at the average bar
GOLDEN_SCHEDULE_Q8_RUNS = {
    "q8 --kv int8 --chunk 4": (["--quant", "q8", "--kv", "int8", "--chunk", "4"], "1",
                               "cpu_q8_kv8", ("q8_layer_fused_int8", "q8_matmul")
                               + INT8_CACHE_PATH, False),
    "q8 --kv int8 --spec 4": (["--quant", "q8", "--kv", "int8", "--spec", "4"], "1",
                              "cpu_q8_kv8_spec4", ("q8_layer_fused_int8", "q8_matmul")
                              + INT8_CACHE_PATH, False),
}


class IdTokenizer:
    """A tokenizer's encode with pieces that spell the token id ("17 "), so
    that a generation's text gives its token stream back."""

    def __init__(self, tok: Tokenizer):
        self.encode = tok.encode

    def decode_piece(self, prev: int, tok: int) -> bytes:
        return f"{tok} ".encode()


class GapSampler(Sampler):
    """Greedy, and it records the top-2 gap of every logit row it samples."""

    def __init__(self, vocab_size: int):
        super().__init__(vocab_size, temperature=0.0)
        self.gaps: list[float] = []

    def sample(self, logits) -> int:
        top2 = np.partition(np.asarray(logits, np.float32), -2)[-2:]
        self.gaps.append(float(abs(top2[1] - top2[0])))
        return super().sample(logits)


def id_serve(cfg, params, tok, prompts: list[str], steps: int, batch: int, **kw):
    """Serve `prompts` greedily on the card with token-id pieces; returns
    each request's generated ids (the prompt's echo dropped), the stats, the
    launches and, where the host sampled, each request's top-2 gaps."""
    eng = InferenceEngine(cfg, params, IdTokenizer(tok), batch_size=batch, **kw)
    reqs = Requests(prompts=list(prompts), generations=[""] * len(prompts))
    samplers = [GapSampler(cfg.vocab_size) for _ in prompts]
    stats: dict = {}
    reset_launches()
    eng.serve(reqs, steps=steps, samplers=samplers, stats=stats)
    torch.cuda.synchronize()
    launches = launch_counts()
    n_echo = [min(len(tok.encode(p)), steps) - 1 for p in prompts]
    ids = [[int(t) for t in g.split()][n:] for g, n in zip(reqs.generations, n_echo)]
    return ids, stats, launches, [sp.gaps for sp in samplers]


def forks_at_near_ties(label: str, plain, other, bar: float = NEAR_TIE) -> list[float]:
    """Each request's first token where `other` parts from `plain` (ids and
    gaps of id_serve) must be a near-tie of the plain run's logits: top-2
    gap at most `bar`. Returns the gaps at the forks."""
    (p_ids, _, _, p_gaps), o_ids = plain, other[0]
    gaps = []
    for r, (a, b) in enumerate(zip(p_ids, o_ids)):
        q = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if q is None:
            if len(a) != len(b):
                raise AssertionError(f"{label} request {r}: {len(b)} tokens, plain {len(a)}")
            continue
        gaps.append(p_gaps[r][q])
    same = sum(a == b for a, b in zip(p_ids, o_ids))
    print(f"{label}: {same} of {len(p_ids)} requests identical to the card's plain serve; "
          f"top-2 gaps of the plain logits at the forks {[round(g, 4) for g in gaps]} "
          f"(bar {bar})", flush=True)
    if any(g > bar for g in gaps):
        raise AssertionError(f"{label}: a fork from the plain serve that is no near-tie")
    return gaps


def phase_schedule_goldens() -> dict[str, dict[str, int]]:
    """The fixture under every schedule through the CLI (fp32 byte for byte,
    Q8 + int8 KV at the average bar), then the Q8 + int8-KV forks of the
    chunked and speculative serves from the card's plain serve, in process
    at -b 4."""
    launches, outputs = phase_golden_runs(GOLDEN_SCHEDULE_RUNS)
    for label, files in outputs.items():
        for c, got in files.items():
            with open(os.path.join(REPO, "assets", "out", "cpu_f32", f"{c}_in_8.out"), "rb") as f:
                if got != f.read():
                    raise AssertionError(f"golden ({label}) {c}_in_8 forked on the card")
        print(f"golden ({label}): the five corpora byte-identical to assets/out/cpu_f32",
              flush=True)
    launches.update(phase_golden_runs(GOLDEN_SCHEDULE_Q8_RUNS)[0])
    cfg, w = load_checkpoint(os.path.join(GOLDEN, "model.bin"))
    tok = Tokenizer.from_file(os.path.join(GOLDEN, "tokenizer.bin"), cfg.vocab_size)
    params = quantize_params_q8(cfg, w, device=torch.device("cuda"))
    prompts = [p for c in CORPORA
               for p in read_inputfile(os.path.join(REPO, "assets", "in", f"{c}_in_8.txt")).prompts]
    runs = {label: id_serve(cfg, params, tok, prompts, cfg.seq_len, 4, kv_quant=True, **kw)
            for label, kw in (("plain", {}), ("chunk", dict(chunk_steps=4)),
                              ("spec", dict(spec_lookup=4)))}
    for label in ("chunk", "spec"):
        forks_at_near_ties(f"fixture q8 --kv int8 {label} (40 requests, -b 4)", runs["plain"],
                           runs[label])
    return launches


def phase_schedule_serves(qparams: QuantLlamaParams) -> dict[str, int]:
    """Phase 6's 7B-width Q8 + int8-KV serve, plain and at chunk_steps=8 with
    device sampling (forks only at near-ties; K23 32 times a decode step;
    one chunk's host enqueue against its wall time), the chunked serve at
    temperature 0.8 (seed 7 twice, seed 8; the 8 shortest prompts), the
    device argmax against the host's on one step's logits, and a
    prompt-lookup spec_lookup=4 serve of the first 8 requests against the
    plain serve's first 8. Returns the chunked serve's launches."""
    dev = qparams.wcls.q.device
    cfg = LLAMA2_7B
    batch, window, steps = 8, 512, 352
    with tempfile.TemporaryDirectory() as tmp:
        tok = llama_sized_tokenizer(tmp, cfg.vocab_size)
    targets = [300, 20, 150, 60, 280, 100, 30, 200, 266, 14, 90, 300, 40, 180, 25, 120]
    prompts = make_prompts(tok, targets)
    kw = dict(max_seq_len=window, kv_quant=True)
    # the schedules' prefill chunks hold other slot sets, so other row counts
    # take other kernels (the tiles, K18's tensor cores) and the logits of a
    # random-weight model move by up to the kernel path's tolerance: a fork is
    # a near-tie where the plain top-2 gap is inside twice that
    bar = 2 * Q8_LOGIT_TOL
    plain = id_serve(cfg, qparams, tok, prompts, steps, batch, **kw)
    chunk = id_serve(cfg, qparams, tok, prompts, steps, batch, chunk_steps=8,
                     device_sampling=True, **kw)
    forks_at_near_ties("7b q8 int8-kv chunk_steps=8 device sampling", plain, chunk, bar)
    launches = chunk[2]
    n_steps = launches["kv_commit_rows_int8"]
    if launches["q8_layer_fused_int8"] != _L * n_steps or n_steps == 0:
        raise AssertionError(f"K23 launched {launches['q8_layer_fused_int8']} times over "
                             f"{n_steps} decode steps")
    # the plain serve above records every row's top-2 gap on the host, so its
    # speed is phase 6's serve of the same requests and weights
    for label, st in (("plain (phase 6, this run)", SERVES["7b q8 int8-kv"]),
                      ("chunk_steps=8, device sampling", chunk[1])):
        print(f"7b q8 int8-kv serve, {label}: {st['total_tokens']} tokens in "
              f"{st['elapsed_s']:.3f} s = {st['tok_per_s']:.2f} tok/s; ttft p50 "
              f"{st['ttft_p50_s'] * 1e3:.1f} ms, p95 {st['ttft_p95_s'] * 1e3:.1f} ms; "
              f"{st['scheduler_iters']} scheduler iterations; card {card_line()}", flush=True)
    print(f"7b q8 int8-kv chunked serve: {n_steps} decode steps, K23 "
          f"{launches['q8_layer_fused_int8']} launches ({_L} a step)", flush=True)

    # one chunk of 8 steps: the host's enqueue (the chunk returns device
    # tokens, with no synchronize inside) against its wall time
    eng = InferenceEngine(cfg, qparams, tok, batch_size=batch, chunk_steps=8,
                          device_sampling=True, **kw)
    cache = eng.new_cache()
    toks = torch.randint(3, cfg.vocab_size, (batch,), generator=torch.Generator().manual_seed(SEED),
                         dtype=torch.int32).to(dev)
    pos = torch.full((batch,), 256, dtype=torch.int32, device=dev)
    eng._chunk(qparams, cache, toks, pos, eng._ds_gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._chunk(qparams, cache, toks, pos, eng._ds_gen)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    print(f"7b q8 int8-kv chunk of 8 decode steps (batch 8, pos 256): host enqueue "
          f"{(t1 - t0) * 1e3:.3f} ms, wall {(time.perf_counter() - t0) * 1e3:.3f} ms "
          f"({(t1 - t0) / 8 * 1e3:.3f} / {(time.perf_counter() - t0) / 8 * 1e3:.3f} ms a step)",
          flush=True)
    # greedy bit-equality: the device argmax of the logits the host path
    # fetches is the host's token, also where bf16 rounding makes ties
    logits, _ = make_decode_step(cfg)(qparams, cache, toks, pos)
    tied = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0] * 4, [0.0, 0.0, 7.0, 7.0]], device=dev)
    for what, lg in (("decode logits", logits), ("bf16-rounded", logits.bfloat16().float()),
                     ("tied rows", tied)):
        got = make_logit_sampler(0.0)(lg).cpu().numpy()
        want = np.argmax(lg.cpu().numpy(), axis=-1)
        print(f"greedy on the card, {what}: device argmax {got.tolist()} host "
              f"{want.tolist()}", flush=True)
        if not np.array_equal(got, want):
            raise AssertionError(f"the device argmax of the {what} is not the host's")
    del cache, logits

    # stochastic chunks: deterministic per seed (the 8 shortest prompts, a
    # budget of 160 steps)
    short = sorted(range(len(prompts)), key=lambda r: targets[r])[:batch]

    def sampled(seed):
        eng = InferenceEngine(cfg, qparams, tok, batch_size=batch, chunk_steps=8,
                              device_sampling=True, ds_temperature=0.8, ds_topp=0.9,
                              ds_seed=seed, **kw)
        reqs = Requests(prompts=[prompts[r] for r in short], generations=[""] * batch)
        eng.serve(reqs, steps=160,
                  samplers=[Sampler(cfg.vocab_size, 0.8, 0.9, SEED) for _ in range(batch)])
        return reqs.generations

    a, b, c = sampled(7), sampled(7), sampled(8)
    print(f"7b q8 int8-kv chunked serve at temperature 0.8, {batch} requests: seed 7 twice "
          f"identical {a == b}; seed 8 differs in {sum(x != y for x, y in zip(a, c))} of "
          f"{batch}", flush=True)
    if a != b or a == c:
        raise AssertionError("stochastic device sampling is not deterministic per seed")

    # prompt-lookup speculation on the first wave, held to the plain serve's
    # first 8 requests (the first wave's slots decode as they do alone)
    base = tuple(x[:batch] for x in (plain[0], plain[3]))
    spec = id_serve(cfg, qparams, tok, prompts[:batch], steps, batch, spec_lookup=4, **kw)
    st = spec[1]
    print(f"7b q8 int8-kv spec_lookup=4 serve, {batch} requests: {st['total_tokens']} tokens "
          f"in {st['elapsed_s']:.3f} s = {st['tok_per_s']:.2f} tok/s; ttft p50 "
          f"{st['ttft_p50_s'] * 1e3:.1f} ms; proposed "
          f"{st['spec_proposed']}, accepted {st['spec_accepted']} (acceptance "
          f"{st['spec_accepted'] / max(st['spec_proposed'], 1):.3f}); "
          f"{st['scheduler_iters']} scheduler iterations; launches "
          f"{ {n: v for n, v in spec[2].items() if v} }", flush=True)
    if not spec[1]["spec_proposed"]:
        raise AssertionError("the 7B lookup serve proposed nothing")
    forks_at_near_ties("7b q8 int8-kv spec_lookup=4", (base[0], None, None, base[1]), spec, bar)
    return launches


def profile_window(what: str, n: int, fn) -> float:
    """Device time by kernel over n calls of fn (after one warm call), from
    torch.profiler, beside the host wall time of the same window; returns
    the device time a call in ms."""
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
    return dev_us / n / 1e3


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
    torch.cuda.empty_cache()
    prefill_ttft_case(int8=False)
    torch.cuda.empty_cache()
    res_q8 = phase_q8_kernels()
    torch.cuda.empty_cache()
    res_int8 = phase_kernels_int8()
    torch.cuda.empty_cache()
    prefill_ttft_case(int8=True)
    torch.cuda.empty_cache()
    phase_goldens()
    launches_golden = phase_golden_runs(GOLDEN_Q8_RUNS)[0]
    launches_golden.update(phase_golden_runs(GOLDEN_INT8_RUNS)[0])
    for kv_quant in (False, True):
        golden_forks_at_near_ties(kv_quant)

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
    for kv_quant in (False, True):  # the int4 GEMV rounds in the tensor cores' order
        golden_forks_at_near_ties(kv_quant, int4=True)
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
    gc.collect()
    torch.cuda.empty_cache()
    profile_q4_a8_chunks(q4params)
    del q4params

    # phase 8: the paged KV cache
    gc.collect()
    torch.cuda.empty_cache()
    res_paged = phase_paged_kernels()
    torch.cuda.empty_cache()
    launches_golden.update(phase_paged_goldens())
    qparams = random_7b_qparams(LLAMA2_7B, dev)
    launches["q8 int8 paged"] = phase_serve("7b q8 int8-kv paged", qparams, Q8_LOGIT_TOL,
                                            Q8_INT8_PAGED_PATH, Q8_INT8_PAGED_STEP,
                                            control=without_ffn0, kv_quant=True, paged=True)
    gc.collect()
    torch.cuda.empty_cache()
    phase_prefix_serve(qparams)

    # phase 9: the a8 modes
    gc.collect()
    torch.cuda.empty_cache()
    res_a8 = phase_a8_kernels()
    torch.cuda.empty_cache()
    launches_golden.update(phase_a8_goldens())
    gc.collect()
    torch.cuda.empty_cache()
    with knobs({"HIPLLAMA_Q8_MODE": "a8"}):
        launches["q8 int8 a8"] = phase_serve("7b q8 int8-kv a8", qparams, Q8_LOGIT_TOL,
                                             Q8_A8_PATH, Q8_A8_STEP, control=without_ffn0,
                                             kv_quant=True)
    fused = launches["q8 int8 a8"]["q8_layer_fused_int8"]
    if fused:
        raise AssertionError(f"q8_layer_fused launched {fused} times in the a8 serve")
    del qparams

    # phase 10: --layout stacked and the four-write KV commit
    t10 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    sparams = random_7b_qparams(LLAMA2_7B, dev, stacked=True)
    res_stacked = phase_stacked_kernels(sparams)
    res_stacked.update(phase_kv_commit_kernels())
    probe_kv_direct()
    torch.cuda.empty_cache()
    launches_golden.update(phase_stacked_goldens())
    launches["q8 int8 stacked"] = phase_serve("7b q8 int8-kv stacked", sparams, Q8_LOGIT_TOL,
                                              Q8_STACKED_PATH, Q8_STACKED_STEP,
                                              control=without_ffn0, kv_quant=True)
    gc.collect()
    torch.cuda.empty_cache()
    with knobs({"HIPLLAMA_Q8_MODE": "a8"}):
        launches["q8 int8 stacked a8"] = phase_serve(
            "7b q8 int8-kv stacked a8", sparams, Q8_LOGIT_TOL, Q8_STACKED_A8_PATH,
            Q8_STACKED_A8_STEP, control=without_ffn0, kv_quant=True)
    for label in ("q8 int8 stacked", "q8 int8 stacked a8"):
        bad = {n: launches[label][n] for n in NOT_STACKED if launches[label][n]}
        if bad:
            raise AssertionError(f"kernels of the unrolled layer launched in the {label} serve: "
                                 f"{bad}")
    del sparams
    print(f"phase 10: {time.perf_counter() - t10:.1f} s", flush=True)

    # phase 11: the prefill variants
    t11 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    res_prefill = phase_prefill_kernels()
    probe_xheads()
    torch.cuda.empty_cache()
    qparams = random_7b_qparams(LLAMA2_7B, dev)
    profile_prefill_knobs(qparams)
    with knobs(PREFILL_KNOBS):
        launches["q8 int8 prefill knobs"] = phase_serve(
            "7b q8 int8-kv prefill knobs", qparams, Q8_LOGIT_TOL, Q8_KNOBS_PATH, Q8_INT8_STEP,
            kv_quant=True)
    on, off = SERVES["7b q8 int8-kv prefill knobs"], SERVES["7b q8 int8-kv"]
    print(f"7b q8 int8-kv TTFT with both prefill knobs: p50 {on['ttft_p50_s'] * 1e3:.1f} ms, "
          f"p95 {on['ttft_p95_s'] * 1e3:.1f} ms, {on['tok_per_s']:.2f} tok/s; the default "
          f"route (phase 6, this run): p50 {off['ttft_p50_s'] * 1e3:.1f} ms, p95 "
          f"{off['ttft_p95_s'] * 1e3:.1f} ms, {off['tok_per_s']:.2f} tok/s", flush=True)
    del qparams
    print(f"phase 11: {time.perf_counter() - t11:.1f} s", flush=True)

    # phase 12: the port bench and its bandwidth probes
    t12 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    res_probes = phase_probe_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    launches["bench"] = phase_bench()
    print(f"phase 12: {time.perf_counter() - t12:.1f} s", flush=True)

    # phase 13: every shape the JAX package serves
    t13 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phase_shape_kernels()
    torch.cuda.empty_cache()
    phase_long_blocks()
    torch.cuda.empty_cache()
    # keyed apart: the fixture's `a8` goldens hold the label "q4 a8" too
    launches_golden.update({f"dim 288 {label}": counts
                            for label, counts in phase_dim288_serves().items()})
    print(f"phase 13: {time.perf_counter() - t13:.1f} s", flush=True)

    # phase 14: multi-step chunks, device sampling and speculation
    t14 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    launches_golden.update(phase_schedule_goldens())
    qparams = random_7b_qparams(LLAMA2_7B, dev)
    launches["q8 int8 chunk"] = phase_schedule_serves(qparams)
    del qparams
    print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)

    # each kernel's count from the first serving path that runs it: the 7B
    # serves, then the golden runs (K5 and its int8 branch run only in the
    # four-kernel layer, K1's int8 branch in the dense fp32 --kv int8 run;
    # K21 and K22 count from the int4 serve; the paged kernels on bf16 or
    # fp32 pages from the fixture's --paged 16 runs), then the bench phase
    # (K24-K27)
    runs = [launches["dense"], launches["q8"], launches["q8 int8"], launches["q4"],
            launches["q8 int8 paged"], launches["q8 int8 a8"], launches["q8 int8 stacked"],
            launches["q8 int8 stacked a8"], launches["q8 int8 prefill knobs"],
            launches_golden["q8, four-kernel layer"], launches_golden["fp32 --kv int8"],
            launches_golden["q8 --kv int8, four-kernel layer"], launches_golden["q8 --paged 16"],
            launches_golden["q8 a8"], launches_golden["q4 a8"],
            launches_golden["fp32, four-write commit"],
            launches_golden["q8 --kv int8, four-write commit"], launches["bench"]]
    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        r = next(d[name] for d in (res[torch.bfloat16], res_q8, res_int8, res_q4, res_paged,
                                   res_a8, res_stacked, res_prefill, res_probes) if name in d)
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

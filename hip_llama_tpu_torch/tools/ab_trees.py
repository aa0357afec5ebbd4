"""Time one checkout of the repository on the card, for comparing two
checkouts in turns (parent, change, change, parent) within one machine.

    cd <checkout> && python <path of this file> attention <checkout>
    cd <checkout> && python <path of this file> serve <checkout>
    cd <checkout> && python <path of this file> prefill <checkout>
    cd <checkout> && python <path of this file> decode <checkout>
    cd <checkout> && python <path of this file> parts <checkout>
    cd <checkout> && python <path of this file> int8 <checkout>
    cd <checkout> && python <path of this file> minner <checkout>
    cd <checkout> && python <path of this file> int4 <checkout>
    cd <checkout> && python <path of this file> a8 <checkout>
    cd <checkout> && python <path of this file> a8host <checkout>
    cd <checkout> && python <path of this file> sass <checkout> [<other checkout>]

Each runs the checkout's own package and its chip_smoke.py helpers (the
checkout goes first on sys.path; run this file by its path, not with -m,
so that the package is imported from the checkout), once per checkout.

- attention: the attention kernels at Llama-2-7B heads (B 8, 8 layers of
  KVH 32, HS 128, S 512; decode at positions 0..511; prefill T 256 from row
  256, and T 128 over pages of 128): K1, K1 int8, K5 int8, K6 int8 (pages
  of 128), K5, K4, K4 int8, K6, K7, and SDPA beside K1 and K5 and beside
  K6 (over [history rows | current row] with the same mask, the pages
  gathered beforehand); then K1 and SDPA with every slot at position 511 (the
  same bytes in every task, against the ragged positions' longest slot);
  the decode kernels and SDPA as CUDA-graph replays, each the least of
  three CUDA-event means (chip_smoke.cuda_ms). Then `layer_parts` on the
  bf16 cache and on the int8 one, and the port bench's decode (one CUDA
  graph) with `--kv bf16` (K23's bf16 phase), `--quant q4 --kv bf16` (K5)
  and `--quant none --kv bf16` (K1), in process.
- serve: a 7B-width Q8_0 model on the int8 KV cache (random weights from
  chip_smoke's seed): a decode step of 8 slots profiled (device time by
  kernel) with the fused layer (K23) and with the four-kernel layer,
  prefill chunks of T 16, 64 and 256 over 8 slots profiled, chip_smoke's
  16-request serve at batch 8, twice (tok/s, TTFT p50 and p95), then the
  port bench's default decode and its --mode ttft in process (the
  achievable bandwidth fixed by HIPLLAMA_ACHIEVABLE_BW where it is set).
- prefill: the Q8 products at prefill rows (reshape math, group size 64,
  7B widths): q8_matmul on QKV with the norm and RoPE, on wo and W2 with
  the residual, and q8_matmul_silu with the norm, at M 32, 128, 512, 2048
  and 4088 (whatever kernel the checkout routes them to), each the least of
  three CUDA-event means; the T-256 and T-16 chunks of the 7B-width Q8 +
  int8-KV model over 8 slots, profiled; then the port bench's default
  decode and its --mode ttft, in process, twice each (the achievable
  bandwidth fixed by HIPLLAMA_ACHIEVABLE_BW where it is set, so that no
  probe runs).
- decode: the Q8 products at decode rows (reshape math, group size 64, 7B
  widths) at every row count 1-16 of the GEMV route: q8_matmul on QKV with
  the norm and RoPE, on wo with the residual and on the classifier with the
  norm, q8_matmul_silu with the norm and q8_matmul_ffn; the int4 products
  (`dequant` math, group size 32): q4_matmul (K21) on QKV, wo, W2 (K 11008)
  and the classifier, q4_matmul_silu (K22); the `a8` products, Q8_0 group
  size 64 and int4 group size 32: QKV, wo and the gate, and K20's QKV on
  layer 1 of a stacked weight (the checkout's `a8` GEMV: dp4a or the int8
  tensor cores; where the checkout has ops/quant.py::a8_gemv_probe, the
  dp4a GEMV on the same QKV and gate inputs too); cuBLAS `x @ w` on bf16
  weights of each shape beside them; each the least of three CUDA-graph
  replays (chip_smoke.cuda_ms). With AB_TREES_OUT set to a directory, the
  `a8` outputs' SHA-1 are saved there and compared with every other
  checkout's (the inputs come from a fixed seed). Then `layer_parts` at B
  8 on an int8 cache; a decode step of 8 slots of the 7B-width int4 model
  (bf16 cache), of it in `a8`, and of the Q8 + int8-KV model in `a8`,
  profiled; and the port bench's --quant q4 decode in process.
- parts: `layer_parts` alone, then what one of K23's grid barriers costs
  (layer_fused.grid_barrier_probe, where the checkout has it).
- int8: the int8 decode kernels alone, as CUDA-graph replays, each the
  least of three CUDA-event means: K1, K5 and K6 int8 at the attention
  mode's shapes (one query head per KV head, blocks of 128), K5 int8 at 8
  query heads per KV head (B 8, KVH 4, S 1024: blocks of 1024) and over a
  block past a CTA's shared memory (S 6392: the JAX block is the whole
  cache); then `layer_parts`.
- minner: K19 at chip_smoke's phase-11 shapes (7B widths, Q8_0 group size
  64): q8_matmul_minner on wo M 2048 with the residual, q M 1024 with the
  norm and RoPE and W2 M 2048 with the residual, q8_matmul_silu_minner on
  the W1|W3 gate M 2048 with the norm, each between two timings of the
  K15/K17 tile on the same inputs (before and after K19, so that the order
  they run in does not decide the comparison), and K16 on wo M 2048 (32
  heads of 128); each the least of three CUDA-event means; then two T-256
  chunks of the 7B-width Q8 + int8-KV model over 8 slots profiled with
  HIPLLAMA_PREFILL_MINNER=1 and on the default route (device time by
  kernel); chip_smoke's 16-request serve of that model with both prefill
  knobs and on the default route (tok/s, TTFT p50 and p95); and the port
  bench's default decode and its --mode ttft, in process.
- int4: the int4 products at prefill rows (`dequant` math, group size 32,
  7B widths): q4_matmul (K21) on QKV with the norm and RoPE, on wo and W2
  with the residual, and q4_matmul_silu (K22) with the norm, at M 32, 128,
  512, 2048 and 4088 (whatever kernel the checkout routes them to), each
  the least of three CUDA-event means; the T-256 and T-16 chunks of the
  7B-width int4 model (bf16 cache) over 8 slots, profiled; then the port
  bench's --quant q4 --mode ttft in process, twice.
- a8: the Q8 products in `a8` math (HIPLLAMA_Q8_MODE=a8, group size 64,
  7B widths): q8_matmul (K15) on QKV with the norm and RoPE and on wo with
  the residual, and q8_matmul_silu (K17) with the norm, at M 8 (the GEMV),
  32, 128, 512, 2048 and 4088 (the tiles); the int4 products in `a8` math
  (HIPLLAMA_Q4_MODE=a8, group size 32): q4_matmul (K21) on QKV and wo as
  above and q4_matmul_silu (K22) with the norm at M 8 (the GEMV), 32, 64,
  128 and 256, and K21 on W2 (K 11008) with the residual at M 8, 32 and 64
  (the most rows `q4_a8_engages` gives each); each the least of three
  CUDA-event means;
  the T-256 and T-16 chunks of the 7B-width Q8 + int8-KV model over 8
  slots in `a8`, and the T-16 and T-32 chunks of the 7B-width int4 model
  (bf16 cache) over 8 slots in `a8`, profiled; chip_smoke's 16-request
  serve of the Q8 + int8-KV model in `a8`, twice (tok/s, TTFT p50 and
  p95). With AB_TREES_OUT set to a directory, each run saves its
  products' outputs there (the inputs come from a fixed seed; about 400 MB
  a checkout) and prints the largest absolute difference of each from
  every other checkout's saved outputs.
- a8host: the host's time to enqueue a decode step of the 7B-width Q8 +
  int8-KV model (batch 8, 10 steps, no synchronize inside, no profiler), in
  `a8` and in reshape math (the fused layer: the control for the host's own
  speed), 5 rounds taking the two in turns, unrolled and --layout stacked;
  the host's time per eager call of q8_matmul on QKV M 8 with the norm and
  RoPE (100 calls, no synchronize inside), in `a8` and reshape math;
  chip_smoke's 16-request serve of the unrolled model in `a8`, once.
- sass: csrc/quant.cu, quant4.cu, layer_fused.cu and attention.cu of the checkout
  compiled to cubins with `ptxas -v` (each kernel's registers, stack frame
  and spill bytes, and each noinline subroutine's stack frame and spill
  bytes, a line each); with another checkout, its cubins too,
  and the SASS of the two compared function by function (cuobjdump -sass;
  names normalized, addresses and encodings dropped): a line for each
  function that differs or is only in one tree, then a count; where a
  kernel differs, the same for each subroutine its cubin labels (nvdisasm:
  K23's noinline phases apart from its own code). It needs nvcc, not the
  card.
"""

from __future__ import annotations

import sys
import tempfile


def attention(cs) -> None:
    import torch
    import torch.nn.functional as F

    from hip_llama_tpu_torch.ops import attention as A
    from hip_llama_tpu_torch.ops import cache as C

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(*s, dtype=torch.bfloat16):
        return torch.randn(s, generator=g, device=dev, dtype=dtype)

    b, n_layers, kvh, h, s, hs, t = 8, 8, 32, 32, 512, 128, 256
    k, v = rnd(b, n_layers, kvh, s, hs), rnd(b, n_layers, kvh, s, hs)
    (k8, ks), (v8, vs) = (C.quantize_kv_rows(rnd(b, n_layers, kvh, s, hs, dtype=torch.float32))
                          for _ in range(2))
    pos = torch.tensor([0, 1, 100, 255, 256, 300, 450, s - 1], dtype=torch.int32, device=dev)
    qkv = rnd(b, h + 2 * kvh, hs)
    q, kc, vc = (x.contiguous() for x in (qkv[:, :h], qkv[:, h:h + kvh], qkv[:, h + kvh:]))
    full = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    qp = rnd(b, t, h, hs)
    start = torch.zeros(b, dtype=torch.int32, device=dev) + 256
    valid = torch.full((b,), t, dtype=torch.int32, device=dev)
    table = (torch.randperm(b * 4, generator=torch.Generator().manual_seed(1)).view(b, 4)
             .to(dev, torch.int32) + 1)
    kp, vp = rnd(n_layers, kvh, b * 4 + 1, 128, hs), rnd(n_layers, kvh, b * 4 + 1, 128, hs)
    (kp8, kps), (vp8, vps) = (C.quantize_kv_rows(x.float()) for x in (kp, vp))
    q7 = qp[:, :128].contiguous()

    def sdpa(kk, vv, p):
        """SDPA over [history rows | current row] of each layer with K1's
        mask at positions p, the rows (for pages: gathered) beforehand"""
        kf = [torch.cat([kk(l), kc[:, :, None]], dim=2) for l in range(n_layers)]
        vf = [torch.cat([vv(l), vc[:, :, None]], dim=2) for l in range(n_layers)]
        col = torch.arange(kf[0].shape[2], device=dev)
        mask = ((col[None, :] < p[:, None]) | (col[None, :] == col[-1]))[:, None, None, :]
        q4 = q[:, :, None, :]
        return lambda i: F.scaled_dot_product_attention(q4, kf[i % n_layers], vf[i % n_layers],
                                                        attn_mask=mask)

    dense = (lambda l: k[:, l], lambda l: v[:, l])
    paged = (lambda l: A.gather_pages(kp, table, l)[:, 0],
             lambda l: A.gather_pages(vp, table, l)[:, 0])
    cases = {
        "K1": lambda i: A.attention_decode(q, k, v, i % n_layers, pos, kc, vc),
        "K1 int8": lambda i: A.attention_decode(q, k8, v8, i % n_layers, pos, kc, vc, ks, vs),
        "K5 int8": lambda i: A.attention_decode_fused(qkv, k8, v8, i % n_layers, pos, h, ks, vs),
        "K6 int8": lambda i: A.attention_decode_paged(q, kp8, vp8, table, i % n_layers, pos, kc,
                                                      vc, kps, vps),
        "K5": lambda i: A.attention_decode_fused(qkv, k, v, i % n_layers, pos, h),
        "K4": lambda i: A.attention_prefill(qp, k, v, i % n_layers, start, valid),
        "K4 int8": lambda i: A.attention_prefill(qp, k8, v8, i % n_layers, start, valid, ks, vs),
        "K6": lambda i: A.attention_decode_paged(q, kp, vp, table, i % n_layers, pos, kc, vc),
        "K7": lambda i: A.attention_prefill_paged(q7, kp, vp, table, i % n_layers, start - 128,
                                                  valid // 2),
        "SDPA (K1, K5)": sdpa(*dense, pos),
        "SDPA on the gathered pages (K6)": sdpa(*paged, pos),
        "K1 at 511": lambda i: A.attention_decode(q, k, v, i % n_layers, full, kc, vc),
        "SDPA at 511": sdpa(*dense, full),
    }
    for name, fn in cases.items():
        fn(0)
        torch.cuda.synchronize()
        graph = not name.startswith(("K4", "K7"))  # decode: below its wrapper's host cost
        ms = [cs.cuda_ms(fn, graph=graph) for _ in range(3)]
        print(f"{name}: ms {min(ms):.4f} ({', '.join(f'{m:.4f}' for m in ms)})", flush=True)
    del cases, k, v, k8, v8, kp, vp, kp8, vp8
    torch.cuda.empty_cache()
    layer_parts(cs.cuda_ms, int8=False)
    layer_parts(cs.cuda_ms)
    bench_lines(cs, [["--kv", "bf16"], ["--quant", "q4", "--kv", "bf16"],
                     ["--quant", "none", "--kv", "bf16"]])


def int8(cs) -> None:
    import torch

    from hip_llama_tpu_torch.ops import attention as A
    from hip_llama_tpu_torch.ops import cache as C

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(*s, dtype=torch.bfloat16):
        return torch.randn(s, generator=g, device=dev, dtype=dtype)

    def int8_cache(*shape):
        return [x for _ in range(2) for x in C.quantize_kv_rows(rnd(*shape, dtype=torch.float32))]

    b, n_layers, h, hs = 8, 8, 32, 128
    k, ks, v, vs = int8_cache(b, n_layers, h, 512, hs)
    pos = torch.tensor([0, 1, 100, 255, 256, 300, 450, 511], dtype=torch.int32, device=dev)
    qkv = rnd(b, 3 * h, hs)
    q, kc, vc = (x.contiguous() for x in (qkv[:, :h], qkv[:, h:2 * h], qkv[:, 2 * h:]))
    table = (torch.randperm(b * 4, generator=torch.Generator().manual_seed(1)).view(b, 4)
             .to(dev, torch.int32) + 1)
    kp, kps, vp, vps = int8_cache(n_layers, h, b * 4 + 1, 128, hs)
    kvh8 = 4  # 8 query heads per KV head
    k8, ks8, v8, vs8 = int8_cache(b, n_layers, kvh8, 1024, hs)
    pos8 = torch.tensor([0, 1, 200, 511, 512, 700, 900, 1023], dtype=torch.int32, device=dev)
    qkv8 = rnd(b, h + 2 * kvh8, hs)
    kl, ksl, vl, vsl = int8_cache(b, 1, kvh8, 6392, hs)
    posl = pos8 * 6 + 200
    cases = {
        "K1 int8": lambda i: A.attention_decode(q, k, v, i % n_layers, pos, kc, vc, ks, vs),
        "K5 int8": lambda i: A.attention_decode_fused(qkv, k, v, i % n_layers, pos, h, ks, vs),
        "K6 int8": lambda i: A.attention_decode_paged(q, kp, vp, table, i % n_layers, pos, kc, vc,
                                                      kps, vps),
        "K5 int8 M8 S1024": lambda i: A.attention_decode_fused(qkv8, k8, v8, i % n_layers, pos8, h,
                                                               ks8, vs8),
        "K5 int8 M8 S6392": lambda i: A.attention_decode_fused(qkv8, kl, vl, 0, posl, h, ksl,
                                                               vsl),
    }
    for name, fn in cases.items():
        fn(0)
        torch.cuda.synchronize()
        ms = [cs.cuda_ms(fn, graph=True) for _ in range(3)]
        print(f"{name}: ms {min(ms):.4f} ({', '.join(f'{m:.4f}' for m in ms)})", flush=True)
    layer_parts(cs.cuda_ms)


def layer_parts(cuda_ms, b: int = 8, s: int = 512, rot: int = 8, int8: bool = True) -> None:
    """K23 on an int8 cache (or with `int8` False a bf16 one) at Llama-2-7B
    widths (b slots over rot layers of a cache of s rows, the layers and two
    weight copies rotating so that each call finds its weights and rows cold
    in L2) beside the standalone kernels of its phases on the same inputs:
    the QKV GEMV with the norm and RoPE, K5 on the same cache, the wo GEMV
    with the residual and K18 (norm, the gate product, W2 with the
    residual). K23 less their sum is what its barriers, its grid and its
    epilogue passes cost against the four-kernel layer's launches.
    CUDA-event means of CUDA-graph replays (cuda_ms: chip_smoke's; the
    device time, below the wrappers' host cost), the least of three; prints
    one `parts` line."""
    import torch

    from hip_llama_tpu_torch.ops import attention as A
    from hip_llama_tpu_torch.ops import cache as C
    from hip_llama_tpu_torch.ops import layer_fused as LF
    from hip_llama_tpu_torch.ops import quant as Q

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    d, hid, h, hs, gs = 4096, 11008, 32, 128, 64

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    def weights(k, n):
        return Q.q8_quantize_weights(rnd(k, n, dtype=torch.float32).mul_(k ** -0.5), gs)

    lw = [dict(wqkv=weights(d, 3 * d), wo=weights(d, d), w13=weights(d, 2 * hid),
               w2=weights(hid, d)) for _ in range(2)]
    if int8:
        (k8, ks), (v8, vs) = (C.quantize_kv_rows(rnd(b, rot, h, s, hs, dtype=torch.float32))
                              for _ in range(2))
        sc, kind = (ks, vs), "int8"
    else:
        k8, v8, sc, kind = rnd(b, rot, h, s, hs), rnd(b, rot, h, s, hs), (), "bf16"
    g1, g2 = ((1 + 0.1 * rnd(d, dtype=torch.float32)).contiguous() for _ in range(2))
    pos = (torch.arange(b, dtype=torch.int32, device=dev) * 61 + 17) % s
    x, x2 = rnd(b, d), rnd(b, d)
    qkv = rnd(b, 3 * h, hs)
    att = rnd(b, d)
    k23, k5 = f"K23 {kind}", f"K5 {kind}"
    cases = {
        k23: lambda i: LF.q8_layer_fused(
            x, lw[i % 2]["wqkv"], lw[i % 2]["wo"], lw[i % 2]["w13"], lw[i % 2]["w2"], g1, g2, k8,
            v8, i % rot, pos, *sc, n_heads=h),
        "QKV": lambda i: Q.q8_matmul(x, lw[i % 2]["wqkv"], norm_weight=g1, rope_pos=pos,
                                     rope_limit=2 * d, rope_head=hs),
        k5: lambda i: A.attention_decode_fused(qkv, k8, v8, i % rot, pos, h, *sc),
        "wo": lambda i: Q.q8_matmul(att, lw[i % 2]["wo"], residual=x),
        "K18": lambda i: Q.q8_matmul_ffn(x2, lw[i % 2]["w13"], lw[i % 2]["w2"], x2, g2),
    }
    ms = {}
    for name, fn in cases.items():
        fn(0)
        torch.cuda.synchronize()
        ms[name] = min(cuda_ms(fn, graph=True) for _ in range(3))
    parts = sum(v for n, v in ms.items() if n != k23)
    print(f"parts {k23} [B {b}, 7B layer, S {s}]: K23 {ms[k23]:.4f} ms; "
          + "; ".join(f"{n} {v:.4f}" for n, v in ms.items() if n != k23)
          + f"; sum of the parts {parts:.4f}; K23 - sum {ms[k23] - parts:+.4f} ms",
          flush=True)


def decode(cs) -> None:
    import glob
    import hashlib
    import json
    import os

    import torch

    from hip_llama_tpu_torch.engine import InferenceEngine
    from hip_llama_tpu_torch.models.llama import make_decode_step
    from hip_llama_tpu_torch.ops import quant as Q
    from hip_llama_tpu_torch.ops import quant4 as Q4

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    d, hid, voc, gs = 4096, 11008, 32000, 64

    def weights(k, n, copies=2, quantize=Q.q8_quantize_weights, gs=gs):
        return [quantize(torch.randn((k, n), generator=g, device=dev) * k ** -0.5, gs)
                for _ in range(copies)]

    def best(fn):
        fn(0)
        torch.cuda.synchronize()
        return min(cs.cuda_ms(fn, graph=True) for _ in range(3))

    wq, wo, w2, w13 = weights(d, 3 * d), weights(d, d), weights(hid, d), weights(d, 2 * hid)
    wc = weights(d, voc, 1)
    q4 = {name: weights(k, n, 1 if name == "classifier" else 2, Q4.q4_quantize_weights, 32)
          for name, (k, n) in (("QKV", (d, 3 * d)), ("wo", (d, d)), ("W2", (hid, d)),
                               ("K22", (d, 2 * hid)), ("classifier", (d, voc)))}
    norm = torch.ones(d, device=dev)
    # K20: layer 1 of a stacked QKV weight of two layers
    wl = Q.q8_quantize_weights(torch.randn((2, d, 3 * d), generator=g, device=dev) * d ** -0.5,
                               gs)
    norml = torch.ones(2, d, device=dev)
    probe = getattr(Q, "a8_gemv_probe", None)  # the dp4a GEMV beside the tensor cores'
    # the library yardstick: cuBLAS `x @ w` on bf16 weights of each shape
    lib = {name: [torch.randn((k, n), generator=g, device=dev).mul_(k ** -0.5)
                  .to(torch.bfloat16) for _ in range(2)]
           for name, (k, n) in (("QKV", (d, 3 * d)), ("wo", (d, d)), ("W2", (hid, d)),
                                ("gate", (d, 2 * hid)), ("classifier", (d, voc)))}
    hashes = {}
    for m in range(1, Q.GEMV_MAX_M + 1):
        x = torch.randn((m, d), generator=g, device=dev).to(torch.bfloat16)
        xh = torch.randn((m, hid), generator=g, device=dev).to(torch.bfloat16)
        pos = torch.arange(m, dtype=torch.int32, device=dev) * 31 % 512
        rope = dict(rope_pos=pos, rope_limit=2 * d, rope_head=128)
        cases = {
            "QKV": lambda i: Q.q8_matmul(x, wq[i % 2], norm_weight=norm, **rope),
            "wo": lambda i: Q.q8_matmul(x, wo[i % 2], residual=x),
            "K17": lambda i: Q.q8_matmul_silu(x, w13[i % 2], norm_weight=norm),
            "K18": lambda i: Q.q8_matmul_ffn(x, w13[i % 2], w2[i % 2], x, norm),
            "classifier": lambda i: Q.q8_matmul(x, wc[0], norm_weight=norm),
        }
        print(f"products M {m} (ms): "
              f"{'; '.join(f'{name} {best(fn):.4f}' for name, fn in cases.items())}", flush=True)
        cases = {name: (lambda i, w=w, xk=xh if name == "W2" else x: xk @ w[i % 2])
                 for name, w in lib.items()}
        print(f"cuBLAS M {m} (ms): "
              f"{'; '.join(f'{name} {best(fn):.4f}' for name, fn in cases.items())}", flush=True)
        cases = {
            "QKV": lambda i: Q4.q4_matmul(x, q4["QKV"][i % 2], norm_weight=norm, **rope),
            "wo": lambda i: Q4.q4_matmul(x, q4["wo"][i % 2], residual=x),
            "W2": lambda i: Q4.q4_matmul(xh, q4["W2"][i % 2], residual=x),
            "K22": lambda i: Q4.q4_matmul_silu(x, q4["K22"][i % 2], norm_weight=norm),
            "classifier": lambda i: Q4.q4_matmul(x, q4["classifier"][0], norm_weight=norm),
        }
        print(f"int4 products M {m} (ms): "
              f"{'; '.join(f'{name} {best(fn):.4f}' for name, fn in cases.items())}", flush=True)
        cases = {
            "QKV": lambda i: Q.q8_matmul(x, wq[i % 2], norm_weight=norm, mode="a8", **rope),
            "wo": lambda i: Q.q8_matmul(x, wo[i % 2], residual=x, mode="a8"),
            "K17": lambda i: Q.q8_matmul_silu(x, w13[i % 2], norm_weight=norm, mode="a8"),
            "int4 QKV": lambda i: Q4.q4_matmul(x, q4["QKV"][i % 2], norm_weight=norm, mode="a8",
                                               **rope),
            "int4 wo": lambda i: Q4.q4_matmul(x, q4["wo"][i % 2], residual=x, mode="a8"),
            "int4 K22": lambda i: Q4.q4_matmul_silu(x, q4["K22"][i % 2], norm_weight=norm,
                                                    mode="a8"),
            "K20 QKV": lambda i: Q.q8_matmul_layered(x, wl, 1, norm_weight=norml, mode="a8",
                                                     **rope),
        }
        row = []
        for name, fn in cases.items():
            out = fn(0)
            torch.cuda.synchronize()
            hashes[f"{name} M {m}"] = hashlib.sha1(out.view(torch.int16).cpu().numpy()
                                                   .tobytes()).hexdigest()
            row.append(f"{name} {best(fn):.4f}")
        print(f"a8 products M {m} (ms): {'; '.join(row)}", flush=True)
        if probe is not None:
            cases = {
                "QKV": lambda i: probe(x, wq[i % 2], False, 1, norm_weight=norm, **rope),
                "K17": lambda i: probe(x, w13[i % 2], True, 1, norm_weight=norm),
                "int4 QKV": lambda i: probe(x, q4["QKV"][i % 2], False, 1, norm_weight=norm,
                                            **rope),
                "int4 K22": lambda i: probe(x, q4["K22"][i % 2], True, 1, norm_weight=norm),
            }
            print(f"a8 dp4a GEMV M {m} (ms): "
                  f"{'; '.join(f'{name} {best(fn):.4f}' for name, fn in cases.items())}",
                  flush=True)
    del wq, wo, w2, w13, wc, q4, wl, lib
    torch.cuda.empty_cache()
    save = os.environ.get("AB_TREES_OUT")
    if save:
        os.makedirs(save, exist_ok=True)
        tag = hashlib.sha1(os.path.abspath(sys.path[0]).encode()).hexdigest()[:8]
        for other in sorted(glob.glob(os.path.join(save, "decode_a8_*.json"))):
            if other.endswith(f"decode_a8_{tag}.json"):
                continue
            with open(other) as f:
                theirs = json.load(f)
            differ = [k for k, v in hashes.items() if theirs.get(k) != v]
            print(f"a8 decode outputs against {os.path.basename(other)}: {len(hashes) - len(differ)}"
                  f" of {len(hashes)} identical{'; differ: ' + ', '.join(differ) if differ else ''}",
                  flush=True)
        with open(os.path.join(save, f"decode_a8_{tag}.json"), "w") as f:
            json.dump(hashes, f)
    layer_parts(cs.cuda_ms)

    cfg = cs.LLAMA2_7B
    tok = torch.tensor([5, 17, 300, 1000, 42, 7, 99, 12345], dtype=torch.int32, device=dev)
    pos0 = torch.tensor([100, 17, 255, 3, 200, 60, 128, 250], dtype=torch.int32, device=dev)
    for int4, kv_quant, runs in ((True, False, (("int4", {}), ("int4 a8", {"HIPLLAMA_Q4_MODE": "a8"}))),
                                 (False, True, (("q8 int8-kv a8", {"HIPLLAMA_Q8_MODE": "a8"}),))):
        params = cs.random_7b_qparams(cfg, dev, int4=int4)
        cache = InferenceEngine(cfg, params, None, batch_size=8, max_seq_len=512,
                                kv_quant=kv_quant).new_cache()
        for label, env in runs:
            with cs.knobs(env):
                step = make_decode_step(cfg)
            cs.profile_window(f"{label} decode step (batch 8)", 4,
                              lambda i, step=step: step(params, cache, tok, pos0 + i))
        del params, cache
        torch.cuda.empty_cache()
    bench_lines(cs, [["--quant", "q4"]])


def parts(cs) -> None:
    """`layer_parts` at B 8 on an int8 cache, then, where the checkout has
    the probe (layer_fused.grid_barrier_probe), one of K23's grid barriers
    on its grid of 264 CTAs: CUDA-event means of 64 and of 0 barriers a
    launch, each the least of three, their difference over 64."""
    import torch

    from hip_llama_tpu_torch.ops import layer_fused as LF

    layer_parts(cs.cuda_ms)
    if hasattr(LF, "grid_barrier_probe"):
        dev = torch.device("cuda")
        ms = {}
        for n in (0, 64):
            fn = lambda i, n=n: LF.grid_barrier_probe(n, 264, dev)  # noqa: E731
            fn(0)
            torch.cuda.synchronize()
            ms[n] = min(cs.cuda_ms(fn) for _ in range(3))
        print(f"barrier [264 CTAs]: {(ms[64] - ms[0]) / 64 * 1e3:.3f} us a barrier "
              f"(launch of 0 barriers {ms[0] * 1e3:.3f} us, of 64 {ms[64] * 1e3:.3f} us)",
              flush=True)


def bench_lines(cs, runs=([], ["--mode", "ttft"])) -> None:
    """The port bench's runs (default: its decode and its --mode ttft), in
    process."""
    import contextlib
    import io

    import torch

    for argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cs.port_bench.main(argv)
        print(f"bench {' '.join(argv) or '(defaults)'}: {buf.getvalue().strip()}", flush=True)
        torch.cuda.empty_cache()


def serve(cs) -> None:
    import os

    import numpy as np
    import torch

    from hip_llama_tpu_torch.engine import InferenceEngine, Requests
    from hip_llama_tpu_torch.models.llama import make_decode_step
    from hip_llama_tpu_torch.sampler import Sampler

    dev = torch.device("cuda")
    cfg = cs.LLAMA2_7B
    params = cs.random_7b_qparams(cfg, dev)
    with tempfile.TemporaryDirectory() as tmp:
        tok = cs.llama_sized_tokenizer(tmp, cfg.vocab_size)
    engine = InferenceEngine(cfg, params, tok, batch_size=8, max_seq_len=512, kv_quant=True)
    cache = engine.new_cache()
    toks = np.random.default_rng(5).integers(3, cfg.vocab_size, (8, 256)).tolist()
    tok_t = torch.tensor([t[-1] for t in toks], dtype=torch.int32, device=dev)
    pos0 = torch.tensor([100, 17, 255, 3, 200, 60, 128, 250], dtype=torch.int32, device=dev)
    step = make_decode_step(cfg)
    cs.profile_window("q8 int8-kv decode step (batch 8)", 4,
                      lambda i: step(params, cache, tok_t, pos0 + i))
    os.environ["HIPLLAMA_LAYER_FUSE"] = "0"
    try:
        four = make_decode_step(cfg)
    finally:
        del os.environ["HIPLLAMA_LAYER_FUSE"]
    cs.profile_window("q8 int8-kv decode step, four-kernel layer (batch 8)", 4,
                      lambda i: four(params, cache, tok_t, pos0 + i))
    for t in (16, 64, 256):
        cs.profile_window(f"q8 int8-kv prefill chunk (batch 8, T {t})", 4 if t < 256 else 2,
                          lambda i, t=t: engine._prefill_tokens(
                              cache, 8, {s: toks[s][:t] for s in range(8)},
                              {s: 0 for s in range(8)}, bm=None))
    targets = [300, 20, 150, 60, 280, 100, 30, 200, 266, 14, 90, 300, 40, 180, 25, 120]
    prompts = cs.make_prompts(tok, targets)
    for rep in range(2):
        engine = InferenceEngine(cfg, params, tok, batch_size=8, max_seq_len=512, kv_quant=True)
        req = Requests(prompts=prompts, generations=[""] * len(prompts))
        stats: dict = {}
        engine.serve(req, steps=352, stats=stats,
                     samplers=[Sampler(cfg.vocab_size, temperature=0.0) for _ in prompts])
        print(f"serve {rep}: {stats['tok_per_s']:.2f} tok/s, ttft p50 "
              f"{stats['ttft_p50_s'] * 1e3:.1f} ms, p95 {stats['ttft_p95_s'] * 1e3:.1f} ms",
              flush=True)
    del engine, cache, params
    torch.cuda.empty_cache()
    bench_lines(cs)


def prefill_products(cs, label: str, quantize, gs: int, matmul, gate, gate_name: str) -> None:
    """The products of a prefill chunk at 7B widths: matmul on QKV with the
    norm and RoPE, on wo and W2 with the residual, and gate with the norm,
    at M 32, 128, 512, 2048 and 4088, weights from quantize(w, gs) rotating
    over two copies; each the least of three CUDA-event means."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    d, hid = 4096, 11008

    def weights(k, n):
        return [quantize(torch.randn((k, n), generator=g, device=dev) * k ** -0.5, gs)
                for _ in range(2)]

    wq, wo, w2, w13 = weights(d, 3 * d), weights(d, d), weights(hid, d), weights(d, 2 * hid)
    norm = torch.ones(d, device=dev)
    for m in (32, 128, 512, 2048, 4088):
        x = torch.randn((m, d), generator=g, device=dev).to(torch.bfloat16)
        xh = torch.randn((m, hid), generator=g, device=dev).to(torch.bfloat16)
        pos = torch.arange(m, dtype=torch.int32, device=dev) % 512
        cases = {
            "QKV": lambda i: matmul(x, wq[i % 2], norm_weight=norm, rope_pos=pos,
                                    rope_limit=2 * d, rope_head=128),
            "wo": lambda i: matmul(x, wo[i % 2], residual=x),
            "W2": lambda i: matmul(xh, w2[i % 2], residual=x),
            gate_name: lambda i: gate(x, w13[i % 2], norm_weight=norm),
        }
        row = []
        for name, fn in cases.items():
            fn(0)
            torch.cuda.synchronize()
            row.append(f"{name} {min(cs.cuda_ms(fn) for _ in range(3)):.4f}")
        print(f"{label}products M {m} (ms): {'; '.join(row)}", flush=True)
    del wq, wo, w2, w13
    torch.cuda.empty_cache()


def prefill(cs) -> None:
    import numpy as np
    import torch

    from hip_llama_tpu_torch.engine import InferenceEngine
    from hip_llama_tpu_torch.ops import quant as Q

    dev = torch.device("cuda")
    prefill_products(cs, "", Q.q8_quantize_weights, 64, Q.q8_matmul, Q.q8_matmul_silu, "K17")

    cfg = cs.LLAMA2_7B
    params = cs.random_7b_qparams(cfg, dev)
    engine = InferenceEngine(cfg, params, None, batch_size=8, max_seq_len=512, kv_quant=True)
    cache = engine.new_cache()
    toks = np.random.default_rng(5).integers(3, cfg.vocab_size, (8, 256)).tolist()
    for t in (256, 16):
        cs.profile_window(f"q8 int8-kv prefill chunk (batch 8, T {t})", 2 if t > 16 else 4,
                          lambda i, t=t: engine._prefill_tokens(
                              cache, 8, {s: toks[s][:t] for s in range(8)},
                              {s: 0 for s in range(8)}, bm=None))
    del engine, cache, params
    torch.cuda.empty_cache()
    for _ in range(2):
        bench_lines(cs)


def minner(cs) -> None:
    import numpy as np
    import torch

    from hip_llama_tpu_torch.engine import InferenceEngine, Requests
    from hip_llama_tpu_torch.ops import quant as Q
    from hip_llama_tpu_torch.sampler import Sampler

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    d, hid, gs, m, mq = 4096, 11008, 64, 2048, 1024

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    def weights(k, n):
        return [Q.q8_quantize_weights(rnd(k, n, dtype=torch.float32).mul_(k ** -0.5), gs)
                for _ in range(2)]

    wo, w2, w13 = weights(d, d), weights(hid, d), weights(d, 2 * hid)
    x, res, xq, xh = rnd(m, d), rnd(m, d), rnd(mq, d), rnd(m, hid)
    norm = (1 + 0.1 * rnd(d, dtype=torch.float32)).contiguous()
    rope = dict(rope_pos=torch.arange(mq, dtype=torch.int32, device=dev) % 512, rope_limit=d,
                rope_head=128, rope_theta=10000.0)
    cases = {
        f"wo M {m}, residual": (
            lambda i: Q.q8_matmul_minner(x, wo[i % 2], residual=res),
            lambda i: Q.q8_matmul(x, wo[i % 2], residual=res)),
        f"q M {mq}, norm + RoPE": (
            lambda i: Q.q8_matmul_minner(xq, wo[i % 2], norm_weight=norm, **rope),
            lambda i: Q.q8_matmul(xq, wo[i % 2], norm_weight=norm, **rope)),
        f"W2 M {m}, residual": (
            lambda i: Q.q8_matmul_minner(xh, w2[i % 2], residual=res),
            lambda i: Q.q8_matmul(xh, w2[i % 2], residual=res)),
        f"gate M {m}, norm": (
            lambda i: Q.q8_matmul_silu_minner(x, w13[i % 2], norm_weight=norm),
            lambda i: Q.q8_matmul_silu(x, w13[i % 2], norm_weight=norm)),
    }

    def best(fn):
        fn(0)
        torch.cuda.synchronize()
        return min(cs.cuda_ms(fn) for _ in range(3))

    for label, (k19, tile) in cases.items():
        before = best(tile)
        print(f"minner {label} (ms): tile {before:.4f}; K19 {best(k19):.4f}; tile again "
              f"{best(tile):.4f}", flush=True)
    x3 = x.view(m, 32, 128)
    print(f"minner K16 wo M {m}, 32 heads (ms): "
          f"{best(lambda i: Q.q8_matmul_xheads(x3, wo[i % 2], residual=res)):.4f}", flush=True)
    del wo, w2, w13, x, res, xq, xh
    torch.cuda.empty_cache()

    cfg = cs.LLAMA2_7B
    params = cs.random_7b_qparams(cfg, dev)
    toks = np.random.default_rng(5).integers(3, cfg.vocab_size, (8, 256)).tolist()
    for env in ({"HIPLLAMA_PREFILL_MINNER": "1"}, {}):
        with cs.knobs(env):
            engine = InferenceEngine(cfg, params, None, batch_size=8, max_seq_len=512,
                                     kv_quant=True)
        cache = engine.new_cache()
        cs.profile_window(f"q8 int8-kv prefill chunk with {env} (batch 8, T 256)", 2,
                          lambda i: engine._prefill_tokens(cache, 8, {s: toks[s] for s in
                                                                      range(8)},
                                                           {s: 0 for s in range(8)}))
        del engine, cache
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tok = cs.llama_sized_tokenizer(tmp, cfg.vocab_size)
    targets = [300, 20, 150, 60, 280, 100, 30, 200, 266, 14, 90, 300, 40, 180, 25, 120]
    prompts = cs.make_prompts(tok, targets)
    for env in (cs.PREFILL_KNOBS, {}):
        with cs.knobs(env):
            engine = InferenceEngine(cfg, params, tok, batch_size=8, max_seq_len=512,
                                     kv_quant=True)
            stats: dict = {}
            engine.serve(Requests(prompts=prompts, generations=[""] * len(prompts)), steps=352,
                         stats=stats,
                         samplers=[Sampler(cfg.vocab_size, temperature=0.0) for _ in prompts])
        print(f"serve with {env}: {stats['tok_per_s']:.2f} tok/s, ttft p50 "
              f"{stats['ttft_p50_s'] * 1e3:.1f} ms, p95 {stats['ttft_p95_s'] * 1e3:.1f} ms",
              flush=True)
        del engine
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    bench_lines(cs)


def int4(cs) -> None:
    import numpy as np
    import torch

    from hip_llama_tpu_torch.engine import InferenceEngine
    from hip_llama_tpu_torch.ops import quant4 as Q4

    dev = torch.device("cuda")
    prefill_products(cs, "int4 ", Q4.q4_quantize_weights, 32, Q4.q4_matmul, Q4.q4_matmul_silu,
                     "K22")

    cfg = cs.LLAMA2_7B
    params = cs.random_7b_qparams(cfg, dev, int4=True)
    engine = InferenceEngine(cfg, params, None, batch_size=8, max_seq_len=512)
    cache = engine.new_cache()
    toks = np.random.default_rng(5).integers(3, cfg.vocab_size, (8, 256)).tolist()
    for t in (256, 16):
        cs.profile_window(f"int4 prefill chunk (batch 8, T {t})", 2 if t > 16 else 4,
                          lambda i, t=t: engine._prefill_tokens(
                              cache, 8, {s: toks[s][:t] for s in range(8)},
                              {s: 0 for s in range(8)}, bm=None))
    del engine, cache, params
    torch.cuda.empty_cache()
    bench_lines(cs, [["--quant", "q4", "--mode", "ttft"]] * 2)


def a8(cs) -> None:
    import glob
    import hashlib
    import os

    import numpy as np
    import torch

    from hip_llama_tpu_torch.engine import InferenceEngine, Requests
    from hip_llama_tpu_torch.ops import quant as Q
    from hip_llama_tpu_torch.ops import quant4 as Q4
    from hip_llama_tpu_torch.sampler import Sampler

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    d, hid = 4096, 11008

    def weights(k, n):
        return [Q.q8_quantize_weights(torch.randn((k, n), generator=g, device=dev) * k ** -0.5, 64)
                for _ in range(2)]

    wq, wo, w13 = weights(d, 3 * d), weights(d, d), weights(d, 2 * hid)
    norm = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).contiguous()
    outs = {}
    for m in (8, 32, 128, 512, 2048, 4088):
        x = torch.randn((m, d), generator=g, device=dev).to(torch.bfloat16)
        pos = torch.arange(m, dtype=torch.int32, device=dev) % 512
        cases = {
            "QKV": lambda i: Q.q8_matmul(x, wq[i % 2], norm_weight=norm, rope_pos=pos,
                                         rope_limit=2 * d, rope_head=128, mode="a8"),
            "wo": lambda i: Q.q8_matmul(x, wo[i % 2], residual=x, mode="a8"),
            "K17": lambda i: Q.q8_matmul_silu(x, w13[i % 2], norm_weight=norm, mode="a8"),
        }
        row = []
        for name, fn in cases.items():
            outs[f"{name} M {m}"] = fn(0).cpu()
            torch.cuda.synchronize()
            row.append(f"{name} {min(cs.cuda_ms(fn) for _ in range(3)):.4f}")
        print(f"a8 products M {m} (ms): {'; '.join(row)}", flush=True)
    del wq, wo, w13
    torch.cuda.empty_cache()
    q4w = {name: [Q4.q4_quantize_weights(torch.randn((k, n), generator=g, device=dev)
                                         * k ** -0.5, 32) for _ in range(2)]
           for name, (k, n) in (("QKV", (d, 3 * d)), ("wo", (d, d)), ("K22", (d, 2 * hid)),
                                ("W2", (hid, d)))}
    for m in (8, 32, 64, 128, 256):
        x = torch.randn((m, d), generator=g, device=dev).to(torch.bfloat16)
        x2 = torch.randn((m, hid), generator=g, device=dev).to(torch.bfloat16)
        pos = torch.arange(m, dtype=torch.int32, device=dev) % 512
        cases = {
            "int4 QKV": lambda i: Q4.q4_matmul(x, q4w["QKV"][i % 2], norm_weight=norm,
                                               rope_pos=pos, rope_limit=2 * d, rope_head=128,
                                               mode="a8"),
            "int4 wo": lambda i: Q4.q4_matmul(x, q4w["wo"][i % 2], residual=x, mode="a8"),
            "int4 K22": lambda i: Q4.q4_matmul_silu(x, q4w["K22"][i % 2], norm_weight=norm,
                                                    mode="a8"),
        }
        if m <= 64:
            cases["int4 W2"] = lambda i: Q4.q4_matmul(x2, q4w["W2"][i % 2], residual=x,
                                                      mode="a8")
        row = []
        for name, fn in cases.items():
            outs[f"{name} M {m}"] = fn(0).cpu()
            torch.cuda.synchronize()
            row.append(f"{name} {min(cs.cuda_ms(fn) for _ in range(3)):.4f}")
        print(f"a8 products M {m} (ms): {'; '.join(row)}", flush=True)
    del q4w
    torch.cuda.empty_cache()
    save = os.environ.get("AB_TREES_OUT")
    if save:
        os.makedirs(save, exist_ok=True)
        tag = hashlib.sha1(os.path.abspath(sys.path[0]).encode()).hexdigest()[:8]
        for other in sorted(glob.glob(os.path.join(save, "a8_*.pt"))):
            if other.endswith(f"a8_{tag}.pt"):
                continue
            theirs = torch.load(other)
            diffs = [f"{k} {(v.float() - theirs[k].float()).abs().max().item():g}"
                     for k, v in outs.items()]
            print(f"a8 max |difference| from {os.path.basename(other)}: {'; '.join(diffs)}",
                  flush=True)
        torch.save(outs, os.path.join(save, f"a8_{tag}.pt"))

    cfg = cs.LLAMA2_7B
    params = cs.random_7b_qparams(cfg, dev)
    toks = np.random.default_rng(5).integers(3, cfg.vocab_size, (8, 256)).tolist()
    with cs.knobs({"HIPLLAMA_Q8_MODE": "a8"}):
        engine = InferenceEngine(cfg, params, None, batch_size=8, max_seq_len=512,
                                 kv_quant=True)
        cache = engine.new_cache()
        for t in (256, 16):
            cs.profile_window(f"q8 int8-kv a8 prefill chunk (batch 8, T {t})",
                              2 if t > 16 else 4,
                              lambda i, t=t: engine._prefill_tokens(
                                  cache, 8, {s: toks[s][:t] for s in range(8)},
                                  {s: 0 for s in range(8)}, bm=None))
        del engine, cache
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            tok = cs.llama_sized_tokenizer(tmp, cfg.vocab_size)
        targets = [300, 20, 150, 60, 280, 100, 30, 200, 266, 14, 90, 300, 40, 180, 25, 120]
        prompts = cs.make_prompts(tok, targets)
        for rep in range(2):
            engine = InferenceEngine(cfg, params, tok, batch_size=8, max_seq_len=512,
                                     kv_quant=True)
            stats: dict = {}
            engine.serve(Requests(prompts=prompts, generations=[""] * len(prompts)), steps=352,
                         stats=stats,
                         samplers=[Sampler(cfg.vocab_size, temperature=0.0) for _ in prompts])
            print(f"a8 serve {rep}: {stats['tok_per_s']:.2f} tok/s, ttft p50 "
                  f"{stats['ttft_p50_s'] * 1e3:.1f} ms, p95 {stats['ttft_p95_s'] * 1e3:.1f} ms",
                  flush=True)
            del engine
            torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    params = cs.random_7b_qparams(cfg, dev, int4=True)
    with cs.knobs({"HIPLLAMA_Q4_MODE": "a8"}):
        engine = InferenceEngine(cfg, params, None, batch_size=8, max_seq_len=512)
        engine.prefill_buckets = (16, 32)  # a T-32 chunk: 256 rows, `a8` at K 4096
        cache = engine.new_cache()
        for t in (16, 32):
            cs.profile_window(f"int4 a8 prefill chunk (batch 8, T {t})", 4,
                              lambda i, t=t: engine._prefill_tokens(
                                  cache, 8, {s: toks[s][:t] for s in range(8)},
                                  {s: 0 for s in range(8)}, bm=None))
        del engine, cache
    del params
    torch.cuda.empty_cache()


def a8host(cs) -> None:
    import time

    import torch

    from hip_llama_tpu_torch.engine import InferenceEngine, Requests
    from hip_llama_tpu_torch.models.llama import make_decode_step
    from hip_llama_tpu_torch.ops import quant as Q
    from hip_llama_tpu_torch.sampler import Sampler

    dev = torch.device("cuda")
    cfg = cs.LLAMA2_7B
    tok_t = torch.tensor([11, 200, 3000, 7, 42, 999, 31000, 5], dtype=torch.int32, device=dev)
    pos0 = torch.tensor([100, 17, 255, 3, 200, 60, 128, 250], dtype=torch.int32, device=dev)

    def enqueue_ms(fn, n: int) -> str:
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return f"{(t1 - t0) / n * 1e3:.3f}"

    g = torch.Generator(device=dev).manual_seed(7)
    w = Q.q8_quantize_weights(torch.randn((4096, 3 * 4096), generator=g, device=dev)
                              * 4096 ** -0.5, 64)
    x = torch.randn((8, 4096), generator=g, device=dev).to(torch.bfloat16)
    norm = torch.ones(4096, device=dev)
    calls = {mode: [] for mode in ("a8", "reshape")}
    for _ in range(5):
        for mode, ts in calls.items():
            ts.append(enqueue_ms(lambda i, mode=mode: Q.q8_matmul(
                x, w, norm_weight=norm, rope_pos=pos0, rope_limit=2 * 4096, rope_head=128,
                mode=mode), 100))
    for mode, ts in calls.items():
        print(f"a8host q8_matmul QKV M 8 in {mode}: host ms a call, 5 rounds of 100: "
              f"{', '.join(ts)}", flush=True)
    del w
    for stacked in (False, True):
        params = cs.random_7b_qparams(cfg, dev, stacked=stacked)
        engine = InferenceEngine(cfg, params, None, batch_size=8, max_seq_len=512,
                                 kv_quant=True)
        cache = engine.new_cache()
        steps = {"reshape": make_decode_step(cfg)}
        with cs.knobs({"HIPLLAMA_Q8_MODE": "a8"}):
            steps["a8"] = make_decode_step(cfg)
        times = {name: [] for name in steps}
        for _ in range(5):
            for name, step in steps.items():
                times[name].append(enqueue_ms(
                    lambda i, step=step: step(params, cache, tok_t, pos0 + i), 10))
        layout = "stacked" if stacked else "unrolled"
        for name, ts in times.items():
            print(f"a8host {layout} decode step in {name} (batch 8): host enqueue ms a step, "
                  f"5 rounds of 10: {', '.join(ts)}", flush=True)
        del engine, cache, steps
        torch.cuda.empty_cache()
        if not stacked:
            with tempfile.TemporaryDirectory() as tmp:
                tok = cs.llama_sized_tokenizer(tmp, cfg.vocab_size)
            targets = [300, 20, 150, 60, 280, 100, 30, 200, 266, 14, 90, 300, 40, 180, 25, 120]
            prompts = cs.make_prompts(tok, targets)
            with cs.knobs({"HIPLLAMA_Q8_MODE": "a8"}):
                engine = InferenceEngine(cfg, params, tok, batch_size=8, max_seq_len=512,
                                         kv_quant=True)
                stats: dict = {}
                engine.serve(Requests(prompts=prompts, generations=[""] * len(prompts)),
                             steps=352, stats=stats,
                             samplers=[Sampler(cfg.vocab_size, temperature=0.0)
                                       for _ in prompts])
            print(f"a8host a8 serve: {stats['tok_per_s']:.2f} tok/s, ttft p50 "
                  f"{stats['ttft_p50_s'] * 1e3:.1f} ms, p95 {stats['ttft_p95_s'] * 1e3:.1f} ms",
                  flush=True)
            del engine
        del params
        torch.cuda.empty_cache()


# the sources whose kernels the sass mode compiles and compares: the
# products', the fused layer's (K23, which inlines q8.cuh's GEMV) and the
# attention kernels' (the decode tasks of decode_attention.cuh)
SASS_SOURCES = ("quant", "quant4", "layer_fused", "attention")


def _sass(cubin: str) -> dict[str, list[str]]:
    """The SASS of each function of a cubin, its name and lines normalized."""
    import os
    import re
    import subprocess

    from hip_llama_tpu_torch.ops import _build

    anon = r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}"
    out = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
                          cubin], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(anon, "_GLOBAL__N_", m.group(1))
            funcs[name] = []
        elif name is not None:
            line = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line)
            line = re.sub(anon, "_GLOBAL__N_", line).strip()
            if line:
                funcs[name].append(line)
    return funcs


def _subroutines(cubin: str) -> dict[str, list[str]]:
    """The SASS of each function symbol of a cubin as nvdisasm labels them:
    a kernel's own code apart from each noinline device function it calls
    (K23's phases), names and lines normalized, branch labels renumbered
    within each function."""
    import os
    import re
    import subprocess

    from hip_llama_tpu_torch.ops import _build

    # the file's anonymous namespace and internal-linkage prefixes, which
    # carry hashes of the source
    anon = r"_(GLOBAL__N_|INTERNAL)_[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}"
    out = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "nvdisasm"), "-c",
                          cubin], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        # a kernel's label, or a subroutine's: $<kernel>$<function>
        m = re.match(r"(\$?_Z\S*|\$__internal\S*):\s*$", line)
        if m:
            name = re.sub(anon, r"_\1_", m.group(1))
            funcs[name] = []
            continue
        line = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
        if name is None or not line or (line.startswith(".") and not line.startswith(".L_x")):
            continue
        funcs[name].append(re.sub(anon, r"_\1_", line))
    for lines in funcs.values():
        labels: dict[str, str] = {}
        for i, line in enumerate(lines):
            lines[i] = re.sub(r"\.L_x_\d+",
                              lambda m: labels.setdefault(m.group(0), f".L{len(labels)}"), line)
    return funcs


def sass(this: str, other: str | None) -> None:
    import os
    import re
    import shutil
    import subprocess

    from hip_llama_tpu_torch.ops import _build

    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "sass")
    os.makedirs(out_dir, exist_ok=True)
    trees = [("this", this)] + ([("other", other)] if other else [])
    procs = {}
    for src in SASS_SOURCES:
        for tag, root in trees:
            cubin = os.path.join(out_dir, f"{src}_{tag}.cubin")
            cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-cubin", "-o", cubin,
                   os.path.join(root, "hip_llama_tpu_torch", "csrc", f"{src}.cu")]
            if tag == "this":
                cmd[1:1] = ["-Xptxas", "-v"]
            procs[(src, tag)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True), cubin)
    filt = shutil.which("cu++filt") or os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    for (src, tag), (p, cubin) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {src}.cu ({tag}):\n{log}")
        if tag != "this":
            continue
        def demangle(sym):
            if not os.path.exists(filt):
                return sym
            return subprocess.run([filt, sym], capture_output=True, text=True).stdout.strip()

        # each kernel's line, then one for each subroutine it calls (ptxas
        # lists their properties after the kernel's)
        name, kernel, sub, frame = None, "", None, ("?", "?", "?")
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = kernel = demangle(m.group(1))
            m = re.search(r"Function properties for (\S+)", line)
            if m and name is None:
                sub = re.sub(r"_INTERNAL_\w+::|\(anonymous namespace\)::", "",
                             demangle(m.group(1)))
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and name:
                frame = m.groups()
            elif m and sub:
                print(f"ptxas {src}.cu: subroutine, stack {m.group(1)} B, spill stores "
                      f"{m.group(2)} B, loads {m.group(3)} B: {sub[:110]} in {kernel[:70]}",
                      flush=True)
                sub = None
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                print(f"ptxas {src}.cu: {m.group(1)} registers, stack {frame[0]} B, spill "
                      f"stores {frame[1]} B, loads {frame[2]} B: {name[:160]}", flush=True)
                name = None
    if other is None:
        return
    for src in SASS_SOURCES:
        a, b = (_sass(procs[(src, tag)][1]) for tag in ("other", "this"))
        same = 0
        for n in sorted(set(a) | set(b)):
            if n not in a or n not in b:
                print(f"sass {src}.cu: only in {'the other' if n in a else 'this'} tree: "
                      f"{n[:110]}")
            elif a[n] == b[n]:
                same += 1
            else:
                print(f"sass {src}.cu: differs ({len(a[n])} vs {len(b[n])} lines): {n[:110]}")
        print(f"sass {src}.cu: {same} of {len(set(a) & set(b))} functions in both trees "
              f"identical", flush=True)
        if same == len(set(a) & set(b)):
            continue
        # a kernel that differs: which of its subroutines do
        try:
            a, b = (_subroutines(procs[(src, tag)][1]) for tag in ("other", "this"))
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"sass {src}.cu: nvdisasm not run ({e})")
            continue
        differ = sorted(n for n in set(a) & set(b) if a[n] != b[n])
        for n in differ + sorted(set(a) ^ set(b)):
            where = "differs" if n in differ else f"only in {'the other' if n in a else 'this'} tree"
            print(f"sass {src}.cu: subroutine {where}: {n[:110]}")
        print(f"sass {src}.cu: {len(set(a) & set(b)) - len(differ)} of {len(set(a) & set(b))} "
              f"functions and subroutines in both trees identical (nvdisasm)", flush=True)


def main(argv: list[str]) -> int:
    modes = {"attention": attention, "serve": serve, "prefill": prefill, "decode": decode,
             "parts": parts, "int8": int8, "minner": minner, "int4": int4, "a8": a8,
             "a8host": a8host}
    if argv[1:2] == ["sass"] and len(argv) in (3, 4):
        sys.path.insert(0, argv[2])
        sass(argv[2], argv[3] if len(argv) == 4 else None)
        return 0
    if len(argv) != 3 or argv[1] not in modes:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, argv[2])
    import torch

    if not torch.cuda.is_available():
        print("ab_trees: this needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    print(f"checkout {argv[2]}: {cs.card_line()}", flush=True)
    modes[argv[1]](cs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

"""CLI with the reference's flag contract (src/llama.cpp:1490-1639), serving
the dense path, the Q8_0 weight path (v2 checkpoints, --quant q8; unrolled
or --layout stacked) or the int4 weight path (v4 checkpoints, --quant q4),
on a bf16/fp32 or (--kv int8) int8 KV cache, dense or paged (--paged), on a
CUDA card (or the CPU with --device cpu):

  python -m hip_llama_tpu_torch.run <checkpoint> [options]
  python -m hip_llama_tpu_torch.run model.bin -n 256 -i "Once upon a time"
  python -m hip_llama_tpu_torch.run model.bin -m test -f <input_file> -o <output_file>

Options (single-dash single-letter, like the reference):
  -t <float>  temperature (default 1.0)
  -p <float>  top-p (default 0.9)
  -s <int>    RNG seed (default time)
  -n <int>    steps (default 256; 0 = max_seq_len)
  -i <str>    prompt
  -z <str>    tokenizer path (default ./assets/tokenizer.bin)
  -m <str>    mode: generate|test (default generate)
  -f <str>    input file (test mode)
  -o <str>    output file (test mode)
  -b <int>    batch size (default 1; test mode continuous-batching slots)
Extra (double-dash):
  --dtype float32|bfloat16   param/compute dtype (default bfloat16; the
                             Q8_0 path computes in bf16 whatever it says)
  --quant q8|q4              quantize a v0/v1 fp32 checkpoint at load to
                             Q8_0 (group size 64) or int4 (group size 32,
                             the embedding Q8_0); v2 files are Q8_0 and v4
                             files int4 whatever it says
  --dequant                  serve a v2 or v4 checkpoint through the dense
                             path (its weights dequantized at load)
  --device cuda|cpu          where the model runs (default cuda)
  --kv int8                  int8 KV cache with one fp32 scale per row
  --paged [page_size]        paged KV cache (default page size 128): a pool
                             of pages handed out per request, so KV memory
                             follows the tokens in flight; prefill runs in
                             chunks of one page
  --prefix-cache             identical prompt prefixes share KV pages and
                             skip their prefill (implies --paged)
  --layout unrolled|stacked  Q8_0 weight layout (default unrolled): stacked
                             keeps each weight one (L, K, N) array that the
                             decode kernels address by layer; int4 falls
                             back to unrolled with a note, and dense params
                             and --paged ignore it
  --chunk N                  multi-step scheduling: decode N tokens per
                             dispatch with sampling on the device (greedy
                             is the host argmax; stochastic draws from a
                             torch.Generator seeded with -s, not the JAX
                             PRNG). Slots retiring mid-chunk waste the chunk
                             tail; saves N-1 host round trips a chunk
  --device-sampling          sample on the card (4 bytes a slot fetched per
                             step instead of the logits; greedy is the host
                             argmax, stochastic as --chunk, not the
                             reference RNG stream); ignored with --paged
  --spec K [--draft path]    speculative decoding: a draft model (or
                             prompt-lookup n-gram matching without --draft)
                             proposes K tokens, the target verifies them in
                             one chunked prefill (-t 0 gives the greedy
                             stream, -t > 0 distribution-preserving
                             rejection sampling). In -m test mode slots
                             speculate by prompt lookup, or by one batched
                             draft chain a round with --draft. It uses the
                             contiguous cache and ignores --paged, and in
                             test mode --chunk and --device-sampling
  --no-prefill               force-feed prompts one token/step (parity mode)
  --rope-theta F             RoPE base override (.bin headers can't carry it)
  --no-eos-stop              test mode stops on BOS only (run.cc parity)
Environment: HIPLLAMA_Q8_MODE=a8 (w8a8) and HIPLLAMA_Q4_MODE=a8 (w4a8)
serve the Q8 and int4 products in the reference int8 engine's arithmetic,
as the JAX package does; their other values exit "not yet ported".
HIPLLAMA_KV_COMMIT=0 commits each decode step's KV rows with four writes
(each plane, each scale plane) instead of one, as the JAX package does; the
cache holds the same values.
HIPLLAMA_PREFILL_MINNER=1 runs the Q8 prefill's large products (above 512
rows) with each weight tile dequantized once per call, and
HIPLLAMA_PREFILL_XHEADS=1 runs the Q8 prefill's wo on the attention output
head by head (head sizes that are a multiple of 128), where the JAX package
does; HIPLLAMA_PREFILL_HEADS=0 as there. Both are off by default.
The JAX CLI's other flags (--tp, --pp, --sp, --replicas, --stream,
--attn, -y, ...) and chat mode are not yet ported: they exit with an error.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from hip_llama_tpu_torch.engine import InferenceEngine, read_inputfile, write_outputfile
from hip_llama_tpu_torch.engine.speculative import speculative_generate
from hip_llama_tpu_torch.io.checkpoint import Q4Weights, QuantWeights, load_checkpoint
from hip_llama_tpu_torch.models.llama import dequant_modes
from hip_llama_tpu_torch.models.params import (
    params_from_q4_dequant,
    params_from_quant_dequant,
    params_from_weights,
    qparams_from_q4_weights,
    qparams_from_quant_weights,
    quantize_params_q4,
    quantize_params_q8,
    resolve_device,
)
from hip_llama_tpu_torch.sampler import Sampler
from hip_llama_tpu_torch.tokenizer import Tokenizer

_VALUE_FLAGS = ("-t", "-p", "-s", "-n", "-i", "-z", "-m", "-f", "-o", "-b",
                "--dtype", "--device", "--rope-theta", "--quant", "--kv", "--layout",
                "--chunk", "--spec", "--draft")
_SWITCHES = ("--no-prefill", "--no-eos-stop", "--dequant", "--prefix-cache",
             "--device-sampling")
_INT_FLAGS = ("--chunk", "--spec")  # "needs an int" (run.py:172-200 of the JAX CLI)


def error_usage():
    print(__doc__, file=sys.stderr)
    sys.exit(1)


def main(argv: list[str]) -> int:
    total_start = time.perf_counter()
    if len(argv) < 2:
        error_usage()
    checkpoint_path = argv[1]
    opts: dict[str, str] = {}
    switches: set[str] = set()
    i = 2
    while i < len(argv):
        a = argv[i]
        if a in _SWITCHES:
            switches.add(a)
            i += 1
        elif a == "--paged":
            # the page size is optional (run.py:134-140 of the JAX CLI)
            switches.add(a)
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                opts[a] = argv[i + 1]
                i += 1
            i += 1
        elif a in _INT_FLAGS and (i + 1 >= len(argv) or not argv[i + 1].isdigit()):
            print(f"{a} needs an int", file=sys.stderr)
            return 1
        elif a in _VALUE_FLAGS:
            if i + 1 >= len(argv):
                error_usage()
            opts[a] = argv[i + 1]
            i += 2
        elif a.startswith("-"):
            print(f"{a}: not yet ported to hip_llama_tpu_torch", file=sys.stderr)
            return 2
        else:
            error_usage()

    temperature = max(float(opts.get("-t", 1.0)), 0.0)
    topp = float(opts.get("-p", 0.9))
    if topp < 0.0 or topp > 1.0:
        topp = 0.9
    rng_seed = int(opts.get("-s", 0))
    if rng_seed <= 0:
        rng_seed = int(time.time())
    steps = max(int(opts.get("-n", 256)), 0)
    batch = int(opts.get("-b", 1))
    mode = opts.get("-m", "generate")
    if mode not in ("generate", "test"):
        print(f"-m {mode}: not yet ported to hip_llama_tpu_torch", file=sys.stderr)
        return 2
    quant = opts.get("--quant")
    if quant not in (None, "q8", "q4"):
        print(f"--quant {quant}: not yet ported to hip_llama_tpu_torch", file=sys.stderr)
        return 2
    try:
        dequant_modes()
    except NotImplementedError as e:
        print(e, file=sys.stderr)
        return 2
    if opts.get("--kv", "int8") != "int8":
        print("--kv supports: int8", file=sys.stderr)
        return 1
    paged = "--paged" in switches
    prefix_cache = "--prefix-cache" in switches
    chunk_steps = int(opts.get("--chunk", 1))
    spec_k = int(opts.get("--spec", 0))
    device_sampling = "--device-sampling" in switches
    # the JAX CLI's notes and drops, in its order (run.py:253-301)
    if spec_k > 0 and paged:
        # the speculative verify prefills at starts that are not page-aligned
        print("note: --spec uses the contiguous KV cache; ignoring --paged"
              + (" and --prefix-cache" if prefix_cache else ""), file=sys.stderr)
        paged = prefix_cache = False
    if mode == "test" and spec_k > 0 and (chunk_steps > 1 or device_sampling):
        print("note: --spec is its own dispatch schedule; ignoring --chunk/--device-sampling",
              file=sys.stderr)
        chunk_steps, device_sampling = 1, False
    if prefix_cache and not paged:
        print("note: --prefix-cache implies --paged", file=sys.stderr)
        paged = True
    if device_sampling and paged:
        print("note: --device-sampling drives the contiguous cache; ignoring it with --paged",
              file=sys.stderr)
        device_sampling = False
    page_size = int(opts.get("--paged", 128))
    layout = opts.get("--layout", "unrolled")
    if layout not in ("unrolled", "stacked"):
        print(f"--layout {layout}: takes unrolled or stacked", file=sys.stderr)
        return 1
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[opts.get("--dtype", "bfloat16")]
    device = resolve_device(opts.get("--device", "cuda"))

    cfg, weights = load_checkpoint(checkpoint_path)
    if "--rope-theta" in opts:
        # the llama2.c .bin headers can't carry the RoPE base
        cfg = dataclasses.replace(cfg, rope_theta=float(opts["--rope-theta"]))
    dequant = "--dequant" in switches
    q4 = (isinstance(weights, Q4Weights) and not dequant) or (
        quant == "q4" and not isinstance(weights, (QuantWeights, Q4Weights)))
    if layout == "stacked" and q4 and not paged:
        # the stacked decode path drives q8_matmul_layered, which has no
        # int4 counterpart (the JAX CLI's note, run.py:419-431)
        print("note: --layout stacked supports int8 only; using unrolled for int4",
              file=sys.stderr)
    # the stacked layout is a Q8_0 decode layout: paged steps run their own
    stacked = layout == "stacked" and not paged
    if isinstance(weights, QuantWeights):
        params = (params_from_quant_dequant(cfg, weights, dtype=dtype, device=device) if dequant
                  else qparams_from_quant_weights(cfg, weights, device=device, stacked=stacked))
    elif isinstance(weights, Q4Weights):
        params = (params_from_q4_dequant(cfg, weights, dtype=dtype, device=device) if dequant
                  else qparams_from_q4_weights(cfg, weights, device=device))
    elif quant == "q8":
        params = quantize_params_q8(cfg, weights, device=device, stacked=stacked)
    elif quant == "q4":
        params = quantize_params_q4(cfg, weights, device=device)
    else:
        params = params_from_weights(weights, dtype=dtype, device=device)
    print(
        f"---------Model Information----------\n"
        f"dim: {cfg.dim}\nhidden_dim: {cfg.hidden_dim}\nn_layers: {cfg.n_layers}\n"
        f"n_heads: {cfg.n_heads}\nn_kv_heads: {cfg.n_kv_heads}\n"
        f"vocab_size: {cfg.vocab_size}\nseq_len: {cfg.seq_len}\n"
        f"------------------------------------"
    )
    if steps == 0 or steps > cfg.seq_len:
        steps = cfg.seq_len
    tokenizer = Tokenizer.from_file(opts.get("-z", "./assets/tokenizer.bin"), cfg.vocab_size)
    use_prefill = "--no-prefill" not in switches
    engine = InferenceEngine(
        cfg, params, tokenizer, batch_size=batch,
        use_prefill=use_prefill, kv_quant="--kv" in opts,
        paged=paged, page_size=page_size, prefix_cache=prefix_cache,
        device_sampling=device_sampling, ds_temperature=temperature, ds_topp=topp,
        ds_seed=rng_seed, chunk_steps=chunk_steps,
        spec_lookup=spec_k if mode == "test" else 0,
    )

    def load_draft_engine(path: str, batch_n: int) -> InferenceEngine:
        """The draft model of --spec (run.py:597-615 of the JAX CLI): its
        own checkpoint, on the target's device and tokenizer."""
        d_cfg, d_weights = load_checkpoint(path)
        if isinstance(d_weights, Q4Weights):
            d_params = qparams_from_q4_weights(d_cfg, d_weights, device=device)
        elif isinstance(d_weights, QuantWeights):
            d_params = qparams_from_quant_weights(d_cfg, d_weights, device=device)
        else:
            d_params = params_from_weights(d_weights, dtype=dtype, device=device)
        return InferenceEngine(d_cfg, d_params, tokenizer, batch_size=batch_n,
                               use_prefill=use_prefill)

    draft_path = opts.get("--draft")
    if mode == "generate" and spec_k > 0:
        # greedy prefix match at -t 0, rejection sampling above; without
        # --draft the proposals come from prompt lookup
        draft_engine = load_draft_engine(draft_path, 1) if draft_path else None
        res, spec_stats = speculative_generate(
            engine, draft_engine, opts.get("-i"), steps, k=spec_k, echo=True,
            temperature=temperature, topp=topp, seed=rng_seed,
        )
        print()
        print(f"speculative: k={spec_k}, rounds={spec_stats.rounds}, "
              f"acceptance={spec_stats.acceptance:.2f}", file=sys.stderr)
        if res.n_gen_tokens > 0:
            print(
                f"achieved tok/s: {res.tok_per_s:.2f}, ttft: {res.ttft_s*1000:.1f} ms",
                file=sys.stderr,
            )
    elif mode == "generate":
        sampler = Sampler(cfg.vocab_size, temperature, topp, rng_seed)
        res = engine.generate(opts.get("-i"), steps, sampler, echo=True)
        print()
        if res.n_gen_tokens > 0:
            print(
                f"achieved tok/s: {res.tok_per_s:.2f}, ttft: {res.ttft_s*1000:.1f} ms",
                file=sys.stderr,
            )
    else:
        if "-f" not in opts or "-o" not in opts:
            error_usage()
        requests = read_inputfile(opts["-f"])
        samplers = None
        if temperature == 0.0:
            # extension: -t 0 in test mode serves the corpus greedily
            samplers = [Sampler(cfg.vocab_size, 0.0) for _ in requests.prompts]
        draft_engine = load_draft_engine(draft_path, batch) if spec_k > 0 and draft_path else None
        start = time.perf_counter()
        stats: dict = {}
        num_gen_tokens = engine.serve(
            requests, steps=cfg.seq_len, samplers=samplers, verbose=True,
            stats=stats, stop_on_eos="--no-eos-stop" not in switches, draft=draft_engine,
        )
        end = time.perf_counter()
        print(f"Total achieved token: {num_gen_tokens}")
        print(
            f"elapsed time(s): {end-start:.6f}, "
            f"achieved throughput(tok/s): {num_gen_tokens/(end-start):.6f}"
        )
        if stats.get("ttft_p50_s") is not None:
            print(
                f"ttft p50: {stats['ttft_p50_s']*1000:.1f} ms, "
                f"p95: {stats['ttft_p95_s']*1000:.1f} ms, "
                f"max: {stats['ttft_max_s']*1000:.1f} ms",
                file=sys.stderr,
            )
        if stats.get("spec_proposed"):
            print(f"speculative: k={spec_k}, proposed={stats['spec_proposed']}, "
                  f"acceptance={stats['spec_accepted'] / stats['spec_proposed']:.2f}",
                  file=sys.stderr)
        if stats.get("prefix_hit_tokens"):
            print(f"prefix cache: {stats['prefix_hit_tokens']} prompt tokens served from shared "
                  "pages", file=sys.stderr)
        write_outputfile(opts["-o"], requests)

    print(f"total elapsed time(s): {time.perf_counter()-total_start:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

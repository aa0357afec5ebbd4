"""CLI with the reference's flag contract (src/llama.cpp:1490-1639), serving
the dense path, the Q8_0 weight path (v2 checkpoints, --quant q8) or the
int4 weight path (v4 checkpoints, --quant q4), on a bf16/fp32 or (--kv int8)
int8 KV cache, on a CUDA card (or the CPU with --device cpu):

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
  --no-prefill               force-feed prompts one token/step (parity mode)
  --rope-theta F             RoPE base override (.bin headers can't carry it)
  --no-eos-stop              test mode stops on BOS only (run.cc parity)
The JAX CLI's other flags (--paged, --tp, --spec, --layout, --stream, ...)
and chat mode are not yet ported: they exit with an error.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from hip_llama_tpu_torch.engine import InferenceEngine, read_inputfile, write_outputfile
from hip_llama_tpu_torch.io.checkpoint import Q4Weights, QuantWeights, load_checkpoint
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
                "--dtype", "--device", "--rope-theta", "--quant", "--kv")
_SWITCHES = ("--no-prefill", "--no-eos-stop", "--dequant")


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
    if opts.get("--kv", "int8") != "int8":
        print("--kv supports: int8", file=sys.stderr)
        return 1
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[opts.get("--dtype", "bfloat16")]
    device = resolve_device(opts.get("--device", "cuda"))

    cfg, weights = load_checkpoint(checkpoint_path)
    if "--rope-theta" in opts:
        # the llama2.c .bin headers can't carry the RoPE base
        cfg = dataclasses.replace(cfg, rope_theta=float(opts["--rope-theta"]))
    dequant = "--dequant" in switches
    if isinstance(weights, QuantWeights):
        params = (params_from_quant_dequant(cfg, weights, dtype=dtype, device=device) if dequant
                  else qparams_from_quant_weights(cfg, weights, device=device))
    elif isinstance(weights, Q4Weights):
        params = (params_from_q4_dequant(cfg, weights, dtype=dtype, device=device) if dequant
                  else qparams_from_q4_weights(cfg, weights, device=device))
    elif quant == "q8":
        params = quantize_params_q8(cfg, weights, device=device)
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
    engine = InferenceEngine(
        cfg, params, tokenizer, batch_size=batch,
        use_prefill="--no-prefill" not in switches, kv_quant="--kv" in opts,
    )

    if mode == "generate":
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
        start = time.perf_counter()
        stats: dict = {}
        num_gen_tokens = engine.serve(
            requests, steps=cfg.seq_len, samplers=samplers, verbose=True,
            stats=stats, stop_on_eos="--no-eos-stop" not in switches,
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
        write_outputfile(opts["-o"], requests)

    print(f"total elapsed time(s): {time.perf_counter()-total_start:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

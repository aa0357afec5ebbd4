"""The port's model, engine and CLI on an int8 KV cache against the JAX
package's: make_decode_step and make_prefill with dense fp32 params (K1,
K2, K3, K12, K4 int8 branches) and with Q8_0 params (K23 or the four-kernel
layer with K5), at 4 KV heads (the JAX cache pads them to 8; the port
keeps 4, so its cache is compared on the logical heads) and at 8; the
engine's greedy serve; the CLI's --kv flag. Tolerances:

- dense fp32: logits at atol = rtol = 1e-2. The int8 cache holds the same
  rows quantized by the same formula, but an fp32 ulp of a row (its
  products summed in another order) can move a value across a .5 rounding
  boundary, and one int8 step of one element moves that row's score by
  about 1e-2 (|q_d| times the row's scale) and the logits of the layers
  after it by up to a few 1e-3 (observed: 2.2e-3); prefill attention also
  rounds its probabilities (p * vs) to bf16 for fp32 activations
  (attention.py:934).
- Q8: logits at atol 0.15, rtol 0.05, as tests/test_torch_model.py's Q8
  cases (bf16 activations rounded after fp32 sums taken in another order).
- caches, on the logical heads: the scales within 3e-2 relative (a row's
  absmax moves with its values: a bf16 ulp is up to 0.8%); at most
  1% of the int8 values differ (at most one step in the dense fp32 cache,
  where only rounding boundaries differ; up to three in the Q8 cache,
  where a bf16 ulp of a row is about half an int8 step and what differs in
  one layer feeds the rows of the next).
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.config import tiny_config
from hip_llama_tpu.io.checkpoint import random_weights
from hip_llama_tpu.models import init_kv_cache as jax_init_kv_cache
from hip_llama_tpu.models import make_decode_step as jax_make_decode_step
from hip_llama_tpu.models import make_prefill as jax_make_prefill
from hip_llama_tpu.models import params_from_weights as jax_params_from_weights
from hip_llama_tpu.models.params import quantize_params_q8, unstack_quant_params
from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.models import (
    init_kv_cache,
    make_decode_step,
    make_prefill,
    params_from_jax_numpy,
    qparams_from_jax_numpy,
)

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

F32_TOL = dict(atol=1e-2, rtol=1e-2)
Q8_TOL = dict(atol=0.15, rtol=0.05)
def _dense(kvh):
    cfg_j = tiny_config(n_layers=3, n_kv_heads=kvh, seq_len=96)
    jp = jax_params_from_weights(random_weights(cfg_j, seed=kvh))
    pp = params_from_jax_numpy({f: np.asarray(getattr(jp, f)) for f in jp._fields}, device="cpu")
    return cfg_j, ModelConfig(**vars(cfg_j)), jp, pp, "highest", torch.float32


def _q8(kvh):
    cfg_j = tiny_config(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=kvh,
                        seq_len=96)
    jp = unstack_quant_params(quantize_params_q8(cfg_j, random_weights(cfg_j, seed=10 + kvh),
                                                 group_size=32))
    pp = qparams_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp)._asdict(), device="cpu")
    return cfg_j, ModelConfig(**vars(cfg_j)), jp, pp, "default", torch.bfloat16


# (make, logit tolerance, int8 steps a cached value may differ by)
MODELS = {"dense fp32": (_dense, F32_TOL, 1), "q8": (_q8, Q8_TOL, 3)}


def _close_cache(jc, pc, kvh, steps, msg):
    """The int8 planes and scales of both caches on the logical heads."""
    for plane in ("k", "v"):
        a = np.asarray(getattr(jc, plane))[:, :, :kvh].astype(np.int32)
        b = getattr(pc, plane).numpy().astype(np.int32)
        assert np.abs(a - b).max() <= steps and (a != b).mean() < 0.01, (
            f"{msg} {plane}: {(a != b).sum()} values differ, by up to {np.abs(a - b).max()}")
        sa = np.asarray(getattr(jc, f"{plane}_scale"))[:, :, :kvh]
        assert_close(getattr(pc, f"{plane}_scale").numpy(), sa, atol=0, rtol=3e-2,
                     msg=f"{msg} {plane}_scale")


@pytest.mark.parametrize("kvh", [4, 8])
@pytest.mark.parametrize("model", ["dense fp32", "q8"])
def test_decode_steps_int8_match_jax(model, kvh, monkeypatch):
    make, tol, steps_tol = MODELS[model]
    cfg_j, cfg, jp, pp, precision, _ = make(kvh)
    b = 3
    rng = np.random.default_rng(31)
    jstep = jax.jit(jax_make_decode_step(cfg_j, attn_impl="pallas", precision=precision))
    steps = {"fused": make_decode_step(cfg)}
    monkeypatch.setenv("HIPLLAMA_LAYER_FUSE", "0")
    steps["four-kernel"] = make_decode_step(cfg)
    jc = jax_init_kv_cache(cfg_j, b, quantized=True)
    assert jc.k.shape[2] == 8  # the JAX cache pads 4 KV heads to 8
    pcs = {k: init_kv_cache(cfg, b, device="cpu", quantized=True) for k in steps}
    for i in range(5):
        tokens = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        pos = np.array([i, i + 2, 3 * i], np.int32)  # ragged slots, one at pos 0
        jl, jc = jstep(jp, jc, jnp.asarray(tokens), jnp.asarray(pos))
        outs = {k: step(pp, pcs[k], torch.from_numpy(tokens), torch.from_numpy(pos))[0]
                for k, step in steps.items()}
        for k, pl in outs.items():
            assert pl.dtype == torch.float32 and pl.shape == (b, cfg.vocab_size)
            assert_close(pl.numpy(), np.asarray(jl), **tol, msg=f"{k} step {i}")
        assert torch.equal(outs["fused"], outs["four-kernel"])
    _close_cache(jc, pcs["fused"], kvh, steps_tol, "after 5 steps")
    assert all(torch.equal(getattr(pcs["fused"], f), getattr(pcs["four-kernel"], f))
               for f in ("k", "v", "k_scale", "v_scale"))


@pytest.mark.parametrize("kvh", [4, 8])
@pytest.mark.parametrize("model", ["dense fp32", "q8"])
def test_prefill_then_decode_int8_matches_jax(model, kvh):
    make, tol, steps_tol = MODELS[model]
    cfg_j, cfg, jp, pp, precision, _ = make(kvh)
    b, t = 3, 16
    rng = np.random.default_rng(32)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    # a fresh prompt, a bystander (valid 0), a second chunk
    start, valid = np.array([0, 5, 16], np.int32), np.array([16, 0, 9], np.int32)
    jpre = jax.jit(jax_make_prefill(cfg_j, attn_impl="pallas", precision=precision))
    jc = jax_init_kv_cache(cfg_j, b, quantized=True)
    pc = init_kv_cache(cfg, b, device="cpu", quantized=True)
    first = np.zeros_like(tokens)
    first[2] = rng.integers(0, cfg.vocab_size, t)
    v0, z = np.array([0, 0, 16], np.int32), np.zeros(b, np.int32)
    _, jc = jpre(jp, jc, jnp.asarray(first), jnp.asarray(z), jnp.asarray(v0))
    make_prefill(cfg)(pp, pc, torch.from_numpy(first), torch.from_numpy(z), torch.from_numpy(v0))
    jl, jc = jpre(jp, jc, jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(valid))
    pl, pc = make_prefill(cfg)(pp, pc, torch.from_numpy(tokens), torch.from_numpy(start),
                               torch.from_numpy(valid))
    for i in range(b):
        if valid[i]:
            assert_close(pl.numpy()[i, : valid[i]], np.asarray(jl)[i, : valid[i]], **tol,
                         msg=f"prefill slot {i}")
    _close_cache(jc, pc, kvh, steps_tol, "after prefill")
    # the bystander's rows and scales are untouched
    assert not pc.k[1].any() and (pc.k_scale[1] == 1).all()

    jstep = jax.jit(jax_make_decode_step(cfg_j, attn_impl="pallas", precision=precision))
    pstep = make_decode_step(cfg)
    pos = start + valid
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos + i))
        pl, pc = pstep(pp, pc, torch.from_numpy(tok), torch.from_numpy(pos + i))
        assert_close(pl.numpy(), np.asarray(jl), **tol, msg=f"decode {i}")
    _close_cache(jc, pc, kvh, steps_tol, "after decode")


def test_int8_cache_layout():
    cfg = ModelConfig(**vars(tiny_config(n_kv_heads=4)))
    c = init_kv_cache(cfg, 2, dtype=torch.bfloat16, seq_len=32, device="cpu", quantized=True)
    assert c.quantized and c.k.dtype == c.v.dtype == torch.int8
    assert c.k.shape == (2, cfg.n_layers, 4, 32, cfg.head_size)  # no head padding
    assert c.k_scale.shape == c.v_scale.shape == (2, cfg.n_layers, 4, 32)
    assert (c.k_scale == 1).all() and not c.k.any()
    assert not init_kv_cache(cfg, 2, seq_len=32, device="cpu").quantized


# ---------------------------------------------------------------------------
# the engine and the CLI


def test_greedy_serve_int8_matches_jax_engine(tiny_cfg, tiny_weights, toy_tokenizer):
    from hip_llama_tpu.engine import InferenceEngine as JaxEngine
    from hip_llama_tpu.engine import Requests as JaxRequests
    from hip_llama_tpu.sampler import Sampler as JaxSampler
    from hip_llama_tpu_torch.engine import InferenceEngine, Requests
    from hip_llama_tpu_torch.sampler import Sampler
    from hip_llama_tpu_torch.tokenizer import Tokenizer

    prompts = ["hello", "hell hello hello", "", "he", " hello hello hello hello hello", "ol"]
    jp = jax_params_from_weights(tiny_weights)
    pp = params_from_jax_numpy({f: np.asarray(getattr(jp, f)) for f in jp._fields}, device="cpu")
    jeng = JaxEngine(tiny_cfg, jp, toy_tokenizer, batch_size=2, attn_impl="pallas",
                     kv_quant=True)
    jreq = JaxRequests(prompts=list(prompts), generations=[""] * len(prompts))
    jn = jeng.serve(jreq, steps=40, samplers=[JaxSampler(tiny_cfg.vocab_size, 0.0)
                                              for _ in prompts])
    eng = InferenceEngine(tiny_cfg, pp, Tokenizer(toy_tokenizer.vocab, toy_tokenizer.scores),
                          batch_size=2, kv_quant=True)
    assert eng.new_cache().quantized
    req = Requests(prompts=list(prompts), generations=[""] * len(prompts))
    n = eng.serve(req, steps=40, samplers=[Sampler(tiny_cfg.vocab_size, 0.0) for _ in prompts])
    assert (n, req.generations) == (jn, jreq.generations)


def test_cli_kv_flag(tmp_path, capsys):
    from hip_llama_tpu_torch import run as port_run

    model = "assets/golden/model.bin"
    tok = "assets/golden/tokenizer.bin"
    assert port_run.main(["run", model, "-z", tok, "--kv", "fp8", "--device", "cpu"]) == 1
    assert "--kv supports: int8" in capsys.readouterr().err
    inp = tmp_path / "in.txt"
    inp.write_text("2\nLong ago\nOnce upon a time\n")
    out = tmp_path / "out.txt"
    with redirect_stdout(io.StringIO()):
        rc = port_run.main(["run", model, "-z", tok, "-m", "test", "-f", str(inp), "-o", str(out),
                            "-b", "2", "-t", "0.0", "--kv", "int8", "--device", "cpu"])
    assert rc == 0 and out.read_text().startswith("2\nLong ago")


# near-tie bound of the Q8 fork check: the fixture's Q8 logits are bf16
# values of magnitude 2 to 8 (ulps of 0.0156 to 0.03), and the port's
# differ from the JAX package's by up to two ulps where a k or v element
# rounded to a neighbouring int8 value (module docstring)
NEAR_TIE = 0.1


def test_q8_int8_serve_forks_from_jax_only_at_near_ties():
    """The golden fixture with --quant q8 --kv int8, greedy at -b 4, served
    by the JAX engine and the port's side by side on one corpus: every
    prefill and decode step sees the same tokens and gives logits within
    Q8_TOL until the first step where a slot's greedy token differs, and
    there the JAX logits' top-2 gap is a near-tie. (Scored against the
    goldens instead, 33 of the 40 requests of the five corpora are
    byte-identical: each fork at a near-tie, so the bar of 3 corpora with
    no fork among the scorer's first four requests is not met on the CPU;
    tests/test_torch_goldens.py asserts the average bar.)"""
    from hip_llama_tpu.engine import InferenceEngine as JaxEngine
    from hip_llama_tpu.engine import Requests as JaxRequests
    from hip_llama_tpu.io.checkpoint import load_checkpoint as jax_load
    from hip_llama_tpu.models.params import pad_kv_head_params
    from hip_llama_tpu.sampler import Sampler as JaxSampler
    from hip_llama_tpu.tokenizer import Tokenizer as JaxTokenizer
    from hip_llama_tpu_torch.engine import InferenceEngine, Requests, read_inputfile
    from hip_llama_tpu_torch.sampler import Sampler
    from hip_llama_tpu_torch.tokenizer import Tokenizer

    cfg_j, w = jax_load("assets/golden/model.bin")
    jp = pad_kv_head_params(unstack_quant_params(quantize_params_q8(cfg_j, w, group_size=64)),
                            cfg_j)
    pp = qparams_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp)._asdict(), device="cpu")
    cfg = ModelConfig(**vars(cfg_j))
    prompts = read_inputfile("assets/in/gen_in_8.txt").prompts
    log = {"jax": [], "port": []}
    jeng = JaxEngine(cfg_j, jp, JaxTokenizer.from_file("assets/golden/tokenizer.bin",
                                                       cfg.vocab_size),
                     batch_size=4, attn_impl="pallas", precision="default", kv_quant=True)
    peng = InferenceEngine(cfg, pp, Tokenizer.from_file("assets/golden/tokenizer.bin",
                                                        cfg.vocab_size),
                           batch_size=4, kv_quant=True)
    for name, eng in (("jax", jeng), ("port", peng)):
        step, prefill = eng._do_step, eng._prefill_tokens

        def logged_step(cache, tokens, pos, *a, _step=step, _log=log[name], **kw):
            logits, cache = _step(cache, tokens, pos, *a, **kw)
            _log.append(((np.asarray(tokens).tolist(), np.asarray(pos).tolist()),
                         np.asarray(logits)))
            return logits, cache

        def logged_prefill(cache, batch, slot_tokens, slot_start, *a, _pf=prefill,
                           _log=log[name], **kw):
            logits, cache = _pf(cache, batch, slot_tokens, slot_start, *a, **kw)
            if logits is not None:
                _log.append(((sorted(slot_tokens.items()), sorted(slot_start.items())),
                             np.asarray(logits)))
            return logits, cache

        eng._do_step, eng._prefill_tokens = logged_step, logged_prefill
    jreq = JaxRequests(prompts=list(prompts), generations=[""] * len(prompts))
    jeng.serve(jreq, steps=cfg.seq_len, samplers=[JaxSampler(cfg.vocab_size, 0.0)
                                                  for _ in prompts])
    req = Requests(prompts=list(prompts), generations=[""] * len(prompts))
    peng.serve(req, steps=cfg.seq_len, samplers=[Sampler(cfg.vocab_size, 0.0) for _ in prompts])
    # slot by slot: a slot is compared while both engines feed it the same
    # input; it leaves the comparison at its first fork, which must be at a
    # near-tie, and the comparison ends where the schedules part
    forked, compared = set(), 0
    for (jin, jl), (pin, pl) in zip(log["jax"], log["port"]):
        if len(jin) != len(pin) or len(jin[0]) != len(pin[0]) or jl.shape != pl.shape:
            break
        if isinstance(jin[0][0], tuple):  # a prefill: (slot, tokens) pairs
            same = [s for (s, a), (s2, b) in zip(jin[0], pin[0]) if s == s2 and a == b
                    and dict(jin[1])[s] == dict(pin[1])[s]]
        else:
            same = [s for s in range(len(jin[0]))
                    if (jin[0][s], jin[1][s]) == (pin[0][s], pin[1][s])]
        for s in same:
            if s in forked:
                continue
            assert_close(pl[s], jl[s], **Q8_TOL, msg=f"slot {s}")
            compared += 1
            if jl[s].argmax() != pl[s].argmax():
                top2 = np.sort(jl[s])[-2:]
                assert top2[1] - top2[0] <= NEAR_TIE, f"slot {s} forks at a gap of {top2}"
                forked.add(s)
        if len(forked) == 4:
            break
    assert compared > 100, compared

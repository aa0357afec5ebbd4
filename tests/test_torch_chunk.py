"""Multi-step scheduling and device sampling in the port
(hip_llama_tpu_torch/models/llama.py::make_chunked_sampling_step,
models/paged.py::make_paged_chunked_sampling_step and the engine's
`chunk_steps` / `device_sampling`) against the JAX package's.

- A greedy chunk equals N single steps of the port token for token, and its
  returned logits are theirs bit for bit; each step's logits match the JAX
  chunk's (atol and rtol 1e-5, fp32), and so do its tokens.
- The paged chunk equals the contiguous one; under page pressure the engine
  takes single steps and still serves the host loop's generations.
- The engine at chunk_steps 4, with device_sampling and with both serves
  the host loop's generations byte for byte on the golden fixture: fp32,
  Q8, Q8 with the int8 cache, int4, and paged with the prefix cache (device
  sampling is refused on pages, as in the JAX engine).
- Every ValueError rule of the JAX engine raises; stochastic device
  sampling is deterministic per seed and stays in the vocab.
- The CLI with --chunk 4, --device-sampling and --chunk 4 --paged 16 serves
  the five fp32 corpora byte-identical to assets/out/cpu_f32/, with the JAX
  CLI's ignore notes.
"""

import io
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.config import ModelConfig as JaxModelConfig
from hip_llama_tpu.io.checkpoint import random_weights
from hip_llama_tpu.models import init_kv_cache as jax_init_kv_cache
from hip_llama_tpu.models import params_from_weights as jax_params_from_weights
from hip_llama_tpu.models.llama import (
    make_chunked_sampling_step as jax_make_chunked_sampling_step,
)
from hip_llama_tpu.models.paged import init_paged_kv_cache as jax_init_paged_kv_cache
from hip_llama_tpu.models.paged import (
    make_paged_chunked_sampling_step as jax_make_paged_chunked_sampling_step,
)
from hip_llama_tpu_torch import run as port_run
from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.engine import InferenceEngine, Requests
from hip_llama_tpu_torch.engine.block_manager import BlockManager, OutOfPagesError
from hip_llama_tpu_torch.engine.requests import read_inputfile
from hip_llama_tpu_torch.io.checkpoint import load_checkpoint
from hip_llama_tpu_torch.models import (
    init_kv_cache,
    make_decode_step,
    params_from_jax_numpy,
    params_from_weights,
    quantize_params_q4,
    quantize_params_q8,
)
from hip_llama_tpu_torch.models.llama import make_chunked_sampling_step
from hip_llama_tpu_torch.models.paged import (
    init_paged_kv_cache,
    make_paged_chunked_sampling_step,
)
from hip_llama_tpu_torch.sampler import Sampler
from hip_llama_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "assets", "golden", "model.bin")
TOK = os.path.join(REPO, "assets", "golden", "tokenizer.bin")
IN = os.path.join(REPO, "assets", "in")
F32 = os.path.join(REPO, "assets", "out", "cpu_f32")
CORPORA = ["gen", "sciq", "tinystories", "truthful_qa", "wikipedia"]


@pytest.fixture(scope="module")
def both_params(tiny_cfg, tiny_weights):
    jp = jax_params_from_weights(tiny_weights)
    pp = params_from_jax_numpy({f: np.asarray(getattr(jp, f)) for f in jp._fields},
                               device="cpu")
    return jp, pp


TOKENS = np.array([5, 300, 17], np.int32)
POS = np.array([0, 4, 9], np.int32)  # ragged slots
N = 5


def _single_steps(cfg, params, cache):
    step = make_decode_step(cfg)
    tok, pos = torch.from_numpy(TOKENS), torch.from_numpy(POS)
    toks, logits = [], []
    for _ in range(N):
        lg, cache = step(params, cache, tok, pos)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        pos = pos + 1
        toks.append(tok)
        logits.append(lg)
    return torch.stack(toks, 1), torch.stack(logits, 1)


def test_greedy_chunk_equals_single_steps_and_the_jax_chunk(tiny_cfg, both_params):
    cfg = tiny_cfg
    jp, pp = both_params
    b = len(TOKENS)
    want_t, want_l = _single_steps(cfg, pp, init_kv_cache(cfg, b, device="cpu"))
    chunk_l = make_chunked_sampling_step(cfg, N, return_logits=True)
    got_t, got_l, cache_l = chunk_l(pp, init_kv_cache(cfg, b, device="cpu"),
                                    torch.from_numpy(TOKENS), torch.from_numpy(POS))
    assert got_t.shape == (b, N) and got_t.dtype == torch.int32
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_l, want_l)
    got_t2, cache_t = make_chunked_sampling_step(cfg, N)(
        pp, init_kv_cache(cfg, b, device="cpu"), torch.from_numpy(TOKENS),
        torch.from_numpy(POS))
    assert torch.equal(got_t2, want_t)
    assert torch.equal(cache_t.k, cache_l.k) and torch.equal(cache_t.v, cache_l.v)
    # the JAX chunk: the same tokens, each step's logits at 1e-5
    jchunk = jax.jit(jax_make_chunked_sampling_step(cfg, N, attn_impl="pallas",
                                                    return_logits=True))
    jt, jl, jc = jchunk(jp, jax_init_kv_cache(cfg, b), jnp.asarray(TOKENS), jnp.asarray(POS),
                        jax.random.PRNGKey(0))
    for i in range(N):
        assert_close(got_l[:, i].numpy(), np.asarray(jl)[:, i], **TOL, msg=f"step {i}")
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(jt))
    assert_close(cache_l.k.numpy(), np.asarray(jc.k), **TOL, msg="k after the chunk")


def test_paged_chunk_equals_the_contiguous_chunk_and_jax(tiny_cfg, both_params):
    cfg = tiny_cfg
    jp, pp = both_params
    b, ps, max_pages = len(TOKENS), 16, 2
    bm = BlockManager(num_pages=6, page_size=ps, num_slots=b)
    for s in range(b):
        bm.ensure_capacity(s, int(POS[s]) + N)
    table = np.array([bm.table_array(s, max_pages) for s in range(b)], np.int32)
    want_t, want_l, _ = make_chunked_sampling_step(cfg, N, return_logits=True)(
        pp, init_kv_cache(cfg, b, device="cpu"), torch.from_numpy(TOKENS),
        torch.from_numpy(POS))
    pchunk = make_paged_chunked_sampling_step(cfg, N, return_logits=True)
    got_t, got_l, _ = pchunk(pp, init_paged_kv_cache(cfg, 7, ps, device="cpu"),
                             torch.from_numpy(table), torch.from_numpy(TOKENS),
                             torch.from_numpy(POS))
    assert torch.equal(got_t, want_t)
    assert_close(got_l.numpy(), want_l.numpy(), **TOL, msg="paged vs contiguous")
    got_t2, _ = make_paged_chunked_sampling_step(cfg, N)(
        pp, init_paged_kv_cache(cfg, 7, ps, device="cpu"), torch.from_numpy(table),
        torch.from_numpy(TOKENS), torch.from_numpy(POS))
    assert torch.equal(got_t2, got_t)
    jchunk = jax.jit(jax_make_paged_chunked_sampling_step(cfg, N, return_logits=True))
    jt, jl, _ = jchunk(jp, jax_init_paged_kv_cache(cfg, 7, ps), jnp.asarray(table),
                       jnp.asarray(TOKENS), jnp.asarray(POS), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(jt))
    assert_close(got_l.numpy(), np.asarray(jl), **TOL, msg="paged vs the JAX paged chunk")


# ---------------------------------------------------------------------------
# the engine


@pytest.fixture(scope="module")
def toy(toy_tokenizer):
    return Tokenizer(toy_tokenizer.vocab, toy_tokenizer.scores)


def _jax_weights_params(cfg_kw: dict, seed: int):
    cfg = ModelConfig(**cfg_kw)
    w = random_weights(JaxModelConfig(**cfg_kw), seed=seed)
    return cfg, params_from_weights(w, device="cpu")


def _serve(cfg, params, tok, prompts, steps, batch=2, samplers=None, **kw):
    eng = InferenceEngine(cfg, params, tok, batch_size=batch, **kw)
    reqs = Requests(prompts=list(prompts), generations=[""] * len(prompts))
    samplers = samplers or [Sampler(cfg.vocab_size, 0.0) for _ in prompts]
    stats: dict = {}
    n = eng.serve(reqs, steps=steps, samplers=samplers, stats=stats)
    return n, list(reqs.generations), stats


def test_chunked_serve_discards_the_chunk_tail():
    """tests/test_engine.py::test_chunked_serve_matches_single_step on the
    port: chunks of 4 retire slots mid-chunk (EOS and the step budget of 21)
    and serve the single-step loop's generations and token count."""
    kw = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=2, n_kv_heads=2, vocab_size=256,
              seq_len=64)
    cfg, params = _jax_weights_params(kw, 21)

    class _Tok:
        def encode(self, text, bos=True, eos=False):
            return ([1] if bos else []) + [3 + (ord(c) % 200) for c in text]

        def decode_piece(self, prev, tok):
            return chr(97 + tok % 26).encode()

    prompts = ["ab", "wxyz", "m"]
    base = _serve(cfg, params, _Tok(), prompts, 21, max_seq_len=48)
    for extra in (dict(chunk_steps=4), dict(device_sampling=True),
                  dict(chunk_steps=4, device_sampling=True)):
        got = _serve(cfg, params, _Tok(), prompts, 21, max_seq_len=48, **extra)
        assert got[:2] == base[:2], extra


def test_paged_chunks_equal_the_contiguous_host_loop(toy):
    """tests/test_paged.py::test_engine_paged_chunked_matches_contiguous:
    pages reserved a whole chunk ahead, idle slots on the trash page."""
    cfg, params = _jax_weights_params(_TINY64, 6)
    prompts = ["hello", " hello hello", "he"]
    base = _serve(cfg, params, toy, prompts, 24)
    got = _serve(cfg, params, toy, prompts, 24, paged=True, page_size=16, chunk_steps=4)
    assert got[:2] == base[:2]


def test_paged_chunks_under_page_pressure_take_single_steps(toy, monkeypatch):
    """tests/test_paged.py::test_engine_paged_chunked_under_page_pressure:
    chunks of 4 on a pool of 4 pages of 16 for 2 slots complete every
    request with the contiguous host loop's generations. Then every other
    chunk reservation fails as a full pool's does (OutOfPagesError): that
    iteration takes a single step, and the generations stay the same."""
    cfg, params = _jax_weights_params(_TINY64, 9)
    prompts = ["hello", " hello hello", "he", "hello hello"]
    base = _serve(cfg, params, toy, prompts, 20)
    got = _serve(cfg, params, toy, prompts, 20, paged=True, page_size=16, num_pages=4,
                 chunk_steps=4)
    assert got[:2] == base[:2] and all(got[1])

    calls = {"chunk": 0, "refused": 0}
    real_ensure = BlockManager.ensure_capacity

    def ensure(self, slot, n_tokens):
        if sys._getframe(1).f_code.co_name == "serve":  # a chunk's reservation
            calls["chunk"] += 1
            if calls["chunk"] % 2:
                calls["refused"] += 1
                raise OutOfPagesError("refused by the test")
        return real_ensure(self, slot, n_tokens)

    monkeypatch.setattr(BlockManager, "ensure_capacity", ensure)
    got = _serve(cfg, params, toy, prompts, 20, paged=True, page_size=16, chunk_steps=4)
    assert calls["refused"] > 0 and calls["chunk"] > calls["refused"]
    assert got[:2] == base[:2]


_TINY64 = dict(dim=64, hidden_dim=172, n_layers=5, n_heads=8, n_kv_heads=4, vocab_size=512,
               seq_len=64, shared_classifier=True)


@pytest.fixture(scope="module")
def golden():
    cfg, w = load_checkpoint(MODEL)
    tok = Tokenizer.from_file(TOK, cfg.vocab_size)
    prompts = read_inputfile(os.path.join(IN, "gen_in_8.txt")).prompts
    return cfg, w, tok, prompts


@pytest.mark.parametrize("config", ["fp32", "q8", "q8-kv8", "q4", "paged-pfx"])
def test_engine_chunks_and_device_sampling_serve_the_host_loop(golden, config):
    """tests/test_feature_matrix.py's configurations on the golden fixture:
    every schedule serves the host loop's generations byte for byte."""
    cfg, w, tok, prompts = golden
    params = {"q8": quantize_params_q8, "q8-kv8": quantize_params_q8,
              "q4": quantize_params_q4}.get(config)
    params = (params(cfg, w, device="cpu") if params
              else params_from_weights(w, dtype=torch.float32, device="cpu"))
    kw = dict(kv_quant=config == "q8-kv8")
    if config == "paged-pfx":
        kw.update(paged=True, page_size=16, prefix_cache=True)
    base = _serve(cfg, params, tok, prompts, cfg.seq_len, batch=4, **kw)
    variants = [dict(chunk_steps=4)]
    if config != "paged-pfx":
        variants += [dict(device_sampling=True), dict(chunk_steps=4, device_sampling=True)]
    for extra in variants:
        got = _serve(cfg, params, tok, prompts, cfg.seq_len, batch=4, **kw, **extra)
        assert got[:2] == base[:2], extra
        if config == "paged-pfx":
            assert got[2]["prefix_hit_tokens"] == base[2]["prefix_hit_tokens"]


@pytest.mark.parametrize("kw,match", [
    (dict(spec_lookup=4, paged=True), "paged=False"),
    (dict(spec_lookup=4, use_prefill=False), "use_prefill=True"),
    (dict(spec_lookup=4, chunk_steps=4), "dispatch schedule"),
    (dict(spec_lookup=4, device_sampling=True), "dispatch schedule"),
    (dict(device_sampling=True, paged=True), "paged=True"),
], ids=["spec-paged", "spec-no-prefill", "spec-chunk", "spec-device-sampling",
        "device-sampling-paged"])
def test_engine_refuses_what_the_jax_engine_refuses(both_params, tiny_cfg, toy, kw, match):
    with pytest.raises(ValueError, match=match):
        InferenceEngine(tiny_cfg, both_params[1], toy, batch_size=2, **kw)


def test_serve_with_a_draft_needs_spec_lookup(both_params, tiny_cfg, toy):
    eng = InferenceEngine(tiny_cfg, both_params[1], toy, batch_size=2)
    reqs = Requests(prompts=["hello"], generations=[""])
    with pytest.raises(ValueError, match="spec_lookup"):
        eng.serve(reqs, steps=8, draft=eng)


def test_stochastic_device_sampling_is_deterministic_per_seed(both_params, tiny_cfg, toy):
    """tests/test_engine.py::test_device_sampling_stochastic_valid on the
    port, in generate and in chunked serve: the same seed gives the same
    tokens, another seed others, all in the vocab."""
    pp = both_params[1]

    def gen(seed):
        eng = InferenceEngine(tiny_cfg, pp, toy, batch_size=1, device_sampling=True,
                              ds_temperature=1.0, ds_topp=0.9, ds_seed=seed)
        return eng.generate("hello", steps=24).token_ids

    a, b, c = gen(7), gen(7), gen(8)
    assert a == b and a != c
    assert all(0 <= t < tiny_cfg.vocab_size for t in a + c)
    prompts = ["hello", " hello hello", "he"]

    def serve(seed):
        # the steps outside chunks sample on the host, from fresh samplers
        samplers = [Sampler(tiny_cfg.vocab_size, 1.0, 0.9, 314028) for _ in prompts]
        return _serve(tiny_cfg, pp, toy, prompts, 40, chunk_steps=4, ds_temperature=1.0,
                      ds_topp=0.9, ds_seed=seed, samplers=samplers)[1]

    assert serve(7) == serve(7)


def test_device_sampling_greedy_generate_equals_the_host(both_params, tiny_cfg, toy):
    pp = both_params[1]
    host = InferenceEngine(tiny_cfg, pp, toy, batch_size=1).generate(
        "hello", steps=24, sampler=Sampler(tiny_cfg.vocab_size, 0.0))
    dev = InferenceEngine(tiny_cfg, pp, toy, batch_size=1, device_sampling=True).generate(
        "hello", steps=24)
    assert (dev.text, dev.token_ids) == (host.text, host.token_ids)


# ---------------------------------------------------------------------------
# the CLI


def _cli(tmp_path, corpus, flags):
    out = str(tmp_path / f"{corpus}.out")
    with redirect_stdout(io.StringIO()):
        rc = port_run.main([
            "run", MODEL, "-z", TOK, "-m", "test", "-t", "0.0",
            "-f", os.path.join(IN, f"{corpus}_in_8.txt"), "-o", out,
            "-b", "4", "--dtype", "float32", "--device", "cpu", *flags,
        ])
    assert rc == 0
    with open(out, "rb") as f, open(os.path.join(F32, f"{corpus}_in_8.out"), "rb") as g:
        return f.read() == g.read()


@pytest.mark.parametrize("corpus", CORPORA)
@pytest.mark.parametrize("flags", [["--chunk", "4"], ["--device-sampling"],
                                   ["--chunk", "4", "--paged", "16"]],
                         ids=lambda f: " ".join(f))
def test_cli_schedules_byte_identical_to_cpu_f32(tmp_path, flags, corpus):
    assert _cli(tmp_path, corpus, flags), f"{corpus} with {flags} differs from cpu_f32"


def test_cli_q8_int8_chunk_serves_the_plain_loop_bytes(tmp_path):
    """--quant q8 --kv int8 --chunk 4 runs the plain loop's decode step: its
    five corpora are the plain CLI's bytes (and so meet the plain run's
    average bar against assets/out/cpu_q8_kv8/)."""
    for c in CORPORA:
        outs = []
        for flags in ([], ["--chunk", "4"]):
            out = str(tmp_path / f"{c}{len(flags)}.out")
            with redirect_stdout(io.StringIO()):
                rc = port_run.main(["run", MODEL, "-z", TOK, "-m", "test", "-t", "0.0",
                                    "-f", os.path.join(IN, f"{c}_in_8.txt"), "-o", out,
                                    "-b", "4", "--quant", "q8", "--kv", "int8", "--device",
                                    "cpu", *flags])
            assert rc == 0
            with open(out, "rb") as f:
                outs.append(f.read())
        assert outs[0] == outs[1], c


def test_cli_device_sampling_with_paged_prints_the_jax_note(tmp_path, capsys):
    assert _cli(tmp_path, "gen", ["--device-sampling", "--paged", "16"])
    assert ("note: --device-sampling drives the contiguous cache; ignoring it with --paged"
            in capsys.readouterr().err)


def test_cli_chunk_needs_an_int(capsys):
    assert port_run.main(["run", MODEL, "-z", TOK, "--chunk", "x"]) == 1
    assert "--chunk needs an int" in capsys.readouterr().err

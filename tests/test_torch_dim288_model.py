"""The port's step at llama2.c stories15M's shape (dim 288, 6 heads of 48,
2 KV heads: 3 query heads per KV head, hidden 768) against the JAX step, on
random weights.

The JAX side runs in a subprocess (its HIPLLAMA_Q4_MODE is read when it is
imported, as tests/test_torch_a8_model.py does) and saves its logits for
the chunked prefill and three decode steps: the dense fp32 model on an fp32
cache and on an int8 cache, and int4 weights in `a8` (w4a8) on a bf16
cache. The int4 group size at K = 288 is q4_group_size(288, 32) = 16, so
the `a8` products quantize x in groups of 16. The JAX package's
quantize_params_q4 raises at dim 288 (its Q8_0 embedding takes groups of
64), so both sides quantize the embedding in groups of gcd(288, 64) = 32,
as the port's quantize_params_q4 does; the matmul weights are the JAX
quantizer's. The port's plain path (on the same params, carried over) is
held to those logits.

Tolerances: fp32 on an fp32 cache atol = rtol = 1e-4 (the same math in
another summation order, over 288-wide products); fp32 on an int8 cache
1e-2, as tests/test_torch_kv_int8_model.py (a value a rounding apart can
quantize to the next int8 step); int4 `a8` atol 0.15, rtol 0.05, as
tests/test_torch_a8_model.py (bf16 activations rounded after fp32 sums
taken in another order).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.io.checkpoint import q4_group_size
from hip_llama_tpu_torch.models import (
    init_kv_cache,
    make_decode_step,
    make_prefill,
    params_from_jax_numpy,
    qparams_from_jax_numpy,
    quantize_params_q4,
)

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 3
RUNS = {  # (params, cache dtype, int8 cache, tolerance)
    "fp32": ("dense", torch.float32, False, dict(atol=1e-4, rtol=1e-4)),
    "fp32 int8": ("dense", torch.float32, True, dict(atol=1e-2, rtol=1e-2)),
    "q4 a8": ("q4", torch.bfloat16, False, dict(atol=0.15, rtol=0.05)),
}

# the model, its params and the run's inputs: executed by both sides
SETUP = r'''
import numpy as np
import jax.numpy as jnp
from hip_llama_tpu.config import tiny_config
from hip_llama_tpu.io.checkpoint import q4_group_size, random_weights
from hip_llama_tpu.models import params_from_weights
from hip_llama_tpu.models.params import QuantLlamaParams, unstack_quant_params
from hip_llama_tpu.ops.quant4 import q4_quantize_weights


def config():
    return tiny_config(dim=288, hidden_dim=768, n_layers=2, n_heads=6, n_kv_heads=2,
                       seq_len=64)


def q4_params(cfg, w, egs=32):
    """quantize_params_q4 with the embedding's Q8_0 groups of egs."""
    def qt(arr):
        a = np.swapaxes(np.asarray(arr, np.float32), -1, -2)
        return q4_quantize_weights(jnp.asarray(a), q4_group_size(a.shape[-2], 32))

    emb = np.asarray(w.tok_emb, np.float32)
    v, d = emb.shape
    s = np.abs(emb.reshape(v, d // egs, egs)).max(axis=-1) / 127.0
    q = np.round(emb.reshape(v, d // egs, egs) / np.where(s == 0, 1.0, s)[..., None])
    return QuantLlamaParams(
        tok_emb_q=jnp.asarray(q.astype(np.int8).reshape(v, d)),
        tok_emb_s=jnp.asarray(s, jnp.float32),
        rms_att=jnp.asarray(w.rms_att, jnp.float32), wq=qt(w.wq), wk=qt(w.wk), wv=qt(w.wv),
        wo=qt(w.wo), rms_ffn=jnp.asarray(w.rms_ffn, jnp.float32), w1=qt(w.w1), w2=qt(w.w2),
        w3=qt(w.w3), rms_final=jnp.asarray(w.rms_final, jnp.float32), wcls=qt(w.wcls))


def setup():
    cfg = config()
    w = random_weights(cfg, seed=288)
    return cfg, w, params_from_weights(w), unstack_quant_params(q4_params(cfg, w))


def inputs(vocab):
    rng = np.random.default_rng(288)
    tokens = rng.integers(0, vocab, (3, 16)).astype(np.int32)
    start, valid = np.zeros(3, np.int32), np.array([16, 9, 0], np.int32)
    steps = [(rng.integers(0, vocab, (3,)).astype(np.int32),
              np.array([16 + i, 9 + i, i], np.int32)) for i in range(3)]
    return tokens, start, valid, steps
'''

JAX_SIDE = SETUP + r'''
import sys
import jax
from hip_llama_tpu.models import init_kv_cache, make_decode_step, make_prefill

out = sys.argv[1]
cfg, _, dense, q4 = setup()
tokens, start, valid, steps = inputs(cfg.vocab_size)
logits = {}
for name, params, dtype, int8, precision in (
        ("fp32", dense, jnp.float32, False, "highest"),
        ("fp32 int8", dense, jnp.float32, True, "highest"),
        ("q4 a8", q4, jnp.bfloat16, False, "default")):
    pre = jax.jit(make_prefill(cfg, attn_impl="pallas", precision=precision))
    step = jax.jit(make_decode_step(cfg, attn_impl="pallas", precision=precision))
    c = init_kv_cache(cfg, 3, dtype=dtype, quantized=int8)
    lg, c = pre(params, c, jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(valid))
    logits[f"{name} prefill"] = np.asarray(lg)
    for i, (tok, pos) in enumerate(steps):
        lg, c = step(params, c, jnp.asarray(tok), jnp.asarray(pos))
        logits[f"{name} step {i}"] = np.asarray(lg)
np.savez(out, **logits)
'''


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(the JAX side's logits, cfg, the port's dense and int4 params, the
    inputs, the JAX weights)."""
    out = str(tmp_path_factory.mktemp("dim288") / "logits.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", HIPLLAMA_Q4_MODE="a8")
    p = subprocess.run([sys.executable, "-c", JAX_SIDE, out], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    ns: dict = {}
    exec(SETUP, ns)
    cfg_j, w, dense, q4 = ns["setup"]()
    params = {
        "dense": params_from_jax_numpy({f: np.asarray(getattr(dense, f)) for f in dense._fields},
                                       device="cpu"),
        "q4": qparams_from_jax_numpy(jax.tree_util.tree_map(np.asarray, q4)._asdict(),
                                     device="cpu", int4=True),
    }
    return dict(np.load(out)), ModelConfig(**vars(cfg_j)), params, ns["inputs"], w


def test_dim288_shape_is_stories15m():
    """Head size 48, 3 query heads per KV head, int4 groups of 16 on the
    288-wide products and of 32 on W2."""
    cfg = ModelConfig(dim=288, hidden_dim=768, n_layers=2, n_heads=6, n_kv_heads=2,
                      vocab_size=512, seq_len=64)
    assert cfg.dim // cfg.n_heads == 48 and cfg.n_heads // cfg.n_kv_heads == 3
    assert q4_group_size(288, 32) == 16 and q4_group_size(768, 32) == 32


@pytest.mark.parametrize("run", list(RUNS))
def test_dim288_prefill_and_steps_match_jax(jax_run, run, monkeypatch):
    want, cfg, params, inputs, _ = jax_run
    kind, dtype, int8, tol = RUNS[run]
    if kind == "q4":
        monkeypatch.setenv("HIPLLAMA_Q4_MODE", "a8")
    tokens, start, valid, steps = inputs(cfg.vocab_size)
    pp = params[kind]
    pc = init_kv_cache(cfg, B, dtype=dtype, device="cpu", quantized=int8)
    lg, _ = make_prefill(cfg)(pp, pc, torch.from_numpy(tokens), torch.from_numpy(start),
                              torch.from_numpy(valid))
    for s in range(B):
        v = int(valid[s])
        if v:
            assert_close(lg.numpy()[s, :v], want[f"{run} prefill"][s, :v], **tol,
                         msg=f"{run} prefill slot {s}")
    step = make_decode_step(cfg)
    for i, (tok, pos) in enumerate(steps):
        lg, _ = step(pp, pc, torch.from_numpy(tok), torch.from_numpy(pos))
        assert_close(lg.numpy(), want[f"{run} step {i}"], **tol, msg=f"{run} step {i}")


def test_dim288_port_int4_quantizer_takes_the_width(jax_run):
    """The port's quantize_params_q4 serves dim 288 (embedding groups of
    gcd(288, 64) = 32) and gives the carried params' bits."""
    _, cfg, params, _, w = jax_run
    from hip_llama_tpu_torch.io.checkpoint import LlamaWeights

    lw = LlamaWeights(**{f.name: np.asarray(getattr(w, f.name)) for f in dataclasses.fields(w)})
    got = quantize_params_q4(cfg, lw, device="cpu")
    want = params["q4"]
    assert got.tok_emb_s.shape == (cfg.vocab_size, 288 // 32)
    assert torch.equal(got.tok_emb_q, want.tok_emb_q)
    assert torch.equal(got.tok_emb_s, want.tok_emb_s)
    for name in ("wq", "wo", "w1", "w2"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s), name

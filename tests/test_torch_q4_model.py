"""The port's int4 model and CLI against the JAX package's: the params
(quantize_params_q4, v4 files) bit for bit; make_decode_step and
make_prefill on the same int4 params as the JAX step (its
unstack_quant_params(quantize_params_q4(...)), attn_impl "pallas" in
interpret mode) at 4 KV heads (GQA), on a bf16 and an int8 cache; the int4
step never reaching a Q8 kernel; the CLI's --quant q4, v4 files and
--dequant.

Hidden 256 and QKV width 256 let the JAX K21 and K22 run as kernels (a
hidden width that is no multiple of 128 would send the JAX K22 to its
fallback, which rounds h1 and h3 to bf16 before the gate). Tolerance: logits
at atol 0.15, rtol 0.05, as the Q8 cases of tests/test_torch_model.py —
bf16 activations rounded after fp32 sums taken in another order (and on an
int8 cache, a k or v element a bf16 ulp apart can round to the next int8
value); bf16 caches at atol = rtol = 2e-2.
"""

import io
import os
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
from hip_llama_tpu.models.params import quantize_params_q4 as jax_quantize_params_q4
from hip_llama_tpu.models.params import unstack_quant_params
from hip_llama_tpu_torch import run as port_run
from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.engine.requests import read_inputfile
from hip_llama_tpu_torch.io.checkpoint import LlamaWeights, load_checkpoint, write_v2, write_v4
from hip_llama_tpu_torch.models import (
    init_kv_cache,
    make_decode_step,
    make_prefill,
    qparams_from_jax_numpy,
    qparams_from_q4_weights,
    quantize_params_q4,
)
from hip_llama_tpu_torch.ops import layer_fused as _layer
from hip_llama_tpu_torch.ops import quant as _quant
from hip_llama_tpu_torch.ops.quant4 import Q4Tensor

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

Q4_TOL = dict(atol=0.15, rtol=0.05)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "assets", "golden", "model.bin")
TOK = os.path.join(REPO, "assets", "golden", "tokenizer.bin")


@pytest.fixture(scope="module")
def q4_both():
    cfg_j = tiny_config(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
                        vocab_size=512, seq_len=96)
    w = random_weights(cfg_j, seed=14)
    jp = unstack_quant_params(jax_quantize_params_q4(cfg_j, w, group_size=32))
    pp = qparams_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp)._asdict(), device="cpu",
                                int4=True)
    return cfg_j, ModelConfig(**vars(cfg_j)), w, jp, pp


def _same_params(a, b):
    assert a.int4 and b.int4
    for f in ("tok_emb_q", "tok_emb_s", "rms_final"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("rms_att", "rms_ffn", "wq", "wo", "w1", "w2"):
        assert len(getattr(a, f)) == len(getattr(b, f)), f
        for x, y in zip(getattr(a, f), getattr(b, f)):
            pairs = [(x.q, y.q), (x.s, y.s)] if isinstance(x, Q4Tensor) else [(x, y)]
            assert all(torch.equal(u, v) for u, v in pairs), f
    assert torch.equal(a.wcls.q, b.wcls.q) and torch.equal(a.wcls.s, b.wcls.s)


def test_q4_params_bit_exact_vs_jax_and_v4(q4_both, tmp_path):
    """quantize_params_q4 on the CPU is the JAX package's, bit for bit; a v4
    file of the same weights loads into the same params."""
    cfg_j, cfg, w, _, pp = q4_both
    pw = LlamaWeights(**vars(w))
    mine = quantize_params_q4(cfg, pw, device="cpu")
    assert isinstance(mine.wq[0], Q4Tensor) and mine.wq[0].group_size == 32
    assert mine.wk == mine.wv == mine.w3 == ()
    assert mine.group_size == 64  # the Q8_0 embedding
    _same_params(mine, pp)
    v4 = str(tmp_path / "m.bin")
    write_v4(v4, cfg, pw)
    cfg4, w4 = load_checkpoint(v4)
    assert cfg4.group_size == 32
    _same_params(qparams_from_q4_weights(cfg4, w4, device="cpu"), pp)


def _caches(cfg_j, cfg, b, int8):
    if int8:
        return jax_init_kv_cache(cfg_j, b, quantized=True), init_kv_cache(cfg, b, device="cpu",
                                                                          quantized=True)
    return (jax_init_kv_cache(cfg_j, b, dtype=jnp.bfloat16),
            init_kv_cache(cfg, b, dtype=torch.bfloat16, device="cpu"))


def _bf16_cache(jc, pc, msg):
    for a, b, name in ((jc.k, pc.k, "k"), (jc.v, pc.v, "v")):
        assert b.dtype == torch.bfloat16
        assert_close(b.float().numpy(), np.asarray(a, np.float32), atol=2e-2, rtol=2e-2,
                     msg=f"{msg} {name}")


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_q4_decode_steps_match_jax(q4_both, cache):
    cfg_j, cfg, _, jp, pp = q4_both
    b = 3
    rng = np.random.default_rng(41)
    jstep = jax.jit(jax_make_decode_step(cfg_j, attn_impl="pallas", precision="default"))
    pstep = make_decode_step(cfg)
    jc, pc = _caches(cfg_j, cfg, b, cache == "int8")
    for i in range(4):
        tokens = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        pos = np.array([i, i + 2, 3 * i], np.int32)  # ragged slots, one at pos 0
        jl, jc = jstep(jp, jc, jnp.asarray(tokens), jnp.asarray(pos))
        pl, pc = pstep(pp, pc, torch.from_numpy(tokens), torch.from_numpy(pos))
        assert pl.dtype == torch.float32 and pl.shape == (b, cfg.vocab_size)
        assert_close(pl.numpy(), np.asarray(jl), **Q4_TOL, msg=f"{cache} step {i}")
    if cache == "bf16":
        _bf16_cache(jc, pc, "after 4 steps")


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_q4_prefill_then_decode_matches_jax(q4_both, cache):
    """T 16 at batch 3 is 48 rows: the tile route of K21 and K22 on the card
    (the decode steps after it take the GEMV route)."""
    cfg_j, cfg, _, jp, pp = q4_both
    b, t = 3, 16
    rng = np.random.default_rng(42)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    start = np.array([0, 5, 16], np.int32)  # a prompt, a bystander, a second chunk
    valid = np.array([t, 0, 9], np.int32)
    jpre = jax.jit(jax_make_prefill(cfg_j, attn_impl="pallas", precision="default"))
    jc, pc = _caches(cfg_j, cfg, b, cache == "int8")
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
            assert_close(pl.numpy()[i, : valid[i]], np.asarray(jl)[i, : valid[i]], **Q4_TOL,
                         msg=f"{cache} prefill slot {i}")
    if cache == "bf16":
        _bf16_cache(jc, pc, "after prefill")
    jstep = jax.jit(jax_make_decode_step(cfg_j, attn_impl="pallas", precision="default"))
    pstep = make_decode_step(cfg)
    pos = start + valid
    for i in range(2):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos + i))
        pl, pc = pstep(pp, pc, torch.from_numpy(tok), torch.from_numpy(pos + i))
        assert_close(pl.numpy(), np.asarray(jl), **Q4_TOL, msg=f"{cache} decode {i}")


def test_q4_never_reaches_a_q8_kernel(q4_both, monkeypatch):
    """The int4 step and prefill run K21, K22 and the attention kernels
    only: q8_layer_fused whatever HIPLLAMA_LAYER_FUSE says, and
    q8_matmul_ffn whatever the row count, are never called."""
    _, cfg, _, _, pp = q4_both

    def boom(*a, **k):
        raise AssertionError("a Q8 kernel on the int4 path")

    for mod, name in ((_layer, "q8_layer_fused"), (_quant, "q8_matmul"),
                      (_quant, "q8_matmul_silu"), (_quant, "q8_matmul_ffn")):
        monkeypatch.setattr(mod, name, boom)
    monkeypatch.setenv("HIPLLAMA_LAYER_FUSE", "1")
    b = 2
    cache = init_kv_cache(cfg, b, dtype=torch.bfloat16, device="cpu")
    tokens = torch.arange(16, dtype=torch.int32).repeat(b, 1)
    start, valid = torch.zeros(b, dtype=torch.int32), torch.tensor([16, 3], dtype=torch.int32)
    make_prefill(cfg)(pp, cache, tokens, start, valid)  # 32 rows: the whole-FFN kernel's range
    logits, _ = make_decode_step(cfg)(pp, cache, torch.tensor([1, 2], dtype=torch.int32), valid)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the CLI


def _serve(tmp_path, model, tag, *args):
    inp = tmp_path / "in.txt"
    inp.write_text("3\nOnce upon a time\nThe sun\nA little dog named\n")
    out = str(tmp_path / f"{tag}.out")
    with redirect_stdout(io.StringIO()):
        rc = port_run.main(["run", model, "-z", TOK, "-m", "test", "-f", str(inp), "-o", out,
                            "-b", "2", "-t", "0.0", "--device", "cpu", *args])
    assert rc == 0, f"port CLI failed ({tag})"
    return out


def test_v4_file_serves_like_quant_q4(tmp_path):
    """A v4 file of the fixture, written by the port, serves the bytes of
    --quant q4 on the fp32 file (both quantize with the same function), on
    a bf16 and an int8 cache."""
    cfg, w = load_checkpoint(MODEL)
    v4 = str(tmp_path / "model_v4.bin")
    write_v4(v4, cfg, w)
    for kv in ((), ("--kv", "int8")):
        with open(_serve(tmp_path, v4, "v4", *kv), "rb") as f:
            from_v4 = f.read()
        with open(_serve(tmp_path, MODEL, "q4", "--quant", "q4", *kv), "rb") as f:
            assert f.read() == from_v4, kv


def test_dequant_serves_v4_and_v2_files(tmp_path):
    """--dequant runs a v4 and a v2 file through the dense path."""
    cfg, w = load_checkpoint(MODEL)
    v4, v2 = str(tmp_path / "v4.bin"), str(tmp_path / "v2.bin")
    write_v4(v4, cfg, w)
    write_v2(v2, cfg, w)
    for path in (v4, v2):
        out = read_inputfile(_serve(tmp_path, path, "dq", "--dequant", "--dtype", "float32"))
        assert out.num_reqs == 3 and out.prompts[0].startswith("Once upon a time")

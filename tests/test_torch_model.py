"""The port's dense model (hip_llama_tpu_torch/models/llama.py) against the
JAX package's make_decode_step / make_prefill, on tiny_config weights carried
across with params_from_jax_numpy, for attn_impl "pallas" (interpret mode)
and "xla".

Tolerance: fp32 logits and cache rows, atol = rtol = 1e-5 — the same math,
with the matmuls summed in XLA's and in PyTorch's orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.models import init_kv_cache as jax_init_kv_cache
from hip_llama_tpu.models import make_decode_step as jax_make_decode_step
from hip_llama_tpu.models import make_prefill as jax_make_prefill
from hip_llama_tpu.models import params_from_weights as jax_params_from_weights
from hip_llama_tpu_torch.models import (
    init_kv_cache,
    make_decode_step,
    make_prefill,
    params_from_jax_numpy,
    params_from_weights,
)
from hip_llama_tpu_torch.models.llama import make_logit_sampler

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def both_params(tiny_cfg, tiny_weights):
    jp = jax_params_from_weights(tiny_weights)
    pp = params_from_jax_numpy({f: np.asarray(getattr(jp, f)) for f in jp._fields},
                               device="cpu")
    return jp, pp


def _close_cache(jc, pc, msg):
    assert_close(pc.k.numpy(), np.asarray(jc.k), **TOL, msg=f"{msg} k")
    assert_close(pc.v.numpy(), np.asarray(jc.v), **TOL, msg=f"{msg} v")


def test_params_from_weights_matches_jax_carry(tiny_weights, both_params):
    _, carried = both_params
    direct = params_from_weights(tiny_weights, device="cpu")
    for f in carried.__dataclass_fields__:
        assert torch.equal(getattr(direct, f), getattr(carried, f)), f


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_decode_steps_match_jax(tiny_cfg, both_params, attn_impl):
    cfg = tiny_cfg
    jp, pp = both_params
    b = 3
    rng = np.random.default_rng(11)
    jstep = jax.jit(jax_make_decode_step(cfg, attn_impl=attn_impl))
    pstep = make_decode_step(cfg)
    jc = jax_init_kv_cache(cfg, b)
    pc = init_kv_cache(cfg, b, device="cpu")
    for i in range(5):
        tokens = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        pos = np.array([i, i + 2, 2 * i], np.int32)  # ragged slots
        jl, jc = jstep(jp, jc, jnp.asarray(tokens), jnp.asarray(pos))
        pl, pc = pstep(pp, pc, torch.from_numpy(tokens), torch.from_numpy(pos))
        assert pl.dtype == torch.float32 and pl.shape == (b, cfg.vocab_size)
        assert_close(pl.numpy(), np.asarray(jl), **TOL, msg=f"step {i}")
    _close_cache(jc, pc, "after 5 steps")


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_prefill_then_decode_matches_jax(tiny_cfg, both_params, attn_impl):
    cfg = tiny_cfg
    jp, pp = both_params
    b, t = 3, 16
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    # a fresh prompt, a bystander mid-decode (valid 0), a second chunk
    start = np.array([0, 5, 16], np.int32)
    valid = np.array([16, 0, 9], np.int32)
    jpre = jax.jit(jax_make_prefill(cfg, attn_impl=attn_impl))
    jpre_last = jax.jit(jax_make_prefill(cfg, attn_impl=attn_impl, last_only=True))
    jstep = jax.jit(jax_make_decode_step(cfg, attn_impl=attn_impl))
    jc = jax_init_kv_cache(cfg, b)
    pc = init_kv_cache(cfg, b, device="cpu")
    # the second chunk of slot 2 needs its first 16 rows: prefill them first
    first = np.zeros_like(tokens)
    first[2] = rng.integers(0, cfg.vocab_size, t)
    v0 = np.array([0, 0, 16], np.int32)
    z = np.zeros(b, np.int32)
    _, jc = jpre(jp, jc, jnp.asarray(first), jnp.asarray(z), jnp.asarray(v0))
    make_prefill(cfg)(pp, pc, torch.from_numpy(first), torch.from_numpy(z), torch.from_numpy(v0))

    jl_last, _ = jpre_last(jp, jax.tree_util.tree_map(jnp.array, jc), jnp.asarray(tokens),
                           jnp.asarray(start), jnp.asarray(valid))
    jl, jc = jpre(jp, jc, jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(valid))
    pc_last = init_kv_cache(cfg, b, device="cpu")
    pc_last.k.copy_(pc.k)
    pc_last.v.copy_(pc.v)
    pl_last, _ = make_prefill(cfg, last_only=True)(
        pp, pc_last, torch.from_numpy(tokens), torch.from_numpy(start), torch.from_numpy(valid))
    pl, pc = make_prefill(cfg)(pp, pc, torch.from_numpy(tokens), torch.from_numpy(start),
                               torch.from_numpy(valid))
    assert pl.shape == (b, t, cfg.vocab_size) and pl_last.shape == (b, cfg.vocab_size)
    for i in range(b):
        if valid[i]:
            assert_close(pl.numpy()[i, : valid[i]], np.asarray(jl)[i, : valid[i]], **TOL,
                         msg=f"prefill slot {i}")
            assert_close(pl_last.numpy()[i], np.asarray(jl_last)[i], **TOL, msg=f"last {i}")
    _close_cache(jc, pc, "after prefill")
    assert torch.equal(pc_last.k, pc.k) and torch.equal(pc_last.v, pc.v)

    # decode on from each slot's prefilled length
    pos = start + valid
    jstep_tok = np.argmax(np.asarray(jl_last), -1).astype(np.int32)
    pstep_tok = make_logit_sampler(0.0)(pl_last)
    assert pstep_tok.tolist() == jstep_tok.tolist()
    pstep = make_decode_step(cfg)
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos + i))
        pl, pc = pstep(pp, pc, torch.from_numpy(tok), torch.from_numpy(pos + i))
        assert_close(pl.numpy(), np.asarray(jl), **TOL, msg=f"decode {i}")
    _close_cache(jc, pc, "after decode")


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_and_rmsnorm_match_jax(theta):
    from hip_llama_tpu.models.llama import rmsnorm as jax_rmsnorm
    from hip_llama_tpu.models.llama import rope as jax_rope
    from hip_llama_tpu_torch.models.llama import rmsnorm, rope

    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 2048, (3, 5)).astype(np.int32)
    got = rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert_close(got.numpy(), np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), theta)), **TOL)
    w = rng.standard_normal(16).astype(np.float32)
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    assert_close(got.numpy(), np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)), **TOL)


def test_logit_sampler_stochastic_not_ported():
    with pytest.raises(NotImplementedError):
        make_logit_sampler(0.8, 0.9)


# ---------------------------------------------------------------------------
# the Q8_0 path: bf16 activations and cache, against the JAX step on
# unstack_quant_params(quantize_params_q8(...)) with attn_impl "pallas"
# (interpret mode). Tolerance: logits at atol 0.15, rtol 0.05, as
# tests/test_q8_model.py:71 — bf16 activations rounded after fp32 sums
# taken in another order.

Q8_TOL = dict(atol=0.15, rtol=0.05)


@pytest.fixture(scope="module")
def q8_both():
    from hip_llama_tpu.config import tiny_config
    from hip_llama_tpu.io.checkpoint import random_weights
    from hip_llama_tpu.models.params import quantize_params_q8, unstack_quant_params
    from hip_llama_tpu_torch.config import ModelConfig
    from hip_llama_tpu_torch.models import qparams_from_jax_numpy

    cfg_j = tiny_config(dim=128, hidden_dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                        vocab_size=512, seq_len=128)
    jp = unstack_quant_params(quantize_params_q8(cfg_j, random_weights(cfg_j, seed=8),
                                                 group_size=32))
    pp = qparams_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp)._asdict(), device="cpu")
    return cfg_j, ModelConfig(**vars(cfg_j)), jp, pp


def _bf16_cache(jc, pc, msg):
    for a, b, name in ((jc.k, pc.k, "k"), (jc.v, pc.v, "v")):
        assert b.dtype == torch.bfloat16
        assert_close(b.float().numpy(), np.asarray(a, np.float32), atol=2e-2, rtol=2e-2,
                     msg=f"{msg} {name}")


def test_q8_decode_steps_match_jax(q8_both):
    cfg_j, cfg, jp, pp = q8_both
    b = 3
    rng = np.random.default_rng(21)
    jstep = jax.jit(jax_make_decode_step(cfg_j, attn_impl="pallas", precision="default"))
    pstep = make_decode_step(cfg)
    jc = jax_init_kv_cache(cfg_j, b, dtype=jnp.bfloat16)
    pc = init_kv_cache(cfg, b, dtype=torch.bfloat16, device="cpu")
    for i in range(5):
        tokens = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        pos = np.array([i, i + 2, 2 * i], np.int32)  # ragged slots, one at pos 0
        jl, jc = jstep(jp, jc, jnp.asarray(tokens), jnp.asarray(pos))
        pl, pc = pstep(pp, pc, torch.from_numpy(tokens), torch.from_numpy(pos))
        assert pl.dtype == torch.float32 and pl.shape == (b, cfg.vocab_size)
        assert_close(pl.numpy(), np.asarray(jl), **Q8_TOL, msg=f"step {i}")
    _bf16_cache(jc, pc, "after 5 steps")


def test_q8_decode_steps_four_kernel_layer_matches_jax(q8_both, monkeypatch):
    """HIPLLAMA_LAYER_FUSE=0: each layer as QKV, attention_decode_fused, wo
    and the FFN instead of one q8_layer_fused, against the same JAX step,
    and equal to the fused step."""
    cfg_j, cfg, jp, pp = q8_both
    b = 3
    rng = np.random.default_rng(23)
    jstep = jax.jit(jax_make_decode_step(cfg_j, attn_impl="pallas", precision="default"))
    fused = make_decode_step(cfg)
    monkeypatch.setenv("HIPLLAMA_LAYER_FUSE", "0")
    pstep = make_decode_step(cfg)
    jc = jax_init_kv_cache(cfg_j, b, dtype=jnp.bfloat16)
    pc = init_kv_cache(cfg, b, dtype=torch.bfloat16, device="cpu")
    fc = init_kv_cache(cfg, b, dtype=torch.bfloat16, device="cpu")
    for i in range(3):
        tokens = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        pos = np.array([i, i + 1, 3 * i], np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tokens), jnp.asarray(pos))
        pl, pc = pstep(pp, pc, torch.from_numpy(tokens), torch.from_numpy(pos))
        fl, fc = fused(pp, fc, torch.from_numpy(tokens), torch.from_numpy(pos))
        assert_close(pl.numpy(), np.asarray(jl), **Q8_TOL, msg=f"step {i}")
        assert torch.equal(pl, fl)
    _bf16_cache(jc, pc, "after 3 steps")
    assert torch.equal(pc.k, fc.k) and torch.equal(pc.v, fc.v)


@pytest.mark.parametrize("t", [16, 96])
def test_q8_prefill_then_decode_matches_jax(q8_both, t):
    """T 16 at batch 3 is 48 rows: the whole-FFN kernel's route (K18). T 96
    is 288 rows, past its 256: the gate and W2 with the residual (K17 +
    K15)."""
    from hip_llama_tpu_torch.ops.quant import ffn_takes_kernel

    cfg_j, cfg, jp, pp = q8_both
    b = 3
    assert ffn_takes_kernel(b * t, cfg.dim) == (t == 16)
    rng = np.random.default_rng(22 + t)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    start = np.array([0, 5, 16], np.int32)  # a prompt, a bystander, a second chunk
    valid = np.array([t, 0, min(t, cfg.seq_len - 16) // 2], np.int32)
    jpre = jax.jit(jax_make_prefill(cfg_j, attn_impl="pallas", precision="default"))
    jpre_last = jax.jit(jax_make_prefill(cfg_j, attn_impl="pallas", precision="default",
                                         last_only=True))
    jc = jax_init_kv_cache(cfg_j, b, dtype=jnp.bfloat16)
    pc = init_kv_cache(cfg, b, dtype=torch.bfloat16, device="cpu")
    first = np.zeros((b, 16), np.int32)
    first[2] = rng.integers(0, cfg.vocab_size, 16)
    v0, z = np.array([0, 0, 16], np.int32), np.zeros(b, np.int32)
    _, jc = jax.jit(jax_make_prefill(cfg_j, attn_impl="pallas", precision="default"))(
        jp, jc, jnp.asarray(first), jnp.asarray(z), jnp.asarray(v0))
    make_prefill(cfg)(pp, pc, torch.from_numpy(first), torch.from_numpy(z), torch.from_numpy(v0))

    jl_last, _ = jpre_last(jp, jax.tree_util.tree_map(jnp.array, jc), jnp.asarray(tokens),
                           jnp.asarray(start), jnp.asarray(valid))
    jl, jc = jpre(jp, jc, jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(valid))
    pc_last = init_kv_cache(cfg, b, dtype=torch.bfloat16, device="cpu")
    pc_last.k.copy_(pc.k)
    pc_last.v.copy_(pc.v)
    pl_last, _ = make_prefill(cfg, last_only=True)(
        pp, pc_last, torch.from_numpy(tokens), torch.from_numpy(start), torch.from_numpy(valid))
    pl, pc = make_prefill(cfg)(pp, pc, torch.from_numpy(tokens), torch.from_numpy(start),
                               torch.from_numpy(valid))
    assert pl.shape == (b, t, cfg.vocab_size) and pl_last.shape == (b, cfg.vocab_size)
    for i in range(b):
        if valid[i]:
            assert_close(pl.numpy()[i, : valid[i]], np.asarray(jl)[i, : valid[i]], **Q8_TOL,
                         msg=f"prefill slot {i}")
            assert_close(pl_last.numpy()[i], np.asarray(jl_last)[i], **Q8_TOL,
                         msg=f"last {i}")
    _bf16_cache(jc, pc, "after prefill")
    assert torch.equal(pc_last.k, pc.k) and torch.equal(pc_last.v, pc.v)

    jstep = jax.jit(jax_make_decode_step(cfg_j, attn_impl="pallas", precision="default"))
    pstep = make_decode_step(cfg)
    pos = start + valid
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos + i))
        pl, pc = pstep(pp, pc, torch.from_numpy(tok), torch.from_numpy(pos + i))
        assert_close(pl.numpy(), np.asarray(jl), **Q8_TOL, msg=f"decode {i}")
    _bf16_cache(jc, pc, "after decode")

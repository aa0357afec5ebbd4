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

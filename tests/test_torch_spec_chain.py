"""The port's speculative chain (hip_llama_tpu_torch/models/spec_chain.py):
tests/test_spec_chain.py's check, that greedy speculation is an execution
strategy and never a change of output: the lookup chain's committed
stream equals the plain greedy chain's, token for token. Run on the golden
fixture (assets/golden/model.bin, fp32) and on the tiny random model of
tests/test_spec_chain.py; on the fixture the port's plain chain is also
held to the JAX package's plain chain."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hip_llama_tpu.models import init_kv_cache as jax_init_kv_cache
from hip_llama_tpu.models import params_from_weights as jax_params_from_weights
from hip_llama_tpu.models.spec_chain import make_plain_chain as jax_make_plain_chain
from hip_llama_tpu_torch.io.checkpoint import load_checkpoint
from hip_llama_tpu_torch.models import init_kv_cache, params_from_weights
from hip_llama_tpu_torch.models.spec_chain import (
    NO_TOKEN,
    make_plain_chain,
    make_spec_lookup_chain,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "assets", "golden", "model.bin")
PROMPT = [1, 5, 9, 5, 9]
H, K, N_ROUNDS = 64, 4, 12


@pytest.fixture(scope="module")
def models(tiny_cfg, tiny_weights):
    g_cfg, g_w = load_checkpoint(MODEL)
    return {"golden": (g_cfg, g_w), "tiny": (tiny_cfg, tiny_weights)}


def _seed(cfg, params):
    """The prompt force-fed through one-step plain chains: the cache, the
    last prompt token and its position."""
    cache = init_kv_cache(cfg, 1, device="cpu")
    plain1 = make_plain_chain(cfg, n_steps=1)
    tok, pos = torch.tensor(PROMPT[0], dtype=torch.int32), torch.tensor(0, dtype=torch.int32)
    for t in PROMPT[1:]:
        _, cache, _, pos = plain1(params, cache, tok, pos)
        tok = torch.tensor(t, dtype=torch.int32)
    return cache, tok, pos


@pytest.mark.parametrize("model", ["golden", "tiny"])
def test_spec_chain_matches_plain_greedy(models, model):
    cfg, w = models[model]
    params = params_from_weights(w, dtype=torch.float32, device="cpu")
    n_tok = N_ROUNDS * (K + 1)
    cache, tok, pos = _seed(cfg, params)
    toks_plain, _, _, pos_plain = make_plain_chain(cfg, n_steps=n_tok)(params, cache, tok, pos)
    assert int(pos_plain) == int(pos) + n_tok

    cache, tok, pos0 = _seed(cfg, params)
    hist = torch.full((H,), NO_TOKEN, dtype=torch.int32)
    hist[-len(PROMPT):] = torch.tensor(PROMPT, dtype=torch.int32)
    chain = make_spec_lookup_chain(cfg, k=K, n_rounds=N_ROUNDS, hist_len=H)
    toks, counts, _, nxt, pos, hist_out = chain(params, cache, tok, pos0, hist)
    assert toks.shape == (N_ROUNDS, K + 1) and counts.shape == (N_ROUNDS,)
    flat = [t for r in range(N_ROUNDS) for t in toks[r, : counts[r]].tolist()]
    n = min(len(flat), n_tok)
    assert n >= N_ROUNDS  # at least one token a round
    assert flat[:n] == toks_plain[:n].tolist()
    # the stream advanced pos by exactly its length, and ends the history
    assert int(pos) - int(pos0) == len(flat)
    assert int(nxt) == flat[-1]
    tail = hist_out[-min(8, len(flat)):].tolist()
    assert tail == flat[-len(tail):]


def test_plain_chain_matches_the_jax_plain_chain(models):
    cfg, w = models["golden"]
    params = params_from_weights(w, dtype=torch.float32, device="cpu")
    jp = jax_params_from_weights(w)
    cache = init_kv_cache(cfg, 1, device="cpu")
    got, *_ = make_plain_chain(cfg, n_steps=24)(params, cache, torch.tensor(1, dtype=torch.int32),
                                                torch.tensor(0, dtype=torch.int32))
    want, *_ = jax_make_plain_chain(cfg, n_steps=24, attn_impl="xla", precision="highest")(
        jp, jax_init_kv_cache(cfg, 1, dtype=jnp.float32), jnp.int32(1), jnp.int32(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

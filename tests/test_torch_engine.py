"""The port's InferenceEngine (hip_llama_tpu_torch/engine/engine.py) against
the JAX package's: greedy continuous-batching serve gives the same
generations and token count; chunked prefill equals force-feeding; the
output does not depend on the batch size; greedy generate matches too."""

import numpy as np
import pytest
import torch

from hip_llama_tpu.engine import InferenceEngine as JaxEngine
from hip_llama_tpu.engine import Requests as JaxRequests
from hip_llama_tpu.models import params_from_weights as jax_params_from_weights
from hip_llama_tpu_torch.engine import InferenceEngine, Requests
from hip_llama_tpu_torch.models import params_from_jax_numpy
from hip_llama_tpu_torch.sampler import Sampler
from hip_llama_tpu_torch.tokenizer import Tokenizer

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

PROMPTS = ["hello", "hell hello hello", "", "he", " hello hello hello hello hello", "ol"]
STEPS = 40


@pytest.fixture(scope="module")
def setup(tiny_cfg, tiny_weights, toy_tokenizer):
    jp = jax_params_from_weights(tiny_weights)
    pp = params_from_jax_numpy({f: np.asarray(getattr(jp, f)) for f in jp._fields},
                               device="cpu")
    tok = Tokenizer(toy_tokenizer.vocab, toy_tokenizer.scores)
    return tiny_cfg, jp, pp, tok, toy_tokenizer


def _serve(cfg, params, tok, batch, **kw):
    eng = InferenceEngine(cfg, params, tok, batch_size=batch, **kw)
    req = Requests(prompts=list(PROMPTS), generations=[""] * len(PROMPTS))
    n = eng.serve(req, steps=STEPS, samplers=[Sampler(cfg.vocab_size, 0.0) for _ in PROMPTS])
    return n, req.generations


def test_greedy_serve_matches_jax_engine(setup):
    cfg, jp, pp, tok, jtok = setup
    jeng = JaxEngine(cfg, jp, jtok, batch_size=2, attn_impl="pallas")
    jreq = JaxRequests(prompts=list(PROMPTS), generations=[""] * len(PROMPTS))
    from hip_llama_tpu.sampler import Sampler as JaxSampler

    jn = jeng.serve(jreq, steps=STEPS, samplers=[JaxSampler(cfg.vocab_size, 0.0) for _ in PROMPTS])
    stats: dict = {}
    eng = InferenceEngine(cfg, pp, tok, batch_size=2)
    req = Requests(prompts=list(PROMPTS), generations=[""] * len(PROMPTS))
    n = eng.serve(req, steps=STEPS, samplers=[Sampler(cfg.vocab_size, 0.0) for _ in PROMPTS],
                  stats=stats)
    assert (n, req.generations) == (jn, jreq.generations)
    assert stats["total_tokens"] == n and stats["ttft_p50_s"] is not None
    assert sum(eng.prefill_chunks.values()) > 0


def test_prefill_equals_force_feed_and_batch_invariance(setup):
    cfg, _, pp, tok, _ = setup
    ref = _serve(cfg, pp, tok, 2)
    assert _serve(cfg, pp, tok, 2, use_prefill=False) == ref
    assert _serve(cfg, pp, tok, 4) == ref


def test_generate_matches_jax_engine(setup):
    cfg, jp, pp, tok, jtok = setup
    jres = JaxEngine(cfg, jp, jtok, batch_size=1, attn_impl="pallas").generate(" hello hell", 30)
    for use_prefill in (True, False):
        res = InferenceEngine(cfg, pp, tok, batch_size=1, use_prefill=use_prefill).generate(
            " hello hell", 30)
        assert (res.text, res.token_ids, res.n_gen_tokens) == (
            jres.text, jres.token_ids, jres.n_gen_tokens)

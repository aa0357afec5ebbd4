"""The port's host layer against the JAX package's: checkpoint readers on
files the JAX writers made (and the port's writers read back by the JAX
readers), random weights, the tokenizer.bin format, BPE encode/decode on the
committed golden tokenizer, and the xorshift64* sampler streams."""

import os

import numpy as np
import pytest
import torch

from hip_llama_tpu import sampler as jax_sampler
from hip_llama_tpu.config import tiny_config
from hip_llama_tpu.io import checkpoint as jck
from hip_llama_tpu.tokenizer import Tokenizer as JaxTokenizer
from hip_llama_tpu_torch import sampler as port_sampler
from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.io import checkpoint as pck
from hip_llama_tpu_torch.io.tokenizer_io import read_tokenizer_bin
from hip_llama_tpu_torch.tokenizer import Tokenizer, printable_piece

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_TOK = os.path.join(REPO, "assets", "golden", "tokenizer.bin")
FIELDS = ("tok_emb", "rms_att", "wq", "wk", "wv", "wo", "rms_ffn", "w1", "w2",
          "w3", "rms_final", "wcls")


@pytest.mark.parametrize("version", [0, 1])
@pytest.mark.parametrize("shared", [True, False])
def test_readers_match_jax(tmp_path, version, shared):
    cfg = tiny_config(shared_classifier=shared)
    w = jck.random_weights(cfg, seed=3)
    path = str(tmp_path / f"m{version}.bin")
    (jck.write_v0 if version == 0 else jck.write_v1)(path, cfg, w)
    cfg_j, w_j = jck.load_checkpoint(path)
    cfg_p, w_p = pck.load_checkpoint(path)
    assert cfg_p == ModelConfig(**vars(cfg_j))
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(w_p, name), getattr(w_j, name), err_msg=name)


@pytest.mark.parametrize("version", [0, 1])
def test_writers_read_back_by_jax(tmp_path, version):
    cfg = ModelConfig(**vars(tiny_config(shared_classifier=False)))
    w = pck.random_weights(cfg, seed=4)
    w_j = jck.random_weights(tiny_config(shared_classifier=False), seed=4)
    for name in FIELDS:  # same seed, same arrays
        np.testing.assert_array_equal(getattr(w, name), getattr(w_j, name), err_msg=name)
    path = str(tmp_path / f"p{version}.bin")
    (pck.write_v0 if version == 0 else pck.write_v1)(path, cfg, w)
    _, back = (jck.read_v0 if version == 0 else jck.read_v1)(path)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(back, name), getattr(w, name), err_msg=name)


def test_quantized_checkpoints_name_the_missing_port(tmp_path):
    cfg = tiny_config()
    path = str(tmp_path / "q.bin")
    jck.write_v2(path, cfg, jck.random_weights(cfg, seed=5))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        pck.load_checkpoint(path)


def test_golden_tokenizer_matches_jax():
    tok = Tokenizer.from_file(GOLDEN_TOK, 512)
    ref = JaxTokenizer.from_file(GOLDEN_TOK, 512)
    assert (tok.vocab, tok.scores, tok.max_token_length) == (ref.vocab, ref.scores, ref.max_token_length)
    assert read_tokenizer_bin(GOLDEN_TOK, 512)[1] == ref.vocab
    texts = []
    for c in ("gen", "sciq", "tinystories", "truthful_qa", "wikipedia"):
        with open(os.path.join(REPO, "assets", "in", f"{c}_in_32.txt"), errors="replace") as f:
            texts += f.read().splitlines()[1:]
    texts += ["", " ", "héllo wörld ☃ 日本", "a\tb\nc"]
    for text in texts:
        ids = tok.encode(text, bos=True, eos=False)
        assert ids == ref.encode(text, bos=True, eos=False), text
        assert tok.encode(text, bos=False, eos=True) == ref.encode(text, bos=False, eos=True)
        assert tok.decode(ids[1:]) == ref.decode(ids[1:])
        for a, b in zip(ids, ids[1:]):
            assert printable_piece(tok.decode_piece(a, b)) == printable_piece(ref.decode_piece(a, b))


@pytest.mark.parametrize("seed", [314028, 1, 0, 2**63 + 5])
def test_sampler_streams_match_jax(seed):
    p, j = port_sampler.XorShift64Star(seed), jax_sampler.XorShift64Star(seed)
    assert [p.next_u32() for _ in range(200)] == [j.next_u32() for _ in range(200)]
    assert [p.next_f32() for _ in range(200)] == [j.next_f32() for _ in range(200)]
    rng = np.random.default_rng(seed % 2**32)
    sp = port_sampler.Sampler(512, temperature=0.9, topp=0.9, seed=seed)
    sj = jax_sampler.Sampler(512, temperature=0.9, topp=0.9, seed=seed)
    rp, rj = port_sampler.request_sampler(512), jax_sampler.request_sampler(512)
    for _ in range(50):
        logits = rng.standard_normal(512).astype(np.float32) * 3
        assert sp.sample(logits) == sj.sample(logits)
        assert rp.sample(logits) == rj.sample(logits)

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
    """v2 (Q8_0) and v4 (int4) files load now: a v4 file of the JAX writer
    reads into the JAX reader's arrays; a version no package writes raises."""
    cfg = tiny_config(hidden_dim=192)
    path = str(tmp_path / "q.bin")
    jck.write_v4(path, cfg, jck.random_weights(cfg, seed=5))
    _, want = jck.read_v4(path)
    _, got = pck.load_checkpoint(path)
    assert isinstance(got, pck.Q4Weights)
    for name in ("emb_q", "emb_s", "wq", "w2", "wcls"):
        a, b = getattr(got, name), getattr(want, name)
        for x, y in ((a, b),) if name.startswith("emb") else ((a.q, b.q), (a.s, b.s)):
            np.testing.assert_array_equal(x, y, err_msg=name)
    with open(path, "r+b") as f:
        f.seek(4)
        f.write(np.int32(3).tobytes())
    with pytest.raises(ValueError, match="unsupported checkpoint version 3"):
        pck.load_checkpoint(path)


Q8_CFG = dict(dim=64, hidden_dim=192, n_heads=8, n_kv_heads=4, seq_len=64)


def _quant_fields(qw):
    yield "q_tokens", qw.q_tokens
    yield "wcls", qw.wcls
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        for l, t in enumerate(getattr(qw, name)):
            yield f"{name}[{l}]", t


@pytest.mark.parametrize("shared", [True, False])
def test_v2_writers_and_readers_match_jax(tmp_path, shared):
    """The port's write_v2 writes the JAX writer's bytes, and each package's
    read_v2 reads the other's file to the same int8 values and scales."""
    cfg_j = tiny_config(shared_classifier=shared, **Q8_CFG)
    cfg = ModelConfig(**vars(cfg_j))
    w = pck.random_weights(cfg, seed=6)
    pj, pp = str(tmp_path / "j.bin"), str(tmp_path / "p.bin")
    err_j = jck.write_v2(pj, cfg_j, jck.random_weights(cfg_j, seed=6), group_size=32)
    err_p = pck.write_v2(pp, cfg, w, group_size=32)
    assert err_p == err_j
    with open(pj, "rb") as f, open(pp, "rb") as g:
        assert f.read() == g.read()
    (cfg_a, qa), (cfg_b, qb) = jck.load_checkpoint(pp), pck.load_checkpoint(pj)
    assert cfg_b == ModelConfig(**vars(cfg_a)) and cfg_b.group_size == 32
    for name in ("rms_att", "rms_ffn", "rms_final"):
        np.testing.assert_array_equal(getattr(qb, name), getattr(qa, name), err_msg=name)
    for (name, ta), (_, tb) in zip(_quant_fields(qa), _quant_fields(qb)):
        np.testing.assert_array_equal(tb.q, ta.q, err_msg=name)
        np.testing.assert_array_equal(tb.s, ta.s, err_msg=name)
        np.testing.assert_array_equal(pck.dequantize(tb, 32), jck.dequantize(ta, 32),
                                      err_msg=name)


@pytest.mark.parametrize("shared", [True, False])
def test_q8_params_bit_identical(tmp_path, shared):
    """qparams_from_quant_weights on a v2 file equals quantize_params_q8 on
    the fp32 weights bit for bit (test_q8_model.py:106-128), and both equal
    the JAX package's unstack_quant_params(quantize_params_q8(...)) carried
    across by qparams_from_jax_numpy."""
    import jax

    from hip_llama_tpu.models.params import quantize_params_q8 as jax_q8
    from hip_llama_tpu.models.params import unstack_quant_params
    from hip_llama_tpu_torch.models.params import (
        qparams_from_jax_numpy,
        qparams_from_quant_weights,
        quantize_params_q8,
    )

    cfg_j = tiny_config(shared_classifier=shared, **Q8_CFG)
    cfg = ModelConfig(**vars(cfg_j))
    w = pck.random_weights(cfg, seed=7)
    path = str(tmp_path / "m.bin")
    pck.write_v2(path, cfg, w, group_size=32)
    cfg2, qw = pck.load_checkpoint(path)
    from_file = qparams_from_quant_weights(cfg2, qw, device="cpu")
    in_memory = quantize_params_q8(cfg, w, group_size=32, device="cpu")
    jp = unstack_quant_params(jax_q8(cfg_j, jck.random_weights(cfg_j, seed=7), group_size=32))
    carried = qparams_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp)._asdict(),
                                     device="cpu")

    def leaves(p):
        yield "tok_emb_q", p.tok_emb_q
        yield "tok_emb_s", p.tok_emb_s
        yield "rms_final", p.rms_final
        yield "wcls.q", p.wcls.q
        yield "wcls.s", p.wcls.s
        for name in ("rms_att", "rms_ffn"):
            for l, t in enumerate(getattr(p, name)):
                yield f"{name}[{l}]", t
        for name in ("wq", "wo", "w1", "w2"):
            for l, t in enumerate(getattr(p, name)):
                yield f"{name}[{l}].q", t.q
                yield f"{name}[{l}].s", t.s
        assert p.wk == p.wv == p.w3 == ()

    for other in (in_memory, carried):
        for (name, a), (_, b) in zip(leaves(from_file), leaves(other)):
            assert a.dtype == b.dtype and torch.equal(a, b), name
            # the kernels take row-major operands and refuse strided ones
            assert a.is_contiguous() and b.is_contiguous(), name
    assert from_file.wq[0].q.shape == (cfg.dim, cfg.dim + 2 * cfg.kv_dim)
    assert from_file.w1[0].q.shape == (cfg.dim, 2 * cfg.hidden_dim)


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

"""The four-write KV commit (HIPLLAMA_KV_COMMIT=0): the port's plain
kv_write_rows (K8) and scale_write_rows (K9) against the JAX kernels in
interpret mode on the same numpy inputs (S 256, HS 128, positions 0, 129
and 255, as tests/test_kv_chunk.py:185-240; bf16, fp32 and int8 planes,
with and without K8's `valid`), the four writes against kv_commit_rows (K2)
bit for bit, the decode step and the CLI under the knob, and the launches
the CUDA wrappers would make (recorded, not made).

Tolerance: none. The writers move values; the int8 rows and their scales
come from quantize_kv_rows on both routes.
"""

import io
import os
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hip_llama_tpu.ops import cache as jc
from hip_llama_tpu_torch import run as port_run
from hip_llama_tpu_torch.models.llama import KVCache, _kernels, _step_commit
from hip_llama_tpu_torch.ops import cache as C
from test_torch_attention import _on_card, launches  # noqa: F401 (a fixture)

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "assets", "golden", "model.bin")
TOK = os.path.join(REPO, "assets", "golden", "tokenizer.bin")
CORPORA = ["gen", "sciq", "tinystories", "truthful_qa", "wikipedia"]
B, L, KVH, S, HS = 3, 4, 8, 256, 128
POS = np.array([0, 129, 255], np.int32)
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp32": (jnp.float32, torch.float32),
          "int8": (jnp.int8, torch.int8)}


def _planes(rng, dtype: str, kvh: int = KVH):
    """A cache plane (B, L, KVH, S, HS) and a step's rows (L, B, KVH, HS) of
    `dtype`, as numpy arrays exactly representable in it."""
    if dtype == "int8":
        return (rng.integers(-127, 128, (B, L, kvh, S, HS)).astype(np.int8),
                rng.integers(-127, 128, (L, B, kvh, HS)).astype(np.int8))
    plane = rng.standard_normal((B, L, kvh, S, HS)).astype(np.float32)
    rows = rng.standard_normal((L, B, kvh, HS)).astype(np.float32)
    if dtype == "bf16":
        plane, rows = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                       for a in (plane, rows))
    return plane, rows


@pytest.mark.parametrize("valid", [None, [1, 0, 1]], ids=["all", "valid"])
@pytest.mark.parametrize("dtype", ["bf16", "fp32", "int8"])
def test_plain_kv_write_rows_matches_jax(dtype, valid):
    rng = np.random.default_rng(80)
    plane, rows = _planes(rng, dtype)
    jdt, pdt = DTYPES[dtype]
    jv = None if valid is None else jnp.asarray(valid, jnp.int32)
    want = jc.kv_write_rows(jnp.asarray(plane, jdt), jnp.asarray(rows, jdt), jnp.asarray(POS),
                            jv, interpret=True)
    got = C.kv_write_rows(torch.from_numpy(plane).to(pdt), torch.from_numpy(rows).to(pdt),
                          torch.from_numpy(POS),
                          None if valid is None else torch.tensor(valid, dtype=torch.int32))
    assert got.dtype == pdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # every row but the written ones keeps its value
    keep = np.ones((B, S), bool)
    for b in range(B):
        if valid is None or valid[b]:
            keep[b, POS[b]] = False
    np.testing.assert_array_equal(got.float().numpy().transpose(0, 3, 1, 2, 4)[keep],
                                  plane.astype(np.float32).transpose(0, 3, 1, 2, 4)[keep])


@pytest.mark.parametrize("kvh", [8, 4], ids=["kernel", "xla"])
def test_plain_scale_write_rows_matches_jax(kvh):
    """At KVH 8 the JAX writer runs its kernel, at KVH 4 its XLA fallback
    (cache.py:444-455); the port's one rule matches both."""
    rng = np.random.default_rng(81)
    plane = rng.random((B, L, kvh, S)).astype(np.float32)
    srows = rng.random((L, B, kvh)).astype(np.float32)
    want = jc.scale_write_rows(jnp.asarray(plane), jnp.asarray(srows), jnp.asarray(POS),
                               interpret=True)
    got = C.scale_write_rows(torch.from_numpy(plane), torch.from_numpy(srows),
                             torch.from_numpy(POS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_positions_outside_the_cache_write_nothing():
    """K2's position rule (ROADMAP.md section 3): a slot at -1 or S writes
    no row and no scale."""
    rng = np.random.default_rng(82)
    plane, rows = _planes(rng, "bf16")
    pos = torch.tensor([-1, S, 3], dtype=torch.int32)
    got = C.kv_write_rows(torch.from_numpy(plane).to(torch.bfloat16),
                          torch.from_numpy(rows).to(torch.bfloat16), pos)
    want = torch.from_numpy(plane).to(torch.bfloat16)
    want[2, :, :, 3] = torch.from_numpy(rows[:, 2]).to(torch.bfloat16)
    assert torch.equal(got, want)
    sc = torch.ones(B, L, KVH, S)
    C.scale_write_rows(sc, torch.full((L, B, KVH), 2.0), pos)
    assert sc.sum() == B * L * KVH * S + L * KVH and (sc[2, :, :, 3] == 2).all()


def _cache(rng, dtype: str, kvh: int = 4):
    k, _ = _planes(rng, dtype, kvh)
    v, _ = _planes(rng, dtype, kvh)
    pdt = DTYPES[dtype][1]
    c = KVCache(torch.from_numpy(k).to(pdt), torch.from_numpy(v).to(pdt))
    if dtype == "int8":
        c.k_scale = torch.from_numpy(rng.random((B, L, kvh, S)).astype(np.float32))
        c.v_scale = torch.from_numpy(rng.random((B, L, kvh, S)).astype(np.float32))
    return c


def _copy(c: KVCache) -> KVCache:
    return KVCache(*(None if t is None else t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale)))


@pytest.mark.parametrize("dtype,rows", [("bf16", "bf16"), ("fp32", "fp32"), ("int8", "bf16"),
                                        ("int8", "fp32")])
def test_four_writes_equal_kv_commit_rows(dtype, rows, monkeypatch):
    """The step's commit under HIPLLAMA_KV_COMMIT=0 (quantize_kv_rows, K8 on
    each plane, K9 on each scale plane) writes what K2 writes, bit for bit:
    K2 quantizes in the kernel as quantize_kv_rows does (absmax * fp32(1/127),
    round half to even). A bf16 or fp32 cache takes rows of its own dtype,
    an int8 cache bf16 or fp32 rows."""
    rng = np.random.default_rng(83)
    c0 = _cache(rng, dtype)
    rdt = DTYPES[rows][1]
    k_rows = torch.from_numpy(rng.standard_normal((L, B, 4, HS)).astype(np.float32)).to(rdt)
    v_rows = torch.from_numpy(rng.standard_normal((L, B, 4, HS)).astype(np.float32)).to(rdt)
    k_rows[1, 0, 2] = 0  # an all-zero row takes scale 1
    pos = torch.tensor([5, 0, S - 1], dtype=torch.int32)
    k2 = C.kv_commit_rows(_copy(c0), k_rows, v_rows, pos)
    monkeypatch.setenv("HIPLLAMA_KV_COMMIT", "0")
    four = _step_commit(_kernels(plain=False))
    assert four is not C.kv_commit_rows
    got = four(_copy(c0), k_rows, v_rows, pos)
    for f in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(got, f), getattr(k2, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    monkeypatch.setenv("HIPLLAMA_KV_COMMIT", "1")
    assert _step_commit(_kernels(plain=False)) is C.kv_commit_rows


@pytest.mark.parametrize("model", ["fp32", "q8 int8"])
def test_step_under_the_knob_equals_the_default(model, monkeypatch):
    """The decode step and its caches with HIPLLAMA_KV_COMMIT=0 equal the
    default's bit for bit, on the dense fp32 path and Q8 with an int8 cache;
    the four writes run (two K8 calls, and on the int8 cache two K9 calls,
    per step) and K2 does not."""
    from hip_llama_tpu.config import tiny_config
    from hip_llama_tpu.io.checkpoint import random_weights
    from hip_llama_tpu_torch.config import ModelConfig
    from hip_llama_tpu_torch.models import (
        init_kv_cache,
        llama,
        make_decode_step,
        params_from_weights,
        quantize_params_q8,
    )

    calls = {"commit": 0, "write_rows": 0, "scale_rows": 0}

    def count(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    kn = llama._kernels(False)
    monkeypatch.setattr(llama, "_kernels", lambda plain: llama._Kernels(**{
        **kn.__dict__, **{name: count(name, getattr(kn, name)) for name in calls}}))
    cfg = ModelConfig(**vars(tiny_config(dim=64, hidden_dim=128, n_layers=2, n_heads=4,
                                         n_kv_heads=2, seq_len=32)))
    w = random_weights(cfg, seed=84)
    q8 = model == "q8 int8"
    params = (quantize_params_q8(cfg, w, group_size=32, device="cpu") if q8
              else params_from_weights(w, device="cpu"))
    out = {}
    for knob in ("1", "0"):
        monkeypatch.setenv("HIPLLAMA_KV_COMMIT", knob)
        step = make_decode_step(cfg)
        cache = init_kv_cache(cfg, 3, device="cpu", quantized=q8)
        calls.update(commit=0, write_rows=0, scale_rows=0)
        rng = np.random.default_rng(84)
        for i in range(3):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, 3).astype(np.int32))
            logits, cache = step(params, cache, tok, torch.tensor([i, 2 * i, 5], dtype=torch.int32))
        out[knob] = (logits, cache, dict(calls))
    for f in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(out["0"][1], f), getattr(out["1"][1], f)
        assert (a is None and b is None) or torch.equal(a, b), f
    assert torch.equal(out["0"][0], out["1"][0])
    assert out["1"][2] == {"commit": 3, "write_rows": 0, "scale_rows": 0}
    assert out["0"][2] == {"commit": 0, "write_rows": 6, "scale_rows": 6 if q8 else 0}


def _serve(tmp_path, corpus, args):
    out = str(tmp_path / f"{corpus}.out")
    with redirect_stdout(io.StringIO()):
        rc = port_run.main(["run", MODEL, "-z", TOK, "-m", "test", "-t", "0.0", "-b", "4",
                            "-f", os.path.join(REPO, "assets", "in", f"{corpus}_in_8.txt"),
                            "-o", out, "--device", "cpu", *args])
    assert rc == 0
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("corpus", CORPORA)
def test_cli_four_writes_fp32_byte_identical_to_cpu_f32(tmp_path, monkeypatch, corpus):
    monkeypatch.setenv("HIPLLAMA_KV_COMMIT", "0")
    with open(os.path.join(REPO, "assets", "out", "cpu_f32", f"{corpus}_in_8.out"), "rb") as f:
        assert _serve(tmp_path, corpus, ["--dtype", "float32"]) == f.read()


@pytest.mark.parametrize("corpus", ["gen", "wikipedia"])
def test_cli_four_writes_q8_int8_equal_the_default_commit(tmp_path, monkeypatch, corpus):
    """Q8 with --kv int8 under HIPLLAMA_KV_COMMIT=0 writes the files the
    default commit writes, byte for byte."""
    args = ["--quant", "q8", "--kv", "int8"]
    default = _serve(tmp_path, corpus, args)
    monkeypatch.setenv("HIPLLAMA_KV_COMMIT", "0")
    assert _serve(tmp_path, corpus, args) == default


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_cuda_wrappers_launch_one_plane(launches, monkeypatch, dtype):
    """On CUDA tensors (recorded, not launched) K8 binds kv_write_rows once
    per plane, with the row's bytes and the valid mask (or none), and K9
    binds scale_write_rows once per scale plane; the C declarations'
    parameter counts hold."""
    monkeypatch.setattr(C, "_stream", lambda: 0)
    pdt = DTYPES[dtype][1]
    plane = _on_card(torch.zeros(B, L, KVH, S, HS, dtype=pdt))
    rows = _on_card(torch.zeros(L, B, KVH, HS, dtype=pdt))
    pos = _on_card(torch.tensor(POS))
    valid = _on_card(torch.ones(B, dtype=torch.int32))
    C.kv_write_rows(plane, rows, pos)
    C.kv_write_rows(plane, rows, pos, valid)
    sc = _on_card(torch.ones(B, L, KVH, S))
    C.scale_write_rows(sc, _on_card(torch.ones(L, B, KVH)), pos)
    assert [fn for fn, _ in launches] == ["kv_write_rows", "kv_write_rows", "scale_write_rows"]
    (_, a0), (_, a1), (_, a2) = launches
    assert a0[0] == plane.data_ptr() and a0[3] == 0 and a1[3] == valid.data_ptr()
    assert a0[4:9] == (B, L, KVH, S, HS * plane.element_size())
    assert a2[0] == sc.data_ptr() and a2[3:7] == (B, L, KVH, S)
    with pytest.raises(TypeError):
        C.kv_write_rows(plane, _on_card(torch.zeros(L, B, KVH, HS)), pos)  # rows not of its dtype

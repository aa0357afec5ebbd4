"""The port's model, engine and CLI in the `a8` modes (HIPLLAMA_Q8_MODE=a8,
HIPLLAMA_Q4_MODE=a8) against the JAX package's.

The JAX package reads its mode when it is imported, so its side runs in a
subprocess with the knob set; it saves its logits, and the port's plain
path (on the same params, carried over by qparams_from_jax_numpy) is held
to them: the chunked prefill then three decode steps on a dense bf16 cache
and on an int8 cache, and on bf16 pages for Q8 (int4 on pages too, against
the JAX paged functions on the unfused unrolled params, as
tests/test_torch_paged_model.py does). Both sides take block_n 64, as the
goldens do, so that the JAX FFN kernels run at the model's hidden width 192
(ROADMAP.md section 3); there the JAX q8_matmul_ffn declines and its
fallback runs q8_matmul_silu and q8_matmul in `a8`
(ops/quant.py::ffn_takes_kernel). Tolerance: logits at atol 0.15, rtol
0.05, as the reshape-mode Q8 and int4 step tests (bf16 activations rounded
after fp32 sums taken in another order).

The CLI with the knobs is scored against the JAX package's outputs in
assets/out/cpu_q8_a8/, cpu_q8_kv8_a8/ and cpu_q4_a8/ (the commands are in
CHANGES.md) at the bars of tests/test_torch_goldens.py; under `a8` the Q8
decode layer is the four-kernel one (no q8_layer_fused), and values of the
knobs the port does not serve exit non-zero.
"""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu_torch import run as port_run
from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.engine.requests import read_inputfile
from hip_llama_tpu_torch.models import (
    init_kv_cache,
    make_decode_step,
    make_prefill,
    qparams_from_jax_numpy,
)
from hip_llama_tpu_torch.models.paged import (
    init_paged_kv_cache,
    make_paged_decode_step,
    make_paged_prefill,
)
from hip_llama_tpu_torch.ops import quant as Q

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "assets", "golden", "model.bin")
TOK = os.path.join(REPO, "assets", "golden", "tokenizer.bin")
IN = os.path.join(REPO, "assets", "in")
OUT = os.path.join(REPO, "assets", "out")
CORPORA = ["gen", "sciq", "tinystories", "truthful_qa", "wikipedia"]
TOL = dict(atol=0.15, rtol=0.05)
B, T, PS = 3, 16, 16
KNOBS = {"q8": {"HIPLLAMA_Q8_MODE": "a8", "HIPLLAMA_Q8_BLOCK_N": "64"},
         "q4": {"HIPLLAMA_Q4_MODE": "a8", "HIPLLAMA_Q4_BLOCK_N": "64"}}

# the model, its params and the run's inputs: executed by both sides
SETUP = r'''
import numpy as np
from hip_llama_tpu.config import tiny_config
from hip_llama_tpu.io.checkpoint import random_weights
from hip_llama_tpu.models.params import (quantize_params_q4, quantize_params_q8,
                                         unstack_quant_params)


def setup(kind):
    cfg = tiny_config(dim=128, hidden_dim=192, n_layers=2, n_heads=8, n_kv_heads=4,
                      seq_len=64)
    w = random_weights(cfg, seed=61 if kind == "q8" else 62)
    stacked = (quantize_params_q8(cfg, w, group_size=64) if kind == "q8"
               else quantize_params_q4(cfg, w))
    return cfg, unstack_quant_params(stacked), unstack_quant_params(stacked, fuse=False)


def inputs(vocab):
    rng = np.random.default_rng(60)
    tokens = rng.integers(0, vocab, (3, 16)).astype(np.int32)
    start, valid = np.zeros(3, np.int32), np.array([16, 9, 0], np.int32)
    steps = [(rng.integers(0, vocab, (3,)).astype(np.int32),
              np.array([16 + i, 9 + i, i], np.int32)) for i in range(3)]
    table = (rng.permutation(12) + 1).reshape(3, 4).astype(np.int32)
    return tokens, start, valid, steps, table
'''

JAX_SIDE = SETUP + r'''
import sys
import jax
import jax.numpy as jnp
from hip_llama_tpu.models import init_kv_cache, make_decode_step, make_prefill
from hip_llama_tpu.models import paged

kind, out = sys.argv[1], sys.argv[2]
cfg, jp, jp_unfused = setup(kind)
tokens, start, valid, steps, table = inputs(cfg.vocab_size)
logits = {}
for name, int8 in (("dense", False), ("int8", True)):
    pre = jax.jit(make_prefill(cfg, attn_impl="pallas", precision="default"))
    step = jax.jit(make_decode_step(cfg, attn_impl="pallas", precision="default"))
    c = init_kv_cache(cfg, 3, dtype=jnp.bfloat16, quantized=int8)
    lg, c = pre(jp, c, jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(valid))
    logits[f"{name} prefill"] = np.asarray(lg)
    for i, (tok, pos) in enumerate(steps):
        lg, c = step(jp, c, jnp.asarray(tok), jnp.asarray(pos))
        logits[f"{name} step {i}"] = np.asarray(lg)
pre = jax.jit(paged.make_paged_prefill(cfg, precision="default"))
step = jax.jit(paged.make_paged_decode_step(cfg, precision="default"))
c = paged.init_paged_kv_cache(cfg, 13, 16, dtype=jnp.bfloat16)
lg, c = pre(jp_unfused, c, jnp.asarray(table), jnp.asarray(tokens), jnp.asarray(start),
            jnp.asarray(valid))
logits["paged prefill"] = np.asarray(lg)
for i, (tok, pos) in enumerate(steps):
    lg, c = step(jp_unfused, c, jnp.asarray(table), jnp.asarray(tok), jnp.asarray(pos))
    logits[f"paged step {i}"] = np.asarray(lg)
np.savez(out, **logits)
'''


@pytest.fixture(scope="module", params=["q8", "q4"])
def a8_runs(request, tmp_path_factory):
    """(kind, the JAX side's logits with the knob set, cfg, the port's
    params)."""
    kind = request.param
    out = str(tmp_path_factory.mktemp(kind) / "logits.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", **KNOBS[kind])
    p = subprocess.run([sys.executable, "-c", JAX_SIDE, kind, out], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    ns: dict = {}
    exec(SETUP, ns)
    cfg_j, jp, _ = ns["setup"](kind)
    pp = qparams_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp)._asdict(), device="cpu",
                                int4=kind == "q4")
    return kind, dict(np.load(out)), ModelConfig(**vars(cfg_j)), pp, ns["inputs"]


@pytest.mark.parametrize("cache", ["dense", "int8", "paged"])
def test_a8_prefill_and_steps_match_jax(a8_runs, cache, monkeypatch):
    kind, want, cfg, pp, inputs = a8_runs
    for k, v in KNOBS[kind].items():
        monkeypatch.setenv(k, v)
    tokens, start, valid, steps, table = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                          for a in inputs(cfg.vocab_size))
    if cache == "paged":
        pc = init_paged_kv_cache(cfg, 13, PS, dtype=torch.bfloat16, device="cpu")
        pre, step = make_paged_prefill(cfg), make_paged_decode_step(cfg)
        run_pre = lambda: pre(pp, pc, table, tokens, start, valid)  # noqa: E731
        run_step = lambda tok, pos: step(pp, pc, table, tok, pos)  # noqa: E731
    else:
        pc = init_kv_cache(cfg, B, dtype=torch.bfloat16, device="cpu", quantized=cache == "int8")
        pre, step = make_prefill(cfg), make_decode_step(cfg)
        run_pre = lambda: pre(pp, pc, tokens, start, valid)  # noqa: E731
        run_step = lambda tok, pos: step(pp, pc, tok, pos)  # noqa: E731
    lg, _ = run_pre()
    for s in range(B):
        v = int(valid[s])
        if v:
            assert_close(lg.numpy()[s, :v], want[f"{cache} prefill"][s, :v], **TOL,
                         msg=f"{kind} {cache} prefill slot {s}")
    for i, (tok, pos) in enumerate(steps):
        lg, _ = run_step(torch.from_numpy(tok), torch.from_numpy(pos))
        assert_close(lg.numpy(), want[f"{cache} step {i}"], **TOL, msg=f"{kind} {cache} step {i}")


def test_a8_differs_from_reshape(a8_runs, monkeypatch):
    """The knob changes the numbers: the port's step with and without it."""
    kind, _, cfg, pp, inputs = a8_runs
    tokens, start, valid, steps, _ = inputs(cfg.vocab_size)
    out = {}
    for mode in ("a8", None):
        if mode:
            for k, v in KNOBS[kind].items():
                monkeypatch.setenv(k, v)
        else:
            for k in KNOBS[kind]:
                monkeypatch.delenv(k)
        pc = init_kv_cache(cfg, B, dtype=torch.bfloat16, device="cpu")
        make_prefill(cfg)(pp, pc, torch.from_numpy(tokens), torch.from_numpy(start),
                          torch.from_numpy(valid))
        out[mode] = make_decode_step(cfg)(pp, pc, torch.from_numpy(steps[0][0]),
                                          torch.from_numpy(steps[0][1]))[0]
    assert not torch.equal(out["a8"], out[None])


def test_q8_a8_decode_layer_is_four_kernels(monkeypatch):
    """Under a Q8 mode other than reshape the decode layer never takes
    q8_layer_fused (llama.py:282-285): its math is reshape's."""
    from hip_llama_tpu_torch.models import llama
    from hip_llama_tpu_torch.ops import layer_fused

    calls = {"layer": 0, "fused_attn": 0, "ffn": 0}

    def count(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    kn = llama._kernels(True)
    monkeypatch.setattr(llama, "_kernels", lambda plain: llama._Kernels(**{
        **kn.__dict__, "layer": count("layer", layer_fused.q8_layer_fused_plain),
        "attn_decode_fused": count("fused_attn", kn.attn_decode_fused),
        "mm_ffn": count("ffn", kn.mm_ffn)}))
    ns: dict = {}
    exec(SETUP, ns)
    cfg_j, jp, _ = ns["setup"]("q8")
    cfg = ModelConfig(**vars(cfg_j))
    pp = qparams_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp)._asdict(), device="cpu")
    tok, pos = torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32)
    make_decode_step(cfg)(pp, init_kv_cache(cfg, B, dtype=torch.bfloat16, device="cpu"), tok, pos)
    assert calls == {"layer": 2, "fused_attn": 0, "ffn": 0}
    monkeypatch.setenv("HIPLLAMA_Q8_MODE", "a8")
    calls.update(layer=0)
    make_decode_step(cfg)(pp, init_kv_cache(cfg, B, dtype=torch.bfloat16, device="cpu"), tok, pos)
    # hidden 192: the JAX K18 declines under a8, the FFN is K17 + K15
    assert calls == {"layer": 0, "fused_attn": 2, "ffn": 0}
    monkeypatch.setattr(Q, "ffn_takes_kernel", lambda *a: True)
    make_decode_step(cfg)(pp, init_kv_cache(cfg, B, dtype=torch.bfloat16, device="cpu"), tok, pos)
    assert calls == {"layer": 0, "fused_attn": 4, "ffn": 2}


def test_jax_q8_ffn_declines_to_a8_products_at_hidden_192():
    """The JAX q8_matmul_ffn under HIPLLAMA_Q8_MODE=a8 at the fixture's
    widths equals its fallback: q8_matmul_silu then q8_matmul with the
    residual, both in `a8` (quant.py:921-938), which is what the port
    serves there."""
    code = r'''
import numpy as np, jax.numpy as jnp
from hip_llama_tpu.ops import quant as q
rng = np.random.default_rng(3)
x = jnp.asarray(rng.standard_normal((4, 64)), jnp.bfloat16)
g = jnp.asarray(1 + 0.1 * rng.standard_normal(64), jnp.float32)
w13 = q.q8_quantize_weights(jnp.asarray(rng.standard_normal((64, 384)) / 8), 64)
w2 = q.q8_quantize_weights(jnp.asarray(rng.standard_normal((192, 64)) / 14), 64)
ffn = q.q8_matmul_ffn(x, w13, w2, residual=x, norm_weight=g, interpret=True)
h = q.q8_matmul_silu(x, w13, norm_weight=g, interpret=True, dequant_mode="a8")
a8 = q.q8_matmul(h, w2, residual=x, interpret=True, dequant_mode="a8")
h = q.q8_matmul_silu(x, w13, norm_weight=g, interpret=True, dequant_mode="reshape")
rs = q.q8_matmul(h, w2, residual=x, interpret=True, dequant_mode="reshape")
f, a, r = (np.asarray(v, np.float32) for v in (ffn, a8, rs))
assert np.array_equal(f, a) and not np.array_equal(f, r), "ffn is not the a8 fallback"
'''
    env = dict(os.environ, JAX_PLATFORMS="cpu", **KNOBS["q8"])
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert not Q.ffn_takes_kernel(4, 64, 192, 64, "a8")


def _scores(tmp_path, golden, extra_args):
    """Greedy -b 4 runs of the five corpora with extra_args, scored against
    `golden` as the fraction of requests byte-identical."""
    scores = {}
    for c in CORPORA:
        out = str(tmp_path / f"{c}.out")
        with redirect_stdout(io.StringIO()):
            rc = port_run.main([
                "run", MODEL, "-z", TOK, "-m", "test", "-t", "0.0",
                "-f", os.path.join(IN, f"{c}_in_8.txt"), "-o", out, "-b", "4", "--device", "cpu",
                *extra_args,
            ])
        assert rc == 0, f"port CLI failed on {c}"
        got = read_inputfile(out)
        want = read_inputfile(os.path.join(golden, f"{c}_in_8.out"))
        assert got.num_reqs == want.num_reqs
        scores[c] = sum(a == b for a, b in zip(got.prompts, want.prompts)) / want.num_reqs
    return scores


@pytest.mark.parametrize("kind,args,golden,bars", [
    ("q8", ["--quant", "q8"], "cpu_q8_a8", 2),
    ("q8", ["--quant", "q8", "--kv", "int8"], "cpu_q8_kv8_a8", 1),
    ("q4", ["--quant", "q4"], "cpu_q4_a8", 2),
], ids=["q8", "q8-kv8", "q4"])
def test_a8_cli_greedy_coverage_vs_jax_goldens(tmp_path, monkeypatch, kind, args, golden, bars):
    """The CLI with HIPLLAMA_Q8_MODE=a8 / HIPLLAMA_Q4_MODE=a8 (and block_n
    64, as the goldens were made) against the JAX package's outputs, at the
    bars of test_goldens.py:84-100: 3 corpora at 1.0 and an average of 0.75;
    with --kv int8 the average only, as in reshape mode, because a bf16 ulp
    can move a cached value to the next int8 value and greedy decoding forks
    at the next near-tie (tests/test_torch_kv_int8_model.py)."""
    for k, v in KNOBS[kind].items():
        monkeypatch.setenv(k, v)
    scores = _scores(tmp_path, os.path.join(OUT, golden), args)
    assert sum(scores.values()) / len(scores) >= 0.75, scores
    if bars == 2:
        assert sum(1 for v in scores.values() if v == 1.0) >= 3, scores


@pytest.mark.parametrize("knob,value", [
    ("HIPLLAMA_Q8_MODE", "group_dot"), ("HIPLLAMA_Q8_MODE", "repeat"),
    ("HIPLLAMA_Q8_MODE", "bf16"), ("HIPLLAMA_Q8_MODE", "f32dot"), ("HIPLLAMA_Q4_MODE", "bf16"),
    ("HIPLLAMA_Q8_MODE", "A8"),
])
def test_unported_modes_exit_nonzero(monkeypatch, capsys, knob, value):
    monkeypatch.setenv(knob, value)
    rc = port_run.main(["run", MODEL, "-z", TOK, "-n", "4", "-i", "hi", "--device", "cpu",
                        "--quant", "q8"])
    assert rc != 0 and "not yet ported" in capsys.readouterr().err

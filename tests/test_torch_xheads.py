"""K16, the JAX package's head-split wo product behind
HIPLLAMA_PREFILL_XHEADS=1 (`q8_matmul_xheads`), and the port's prefill with
both prefill knobs against the JAX prefill.

- The port's plain K16 against the JAX kernel in interpret mode, within
  one bf16 ulp at the outputs' largest magnitude
  (tests/test_torch_a8.py::assert_within_ulp): the same cast points and
  per-head fp32 partials, each summed in another order before the one
  cast; an ineligible shape flattens to q8_matmul on both sides.
- The model: Q8 params at dim 256, 2 heads of 128 (the head size K16
  needs), 2 layers, hidden 320, 4 slots, against the JAX prefill run in a
  subprocess with the knobs set (the JAX package reads them, and the
  dequant mode, when it is imported or traced): HIPLLAMA_PREFILL_MINNER=1
  on a T-160 chunk (640 rows: wo and W2 take K19, the gate K19 silu
  through the JAX fallback at hidden 320), HIPLLAMA_PREFILL_XHEADS=1 on a
  T-64 chunk (256 rows: K16; 640 rows would flatten), both knobs on the
  two chunks in turn; each knob meets the bf16 and the int8 cache. Logits
  at atol 0.15, rtol 0.05, as the other Q8 prefill tests (bf16 activations
  rounded after fp32 sums taken in another order); layer 0's int8 rows
  within one quantization step of the JAX rows (only sums in another order
  feed them), the whole int8 cache within three
  (tests/test_torch_kv_int8_model.py: what differs in one layer feeds the
  rows of the next).
- The `a8` case: under HIPLLAMA_Q8_MODE=a8 the JAX K16 keeps reshape math
  (quant.py:491-495: its call passes no dequant mode), so with XHEADS the
  JAX prefill's wo is not the w8a8 product it is without the knob. The
  `a8` activation quantization makes logits chaotic at the scale of one
  product's difference (measured: the logits of the two wo arithmetics sit
  as far from each other as from the JAX run's), so besides the logit
  tolerance the test holds the knob to what it does: with it, more of the
  port's logits are bit-equal to the JAX prefill's with the knob than
  without it (0.109 against 0.074 of them; equal fractions, and a failure,
  where the port ignores the knob).
- The CLI: the golden fixture with either knob serves what it serves
  without, and no K16 or K19 runs: its prefill has at most 4 x 96 rows (K19
  needs more than 512), its head size is 8 (K16 needs a multiple of 128)
  and its width 64 fails K19's block_n % 128.
"""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.ops import quant as jq
from hip_llama_tpu_torch import run as port_run
from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.models import init_kv_cache, make_prefill, qparams_from_jax_numpy
from hip_llama_tpu_torch.ops import quant as Q
from test_torch_a8 import assert_within_ulp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=0.15, rtol=0.05)


def _qt(rng, k, n):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    qt = jq.q8_quantize_weights(jnp.asarray(w), 64)
    return qt, Q.QTensor(torch.from_numpy(np.array(qt.q)), torch.from_numpy(np.array(qt.s)))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("m,gh", [(32, 2), (256, 2), (32, 8), (256, 8), (320, 2)])
def test_xheads_plain_matches_jax_kernel(m, gh, residual, monkeypatch):
    hs, n = 128, 256
    rng = np.random.default_rng(m + gh)
    x3 = rng.standard_normal((m, gh, hs)).astype(np.float32)
    qt, pqt = _qt(rng, gh * hs, n)
    r = rng.standard_normal((m, n)).astype(np.float32) if residual else None
    want = jq.q8_matmul_xheads(jnp.asarray(x3, jnp.bfloat16), qt, interpret=True,
                               residual=None if r is None else jnp.asarray(r, jnp.bfloat16))
    heads = []
    monkeypatch.setattr(Q, "_xheads_dot", lambda *a, _f=Q._xheads_dot: heads.append(1) or _f(*a))
    got = Q.q8_matmul_xheads(torch.from_numpy(x3).to(torch.bfloat16), pqt,
                             residual=None if r is None else torch.from_numpy(r).to(torch.bfloat16))
    eligible = m != 320  # 320 rows are neither one block nor whole 256-row blocks
    assert Q.xheads_engages(m, gh, hs, gh * hs, n, 64) == eligible and len(heads) == eligible
    assert got.shape == (m, n)
    assert_within_ulp(got.float().numpy(), np.asarray(want, np.float32), f"K16 m {m}")


def test_xheads_reads_a_strided_view():
    """x3 as a head slice of wider rows gives its result on a copy, and the
    per-head partials are not q8_matmul's one K-deep sum."""
    rng = np.random.default_rng(5)
    qt, pqt = _qt(rng, 4 * 128, 256)
    big = torch.from_numpy(rng.standard_normal((64, 6, 160)).astype(np.float32)).to(torch.bfloat16)
    view = big[:, 1:5, 16:144]
    got = Q.q8_matmul_xheads(view, pqt)
    assert torch.equal(got, Q.q8_matmul_xheads(view.contiguous(), pqt))
    assert got.shape == (64, 256)


# ---------------------------------------------------------------------------
# the model

SETUP = r'''
import numpy as np
from hip_llama_tpu.config import tiny_config
from hip_llama_tpu.io.checkpoint import random_weights
from hip_llama_tpu.models.params import quantize_params_q8, unstack_quant_params


def setup():
    cfg = tiny_config(dim=256, hidden_dim=320, n_layers=2, n_heads=2, n_kv_heads=2,
                      seq_len=256)
    return cfg, unstack_quant_params(quantize_params_q8(cfg, random_weights(cfg, seed=81),
                                                        group_size=64))


def chunks(vocab):
    """The T-160 chunk (640 rows) then the T-64 chunk (256 rows) after it."""
    rng = np.random.default_rng(80)
    t160 = (rng.integers(0, vocab, (4, 160)).astype(np.int32), np.zeros(4, np.int32),
            np.array([160, 151, 100, 0], np.int32))
    t64 = (rng.integers(0, vocab, (4, 64)).astype(np.int32), t160[2].copy(),
           np.array([64, 50, 0, 64], np.int32))
    return {"t160": t160, "t64": t64}


# (minner, xheads): the chunks run in turn, the caches they run on (each
# knob meets both caches)
RUNS = {"minner": ((True, False), ("t160",), (False,)),
        "xheads": ((False, True), ("t64",), (False, True)),
        "both": ((True, True), ("t160", "t64"), (True,))}
'''

JAX_SIDE = SETUP + r'''
import sys
import jax
import jax.numpy as jnp
from hip_llama_tpu.models import init_kv_cache, llama, make_prefill
from hip_llama_tpu.ops import quant

out, names = sys.argv[1], sys.argv[2].split(",")
cfg, jp = setup()
data = chunks(cfg.vocab_size)
res = {}
for name in names:
    (quant._ENV_PREFILL_MINNER, llama._ENV_PREFILL_XHEADS), seq, caches = RUNS[name]
    jax.clear_caches()  # the knobs are read when q8_matmul and the prefill trace
    for int8 in caches:
        pre = jax.jit(make_prefill(cfg, attn_impl="pallas", precision="default"))
        c = init_kv_cache(cfg, 4, dtype=jnp.bfloat16, quantized=int8)
        for ch in seq:
            tok, st, va = data[ch] if len(seq) > 1 else (data[ch][0], 0 * data[ch][1],
                                                         data[ch][2])
            lg, c = pre(jp, c, jnp.asarray(tok), jnp.asarray(st), jnp.asarray(va))
            res[f"{name} {int8} {ch}"] = np.asarray(lg)
        if int8:
            res[f"{name} k"] = np.asarray(c.k)
np.savez(out, **res)
'''


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX side's logits and int8 caches by run, in `reshape` (MINNER,
    XHEADS, both) and in `a8` (XHEADS): two subprocesses side by side."""
    procs = {}
    for mode, names in (("reshape", "minner,xheads,both"), ("a8", "xheads")):
        out = str(tmp_path_factory.mktemp(f"jax_{mode}") / "runs.npz")
        env = {k: v for k, v in os.environ.items() if not k.startswith("HIPLLAMA_")}
        env.update(JAX_PLATFORMS="cpu", HIPLLAMA_Q8_MODE=mode)
        procs[mode] = (subprocess.Popen([sys.executable, "-c", JAX_SIDE, out, names], env=env,
                                        cwd=REPO, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), out)
    runs = {}
    for mode, (p, out) in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
        runs[mode] = dict(np.load(out))
    return runs


@pytest.fixture(scope="module")
def model():
    ns: dict = {}
    exec(SETUP, ns)
    cfg_j, jp = ns["setup"]()
    pp = qparams_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp)._asdict(), device="cpu")
    return ModelConfig(**vars(cfg_j)), pp, ns


def _port_run(model, name, env, monkeypatch, caches=None):
    """The port's prefill under `env` for run `name`: logits by (cache,
    chunk), the int8 cache, and the K19/K16 plain-kernel calls made."""
    cfg, pp, ns = model
    knobs, seq, run_caches = ns["RUNS"][name]
    for k in ("HIPLLAMA_PREFILL_MINNER", "HIPLLAMA_PREFILL_XHEADS", "HIPLLAMA_Q8_MODE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = {"k19": 0, "k19 silu": 0, "k16": 0}

    def count(key, f):
        def counted(*a, **kw):
            calls[key] += 1
            return f(*a, **kw)
        return counted

    with monkeypatch.context() as mp:
        mp.setattr(Q, "q8_matmul_minner_plain", count("k19", Q.q8_matmul_minner_plain))
        mp.setattr(Q, "q8_matmul_silu_minner_plain",
                   count("k19 silu", Q.q8_matmul_silu_minner_plain))
        mp.setattr(Q, "_xheads_dot", count("k16", Q._xheads_dot))
        data = ns["chunks"](cfg.vocab_size)
        res = {}
        for int8 in caches or run_caches:
            pre = make_prefill(cfg)
            c = init_kv_cache(cfg, 4, dtype=torch.bfloat16, device="cpu", quantized=int8)
            for ch in seq:
                tok, st, va = data[ch]
                if len(seq) == 1:
                    st = 0 * st
                lg, c = pre(pp, c, *(torch.from_numpy(a) for a in (tok, st, va)))
                res[(int8, ch)] = lg.numpy()
            if int8:
                res["k"] = c.k.numpy()
    return res, calls, data


def _check(name, res, want, data, tag):
    for key, lg in res.items():
        if key == "k":
            a = want[f"{name} k"][:, :, :2].astype(np.int32)  # the JAX cache pads KV heads to 8
            b = lg.astype(np.int32)
            assert np.abs(a[:, 0] - b[:, 0]).max() <= 1, f"{tag}: layer 0 int8 rows"
            assert np.abs(a - b).max() <= 3, f"{tag}: int8 rows {np.abs(a - b).max()} steps apart"
            continue
        int8, ch = key
        valid = data[ch][2]
        for s, v in enumerate(valid):
            if v:
                assert_close(lg[s, :v], want[f"{name} {int8} {ch}"][s, :v], **TOL,
                             msg=f"{tag} int8={int8} {ch} slot {s}")


# the plain-kernel calls each run makes (2 layers): K19 on wo and W2 and
# K19 silu on the gate at 640 rows, K16 on wo at 256 rows
CALLS = {"minner": {"k19": 4, "k19 silu": 2, "k16": 0},
         "xheads": {"k19": 0, "k19 silu": 0, "k16": 2},
         "both": {"k19": 4, "k19 silu": 2, "k16": 2}}
ENVS = {"minner": {"HIPLLAMA_PREFILL_MINNER": "1"}, "xheads": {"HIPLLAMA_PREFILL_XHEADS": "1"},
        "both": {"HIPLLAMA_PREFILL_MINNER": "1", "HIPLLAMA_PREFILL_XHEADS": "1"}}


@pytest.mark.parametrize("name", ["minner", "xheads", "both"])
def test_prefill_with_knobs_matches_jax(model, jax_runs, name, monkeypatch):
    res, calls, data = _port_run(model, name, ENVS[name], monkeypatch)
    n_caches = len(model[2]["RUNS"][name][2])
    assert calls == {k: v * n_caches for k, v in CALLS[name].items()}
    _check(name, res, jax_runs["reshape"], data, name)


def test_xheads_keeps_reshape_math_under_a8(model, jax_runs, monkeypatch):
    jax_a8 = jax_runs["a8"]
    res, calls, data = _port_run(model, "xheads", {"HIPLLAMA_PREFILL_XHEADS": "1",
                                                   "HIPLLAMA_Q8_MODE": "a8"}, monkeypatch)
    assert calls["k16"] == 4
    _check("xheads", {k: v for k, v in res.items() if k != "k"}, jax_a8, data, "xheads a8")
    k = jax_a8["xheads k"][:, :, :2].astype(np.int32)
    assert np.abs(k[:, 0] - res["k"][:, 0].astype(np.int32)).max() <= 1
    # the knob moves the port toward the JAX prefill with the knob: wo's
    # reshape math gives more bit-equal logits than the w8a8 wo without it
    off, _, _ = _port_run(model, "xheads", {"HIPLLAMA_Q8_MODE": "a8"}, monkeypatch,
                          caches=(False,))
    valid = data["t64"][2]

    def equal(lg):
        want = jax_a8["xheads False t64"]
        return np.mean([np.mean(lg[s, :v] == want[s, :v]) for s, v in enumerate(valid) if v])

    on_eq, off_eq = equal(res[(False, "t64")]), equal(off[(False, "t64")])
    assert on_eq > off_eq + 0.01, (on_eq, off_eq)


# ---------------------------------------------------------------------------
# the CLI on the golden fixture

MODEL = os.path.join(REPO, "assets", "golden", "model.bin")
TOK = os.path.join(REPO, "assets", "golden", "tokenizer.bin")


def _serve(tmp_path, tag):
    out = str(tmp_path / f"{tag}.out")
    with redirect_stdout(io.StringIO()):
        rc = port_run.main(["run", MODEL, "-z", TOK, "-m", "test", "-t", "0.0", "-f",
                            os.path.join(REPO, "assets", "in", "gen_in_8.txt"), "-o", out,
                            "-b", "4", "--device", "cpu", "--quant", "q8"])
    assert rc == 0
    with open(out, "rb") as f:
        return f.read()


def test_cli_knobs_leave_the_fixture_as_it_is(tmp_path, monkeypatch):
    calls = []
    for f in ("q8_matmul_minner_plain", "q8_matmul_silu_minner_plain", "_xheads_dot"):
        monkeypatch.setattr(Q, f, lambda *a, _f=getattr(Q, f), **kw: calls.append(1) or _f(*a, **kw))
    plain = _serve(tmp_path, "default")
    for knob in ("HIPLLAMA_PREFILL_MINNER", "HIPLLAMA_PREFILL_XHEADS"):
        monkeypatch.setenv(knob, "1")
        assert _serve(tmp_path, knob) == plain, knob
        monkeypatch.delenv(knob)
    assert not calls

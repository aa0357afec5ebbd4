"""`--layout stacked` in the port against the JAX package: the stacked
params (fuse_stacked_quant_params, the stacked builders, the stacked form of
qparams_from_jax_numpy) bit for bit; the plain q8_matmul_layered (K20)
against the JAX q8_matmul_layered in interpret mode, in reshape and `a8`,
with each prologue and epilogue, on two layers, at decode rows, at the
edge of its `a8` rule and past 512 rows (where it hands the call to
q8_matmul); K20's `a8` decision by table; the launches its CUDA wrapper
and attention_decode's would make on the stacked step's operands (recorded,
not made); the stacked decode step and prefill against the JAX stacked step;
and the CLI's --layout.

The JAX package reads HIPLLAMA_Q8_MODE and HIPLLAMA_Q8_BLOCK_N when it is
imported, so the step comparison runs its side in a subprocess with the
knobs set, as tests/test_torch_a8_model.py does, at the goldens' block_n 64
(its FFN kernels then run at the model's hidden 192 in the prefill).

Tolerances: K20's outputs within one bf16 ulp at the output's largest
magnitude (the same cast points, fp32 sums in another order); logits at
atol 0.15, rtol 0.05 and the caches within the int8 steps of
tests/test_torch_kv_int8_model.py, as the other Q8 step tests.
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
from hip_llama_tpu_torch.engine.requests import read_inputfile
from hip_llama_tpu_torch.models import (
    init_kv_cache,
    layer_views,
    make_decode_step,
    make_prefill,
    qparams_from_jax_numpy,
    qparams_from_quant_weights,
    quantize_params_q8,
)
from hip_llama_tpu_torch.ops import attention as A
from hip_llama_tpu_torch.ops import quant as Q
from test_torch_a8 import assert_within_ulp
from test_torch_attention import _on_card, launches  # noqa: F401 (a fixture)

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
KNOBS = {"reshape": {"HIPLLAMA_Q8_BLOCK_N": "64"},
         "a8": {"HIPLLAMA_Q8_MODE": "a8", "HIPLLAMA_Q8_BLOCK_N": "64"}}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# params


def _leaves(p):
    yield "tok_emb_q", p.tok_emb_q
    yield "tok_emb_s", p.tok_emb_s
    yield "rms_final", p.rms_final
    yield "rms_att", p.rms_att
    yield "rms_ffn", p.rms_ffn
    yield "wcls.q", p.wcls.q
    yield "wcls.s", p.wcls.s
    for name in ("wq", "wo", "w1", "w2"):
        yield f"{name}.q", getattr(p, name).q
        yield f"{name}.s", getattr(p, name).s


@pytest.mark.parametrize("shared", [True, False])
def test_stacked_params_match_jax(tmp_path, shared):
    """quantize_params_q8 and qparams_from_quant_weights (a v2 file) with
    stacked=True, and qparams_from_jax_numpy of the JAX package's
    fuse_stacked_quant_params(quantize_params_q8(...)), agree bit for bit,
    in the stacked layout: one (L, K, N) QTensor per fused weight, (L, D)
    norms, and the JAX marker (wk, wv, w3 empty)."""
    from hip_llama_tpu.config import tiny_config
    from hip_llama_tpu.io import checkpoint as jck
    from hip_llama_tpu.models.params import fuse_stacked_quant_params as jfuse
    from hip_llama_tpu.models.params import quantize_params_q8 as jq8
    from hip_llama_tpu_torch.io import checkpoint as pck

    cfg_j = tiny_config(dim=128, hidden_dim=192, n_layers=3, n_heads=8, n_kv_heads=4,
                        seq_len=64, shared_classifier=shared)
    cfg = ModelConfig(**vars(cfg_j))
    w = jck.random_weights(cfg_j, seed=90)
    path = str(tmp_path / "m.bin")
    pck.write_v2(path, cfg, w, group_size=64)
    cfg2, qw = pck.load_checkpoint(path)
    from_file = qparams_from_quant_weights(cfg2, qw, device="cpu", stacked=True)
    in_memory = quantize_params_q8(cfg, w, group_size=64, device="cpu", stacked=True)
    jp = jfuse(jq8(cfg_j, w, group_size=64))
    carried = qparams_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp)._asdict(),
                                     device="cpu")
    d, kvd, hid, n_layers = cfg.dim, cfg.kv_dim, cfg.hidden_dim, cfg.n_layers
    for p in (from_file, in_memory, carried):
        assert p.stacked and p.wk == p.wv == p.w3 == ()
        assert p.wq.q.shape == (n_layers, d, d + 2 * kvd) and p.w1.q.shape == (n_layers, d, 2 * hid)
        assert p.wq.s.shape == (n_layers, d // 64, d + 2 * kvd) and p.rms_att.shape == (n_layers, d)
    for other in (in_memory, carried):
        for (name, a), (_, b) in zip(_leaves(from_file), _leaves(other)):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    unrolled = quantize_params_q8(cfg, w, group_size=64, device="cpu")
    assert not unrolled.stacked


def test_layer_views_share_the_storage():
    """layer_views hands the unrolled prefill views of the stacked tensors:
    the same storage, no copy."""
    from hip_llama_tpu.config import tiny_config
    from hip_llama_tpu.io.checkpoint import random_weights

    cfg = ModelConfig(**vars(tiny_config(dim=64, hidden_dim=192, n_layers=3, n_heads=8,
                                         n_kv_heads=4)))
    p = quantize_params_q8(cfg, random_weights(cfg, seed=91), device="cpu", stacked=True)
    v = layer_views(p)
    assert not v.stacked and len(v.wq) == len(v.rms_ffn) == 3
    for l in range(3):
        for name in ("wq", "wo", "w1", "w2"):
            st, lv = getattr(p, name), getattr(v, name)[l]
            assert lv.q.data_ptr() == st.q[l].data_ptr() and torch.equal(lv.q, st.q[l])
            assert lv.s.data_ptr() == st.s[l].data_ptr() and lv.q.is_contiguous()
        assert v.rms_att[l].data_ptr() == p.rms_att[l].data_ptr()
    assert layer_views(v) is v


# ---------------------------------------------------------------------------
# K20: the plain version against the JAX kernel in interpret mode

L_, K_, N_, GS = 2, 128, 192, 64
# M: decode rows, the last row count K20 takes `a8` at, the first it does
# not (65: reshape math in K20, where q8_matmul would take `a8`), and a row
# count past 512 (q8_matmul on the layer, under its own decision)
K20_CASES = [(mode, m, epi) for mode in ("reshape", "a8") for m in (4, 64, 65, 600)
             for epi in ("norm", "residual", "rope", "norm_rope")]


@pytest.mark.parametrize("mode,m,epi", K20_CASES)
def test_plain_q8_matmul_layered_matches_jax(mode, m, epi):
    rng = np.random.default_rng(m + len(epi))
    w = (rng.standard_normal((L_, K_, N_)) / np.sqrt(K_)).astype(np.float32)
    jt = jq.q8_quantize_weights(jnp.asarray(w), GS)
    pt = Q.q8_quantize_weights(torch.from_numpy(w), GS)
    x = rng.standard_normal((m, K_)).astype(np.float32)
    xj, xp = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    jkw, pkw = {}, {}
    if "norm" in epi:
        g = (1 + 0.1 * rng.standard_normal((L_, K_))).astype(np.float32)
        jkw["norm_weight"], pkw["norm_weight"] = jnp.asarray(g), torch.from_numpy(g)
    if epi == "residual":
        r = rng.standard_normal((m, N_)).astype(np.float32)
        jkw["residual"] = jnp.asarray(r, jnp.bfloat16)
        pkw["residual"] = torch.from_numpy(r).to(torch.bfloat16)
    if "rope" in epi:
        pos = rng.integers(0, 2048, m).astype(np.int32)
        pos[0] = 0
        # q|k rotate in heads of 64, v (the last third) passes through
        rope = dict(rope_limit=128, rope_head=64, rope_theta=10000.0)
        jkw.update(rope_pos=jnp.asarray(pos), **rope)
        pkw.update(rope_pos=torch.from_numpy(pos), **rope)
    for layer in range(L_):
        want = jq.q8_matmul_layered(xj, jt, jnp.int32(layer), interpret=True, dequant_mode=mode,
                                    **jkw)
        got = Q.q8_matmul_layered(xp, pt, layer, mode=mode, **pkw)
        assert got.dtype == torch.bfloat16 and got.shape == (m, N_)
        assert_within_ulp(got, want, f"{mode} {epi} M {m} layer {layer}")
    if mode == "a8":
        # a8 runs where K20's rule says (past 512 rows, q8_matmul's): else
        # the output is the reshape output bit for bit, on both sides
        a8 = Q.q8_a8_engages(m, K_, N_, GS) if m > 512 else Q.q8_layered_a8_engages(m, K_, N_, GS)
        assert a8 is (m != 65)
        reshape = Q.q8_matmul_layered(xp, pt, L_ - 1, **pkw)
        assert torch.equal(got, reshape) is (not a8)
        jr = jq.q8_matmul_layered(xj, jt, jnp.int32(L_ - 1), interpret=True,
                                  dequant_mode="reshape", **jkw)
        assert np.array_equal(_np(want), _np(jr)) is (not a8)


# (m, k, n, gs, block_n, engages): the fixture (dim 64, hidden 192, 8 heads
# of 8, 4 KV heads) at the goldens' block_n 64: QKV (n 128), wo, W1|W3 (n
# 384) and W2 (k 192) at decode rows and at a prefill chunk's; Llama-2-7B at
# the defaults: all four K20 products take `a8` at batch 8, W2 too (172
# groups x 8 x 512 x 4 = 2.8 MB of group sums), none at 128 rows, where
# q8_matmul would take it for the three with K of 64 groups
K20_TABLE = [
    (m, k, n, 64, 64, m <= 64) for m in (4, 64, 65, 256)
    for k, n in ((64, 128), (64, 64), (64, 384), (192, 64))
] + [
    (8, 4096, 12288, 64, None, True), (8, 4096, 4096, 64, None, True),
    (8, 4096, 22016, 64, None, True), (8, 11008, 4096, 64, None, True),
    (128, 4096, 12288, 64, None, False), (128, 4096, 4096, 64, None, False),
    (128, 4096, 22016, 64, None, False), (128, 11008, 4096, 64, None, False),
    (64, 4096, 22016, 64, None, False),  # group sums past 4 MiB
]


@pytest.mark.parametrize("m,k,n,gs,block_n,engages", K20_TABLE)
def test_q8_layered_a8_decision_table(m, k, n, gs, block_n, engages):
    assert Q.q8_layered_a8_engages(m, k, n, gs, block_n) is engages


def test_k20_rule_differs_from_k15s_at_prefill_rows():
    """Rows 65-512 keep reshape math in K20 where q8_matmul takes `a8`
    (quant.py:1660-1665 against :1298-1316)."""
    for n in (12288, 4096, 22016):
        assert Q.q8_a8_engages(128, 4096, n, 64) and not Q.q8_layered_a8_engages(128, 4096, n, 64)


# ---------------------------------------------------------------------------
# the CUDA wrappers on the stacked step's operands (recorded, not launched)


@pytest.mark.parametrize("mode", ["reshape", "a8"])
@pytest.mark.parametrize("m", [8, 128, 600])
def test_cuda_q8_matmul_layered_passes_the_stacked_storage(launches, monkeypatch, mode, m):
    """The K20 wrapper hands its kernel the stacked base pointers of q, s and
    the norm weight with the layer index, and allocates nothing of a layer's
    size (its output, normed or quantized rows and split partials only):
    no layer is copied. `a8` runs by K20's rule. Past 512 rows it is
    q8_matmul on the layer's views, whose pointers are the layer's."""
    allocated = []
    empty = torch.empty

    def recorded(*shape, **kw):
        t = empty(*shape, **kw)
        allocated.append(t.numel() * t.element_size())
        return t

    monkeypatch.setattr(torch, "empty", recorded)
    monkeypatch.setattr(torch, "empty_like", lambda t: recorded(t.shape, dtype=t.dtype,
                                                                  device=t.device))
    n_layers, k, n, gs, layer = 4, 4096, 12288, 64, 2
    qt = Q.QTensor(_on_card(torch.zeros(n_layers, k, n, dtype=torch.int8)),
                   _on_card(torch.ones(n_layers, k // gs, n)))
    g = _on_card(torch.ones(n_layers, k))
    x = _on_card(torch.zeros(m, k, dtype=torch.bfloat16))
    pos = _on_card(torch.zeros(m, dtype=torch.int32))
    Q.q8_matmul_layered(x, qt, layer, norm_weight=g, rope_pos=pos, rope_limit=8192,
                        rope_head=128, mode=mode)
    (fn, args), = launches
    if m > 512:
        assert fn == "q8_matmul" + ("_a8" if mode == "a8" else "")
        assert args[1] == qt.q[layer].data_ptr() and args[2] == qt.s[layer].data_ptr()
        assert args[3] == g[layer].data_ptr()
    else:
        a8 = mode == "a8" and m <= 64
        assert fn == "q8_matmul_layered" + ("_a8" if a8 else "")
        assert args[1:4] == (qt.q.data_ptr(), qt.s.data_ptr(), g.data_ptr())
        # after M, K, N, gs, split, (the a8 GEMV's kslice,) rope_limit, rope_hs
        n_ptrs, n_ints = (10, 8) if a8 else (9, 7)
        assert args[n_ptrs + n_ints] == layer
    assert max(allocated) < k * n  # nothing of a layer's size


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_attention_decode_reads_the_flat_qkv_rows_in_place(launches, int8):
    """The stacked step's q, k and v are column views of the flat QKV rows
    (B, (H + 2 KVH) HS): attention_decode passes their pointers and the
    row's width as their slot stride, and copies nothing."""
    b, h, kvh, hs, s = 3, 8, 4, 64, 32
    n = (h + 2 * kvh) * hs
    qkv = _on_card(torch.zeros(b, n, dtype=torch.bfloat16))
    q = qkv[:, :h * hs].unflatten(1, (h, hs))
    k = qkv[:, h * hs:(h + kvh) * hs].unflatten(1, (kvh, hs))
    v = qkv[:, (h + kvh) * hs:].unflatten(1, (kvh, hs))
    cdt = torch.int8 if int8 else torch.bfloat16
    kc, vc = (_on_card(torch.zeros(b, 2, kvh, s, hs, dtype=cdt)) for _ in range(2))
    sc = [_on_card(torch.ones(b, 2, kvh, s)) for _ in range(2)] if int8 else [None, None]
    A.attention_decode(q, kc, vc, 1, _on_card(torch.zeros(b, dtype=torch.int32)), k, v, *sc)
    (fn, args), = launches
    base = qkv.data_ptr()
    ptrs = (args[0], args[6], args[7]) if int8 else (args[0], args[4], args[5])
    assert ptrs == (base, base + h * hs * 2, base + (h + kvh) * hs * 2)
    assert args[-5:-3] == (n, n)  # q_bs, cur_bs
    with pytest.raises(ValueError, match="slot strides"):
        A.attention_decode(q, kc, vc, 1, _on_card(torch.zeros(b, dtype=torch.int32)), k,
                           _on_card(torch.zeros(b, kvh, hs, dtype=torch.bfloat16)), *sc)


def test_plain_attention_decode_on_flat_qkv_views_equals_contiguous():
    rng = np.random.default_rng(92)
    b, h, kvh, hs, s = 3, 8, 4, 16, 24
    qkv = torch.from_numpy(rng.standard_normal((b, (h + 2 * kvh) * hs)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16)
    kc = torch.from_numpy(rng.standard_normal((b, 2, kvh, s, hs)).astype(np.float32))
    kc, vc = kc.to(torch.bfloat16), kc.flip(-1).to(torch.bfloat16).contiguous()
    pos = torch.tensor([0, 7, 23], dtype=torch.int32)
    views = qkv.unflatten(1, (h + 2 * kvh, hs))
    q, k, v = views[:, :h], views[:, h:h + kvh], views[:, h + kvh:]
    got = A.attention_decode(q, kc, vc, 1, pos, k, v)
    want = A.attention_decode(q.contiguous(), kc, vc, 1, pos, k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the stacked step and prefill against the JAX stacked step

# the model, its params and the run's inputs: executed by both sides
SETUP = r'''
import numpy as np
from hip_llama_tpu.config import tiny_config
from hip_llama_tpu.io.checkpoint import random_weights
from hip_llama_tpu.models.params import fuse_stacked_quant_params, quantize_params_q8


def setup():
    cfg = tiny_config(dim=128, hidden_dim=192, n_layers=2, n_heads=8, n_kv_heads=4,
                      seq_len=64)
    w = random_weights(cfg, seed=93)
    return cfg, fuse_stacked_quant_params(quantize_params_q8(cfg, w, group_size=64))


def inputs(vocab):
    rng = np.random.default_rng(94)
    tokens = rng.integers(0, vocab, (3, 16)).astype(np.int32)
    start, valid = np.zeros(3, np.int32), np.array([16, 9, 0], np.int32)
    steps = [(rng.integers(0, vocab, (3,)).astype(np.int32),
              np.array([16 + i, 9 + i, i], np.int32)) for i in range(3)]
    return tokens, start, valid, steps
'''

JAX_SIDE = SETUP + r'''
import sys
import jax
import jax.numpy as jnp
from hip_llama_tpu.models import init_kv_cache, make_decode_step, make_prefill

out = sys.argv[1]
cfg, jp = setup()
tokens, start, valid, steps = inputs(cfg.vocab_size)
res = {}
for name, int8 in (("bf16", False), ("int8", True)):
    pre = jax.jit(make_prefill(cfg, attn_impl="pallas", precision="default"))
    step = jax.jit(make_decode_step(cfg, attn_impl="pallas", precision="default"))
    c = init_kv_cache(cfg, 3, dtype=jnp.bfloat16, quantized=int8)
    lg, c = pre(jp, c, jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(valid))
    res[f"{name} prefill"] = np.asarray(lg)
    for i, (tok, pos) in enumerate(steps):
        lg, c = step(jp, c, jnp.asarray(tok), jnp.asarray(pos))
        res[f"{name} step {i}"] = np.asarray(lg)
    # the logical KV heads (an int8 cache pads 4 to 8)
    for f in ("k", "v", "k_scale", "v_scale"):
        if getattr(c, f) is not None:
            res[f"{name} {f}"] = np.asarray(getattr(c, f), np.float32)[:, :, :cfg.n_kv_heads]
np.savez(out, **res)
'''


@pytest.fixture(scope="module", params=["reshape", "a8"])
def stacked_runs(request, tmp_path_factory):
    """(mode, the JAX side's logits and caches with the knobs set, cfg, the
    port's params carried across, the inputs)."""
    mode = request.param
    out = str(tmp_path_factory.mktemp(mode) / "res.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", **KNOBS[mode])
    p = subprocess.run([sys.executable, "-c", JAX_SIDE, out], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    ns: dict = {}
    exec(SETUP, ns)
    cfg_j, jp = ns["setup"]()
    pp = qparams_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp)._asdict(), device="cpu")
    assert pp.stacked
    return mode, dict(np.load(out)), ModelConfig(**vars(cfg_j)), pp, ns["inputs"]


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_stacked_prefill_and_steps_match_jax(stacked_runs, cache, monkeypatch):
    mode, want, cfg, pp, inputs = stacked_runs
    for k, v in KNOBS[mode].items():
        monkeypatch.setenv(k, v)
    tokens, start, valid, steps = inputs(cfg.vocab_size)
    int8 = cache == "int8"
    pc = init_kv_cache(cfg, 3, dtype=torch.bfloat16, device="cpu", quantized=int8)
    lg, _ = make_prefill(cfg)(pp, pc, torch.from_numpy(tokens), torch.from_numpy(start),
                              torch.from_numpy(valid))
    for s in range(3):
        v = int(valid[s])
        if v:
            assert_close(lg.numpy()[s, :v], want[f"{cache} prefill"][s, :v], **TOL,
                         msg=f"{mode} {cache} prefill slot {s}")
    step = make_decode_step(cfg)
    for i, (tok, pos) in enumerate(steps):
        lg, _ = step(pp, pc, torch.from_numpy(tok), torch.from_numpy(pos))
        assert_close(lg.numpy(), want[f"{cache} step {i}"], **TOL, msg=f"{mode} {cache} step {i}")
    for f in ("k", "v"):
        a, b = want[f"{cache} {f}"], _np(getattr(pc, f))
        if int8:
            # a bf16 ulp apart can round a cached value to a neighbouring
            # int8 value (tests/test_torch_kv_int8_model.py)
            assert np.abs(a - b).max() <= 3 and (a != b).mean() < 0.01, f
            assert_close(_np(getattr(pc, f"{f}_scale")), want[f"{cache} {f}_scale"], atol=0,
                         rtol=3e-2, msg=f"{f}_scale")
        else:
            assert_close(b, a, atol=2e-2, rtol=2e-2, msg=f"{mode} {f} cache")


def test_stacked_step_runs_k20_and_k1_only(monkeypatch):
    """The stacked decode layer is four K20 products and K1, whatever
    HIPLLAMA_LAYER_FUSE says; never K23, K5, K15 (but the classifier), K17
    or K18; the prefill runs the unrolled layer on the layers' views."""
    from hip_llama_tpu.config import tiny_config
    from hip_llama_tpu.io.checkpoint import random_weights
    from hip_llama_tpu_torch.models import llama

    names = ("mm_layered", "attn_decode", "mm", "mm_silu", "mm_ffn", "layer",
             "attn_decode_fused", "commit")
    calls = dict.fromkeys(names, 0)

    def count(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    kn = llama._kernels(True)
    monkeypatch.setattr(llama, "_kernels", lambda plain: llama._Kernels(**{
        **kn.__dict__, **{n: count(n, getattr(kn, n)) for n in names}}))
    cfg = ModelConfig(**vars(tiny_config(dim=64, hidden_dim=192, n_layers=3, n_heads=8,
                                         n_kv_heads=4, seq_len=32)))
    p = quantize_params_q8(cfg, random_weights(cfg, seed=95), device="cpu", stacked=True)
    cache = init_kv_cache(cfg, 2, dtype=torch.bfloat16, device="cpu")
    make_decode_step(cfg)(p, cache, torch.zeros(2, dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32))
    assert calls == dict(calls, mm_layered=12, attn_decode=3, mm=1, mm_silu=0, mm_ffn=0, layer=0,
                         attn_decode_fused=0, commit=1)
    calls.update(dict.fromkeys(names, 0))
    make_prefill(cfg)(p, cache, torch.zeros((2, 4), dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32), torch.full((2,), 4, dtype=torch.int32))
    assert calls["mm_layered"] == 0 and calls["mm"] == 3 * 2 + 1 and calls["mm_ffn"] == 3


FORK_SIDE = r'''
import pickle, sys
import numpy as np
from hip_llama_tpu.engine import InferenceEngine, Requests
from hip_llama_tpu.io.checkpoint import load_checkpoint
from hip_llama_tpu.models.params import fuse_stacked_quant_params, quantize_params_q8
from hip_llama_tpu.sampler import Sampler
from hip_llama_tpu.tokenizer import Tokenizer

sys.path.insert(0, "tests")
from test_torch_stacked import logged_serve

cfg, w = load_checkpoint("assets/golden/model.bin")
jp = fuse_stacked_quant_params(quantize_params_q8(cfg, w, group_size=64))
eng = InferenceEngine(cfg, jp, Tokenizer.from_file("assets/golden/tokenizer.bin", cfg.vocab_size),
                      batch_size=4, attn_impl="pallas", precision="default")
log = logged_serve(eng, Requests, Sampler, cfg.vocab_size, sys.argv[1])
with open(sys.argv[2], "wb") as f:
    pickle.dump(log, f)
'''


def logged_serve(eng, requests, sampler, vocab: int, corpus: str) -> list:
    """Serve a corpus greedily at -b 4 through `eng` (either package's
    engine), logging each decode step's and prefill's inputs and logits."""
    log = []
    step, prefill = eng._do_step, eng._prefill_tokens

    def logged_step(cache, tokens, pos, *a, **kw):
        logits, cache = step(cache, tokens, pos, *a, **kw)
        log.append(((np.asarray(tokens).tolist(), np.asarray(pos).tolist()), np.asarray(logits)))
        return logits, cache

    def logged_prefill(cache, batch, slot_tokens, slot_start, *a, **kw):
        logits, cache = prefill(cache, batch, slot_tokens, slot_start, *a, **kw)
        if logits is not None:
            log.append(((sorted(slot_tokens.items()), sorted(slot_start.items())),
                        np.asarray(logits)))
        return logits, cache

    eng._do_step, eng._prefill_tokens = logged_step, logged_prefill
    prompts = read_inputfile(os.path.join(IN, f"{corpus}_in_8.txt")).prompts
    req = requests(prompts=list(prompts), generations=[""] * len(prompts))
    eng.serve(req, steps=eng.cfg.seq_len, samplers=[sampler(vocab, 0.0) for _ in prompts])
    return log


def test_stacked_serve_forks_from_jax_only_at_near_ties(tmp_path):
    """The golden fixture with --quant q8 --layout stacked, greedy at -b 4,
    served by the JAX engine (in a subprocess at block_n 64, as the golden
    was made) and the port's on one corpus: every prefill and decode step
    that sees the same tokens gives logits within TOL until a slot's greedy
    token differs, and there the JAX logits' top-2 gap is a near-tie (at
    most two bf16 ulps of the O(1)-O(8) logits, as
    tests/test_torch_kv_int8_model.py::NEAR_TIE). On the CPU the five
    corpora fork at such ties in 5 of 40 requests (1 corpus at 1.0, average
    0.875), which is why the stacked reshape goldens are held to the
    average bar."""
    import pickle

    from hip_llama_tpu_torch.engine import InferenceEngine, Requests
    from hip_llama_tpu_torch.io.checkpoint import load_checkpoint
    from hip_llama_tpu_torch.sampler import Sampler
    from hip_llama_tpu_torch.tokenizer import Tokenizer

    out = str(tmp_path / "log.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu", **KNOBS["reshape"])
    p = subprocess.run([sys.executable, "-c", FORK_SIDE, "gen", out], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    with open(out, "rb") as f:
        jlog = pickle.load(f)
    cfg, w = load_checkpoint(MODEL)
    pp = quantize_params_q8(cfg, w, group_size=64, device="cpu", stacked=True)
    eng = InferenceEngine(cfg, pp, Tokenizer.from_file(TOK, cfg.vocab_size), batch_size=4)
    plog = logged_serve(eng, Requests, Sampler, cfg.vocab_size, "gen")
    forked, compared = set(), 0
    for (jin, jl), (pin, pl) in zip(jlog, plog):
        if len(jin) != len(pin) or len(jin[0]) != len(pin[0]) or jl.shape != pl.shape:
            break
        if isinstance(jin[0][0], tuple):  # a prefill: (slot, tokens) pairs
            same = [s for (s, a), (s2, b) in zip(jin[0], pin[0]) if s == s2 and a == b
                    and dict(jin[1])[s] == dict(pin[1])[s]]
        else:
            same = [s for s in range(len(jin[0]))
                    if (jin[0][s], jin[1][s]) == (pin[0][s], pin[1][s])]
        for s in same:
            if s in forked:
                continue
            assert_close(pl[s], jl[s], **TOL, msg=f"slot {s}")
            compared += 1
            if jl[s].argmax() != pl[s].argmax():
                top2 = np.sort(jl[s])[-2:]
                assert top2[1] - top2[0] <= 0.1, f"slot {s} forks at a gap of {top2}"
                forked.add(s)
        if len(forked) == 4:
            break
    assert compared > 100, compared


# ---------------------------------------------------------------------------
# the CLI


def _serve(tmp_path, corpus, args, tag=""):
    out = str(tmp_path / f"{corpus}{tag}.out")
    with redirect_stdout(io.StringIO()):
        rc = port_run.main(["run", MODEL, "-z", TOK, "-m", "test", "-t", "0.0", "-b", "4",
                            "-f", os.path.join(IN, f"{corpus}_in_8.txt"), "-o", out,
                            "--device", "cpu", *args])
    assert rc == 0, f"port CLI failed on {corpus} {args}"
    return out


@pytest.mark.parametrize("args,golden,knobs,bars", [
    (["--quant", "q8"], "cpu_q8_stacked", KNOBS["reshape"], 1),
    (["--quant", "q8", "--kv", "int8"], "cpu_q8_kv8_stacked", KNOBS["reshape"], 1),
    (["--quant", "q8"], "cpu_q8_a8_stacked", KNOBS["a8"], 2),
], ids=["q8", "q8-kv8", "q8-a8"])
def test_stacked_cli_greedy_coverage_vs_jax_goldens(tmp_path, monkeypatch, args, golden, knobs,
                                                    bars):
    """--layout stacked against the JAX CLI's --layout stacked outputs (the
    commands are in CHANGES.md), scored per request at the bars of
    tests/test_goldens.py:84-100: the average of 0.75, and for `a8` also 3
    corpora at 1.0. The reshape-mode runs fork from the JAX outputs at exact
    ties of bf16 logits (test_stacked_serve_forks_from_jax_only_at_near_
    ties), so they are held to the average, as the Q8 int8-cache runs."""
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    scores = {}
    for c in CORPORA:
        got = read_inputfile(_serve(tmp_path, c, [*args, "--layout", "stacked"]))
        want = read_inputfile(os.path.join(OUT, golden, f"{c}_in_8.out"))
        assert got.num_reqs == want.num_reqs
        scores[c] = sum(a == b for a, b in zip(got.prompts, want.prompts)) / want.num_reqs
    assert sum(scores.values()) / len(scores) >= 0.75, scores
    if bars == 2:
        assert sum(1 for v in scores.values() if v == 1.0) >= 3, scores


@pytest.mark.parametrize("args", [["--dtype", "float32"], ["--quant", "q8", "--paged", "16"],
                                  ["--quant", "q4"]], ids=["dense", "paged", "int4"])
def test_layout_stacked_is_a_no_op_where_the_jax_cli_ignores_it(tmp_path, capsys, args):
    """Dense params and --paged ignore --layout stacked; int4 prints the JAX
    CLI's note and serves unrolled (run.py:409-431): the same output files."""
    plain = _serve(tmp_path, "gen", args)
    capsys.readouterr()
    stacked = _serve(tmp_path, "gen", [*args, "--layout", "stacked"], tag="-stacked")
    note = "note: --layout stacked supports int8 only; using unrolled for int4"
    assert (note in capsys.readouterr().err) is (args == ["--quant", "q4"])
    with open(plain, "rb") as f, open(stacked, "rb") as g:
        assert f.read() == g.read()


def test_layout_takes_unrolled_or_stacked(tmp_path, capsys):
    assert port_run.main(["run", MODEL, "-z", TOK, "--layout", "fused", "--device", "cpu"]) == 1
    assert "--layout fused" in capsys.readouterr().err
    a = _serve(tmp_path, "sciq", ["--quant", "q8"])
    b = _serve(tmp_path, "sciq", ["--quant", "q8", "--layout", "unrolled"], tag="-u")
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()

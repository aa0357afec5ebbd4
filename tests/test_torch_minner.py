"""K19, the JAX package's large-M Q8 prefill products behind
HIPLLAMA_PREFILL_MINNER=1 (`_q8_matmul_minner` and the K19 branch of
q8_matmul_silu), and the decisions of both prefill knobs, against the JAX
package.

- The port's plain K19 and K19 silu against the JAX kernels in interpret
  mode: within one bf16 ulp at the outputs' largest magnitude
  (tests/test_torch_a8.py::assert_within_ulp; the same cast points, the
  fp32 sums taken in another order before the one cast).
- The decisions: `minner_engages`, `minner_silu_engages` and
  `xheads_engages` against what the JAX wrappers do, read off a trace
  (jax.make_jaxpr on abstract shapes, spies on the K19 kernels, and
  q8_matmul_xheads's fallback to q8_matmul), so nothing heavy runs: the
  golden fixture's widths and Llama-2-7B's, the contiguous prefill at T 16,
  64 and 256 (and the fixture at its 96-token window), the paged prefill's
  separate products at T 128 (8 slots), in `reshape` and in `a8`. The JAX
  package reads both knobs and the mode when it is imported, so its side
  runs in a subprocess with them set.
"""

import functools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hip_llama_tpu.ops import quant as jq
from hip_llama_tpu_torch.ops import quant as Q
from test_torch_a8 import assert_within_ulp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, m, k, n, gs=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    qt = jq.q8_quantize_weights(jnp.asarray(w), gs)
    pqt = Q.QTensor(torch.from_numpy(np.asarray(qt.q)), torch.from_numpy(np.asarray(qt.s)))
    return rng, x, qt, pqt


@pytest.mark.parametrize("epi", ["none", "residual", "rope"])
@pytest.mark.parametrize("m,k,n,bk,bn", [(520, 256, 256, 128, 128), (1024, 256, 256, 128, 128),
                                         (520, 256, 272, 128, 16), (520, 320, 256, 64, 128)])
def test_minner_plain_matches_jax_kernel(m, k, n, bk, bn, epi):
    """K19 in K blocks of bk and column blocks of bn (at least two of each,
    so the accumulator carries across K tiles and the RoPE columns start at
    each block's offset), the rows padded to the JAX call's 512-row blocks
    on the JAX side only: K = N = 256; a ragged N of 272 (the kernel's 128-
    column tiles leave 16, the JAX call takes blocks of 16); a K of 320,
    which the kernel's 64-row steps and the JAX call's 64-row blocks cut
    into 5."""
    rng, x, qt, pqt = _inputs(1 + m + (n - 256) + (k - 256), m, k, n)
    pad = (-m) % 512
    xj = jnp.pad(jnp.asarray(x, jnp.bfloat16), ((0, pad), (0, 0)))
    kw_j, kw_p = {}, {}
    if epi == "residual":
        r = rng.standard_normal((m, n)).astype(np.float32)
        kw_j["residual"] = jnp.pad(jnp.asarray(r, jnp.bfloat16), ((0, pad), (0, 0)))
        kw_p["residual"] = torch.from_numpy(r).to(torch.bfloat16)
    pos = rng.integers(0, 2048, m).astype(np.int32)
    rope = dict(rope_limit=128, rope_head=64, rope_theta=10000.0)
    want = jq._q8_matmul_minner(
        xj, qt, s_blocked_n=bn, block_k=bk, block_m=512, out_dtype=jnp.bfloat16,
        residual=kw_j.get("residual"), rope_pos=jnp.asarray(pos) if epi == "rope" else None,
        interpret=True, b=m, pad_m=pad, **rope)
    if epi == "rope":
        kw_p.update(rope_pos=torch.from_numpy(pos), **rope)
    got = Q.q8_matmul_minner(torch.from_numpy(x).to(torch.bfloat16), pqt, **kw_p)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert_within_ulp(got.float().numpy(), np.asarray(want, np.float32), f"K19 {epi}")


def test_minner_silu_plain_matches_jax_kernel(monkeypatch):
    """K19 silu: the JAX q8_matmul_silu with HIPLLAMA_PREFILL_MINNER=1 (the
    module global it reads) and no norm at M 640, K 256, H 256 takes its
    `_q8_kernel_silu_minner` branch; the port's q8_matmul_silu routes to
    q8_matmul_silu_minner there."""
    m, k, h = 640, 256, 256
    _, x, qt, pqt = _inputs(7, m, k, 2 * h)
    seen = []
    real = jq._q8_kernel_silu_minner

    def spy(*a, **kw):
        seen.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jq, "_ENV_PREFILL_MINNER", True)
    monkeypatch.setattr(jq, "_q8_kernel_silu_minner", spy)
    want = jq.q8_matmul_silu(jnp.asarray(x, jnp.bfloat16), qt, interpret=True)
    assert seen, "the JAX call did not take its K19 branch"
    assert Q.minner_silu_engages(m, k, h, 64)
    calls = []
    monkeypatch.setattr(Q, "q8_matmul_silu_minner_plain",
                        functools.partial(lambda f, *a, **kw: calls.append(1) or f(*a, **kw),
                                          Q.q8_matmul_silu_minner_plain))
    got = Q.q8_matmul_silu(torch.from_numpy(x).to(torch.bfloat16), pqt, minner=True)
    assert calls == [1]
    assert_within_ulp(got.float().numpy(), np.asarray(want, np.float32), "K19 silu")


# ---------------------------------------------------------------------------
# the decisions

FIXTURE = dict(dim=64, hidden=192, heads=8, kv_heads=4, head=8, vocab=512)
LLAMA7B = dict(dim=4096, hidden=11008, heads=32, kv_heads=32, head=128, vocab=32000)


def _cases():
    """(kind, args) of every product the JAX prefills run, by model and
    rows: kind "mm" (m, k, n, norm, out_heads), "silu" (m, k, h, norm),
    "xheads" (m, gh, hs, n)."""
    cases = set()
    for cfg, slots, ts in ((FIXTURE, 4, (16, 64, 96, 256)), (LLAMA7B, 8, (16, 64, 256))):
        d, hid, hs = cfg["dim"], cfg["hidden"], cfg["head"]
        kvd = cfg["kv_heads"] * hs
        for t in ts:
            m = slots * t
            for heads in (hs, 0):  # HIPLLAMA_PREFILL_HEADS on, off
                cases.add(("mm", m, d, d + 2 * kvd, True, heads))
            cases.update({("mm", m, d, d, False, 0), ("mm", m, hid, d, False, 0),
                          ("silu", m, d, hid, True), ("mm", m, d, cfg["vocab"], True, 0),
                          ("xheads", m, cfg["heads"], hs, d)})
        cases.add(("mm", slots, d, cfg["vocab"], True, 0))  # last-row classifier
    m = 8 * 128  # the paged prefill's separate products, T 128 x 8 slots
    d, hid = LLAMA7B["dim"], LLAMA7B["hidden"]
    cases.update({("mm", m, d, d, True, 0), ("mm", m, d, hid, True, 0),
                  ("mm", m, d, d, False, 0), ("mm", m, hid, d, False, 0)})
    cases.add(("xheads", 640, 32, 128, 4096))  # flattens: 640 rows are not 256-row blocks
    return sorted(cases)


JAX_DECISIONS = r'''
import json, sys
import jax, jax.numpy as jnp
from hip_llama_tpu.ops import quant as q

hits = []

def spy(fn):
    def kernel(*a, **kw):
        hits.append(1)
        return fn(*a, **kw)
    return kernel

q._q8_kernel_minner = spy(q._q8_kernel_minner)
q._q8_kernel_silu_minner = spy(q._q8_kernel_silu_minner)
S = jax.ShapeDtypeStruct
bf, f32 = jnp.bfloat16, jnp.float32

def qt(k, n):
    return q.QTensor(S((k, n), jnp.int8), S((k // 64, n), f32))

def calls(jaxpr, name):
    n = 0
    for e in jaxpr.eqns:
        if e.primitive.name in ("pjit", "jit") and e.params.get("name") == name:
            n += 1
        for p in e.params.values():
            sub = getattr(p, "jaxpr", None)
            if sub is not None and hasattr(sub, "eqns"):
                n += calls(sub, name)
    return n

out = []
for kind, *a in json.loads(sys.argv[1]):
    hits.clear()
    jax.clear_caches()
    if kind == "mm":
        m, k, n, norm, heads = a
        args = [S((m, k), bf), qt(k, n)] + ([S((k,), f32)] if norm else [])
        jax.make_jaxpr(lambda x, w, *g: q.q8_matmul(x, w, norm_weight=g[0] if g else None,
                                                     out_heads=heads))(*args)
        out.append([bool(hits)])
    elif kind == "silu":
        m, k, h, norm = a
        args = [S((m, k), bf), qt(k, 2 * h)] + ([S((k,), f32)] if norm else [])
        jax.make_jaxpr(lambda x, w, *g: q.q8_matmul_silu(x, w, norm_weight=g[0] if g else None))(
            *args)
        out.append([bool(hits)])
    else:
        m, gh, hs, n = a
        jp = jax.make_jaxpr(lambda x, w, r: q.q8_matmul_xheads(x, w, residual=r))(
            S((m, gh, hs), bf), qt(gh * hs, n), S((m, n), bf))
        out.append([calls(jp.jaxpr, "q8_matmul") == 0, bool(hits)])
print(json.dumps(out))
'''


@pytest.fixture(scope="module", params=["reshape", "a8"])
def jax_decisions(request):
    mode = request.param
    env = {k: v for k, v in os.environ.items() if not k.startswith("HIPLLAMA_")}
    env.update(JAX_PLATFORMS="cpu", HIPLLAMA_PREFILL_MINNER="1", HIPLLAMA_Q8_MODE=mode)
    cases = _cases()
    p = subprocess.run([sys.executable, "-c", JAX_DECISIONS, json.dumps(cases)], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return mode, dict(zip(map(tuple, cases), json.loads(p.stdout.splitlines()[-1])))


def _port(mode, kind, *a):
    if kind == "mm":
        m, k, n, norm, heads = a
        return [Q.minner_engages(m, k, n, 64, mode, norm, heads)]
    if kind == "silu":
        m, k, h, norm = a
        return [Q.minner_silu_engages(m, k, h, 64, mode, norm)]
    m, gh, hs, n = a
    eng = Q.xheads_engages(m, gh, hs, gh * hs, n, 64)
    # the flat fallback is q8_matmul at the xheads call's own block_n
    return [eng, not eng and Q.minner_engages(m, gh * hs, n, 64, mode, block_n=Q.XHEADS_BLOCK_N)]


def test_prefill_decisions_match_jax(jax_decisions, monkeypatch):
    monkeypatch.delenv("HIPLLAMA_Q8_BLOCK_N", raising=False)
    mode, want = jax_decisions
    got = {case: _port(mode, *case) for case in want}
    bad = {case: (got[case], w) for case, w in want.items() if got[case] != w}
    assert not bad, f"port vs JAX decisions ({mode}): {bad}"
    # what the 7B prefill then does: T 256 x 8 slots
    d, hid = LLAMA7B["dim"], LLAMA7B["hidden"]
    m = 2048
    seven_b = {"wo": want[("mm", m, d, d, False, 0)][0],
               "W2": want[("mm", m, hid, d, False, 0)][0],
               "W1|W3": want[("silu", m, d, hid, True)][0],
               "QKV head-split": want[("mm", m, d, 3 * d, True, 128)][0],
               "QKV flat": want[("mm", m, d, 3 * d, True, 0)][0],
               "K16": want[("xheads", m, 32, 128, d)][0]}
    if mode == "reshape":
        assert seven_b == {"wo": True, "W2": True, "W1|W3": True, "QKV head-split": False,
                           "QKV flat": True, "K16": True}
        paged = [want[("mm", 1024, d, n, norm, 0)][0]
                 for n, norm in ((d, True), (hid, True), (d, False))]
        assert paged == [True] * 3 and want[("mm", 1024, hid, d, False, 0)][0]
    else:  # a8: only W2 (172 groups) declines a8 and takes K19
        assert seven_b == {"wo": False, "W2": True, "W1|W3": False, "QKV head-split": False,
                           "QKV flat": False, "K16": True}
    # the golden fixture never reaches K16 or K19: its prefill has at most
    # 4 x 96 rows, its head size is 8 and its widths of 64 fail K19's
    # block_n % 128 (its gate at 1024 rows would, through the JAX fallback)
    f = FIXTURE
    for t in (16, 64, 96):
        m = 4 * t
        assert not any(v for case, vs in want.items() if case[1] == m and case[2] in
                       (f["dim"], f["hidden"], f["heads"]) for v in vs)
    assert want[("silu", 1024, f["dim"], f["hidden"], True)] == [mode == "reshape"]


def test_the_wrappers_raise_where_fused_products_decide_apart():
    """A fused product whose JAX products decide apart raises, as under a8."""
    x = torch.zeros((1024, 128), dtype=torch.bfloat16)
    qt = Q.QTensor(torch.zeros((128, 200), dtype=torch.int8), torch.ones((2, 200)))
    # width 72 cannot tile (its block is 72, not a multiple of 128); 128 can
    assert Q.minner_engages(1024, 128, 128, 64) and not Q.minner_engages(1024, 128, 72, 64)
    with pytest.raises(NotImplementedError, match="PREFILL_MINNER"):
        Q.q8_matmul(x, qt, minner=True, widths=(128, 72))
    out = Q.q8_matmul(x, qt, minner=False, widths=(128, 72))
    assert out.shape == (1024, 200)


# ---------------------------------------------------------------------------
# the paged prefill and --layout stacked with the knob


@pytest.mark.parametrize("layout", ["paged", "stacked"])
def test_prefill_routes_through_k19(layout, monkeypatch):
    """At 8 slots x T 128 (1024 rows) and dim 128, wo and W2 take K19 in
    the paged prefill (its separate products) and in the stacked params'
    prefill (the unrolled one on the layers' views), as minner_engages
    says; the plain K19 is K15's arithmetic, so the logits equal the run
    without the knob bit for bit (the numbers against the JAX package:
    the decision tables above and tests/test_torch_xheads.py)."""
    from hip_llama_tpu_torch.config import tiny_config
    from hip_llama_tpu_torch.io.checkpoint import random_weights
    from hip_llama_tpu_torch.models import init_kv_cache, make_prefill, quantize_params_q8
    from hip_llama_tpu_torch.models.paged import init_paged_kv_cache, make_paged_prefill

    cfg = tiny_config(dim=128, hidden_dim=256, n_layers=2, n_heads=4, n_kv_heads=4,
                      vocab_size=256, seq_len=128)
    params = quantize_params_q8(cfg, random_weights(cfg, seed=70), device="cpu",
                                stacked=layout == "stacked")
    rng = np.random.default_rng(71)
    tok = torch.from_numpy(rng.integers(0, 256, (8, 128)).astype(np.int32))
    start = torch.zeros(8, dtype=torch.int32)
    valid = torch.from_numpy(rng.integers(1, 129, 8).astype(np.int32))
    table = torch.arange(1, 9, dtype=torch.int32)[:, None]
    calls = []
    monkeypatch.setattr(Q, "q8_matmul_minner_plain",
                        lambda *a, _f=Q.q8_matmul_minner_plain, **kw: calls.append(1) or _f(*a, **kw))
    out = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("HIPLLAMA_PREFILL_MINNER", knob)
        if layout == "paged":
            cache = init_paged_kv_cache(cfg, 9, 128, dtype=torch.bfloat16, device="cpu")
            out[knob] = make_paged_prefill(cfg)(params, cache, table, tok, start, valid)[0]
        else:
            cache = init_kv_cache(cfg, 8, dtype=torch.bfloat16, device="cpu")
            out[knob] = make_prefill(cfg)(params, cache, tok, start, valid)[0]
    assert Q.minner_engages(1024, 128, 128, 64) and Q.minner_engages(1024, 256, 128, 64)
    assert not Q.minner_engages(1024, 128, 3 * 128, 64, norm=True)  # the norm stays inside
    assert len(calls) == 2 * cfg.n_layers
    assert torch.equal(out["0"], out["1"])

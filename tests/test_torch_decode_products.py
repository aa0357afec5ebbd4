"""The decode-shaped Q8 products on the CPU: the tensor-core GEMV
(csrc/q8.cuh::gemv_tasks) that q8_matmul (K15), q8_matmul_silu (K17),
q8_matmul_layered (K20), q8_matmul_ffn (K18) and q8_layer_fused (K23) run
at up to 16 rows.

- The plan (`ops/quant.py::gemv_plan`) and the tasks as the kernel takes
  them (`gemv_runs`) at every product of the golden fixture (dim 64, hidden
  192), stories15M (dim 288, 6 heads of 48 over 2 KV heads, hidden 768) and
  Llama-2-7B, group sizes 16, 32 and 64, rows 1-16: every output column,
  every row and every contraction row is covered exactly once; at 7B every
  product keeps K23's grid busy (whole waves within 6% of the work spread
  evenly), and the FFN's W1|W3 product deals every CTA a task, where the
  hidden strips of the kernel it replaced left 92 of 264 CTAs idle.
- The order of the sums: an emulation of the tasks in fp32 (each warp's run,
  the warps in order, the splits in order) gives the same bits whatever
  order the CTAs take the tasks in, and matches the plain version.
- The CUDA wrappers, their launches recorded instead of made
  (tests/test_torch_attention.py's `launches` fixture): each passes the
  plan's splits and the workspaces the C entry points read, and refuses
  before launching what the C launchers refuse.
- The plain versions at decode rows against the JAX kernels in interpret
  mode at stories15M's widths.

The int4 weight (q4_matmul, K21; q4_matmul_silu, K22) runs the same GEMV
at up to 16 rows with its packed half-split format (gemv_tasks<MAXM, FAST,
4>: a step of 8 packed rows, whose low nibbles meet x[:, k'..] and high
nibbles x[:, K/2 + k'..]). Its plan is gemv_plan over the K/2 packed rows
in steps of GEMV_STEP_Q4 (K / 16 steps, as the Q8 plan's): every output
column, row and packed row covered once at the int4 products of the three
models (group sizes 16 and 32 where they divide K/2), the wrappers passing
that split and refusing before any launch what the C launcher refuses, and
the plain int4 decode products against the JAX kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.ops import quant as jq
from hip_llama_tpu.ops import quant4 as jq4
from hip_llama_tpu_torch.ops import layer_fused as LF
from hip_llama_tpu_torch.ops import quant as Q
from hip_llama_tpu_torch.ops import quant4 as Q4
from test_torch_attention import _on_card, launches  # noqa: F401 (a fixture)

torch.set_num_threads(1)

# name: (dim, hidden, heads, KV heads, vocab)
MODELS = {
    "golden": (64, 192, 8, 4, 512),
    "stories15M": (288, 768, 6, 2, 32000),
    "7b": (4096, 11008, 32, 32, 32000),
}
GROUP_SIZES = (16, 32, 64)


def products(model: str) -> dict[str, tuple[int, int]]:
    """Each Q8 product of a layer and the classifier: (K, N), N the
    weight's columns (2H for the W1|W3 gate)."""
    dim, hidden, heads, kvh, vocab = MODELS[model]
    kv_dim = dim * kvh // heads
    return {"qkv": (dim, dim + 2 * kv_dim), "wo": (dim, dim), "w13": (dim, 2 * hidden),
            "w2": (hidden, dim), "classifier": (dim, vocab)}


CASES = [(model, prod) for model in MODELS for prod in products(model)]


def _covers_once(intervals, end: int) -> bool:
    """Whether the half-open intervals tile [0, end) with no overlap."""
    at = 0
    for a, b in sorted(i for i in intervals if i[0] < i[1]):
        if a != at:
            return False
        at = b
    return at == end


@pytest.mark.parametrize("model,prod", CASES)
def test_gemv_tasks_cover_every_output_and_contraction_row_once(model, prod):
    k, n = products(model)[prod]
    for gs in GROUP_SIZES:
        if k % gs == 0:
            assert Q.q8_kernel_takes("gemv", k, n, gs, gate=prod == "w13"), (model, prod, gs)
    for m in range(1, Q.GEMV_MAX_M + 1):
        split = Q.gemv_plan(k, n, m)
        tasks = Q.gemv_runs(k, n, m, split)
        tasks = Q.gemv_runs(k, n, m, split)
        cells: dict = {}  # (columns, rows) -> the contraction rows of every warp run
        for cols, rows, sp, runs in tasks:
            assert 0 <= sp < split and len(runs) == Q.GEMV_WARPS
            cells.setdefault((cols, rows), []).extend(runs)
        assert _covers_once({c for c, _ in cells}, n), (model, prod, m)
        assert _covers_once({r for _, r in cells}, m), (model, prod, m)
        assert len(cells) == len({c for c, _ in cells}) * len({r for _, r in cells})
        for key, runs in cells.items():
            assert _covers_once(runs, k), (model, prod, m, key)
        assert len(tasks) == -(-n // Q.GEMV_BN) * split * -(-m // (8 if m <= 8 else 16))


@pytest.mark.parametrize("m", [8, 16])
def test_gemv_plan_keeps_k23s_grid_busy_at_7b(m):
    """Each 7B product's tasks, dealt out to K23's grid (two CTAs an SM of
    an H100 up to 8 rows, one above), take whole waves within 5% of the
    work spread evenly over the grid, the warps' runs at least
    GEMV_MIN_RUN steps; the FFN's W1|W3 product gives every CTA a task."""
    ctas = Q.GEMV_CTAS[8 if m <= 8 else 16]
    for prod, (k, n) in products("7b").items():
        split = Q.gemv_plan(k, n, m)
        tasks = Q.gemv_runs(k, n, m, split)
        task_steps = max((runs[-1][1] - runs[0][0]) // Q.GEMV_STEP for *_, runs in tasks)
        spread = -(-n // Q.GEMV_BN) * (k // Q.GEMV_STEP) / ctas
        assert spread / (-(-len(tasks) // ctas) * task_steps) >= 0.94, (prod, m, split)
        run_steps = [(k1 - k0) // Q.GEMV_STEP for *_, runs in tasks for k0, k1 in runs]
        assert min(run_steps) >= Q.GEMV_MIN_RUN, (prod, m, split)
        if prod == "w13" and m <= 8:
            assert len(tasks) >= ctas, (prod, m, len(tasks))


def _emulate(x: torch.Tensor, qt, split: int, order) -> torch.Tensor:
    """The GEMV's sums in fp32 as the kernel orders them: each warp's run
    (its own partial), the warps added in order into the task's partial,
    the tasks taken in `order`, then each output's splits added in order
    (q8.cuh::split_epilogue_at), before the bf16 cast."""
    m, k = x.shape
    n = qt.q.shape[1]
    w = Q.q8_dequantize(qt).to(torch.bfloat16).float()
    xf = x.float()
    part = torch.zeros(split, m, n)
    tasks = Q.gemv_runs(k, n, m, split)
    for t in order:
        (n0, n1), (m0, m1), sp, runs = tasks[t]
        acc = torch.zeros(m1 - m0, n1 - n0)
        for k0, k1 in runs:
            acc = acc + xf[m0:m1, k0:k1] @ w[k0:k1, n0:n1]
        part[sp, m0:m1, n0:n1] = acc
    out = torch.zeros(m, n)
    for sp in range(split):
        out = out + part[sp]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("m", [1, 5, 8, 13, 16])
@pytest.mark.parametrize("k,n,gs", [(64, 128, 64), (288, 480, 32), (768, 288, 16),
                                    (2048, 384, 64)])
def test_gemv_sums_in_a_fixed_order(m, k, n, gs):
    rng = np.random.default_rng(m * 7 + k)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    qt = Q.q8_quantize_weights(w, gs)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    split = Q.gemv_plan(k, n, m)
    ntasks = len(Q.gemv_runs(k, n, m, split))
    first = _emulate(x, qt, split, range(ntasks))
    again = _emulate(x, qt, split, rng.permutation(ntasks))
    assert torch.equal(first, again)
    assert_close(first.float().numpy(), Q.q8_matmul_plain(x, qt).float().numpy(),
                 atol=2e-2, rtol=2e-2)


def _qt(k: int, n: int, gs: int):
    return Q.QTensor(_on_card(torch.zeros(k, n, dtype=torch.int8)),
                     _on_card(torch.ones(k // gs, n)))


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("m", [1, 8, 9, 16])
def test_cuda_wrappers_pass_the_plan(launches, model, m):
    """q8_matmul (QKV with norm + RoPE, wo with the residual), q8_matmul_silu,
    q8_matmul_ffn and q8_layer_fused launch their GEMV entry points with
    gemv_plan's splits for m rows."""
    dim, hidden, heads, kvh, _ = MODELS[model]
    gs = 16 if model == "stories15M" else 64
    hs = dim // heads
    prods = products(model)
    x = _on_card(torch.zeros(m, dim, dtype=torch.bfloat16))
    g = _on_card(torch.ones(dim))
    pos = _on_card(torch.zeros(m, dtype=torch.int32))
    wq, wo = _qt(*prods["qkv"], gs), _qt(*prods["wo"], gs)
    w13, w2 = _qt(*prods["w13"], gs), _qt(*prods["w2"], gs)
    Q.q8_matmul(x, wq, norm_weight=g, rope_pos=pos, rope_limit=(heads + kvh) * hs, rope_head=hs)
    Q.q8_matmul(x, wo, residual=x)
    Q.q8_matmul_silu(x, w13, norm_weight=g)
    Q.q8_matmul_ffn(x, w13, w2, x, g)
    plan = {p: Q.gemv_plan(*kn, m) for p, kn in prods.items()}
    (f1, a1), (f2, a2), (f3, a3), (f4, a4) = launches
    assert (f1, a1[9:14]) == ("q8_matmul", (m, dim, prods["qkv"][1], gs, plan["qkv"]))
    assert (f2, a2[9:14]) == ("q8_matmul", (m, dim, dim, gs, plan["wo"]))
    assert (f3, a3[7:12]) == ("q8_matmul_silu", (m, dim, hidden, gs, plan["w13"]))
    assert (f4, a4[11:19]) == ("q8_matmul_ffn", (m, dim, hidden, dim, gs, gs, plan["w13"],
                                                 plan["w2"]))
    launches.clear()
    k = _on_card(torch.zeros(m, 2, kvh, 32, hs, dtype=torch.bfloat16))
    LF.q8_layer_fused(x, wq, wo, w13, w2, g, g, k, k, 0, pos, n_heads=heads)
    [(fn, args)] = launches
    assert fn == "q8_layer_fused"
    assert args[24:33] == (m, dim, heads, kvh, 32, hs, 2, 0, hidden)
    assert args[37:41] == (plan["qkv"], plan["wo"], plan["w13"], plan["w2"])


@pytest.mark.parametrize("k,n,s_rows", [(40, 128, 5), (64, 200, 1), (64, 128, 3)])
def test_cuda_wrappers_refuse_what_the_gemv_refuses(launches, k, n, s_rows):
    """K 40 or N 200 (no multiples of 16; the gate's H 100), or 3 scale
    rows for K 64 (a group size that does not divide K): the C launchers
    return cudaErrorInvalidValue there, so the wrappers raise ValueError
    first and launch nothing (no fallback to another kernel or to the
    plain version)."""
    x = _on_card(torch.zeros(8, k, dtype=torch.bfloat16))
    qt = Q.QTensor(_on_card(torch.zeros(k, n, dtype=torch.int8)),
                   _on_card(torch.ones(s_rows, n)))
    g = _on_card(torch.ones(k))
    for call in (lambda: Q.q8_matmul(x, qt), lambda: Q.q8_matmul_silu(x, qt, norm_weight=g),
                 lambda: Q.q8_matmul_ffn(x, qt, qt, x, g)):
        with pytest.raises(ValueError):
            call()
    assert launches == []


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("gs", [16, 32])
def test_plain_decode_products_match_jax_at_stories15m(m, gs):
    """The plain versions the card holds the GEMV to, at decode rows and
    stories15M's widths (QKV N 480 with the norm and RoPE over 6 + 2 heads
    of 48, the FFN at hidden 768): against the JAX kernels in interpret
    mode."""
    dim, hidden, hs = 288, 768, 48
    rng = np.random.default_rng(m + gs)
    xj, xp = _bf16(rng.standard_normal((m, dim)))
    g = (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
    pos = rng.integers(0, 256, m).astype(np.int32)

    def weights(k, n):
        w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
        return jq.q8_quantize_weights(jnp.asarray(w), gs), Q.q8_quantize_weights(
            torch.from_numpy(w), gs)

    jt, pt = weights(dim, 480)
    rope = dict(rope_limit=384, rope_head=hs, rope_theta=10000.0)
    want = jq.q8_matmul(xj, jt, interpret=True, norm_weight=jnp.asarray(g),
                        rope_pos=jnp.asarray(pos), **rope)
    got = Q.q8_matmul(xp, pt, norm_weight=torch.from_numpy(g), rope_pos=torch.from_numpy(pos),
                      **rope)
    assert_close(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)
    (j13, p13), (j2, p2) = weights(dim, 2 * hidden), weights(hidden, dim)
    want = jq.q8_matmul_ffn(xj, j13, j2, xj, jnp.asarray(g), interpret=True)
    got = Q.q8_matmul_ffn(xp, p13, p2, xp, torch.from_numpy(g))
    assert_close(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# the int4 weight on the same GEMV


@pytest.mark.parametrize("model,prod", CASES)
def test_int4_gemv_tasks_cover_every_output_and_packed_row_once(model, prod):
    k, n = products(model)[prod]
    kh = k // 2
    for gs in (16, 32):
        if kh % gs == 0:
            assert Q4.q4_kernel_takes("gemv", k, n, gs, gate=prod == "w13"), (model, prod, gs)
    for m in range(1, Q.GEMV_MAX_M + 1):
        split = Q.gemv_plan(kh, n, m, Q.GEMV_STEP_Q4)
        assert split == Q.gemv_plan(k, n, m)  # K / 16 steps either way
        tasks = Q.gemv_runs(kh, n, m, split, Q.GEMV_STEP_Q4)
        cells: dict = {}  # (columns, rows) -> the packed rows of every warp run
        for cols, rows, sp, runs in tasks:
            assert 0 <= sp < split and len(runs) == Q.GEMV_WARPS
            assert all(a % Q.GEMV_STEP_Q4 == 0 and b % Q.GEMV_STEP_Q4 == 0 for a, b in runs)
            cells.setdefault((cols, rows), []).extend(runs)
        assert _covers_once({c for c, _ in cells}, n), (model, prod, m)
        assert _covers_once({r for _, r in cells}, m), (model, prod, m)
        assert len(cells) == len({c for c, _ in cells}) * len({r for _, r in cells})
        for key, runs in cells.items():
            assert _covers_once(runs, kh), (model, prod, m, key)


def _q4t(k: int, n: int, gs: int):
    return Q4.Q4Tensor(_on_card(torch.zeros(k // 2, n, dtype=torch.int8)),
                       _on_card(torch.ones(k // gs, n)))


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("m", [1, 8, 9, 16])
def test_int4_cuda_wrappers_pass_the_plan(launches, model, m):
    """q4_matmul (QKV with norm + RoPE, wo with the residual, W2) and
    q4_matmul_silu launch their GEMV entry points with gemv_plan's splits of
    the packed rows for m rows, and a (split, M, N) partials workspace."""
    dim, hidden, heads, kvh, _ = MODELS[model]
    gs = 16 if model == "stories15M" else 32
    hs = dim // heads
    prods = products(model)
    x = _on_card(torch.zeros(m, dim, dtype=torch.bfloat16))
    xh = _on_card(torch.zeros(m, hidden, dtype=torch.bfloat16))
    g = _on_card(torch.ones(dim))
    pos = _on_card(torch.zeros(m, dtype=torch.int32))
    Q4.q4_matmul(x, _q4t(*prods["qkv"], gs), norm_weight=g, rope_pos=pos,
                 rope_limit=(heads + kvh) * hs, rope_head=hs)
    Q4.q4_matmul(x, _q4t(*prods["wo"], gs), residual=x)
    Q4.q4_matmul(xh, _q4t(*prods["w2"], gs), residual=x)
    Q4.q4_matmul_silu(x, _q4t(*prods["w13"], gs), norm_weight=g)
    plan = {p: Q.gemv_plan(kn[0] // 2, kn[1], m, Q.GEMV_STEP_Q4) for p, kn in prods.items()}
    (f1, a1), (f2, a2), (f3, a3), (f4, a4) = launches
    assert (f1, a1[9:14]) == ("q4_matmul", (m, dim, prods["qkv"][1], gs, plan["qkv"]))
    assert (f2, a2[9:14]) == ("q4_matmul", (m, dim, dim, gs, plan["wo"]))
    assert (f3, a3[9:14]) == ("q4_matmul", (m, hidden, dim, gs, plan["w2"]))
    assert (f4, a4[7:12]) == ("q4_matmul_silu", (m, dim, hidden, gs, plan["w13"]))
    assert all(args[8 if fn == "q4_matmul" else 6] != 0 for fn, args in launches)


@pytest.mark.parametrize("k,n,s_rows", [(48, 128, 3), (64, 200, 2), (64, 128, 3)])
def test_int4_cuda_wrappers_refuse_what_the_gemv_refuses(launches, k, n, s_rows):
    """K 48 (no multiple of 32), N 200 (no multiple of 16; the gate's H
    100), or 3 scale rows for K 64 (a group size that does not divide K/2):
    the C launchers return cudaErrorInvalidValue there, so the wrappers
    raise ValueError first and launch nothing (no fallback to another
    kernel or to the plain version)."""
    x = _on_card(torch.zeros(8, k, dtype=torch.bfloat16))
    qt = Q4.Q4Tensor(_on_card(torch.zeros(k // 2, n, dtype=torch.int8)),
                     _on_card(torch.ones(s_rows, n)))
    for call in (lambda: Q4.q4_matmul(x, qt), lambda: Q4.q4_matmul_silu(x, qt)):
        with pytest.raises(ValueError):
            call()
    assert launches == []


@pytest.mark.parametrize("m", [1, 8, 16])
def test_plain_int4_decode_products_match_jax_at_stories15m(m):
    """The plain versions the card holds the int4 GEMV to, at decode rows
    and stories15M's widths (K/2 144, groups of 16): QKV N 480 with the
    norm and RoPE over 6 + 2 heads of 48, wo with the residual, the W1|W3
    gate at hidden 768 with the norm, against the JAX kernels in interpret
    mode."""
    dim, hidden, hs, gs = 288, 768, 48, 16
    rng = np.random.default_rng(m + 41)
    xj, xp = _bf16(rng.standard_normal((m, dim)))
    g = (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
    pos = rng.integers(0, 256, m).astype(np.int32)

    def weights(k, n):
        w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
        return jq4.q4_quantize_weights(jnp.asarray(w), gs), Q4.q4_quantize_weights(
            torch.from_numpy(w), gs)

    jt, pt = weights(dim, 480)
    rope = dict(rope_limit=384, rope_head=hs, rope_theta=10000.0)
    want = jq4.q4_matmul(xj, jt, interpret=True, norm_weight=jnp.asarray(g),
                         rope_pos=jnp.asarray(pos), **rope)
    got = Q4.q4_matmul(xp, pt, norm_weight=torch.from_numpy(g), rope_pos=torch.from_numpy(pos),
                       **rope)
    assert_close(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)
    jo, po = weights(dim, dim)
    rj, rp = _bf16(rng.standard_normal((m, dim)))
    want = jq4.q4_matmul(xj, jo, interpret=True, residual=rj)
    got = Q4.q4_matmul(xp, po, residual=rp)
    assert_close(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)
    j13, p13 = weights(dim, 2 * hidden)
    want = jq4.q4_matmul_silu(xj, j13, interpret=True, norm_weight=jnp.asarray(g))
    got = Q4.q4_matmul_silu(xp, p13, norm_weight=torch.from_numpy(g))
    assert_close(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)

"""The `a8` mode of the port's weight products (HIPLLAMA_Q8_MODE=a8,
HIPLLAMA_Q4_MODE=a8) against the JAX package's kernels in interpret mode
with dequant_mode="a8", on the same numpy inputs: the plain q8_matmul (K15)
with each prologue and epilogue at decode and prefill row counts, the plain
q8_matmul_silu (K17), q4_matmul (K21) and q4_matmul_silu (K22); and the
per-call decisions `q8_a8_engages`, `q4_a8_engages` and `ffn_takes_kernel`,
by table at the golden fixture's shapes and Llama-2-7B's, and by behaviour
where the JAX package declines `a8` (its `a8` output is then its reshape or
dequant output bit for bit, and the port's is its own reshape output).

Tolerance: one bf16 ulp at the output's largest magnitude. Both sides
quantize x with the same cast points (the bf16 rounding of x, the product
with fp32(1/127), a true division, round half to even) and sum each group
exactly in int32; they differ only in the order of the fp32 sum over the
groups, which can move an output across a bf16 rounding boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hip_llama_tpu.ops import quant as jq
from hip_llama_tpu.ops import quant4 as jq4
from hip_llama_tpu_torch.ops import quant as Q
from hip_llama_tpu_torch.ops import quant4 as Q4
from test_torch_attention import _on_card, launches  # noqa: F401 (a fixture)

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

N = 384


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _q8(rng, k, n, gs):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return jq.q8_quantize_weights(jnp.asarray(w), gs), Q.q8_quantize_weights(torch.from_numpy(w), gs)


def _q4(rng, k, n, gs):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return (jq4.q4_quantize_weights(jnp.asarray(w), gs),
            Q4.q4_quantize_weights(torch.from_numpy(w), gs))


def assert_within_ulp(got, want, msg=""):
    """|got - want| <= one bf16 ulp at max |want| (the module docstring)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, msg
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want).max()
    assert err <= ulp, f"{msg}: max |diff| {err} > one bf16 ulp {ulp}"


# (M, K, epilogue): decode (M 4) and prefill (M 72) rows, one and three
# groups of 64, every prologue and epilogue
K15_CASES = [(m, k, epi) for m in (4, 72) for k in (128, 192)
             for epi in ("none", "norm", "residual", "norm_rope_heads")]


@pytest.mark.parametrize("m,k,epi", K15_CASES)
def test_plain_q8_matmul_a8_matches_jax(m, k, epi):
    gs = 64
    rng = np.random.default_rng(m * 1000 + k)
    jt, pt = _q8(rng, k, N, gs)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    jkw, pkw = {}, {}
    if "norm" in epi:
        g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
        jkw["norm_weight"], pkw["norm_weight"] = jnp.asarray(g), torch.from_numpy(g)
    if epi == "residual":
        rj, rp = _bf16(rng.standard_normal((m, N)))
        jkw["residual"], pkw["residual"] = rj, rp
    if "rope" in epi:
        pos = rng.integers(0, 2048, m).astype(np.int32)
        pos[0] = 0
        # q|k rotate in heads of 128, v (the last third) passes through
        jkw.update(rope_pos=jnp.asarray(pos), rope_limit=256, rope_head=128, rope_theta=10000.0,
                   out_heads=128)
        pkw.update(rope_pos=torch.from_numpy(pos), rope_limit=256, rope_head=128,
                   rope_theta=10000.0)
    assert Q.q8_a8_engages(m, k, N, gs)
    want = jq.q8_matmul(xj, jt, interpret=True, dequant_mode="a8", **jkw)
    got = Q.q8_matmul(xp, pt, mode="a8", **pkw)
    assert got.dtype == torch.bfloat16 and got.shape == (m, N)
    if "heads" in epi:
        got = got.view(m, N // 128, 128)  # the head-split layout is a view
    assert_within_ulp(got, want, f"{epi} M {m} K {k}")
    # the mode changes the numbers: a8 is not the reshape product
    reshape = Q.q8_matmul(xp, pt, **pkw)
    assert not torch.equal(got.reshape(m, N), reshape)


@pytest.mark.parametrize("m", [4, 72])
def test_plain_q8_matmul_silu_a8_matches_jax(m):
    k, h, gs = 192, 256, 64
    rng = np.random.default_rng(m + 7)
    jt, pt = _q8(rng, k, 2 * h, gs)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    want = jq.q8_matmul_silu(xj, jt, interpret=True, dequant_mode="a8", norm_weight=jnp.asarray(g))
    got = Q.q8_matmul_silu(xp, pt, norm_weight=torch.from_numpy(g), mode="a8")
    assert got.shape == (m, h)
    assert_within_ulp(got, want, f"M {m}")


@pytest.mark.parametrize("m,k,epi", [(m, k, epi) for m in (4, 72) for k in (128, 192)
                                     for epi in ("none", "norm_rope", "residual")])
def test_plain_q4_matmul_a8_matches_jax(m, k, epi):
    gs = 32
    rng = np.random.default_rng(m * 10 + k + 3)
    jt, pt = _q4(rng, k, N, gs)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    jkw, pkw = {}, {}
    if "norm" in epi:
        g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
        jkw["norm_weight"], pkw["norm_weight"] = jnp.asarray(g), torch.from_numpy(g)
    if "rope" in epi:
        pos = rng.integers(0, 2048, m).astype(np.int32)
        jkw.update(rope_pos=jnp.asarray(pos), rope_limit=256, rope_head=64, rope_theta=10000.0)
        pkw.update(rope_pos=torch.from_numpy(pos), rope_limit=256, rope_head=64,
                   rope_theta=10000.0)
    if epi == "residual":
        rj, rp = _bf16(rng.standard_normal((m, N)))
        jkw["residual"], pkw["residual"] = rj, rp
    assert Q4.q4_a8_engages(m, k, N, gs)
    want = jq4.q4_matmul(xj, jt, interpret=True, dequant_mode="a8", **jkw)
    got = Q4.q4_matmul(xp, pt, mode="a8", **pkw)
    assert_within_ulp(got, want, f"{epi} M {m} K {k}")
    assert not torch.equal(got, Q4.q4_matmul(xp, pt, **pkw))


@pytest.mark.parametrize("m,norm", [(4, True), (72, True), (72, False)])
def test_plain_q4_matmul_silu_a8_matches_jax(m, norm):
    k, h, gs = 192, 128, 32
    rng = np.random.default_rng(m + 11)
    jt, pt = _q4(rng, k, 2 * h, gs)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    jkw, pkw = {}, {}
    if norm:
        g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
        jkw["norm_weight"], pkw["norm_weight"] = jnp.asarray(g), torch.from_numpy(g)
    want = jq4.q4_matmul_silu(xj, jt, interpret=True, dequant_mode="a8", **jkw)
    got = Q4.q4_matmul_silu(xp, pt, mode="a8", **pkw)
    assert got.shape == (m, h)
    assert_within_ulp(got, want, f"M {m}")


def test_int4_halves_quantize_as_the_whole_row():
    """K/2 is a multiple of the group size, so quantizing x[:, :K/2] and
    x[:, K/2:] each in groups of gs (quant4.py:139) gives the groups of the
    whole row: one quantizer serves the kernels of both weight types."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 192)).astype(np.float32))
    x[2, 96:128] = 0.0  # an all-zero group takes scale 1
    xi, sx = Q.a8_quantize_rows(x, 32)
    for sl, sg in ((slice(0, 96), slice(0, 3)), (slice(96, 192), slice(3, 6))):
        hi, hs = Q.a8_quantize_rows(x[:, sl], 32)
        assert torch.equal(hi, xi[:, sl]) and torch.equal(hs, sx[:, sg])
    assert sx[2, 3] == 1.0 and xi.abs().max() == 127


def test_a8_quantizer_matches_jax_stash():
    """The activation quantizer bit for bit against the JAX kernels' own
    (quant4.py::_a8_quant_half, the transposed stash of quant.py:271-275)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 128)).astype(np.float32)
    xi_j, sx_j = jq4._a8_quant_half(jnp.asarray(x), 4, 32)  # (G, gs, M), (G, 1, M)
    xi, sx = Q.a8_quantize_rows(torch.from_numpy(x), 32)
    np.testing.assert_array_equal(xi.numpy(), np.asarray(xi_j).transpose(2, 0, 1).reshape(5, 128))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_j)[:, 0].T)


# ---------------------------------------------------------------------------
# the per-call decisions

# (m, k, n, gs, block_n, engages): the fixture (dim 64, hidden 192, 8 heads
# of 8, 4 KV heads, vocab 512) at the goldens' block_n 64, decode rows (4)
# and the prefill chunks of -b 4 (T 16 and 64); Llama-2-7B at the defaults,
# decode (8) and prefill (2048) rows: every product takes `a8` but the
# prefill W2, whose K of 172 groups exceeds 64 (quant.py:1298-1303). The
# paged decode's separate W1 and W3 (n 11008) and W2 take it too
Q8_TABLE = [
    (m, k, n, 64, 64, True) for m in (4, 64, 256)
    for k, n in ((64, 128), (64, 64), (64, 384), (192, 64), (64, 512))
] + [
    (8, 4096, 12288, 64, None, True), (8, 4096, 4096, 64, None, True),
    (8, 4096, 11008, 64, None, True), (8, 11008, 4096, 64, None, True),
    (8, 4096, 32000, 64, None, True),
    (2048, 4096, 12288, 64, None, True), (2048, 4096, 4096, 64, None, True),
    (2048, 4096, 11008, 64, None, True), (2048, 11008, 4096, 64, None, False),
    (72, 4160, 128, 64, None, False),  # 65 groups at prefill rows
    (64, 4096, 22016, 64, None, False),  # decode group sums past 4 MiB
]


@pytest.mark.parametrize("m,k,n,gs,block_n,engages", Q8_TABLE)
def test_q8_a8_decision_table(m, k, n, gs, block_n, engages):
    assert Q.q8_a8_engages(m, k, n, gs, block_n) is engages


# int4: decode rows take `a8` at 7B (each x half one K block); prefill rows
# do not (M x K x 2 bytes past 2 MiB), nor does W2's 11008 x 256 strip
# past 4 MiB at block_n 512
Q4_TABLE = [
    (m, k, n, 32, 64, True) for m in (4, 64, 256)
    for k, n in ((64, 128), (64, 384), (192, 64), (64, 512))
] + [
    (8, 4096, 12288, 32, None, True), (8, 4096, 4096, 32, None, True),
    (8, 4096, 11008, 32, None, True), (8, 11008, 4096, 32, None, True),
    (8, 4096, 32000, 32, None, True),
    (2048, 4096, 12288, 32, None, False), (2048, 11008, 4096, 32, None, False),
    (2048, 4096, 11008, 32, None, False), (8, 11008, 4096, 32, 512, False),
]


@pytest.mark.parametrize("m,k,n,gs,block_n,engages", Q4_TABLE)
def test_q4_a8_decision_table(m, k, n, gs, block_n, engages):
    assert Q4.q4_a8_engages(m, k, n, gs, block_n) is engages


@pytest.mark.parametrize("m,k,h,gs,mode,takes", [
    (4, 64, 192, 64, "reshape", True),  # the port's K18 runs at every width in reshape mode
    (4, 64, 192, 64, "a8", False),  # the JAX K18 declines at hidden 192 (quant.py:925-933)
    (64, 64, 192, 64, "a8", False),
    (8, 4096, 11008, 64, "a8", True),  # 7B decode: K18, reshape math
    (128, 4096, 11008, 64, "a8", True),
    (257, 4096, 11008, 64, "a8", False),  # past 256 rows: K17 and K15
    (128, 4096, 11008, 64, "reshape", True),
])
def test_ffn_kernel_decision(m, k, h, gs, mode, takes):
    assert Q.ffn_takes_kernel(m, k, h, gs, mode) is takes


def test_q8_declined_a8_is_reshape_on_both_sides():
    """M 72 with K 4160 (65 groups): the JAX wrapper keeps reshape math
    under dequant_mode="a8" (its output equals its reshape output bit for
    bit); the port's decision says no and its output is its reshape
    output."""
    m, k, n, gs = 72, 4160, 128, 64
    rng = np.random.default_rng(8)
    jt, pt = _q8(rng, k, n, gs)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    ja8 = jq.q8_matmul(xj, jt, interpret=True, dequant_mode="a8")
    np.testing.assert_array_equal(_np(ja8), _np(jq.q8_matmul(xj, jt, interpret=True,
                                                             dequant_mode="reshape")))
    assert not Q.q8_a8_engages(m, k, n, gs)
    assert torch.equal(Q.q8_matmul(xp, pt, mode="a8"), Q.q8_matmul(xp, pt))


def test_q4_declined_a8_is_dequant_on_both_sides():
    """M x K x 2 bytes past 2 MiB (M 80, K 16384): each x half spans several
    K blocks, so the JAX wrapper keeps dequant math under a8; so does the
    port."""
    m, k, n, gs = 80, 16384, 128, 32
    rng = np.random.default_rng(9)
    jt, pt = _q4(rng, k, n, gs)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    ja8 = jq4.q4_matmul(xj, jt, interpret=True, dequant_mode="a8")
    np.testing.assert_array_equal(_np(ja8), _np(jq4.q4_matmul(xj, jt, interpret=True,
                                                              dequant_mode="dequant")))
    assert not Q4.q4_a8_engages(m, k, n, gs)
    assert torch.equal(Q4.q4_matmul(xp, pt, mode="a8"), Q4.q4_matmul(xp, pt))


@pytest.mark.parametrize("fn,mode", [
    ("q8", "group_dot"), ("q8", "bf16"), ("q8", "f32dot"), ("q8", "repeat"), ("q4", "bf16"),
])
def test_unported_modes_raise(fn, mode):
    x = torch.zeros((2, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 64))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        if fn == "q8":
            Q.q8_matmul(x, Q.q8_quantize_weights(w, 64), mode=mode)
        else:
            Q4.q4_matmul(x, Q4.q4_quantize_weights(w, 32), mode=mode)


@pytest.mark.parametrize("m", [8, 12, 40, 300])
def test_cuda_wrappers_launch_the_a8_kernels(launches, m):
    """On CUDA tensors (recorded, not launched) each wrapper in `a8` mode
    binds its `a8` entry point with the C declaration's parameters, the
    GEMV path with a split plan of whole groups (M <= 16) or the tiled
    path, where the decision says `a8`; else the reshape (dequant) entry
    point: at 7B widths, QKV at 40 rows and W2 at 12 (group sums past 4
    MiB) and prefill W2 (172 groups) keep reshape math, and int4 past 256
    rows of K 4096 dequant math."""
    dt = torch.bfloat16
    gs8, gs4 = 64, 32

    def q8(k, n):
        return Q.QTensor(_on_card(torch.zeros(k, n, dtype=torch.int8)),
                         _on_card(torch.ones(k // gs8, n)))

    def q4(k, n):
        return Q4.Q4Tensor(_on_card(torch.zeros(k // 2, n, dtype=torch.int8)),
                           _on_card(torch.ones(k // gs4, n)))

    x = _on_card(torch.zeros(m, 4096, dtype=dt))
    x2 = _on_card(torch.zeros(m, 11008, dtype=dt))
    g = _on_card(torch.ones(4096))
    pos = _on_card(torch.zeros(m, dtype=torch.int32))
    rope = dict(rope_pos=pos, rope_limit=8192, rope_head=128)
    Q.q8_matmul(x, q8(4096, 12288), norm_weight=g, mode="a8", **rope)
    Q.q8_matmul_silu(x, q8(4096, 2 * 11008), norm_weight=g, mode="a8")
    Q.q8_matmul(x2, q8(11008, 4096), residual=_on_card(torch.zeros(m, 4096, dtype=dt)),
                mode="a8")
    Q4.q4_matmul(x, q4(4096, 12288), norm_weight=g, mode="a8", **rope)
    Q4.q4_matmul_silu(x, q4(4096, 2 * 11008), mode="a8")
    expect = [("q8_matmul", Q.q8_a8_engages(m, 4096, 12288, gs8)),
              ("q8_matmul_silu", Q.q8_a8_engages(m, 4096, 11008, gs8)),
              ("q8_matmul", Q.q8_a8_engages(m, 11008, 4096, gs8)),
              ("q4_matmul", Q4.q4_a8_engages(m, 4096, 12288, gs4)),
              ("q4_matmul_silu", Q4.q4_a8_engages(m, 4096, 11008, gs4))]
    assert [fn for fn, _ in launches] == [f + ("_a8" if a8 else "") for f, a8 in expect]
    assert [a8 for _, a8 in expect] == {8: [True] * 5, 12: [True, True, False, True, True],
                                        40: [False, True, False, True, True],
                                        300: [True, True, False, False, False]}[m]
    for fn, args in launches:
        if fn.endswith("_a8"):
            split, kslice = args[12:14] if "silu" in fn else args[14:16]
            assert (split > 0) == (m <= Q.GEMV_MAX_M), (fn, split)
            assert kslice % (gs4 if fn.startswith("q4") else gs8) == 0, (fn, kslice)


@pytest.mark.parametrize("int4", [False, True], ids=["q8", "int4"])
@pytest.mark.parametrize("gs", [16, 32, 48, 64])
def test_a8_gemv_row_rule_and_counters(launches, int4, gs):
    """Up to 16 rows an `a8` product takes the GEMV on the int8 tensor
    cores (a8.cuh::a8_gemv_tc_kernel) where the group size is a multiple
    of 32, so that a 32-deep step lies in one group, and the dp4a GEMV at
    the other group sizes, both weights alike; either gets the same slices
    of whole groups (kslice_plan), since the two add the same partials.
    Each wrapper counts the tensor-core launches in `.launches_a8_tc`, a
    share of `.launches_a8`, apart from the tiles' `.launches_a8_wgmma`."""
    k, n = 384, 256
    if int4:
        qt = Q4.Q4Tensor(_on_card(torch.zeros(k // 2, n, dtype=torch.int8)),
                         _on_card(torch.ones(k // gs, n)))
        wrapper, rows, kmax = Q4.q4_matmul, k // 2, Q.A8_GEMV_ROWS // 2
    else:
        qt = Q.QTensor(_on_card(torch.zeros(k, n, dtype=torch.int8)),
                       _on_card(torch.ones(k // gs, n)))
        wrapper, rows, kmax = Q.q8_matmul, k, Q.A8_GEMV_ROWS
    for m in (1, 8, 9, 16, 17):
        kernel = Q.a8_rows_kernel(m, gs)
        if m <= Q.GEMV_MAX_M:
            assert kernel == ("gemv_tc" if gs % 32 == 0 else "gemv"), (m, gs)
        else:
            assert kernel == ("wgmma" if gs % 32 == 0 else "mma"), (m, gs)
        assert Q.a8_kernel_takes(kernel, k, n, gs, int4=int4)
        before = (wrapper.launches_a8, wrapper.launches_a8_tc, wrapper.launches_a8_wgmma)
        launches.clear()
        wrapper(_on_card(torch.zeros(m, k, dtype=torch.bfloat16)), qt, mode="a8")
        (fn, args), = launches
        assert fn == wrapper.__name__ + "_a8"
        plan = Q.kslice_plan(rows, n, kmax, gs) if m <= Q.GEMV_MAX_M else (0, 0)
        assert args[14:16] == plan, (m, gs)
        assert (wrapper.launches_a8 - before[0], wrapper.launches_a8_tc - before[1],
                wrapper.launches_a8_wgmma - before[2]) == (
            1, int(kernel == "gemv_tc"), int(kernel == "wgmma"))


@pytest.mark.parametrize("int4", [False, True], ids=["q8", "int4"])
def test_a8_gemv_probe_launches_either_gemv(launches, int4):
    """a8_gemv_probe binds the probe entry point of the weight's library
    with the variant (0 the tensor-core GEMV, 1 dp4a) and the wrappers'
    slices, counts its launches apart from the wrappers', and refuses what
    the chosen GEMV does not take (groups of 16 on the tensor cores, more
    than 16 rows) before any launch."""
    k, n = 256, 128
    gs = 32 if int4 else 64
    if int4:
        qt = Q4.Q4Tensor(_on_card(torch.zeros(k // 2, n, dtype=torch.int8)),
                         _on_card(torch.ones(k // gs, n)))
        qt16 = Q4.Q4Tensor(qt.q, _on_card(torch.ones(k // 16, n)))
        fn, rows, kmax = "q4_a8_gemv_probe", k // 2, Q.A8_GEMV_ROWS // 2
    else:
        qt = Q.QTensor(_on_card(torch.zeros(k, n, dtype=torch.int8)),
                       _on_card(torch.ones(k // gs, n)))
        qt16 = Q.QTensor(qt.q, _on_card(torch.ones(k // 16, n)))
        fn, rows, kmax = "q8_a8_gemv_probe", k, Q.A8_GEMV_ROWS
    x = _on_card(torch.zeros(8, k, dtype=torch.bfloat16))
    a0, w0 = Q.a8_gemv_probe.launches, Q.q8_matmul.launches_a8
    for v in (0, 1):
        Q.a8_gemv_probe(x, qt, False, v, residual=_on_card(torch.zeros(8, n, dtype=torch.bfloat16)))
    Q.a8_gemv_probe(x, qt, True, 0, norm_weight=_on_card(torch.ones(k)))
    assert [f for f, _ in launches] == [fn] * 3
    assert [a[10:18] for _, a in launches] == [
        (8, k, n, gs, *Q.kslice_plan(rows, n, kmax, gs), gate, v)
        for gate, v in ((0, 0), (0, 1), (1, 0))]
    assert (Q.a8_gemv_probe.launches - a0, Q.q8_matmul.launches_a8 - w0) == (3, 0)
    launches.clear()
    for call in (lambda: Q.a8_gemv_probe(x, qt16, False, 0),
                 lambda: Q.a8_gemv_probe(_on_card(torch.zeros(17, k, dtype=torch.bfloat16)), qt,
                                         False, 1),
                 lambda: Q.a8_gemv_probe(x, qt, False, 2)):
        with pytest.raises(ValueError):
            call()
    assert launches == []
    Q.a8_gemv_probe(x, qt16, False, 1)  # dp4a takes groups of 16
    assert [f for f, _ in launches] == [fn]

"""The one row rule of the int4 products and what each of its kernels
takes, on the CPU.

`ops/quant4.py::q4_rows_kernel` decides, by row count alone, which kernel
q4_matmul (K21) and q4_matmul_silu (K22) launch in `dequant` math: the
split-K GEMV up to GEMV_MAX_M rows, the tiles on csrc/q8_wgmma.cuh's
pipelined mainloop (its int4 weight format) above. `q4_kernel_takes` says
which K, N and group sizes each accepts, as its C launcher decides. Here
both run over every int4 product shape of the models the port serves: the
golden fixture (dim 64, hidden 192, 8 heads over 4 KV heads), llama2.c's
stories15M (dim 288, 6 heads of 48 over 2 KV heads, hidden 768: K/2 = 144,
which 32-row steps leave half a step short, and the group size that
`q4_group_size` shrinks to 16 there) and Llama-2-7B (K/2 = 5504 for W2);
then the CUDA wrappers on the small shapes, their launches recorded instead
of made (tests/test_torch_attention.py's `launches` fixture): the kernel's
split argument, the tiles' RoPE table and the wgmma count agree with the
rule, and a shape no kernel takes raises before any launch. The plain
versions, which the kernels are held to on the card (tests/
test_torch_cuda.py), are held to the JAX package's kernels in interpret
mode at K 288 and K 96, both half a step past a multiple of 64, at atol =
rtol = 2e-2 (the same cast points, the fp32 sums in another order: one bf16
ulp of an O(1) output, tests/test_attention_pallas.py:83-85).

The `a8` mode (HIPLLAMA_Q4_MODE=a8) has the Q8 products' row rule
(ops/quant.py::a8_rows_kernel): up to GEMV_MAX_M rows the GEMV, on the int8
tensor cores at group sizes that are multiples of 32, else by dp4a; above,
at group sizes that are multiples of 32, csrc/a8_wgmma.cuh's int8 wgmma
tiles, one nibble plane a CTA into the workspace part (2, M, N), whose
planes a split pass adds through the epilogue or gate; a8.cuh's mma.sync
tiles at other group sizes (stories15M's dim-288 products, groups of 16).
The same shapes go through that rule and the `a8` wrappers, and the plain
`a8` products are held to the JAX kernels in interpret mode at a plane's
K tails (K 64: half of one 128-deep step a plane; K 320: a last step of
32 rows), within one bf16 ulp at the output's largest magnitude as in
tests/test_torch_a8.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.ops import quant4 as jq4
from hip_llama_tpu_torch.io.checkpoint import q4_group_size
from hip_llama_tpu_torch.ops import quant as Q
from hip_llama_tpu_torch.ops import quant4 as Q4
from test_torch_a8 import assert_within_ulp
from test_torch_attention import _on_card, launches  # noqa: F401 (a fixture)

torch.set_num_threads(1)

# name: (dim, hidden, heads, KV heads, vocab, requested int4 group sizes)
MODELS = {
    "golden": (64, 192, 8, 4, 512, (32,)),
    "stories15M": (288, 768, 6, 2, 32000, (32, 16)),
    "7b": (4096, 11008, 32, 32, 32000, (32,)),
}
# rows of a prefill product: 1-8 slots times chunks of T 16, 64 and 256, the
# bench's 8 x 511, the GEMV rows below them and the tiles' edges around 256
ROWS = (1, 8, 16, 17, 32, 64, 128, 255, 256, 257, 512, 1024, 2048, 4088)


def products(model: str) -> dict[str, tuple[int, int, bool]]:
    """Each int4 product of a layer and the classifier: (K, N, gate), N the
    weight's columns (2H for the W1|W3 gate)."""
    dim, hidden, heads, kvh, vocab, _ = MODELS[model]
    kv_dim = dim * kvh // heads
    return {"qkv": (dim, dim + 2 * kv_dim, False), "wo": (dim, dim, False),
            "w13": (dim, 2 * hidden, True), "w2": (hidden, dim, False),
            "classifier": (dim, vocab, False)}


CASES = [(model, prod, gs) for model in MODELS for prod in products(model)
         for gs in MODELS[model][5]]


@pytest.mark.parametrize("model,prod,gs", CASES)
def test_the_row_rule_picks_a_kernel_that_takes_the_shape(model, prod, gs):
    k, n, gate = products(model)[prod]
    gs = q4_group_size(k, gs)  # the group size the quantizer gives this K
    for m in ROWS:
        kernel = Q4.q4_rows_kernel(m)
        assert kernel == ("gemv" if m <= Q4.GEMV_MAX_M else "wgmma"), m
        assert Q4.q4_kernel_takes(kernel, k, n, gs, gate), (model, prod, m, kernel)


@pytest.mark.parametrize("model,prod,gs", CASES)
def test_the_a8_rule_picks_a_kernel_that_takes_the_int4_shape(model, prod, gs):
    """The `a8` row rule over the same products: the int8 wgmma tiles above
    16 rows wherever the quantizer's group size is a multiple of 32 (the
    fixture's and 7B's 32, W2 at K 11008 among them; stories15M's W2 at K
    768), the mma.sync tiles where it shrinks to 16 (stories15M's K 288)."""
    k, n, gate = products(model)[prod]
    gs = q4_group_size(k, gs)
    for m in ROWS:
        kernel = Q.a8_rows_kernel(m, gs)
        assert kernel == (("gemv_tc" if gs % 32 == 0 else "gemv") if m <= Q.GEMV_MAX_M
                          else "wgmma" if gs % 32 == 0 else "mma"), (m, gs)
        assert Q.a8_kernel_takes(kernel, k, n, gs, gate, int4=True), (model, prod, m, kernel)
    if model == "stories15M" and k == 288:
        assert gs == 16 and Q.a8_rows_kernel(40, gs) == "mma"


@pytest.mark.parametrize("kernel", ["gemv", "wgmma"])
@pytest.mark.parametrize("k,n,gs,gate", [(48, 128, 8, False), (64, 200, 32, False),
                                         (96, 128, 32, False), (64, 128, 12, False),
                                         (64, 400, 32, True), (0, 128, 32, False)])
def test_kernels_refuse_what_their_launchers_refuse(kernel, k, n, gs, gate):
    """K no multiple of 32, N no multiple of 16, a group size that does not
    divide K/2 (K 96 at 32, K 64 at 12), a gate's H no multiple of 16 (N
    400: H 200): the C launchers return cudaErrorInvalidValue there, so the
    rule's check refuses them first. K 288 at groups of 12 and 8 (K/2 =
    144) is taken."""
    assert not Q4.q4_kernel_takes(kernel, k, n, gs, gate)
    assert Q4.q4_kernel_takes(kernel, 64, 128, 32)
    for g in (8, 12, 16):
        assert Q4.q4_kernel_takes(kernel, 288, 480, g)
    with pytest.raises(ValueError):
        Q4.q4_kernel_takes("wmma", 64, 128, 32)  # the rule has no other kernel


def _split_arg(fn: str, args: tuple) -> int:
    """The split argument of a recorded q4_matmul / q4_matmul_silu launch
    (0: the tiles), after the pointers and M, K, N (or H), gs."""
    return args[(9 if fn == "q4_matmul" else 7) + 4]


@pytest.mark.parametrize("m", [8, 16, 17, 128, 300])
@pytest.mark.parametrize("model,prod,gs", [c for c in CASES if c[0] != "7b"
                                           and c[1] != "classifier"])
def test_cuda_wrappers_launch_the_kernel_of_the_rule(launches, model, prod, gs, m):
    k, n, gate = products(model)[prod]
    gs = q4_group_size(k, gs)
    qt = Q4.Q4Tensor(_on_card(torch.zeros(k // 2, n, dtype=torch.int8)),
                     _on_card(torch.ones(k // gs, n)))
    x = _on_card(torch.zeros(m, k, dtype=torch.bfloat16))
    g = _on_card(torch.ones(k))
    wrapper = Q4.q4_matmul_silu if gate else Q4.q4_matmul
    before = (wrapper.launches, wrapper.launches_wgmma)
    rope = prod == "qkv"
    if gate:
        Q4.q4_matmul_silu(x, qt, norm_weight=g)
    elif rope:  # q and k rotate, v passes
        hs = k // MODELS[model][2]
        Q4.q4_matmul(x, qt, norm_weight=g, rope_pos=_on_card(torch.zeros(m, dtype=torch.int32)),
                     rope_limit=n - (n - k) // 2, rope_head=hs)
    else:
        Q4.q4_matmul(x, qt, residual=_on_card(torch.zeros(m, n, dtype=torch.bfloat16)))
    (fn, args), = launches
    assert fn == wrapper.__name__
    wgmma = Q4.q4_rows_kernel(m) == "wgmma"
    assert (_split_arg(fn, args) == 0) == wgmma
    if fn == "q4_matmul":  # the GEMV's partials or the tiles' RoPE table: part_ws
        assert (args[8] != 0) == (not wgmma or rope)
    assert (wrapper.launches - before[0], wrapper.launches_wgmma - before[1]) == (1, int(wgmma))


@pytest.mark.parametrize("m", [8, 40])
def test_cuda_wrappers_refuse_before_launching(launches, m):
    """A shape no kernel takes raises ValueError and launches nothing (no
    fallback to another kernel or to the plain version), on either side of
    the row rule: K 48, a group size of 32 over K/2 = 48, and a gate of H
    200."""
    x = _on_card(torch.zeros(m, 48, dtype=torch.bfloat16))
    qt = Q4.Q4Tensor(_on_card(torch.zeros(24, 128, dtype=torch.int8)),
                     _on_card(torch.ones(3, 128)))
    with pytest.raises(ValueError):
        Q4.q4_matmul(x, qt)
    x = _on_card(torch.zeros(m, 96, dtype=torch.bfloat16))
    qt = Q4.Q4Tensor(_on_card(torch.zeros(48, 128, dtype=torch.int8)),
                     _on_card(torch.ones(3, 128)))
    with pytest.raises(ValueError):
        Q4.q4_matmul(x, qt)
    x = _on_card(torch.zeros(m, 64, dtype=torch.bfloat16))
    qt = Q4.Q4Tensor(_on_card(torch.zeros(32, 400, dtype=torch.int8)),
                     _on_card(torch.ones(2, 400)))
    with pytest.raises(ValueError):
        Q4.q4_matmul_silu(x, qt)
    assert launches == []


def _a8_args(fn: str, args: tuple) -> tuple[int, int]:
    """(split, part_ws) of a recorded q4_matmul_a8 / q4_matmul_silu_a8
    launch: the split (0: the tiles) after the pointers and M, K, N (or H),
    gs; part_ws the last pointer before the ints."""
    ptrs = 10 if fn == "q4_matmul_a8" else 8
    return args[ptrs + 4], args[ptrs - 1]


@pytest.mark.parametrize("m", [8, 16, 17, 128, 300])
@pytest.mark.parametrize("model,prod,gs", [c for c in CASES if c[0] != "7b"
                                           and c[1] != "classifier"])
def test_cuda_wrappers_launch_the_a8_kernel_of_the_rule(launches, monkeypatch, model, prod, gs,
                                                         m):
    """In `a8` the wrapper launches its `_a8` entry point once: the GEMV's
    split, or the tiles (split 0); the wgmma tiles with part_ws a (2, M, N)
    fp32 workspace for the nibble planes' sums (the W1|W3 gate: N = 2H),
    which the entry point's split pass adds with the epilogue; the mma.sync
    tiles with none. `.launches_a8_wgmma` counts the wgmma tiles."""
    made = []
    empty = torch.empty

    def recorded(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", recorded)
    k, n, gate = products(model)[prod]
    gs = q4_group_size(k, gs)
    qt = Q4.Q4Tensor(_on_card(torch.zeros(k // 2, n, dtype=torch.int8)),
                     _on_card(torch.ones(k // gs, n)))
    x = _on_card(torch.zeros(m, k, dtype=torch.bfloat16))
    g = _on_card(torch.ones(k))
    wrapper = Q4.q4_matmul_silu if gate else Q4.q4_matmul
    assert Q4.q4_a8_engages(m, k, n // 2 if gate else n, gs)
    before = (wrapper.launches, wrapper.launches_a8, wrapper.launches_a8_wgmma,
              wrapper.launches_a8_tc)
    if gate:
        Q4.q4_matmul_silu(x, qt, norm_weight=g, mode="a8")
    elif prod == "qkv":  # q and k rotate, v passes
        Q4.q4_matmul(x, qt, norm_weight=g, rope_pos=_on_card(torch.zeros(m, dtype=torch.int32)),
                     rope_limit=n - (n - k) // 2, rope_head=k // MODELS[model][2], mode="a8")
    else:
        Q4.q4_matmul(x, qt, residual=_on_card(torch.zeros(m, n, dtype=torch.bfloat16)),
                     mode="a8")
    (fn, args), = launches
    assert fn == wrapper.__name__ + "_a8"
    kernel = Q.a8_rows_kernel(m, gs)
    split, part = _a8_args(fn, args)
    assert (split > 0) == (kernel in ("gemv", "gemv_tc"))
    assert (part != 0) == (kernel != "mma")
    if kernel == "wgmma":
        ws, = [t for t in made if t.data_ptr() == part]
        assert ws.shape == (2, m, n) and ws.dtype == torch.float32
    assert (wrapper.launches - before[0], wrapper.launches_a8 - before[1],
            wrapper.launches_a8_wgmma - before[2], wrapper.launches_a8_tc - before[3]) == (
        0, 1, int(kernel == "wgmma"), int(kernel == "gemv_tc"))


@pytest.mark.parametrize("m", [8, 40])
def test_cuda_a8_wrappers_refuse_before_launching(launches, m):
    """In `a8`, a shape no `a8` kernel takes raises ValueError and launches
    nothing, on either side of the row rule: groups of 12 (no multiple of
    8) over K/2 = 48, and a gate of H 200."""
    x = _on_card(torch.zeros(m, 96, dtype=torch.bfloat16))
    qt = Q4.Q4Tensor(_on_card(torch.zeros(48, 128, dtype=torch.int8)),
                     _on_card(torch.ones(8, 128)))
    assert Q4.q4_a8_engages(m, 96, 128, 12)
    with pytest.raises(ValueError):
        Q4.q4_matmul(x, qt, mode="a8")
    x = _on_card(torch.zeros(m, 64, dtype=torch.bfloat16))
    qt = Q4.Q4Tensor(_on_card(torch.zeros(32, 400, dtype=torch.int8)),
                     _on_card(torch.ones(2, 400)))
    with pytest.raises(ValueError):
        Q4.q4_matmul_silu(x, qt, mode="a8")
    assert launches == []


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("variant", [0, 1])
def test_tiles_probe_launches_the_variant(launches, gate, variant):
    """q4_a8_tiles_probe (the card's bit-for-bit check of the two int4 `a8`
    tile kernels) passes its variant and, for the wgmma tiles, a (2, M, N)
    workspace; it refuses the GEMV's rows and, for the wgmma tiles, groups
    of 16, before any launch."""
    k, n, m = 64, 256, 40
    qt = Q4.Q4Tensor(_on_card(torch.zeros(k // 2, n, dtype=torch.int8)),
                     _on_card(torch.ones(k // 32, n)))
    x = _on_card(torch.zeros(m, k, dtype=torch.bfloat16))
    out = Q4.q4_a8_tiles_probe(x, qt, gate, variant)
    assert out.shape == (m, n // 2 if gate else n)
    (fn, args), = launches
    assert fn == "q4_a8_tiles_probe" and args[10:16] == (m, k, n, 32, int(gate), variant)
    assert (args[9] != 0) == (variant == 0)
    with pytest.raises(ValueError):
        Q4.q4_a8_tiles_probe(x[:16], qt, gate, variant)
    qt16 = Q4.Q4Tensor(qt.q, _on_card(torch.ones(k // 16, n)))
    if variant == 0:
        with pytest.raises(ValueError):
            Q4.q4_a8_tiles_probe(x, qt16, gate, variant)
        assert len(launches) == 1
    else:
        Q4.q4_a8_tiles_probe(x, qt16, gate, variant)
        assert len(launches) == 2


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _weights(rng, k, n, gs):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return (jq4.q4_quantize_weights(jnp.asarray(w), gs),
            Q4.q4_quantize_weights(torch.from_numpy(w), gs))


@pytest.mark.parametrize("k,n,h,hs,gs", [(288, 480, 768, 48, 16), (288, 480, 768, 48, 12),
                                         (96, 208, 128, 8, 16)])
def test_plain_products_match_jax_at_half_step_k(k, n, h, hs, gs):
    """K 288 (stories15M; K/2 = 144) and K 96 (K/2 = 48): a last 32-row step
    of the tiles half dead in each nibble half. QKV with the norm and RoPE
    (the first two thirds rotating in heads of hs), an output with the
    residual, and the W1|W3 gate with the norm: the plain versions against
    the JAX kernels in interpret mode (the gate at block_n 64, where the
    JAX kernel runs at H 128 rather than declining), at 40 rows (tiles on
    the card); groups of 16, and of 12 (no multiple of 8: the tiles read
    those scales a row at a time)."""
    m = 40
    rng = np.random.default_rng(k + gs)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    pos = rng.integers(0, 256, m).astype(np.int32)
    jt, pt = _weights(rng, k, n, gs)
    rope = dict(rope_limit=(2 * n // 3) // hs * hs, rope_head=hs, rope_theta=10000.0)
    want = jq4.q4_matmul(xj, jt, interpret=True, norm_weight=jnp.asarray(g),
                         rope_pos=jnp.asarray(pos), **rope)
    got = Q4.q4_matmul(xp, pt, norm_weight=torch.from_numpy(g), rope_pos=torch.from_numpy(pos),
                       **rope)
    assert_close(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2,
                 msg="norm + RoPE")
    rj, rp = _bf16(rng.standard_normal((m, n)))
    want = jq4.q4_matmul(xj, jt, interpret=True, residual=rj)
    got = Q4.q4_matmul(xp, pt, residual=rp)
    assert_close(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2,
                 msg="residual")
    jt, pt = _weights(rng, k, 2 * h, gs)
    want = jq4.q4_matmul_silu(xj, jt, block_n=64, interpret=True, norm_weight=jnp.asarray(g))
    got = Q4.q4_matmul_silu(xp, pt, norm_weight=torch.from_numpy(g))
    assert got.shape == (m, h)
    assert_close(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2,
                 msg="gate")


@pytest.mark.parametrize("k", [64, 320])
def test_plain_a8_products_match_jax_at_plane_tails(k):
    """QKV with the norm and RoPE (q|k rotating in heads of 64, v passing),
    an output with the residual, and the W1|W3 gate with the norm: the plain
    `a8` versions against the JAX kernels in interpret mode with
    dequant_mode="a8", at 40 rows and groups of 32 (the wgmma tiles on the
    card), where a plane's K/2 (32, 160) ends inside a 128-deep step."""
    m, n, h, gs = 40, 384, 256, 32
    rng = np.random.default_rng(k + 5)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    pos = rng.integers(0, 2048, m).astype(np.int32)
    jt, pt = _weights(rng, k, n, gs)
    assert Q.a8_rows_kernel(m, gs) == "wgmma" and Q4.q4_a8_engages(m, k, n, gs)
    rope = dict(rope_limit=256, rope_head=64, rope_theta=10000.0)
    want = jq4.q4_matmul(xj, jt, interpret=True, dequant_mode="a8", norm_weight=jnp.asarray(g),
                         rope_pos=jnp.asarray(pos), **rope)
    got = Q4.q4_matmul(xp, pt, norm_weight=torch.from_numpy(g), rope_pos=torch.from_numpy(pos),
                       mode="a8", **rope)
    assert_within_ulp(got, want, f"norm + RoPE K {k}")
    rj, rp = _bf16(rng.standard_normal((m, n)))
    want = jq4.q4_matmul(xj, jt, interpret=True, dequant_mode="a8", residual=rj)
    got = Q4.q4_matmul(xp, pt, residual=rp, mode="a8")
    assert_within_ulp(got, want, f"residual K {k}")
    jt, pt = _weights(rng, k, 2 * h, gs)
    assert Q4.q4_a8_engages(m, k, h, gs)
    want = jq4.q4_matmul_silu(xj, jt, interpret=True, dequant_mode="a8",
                              norm_weight=jnp.asarray(g))
    got = Q4.q4_matmul_silu(xp, pt, norm_weight=torch.from_numpy(g), mode="a8")
    assert got.shape == (m, h)
    assert_within_ulp(got, want, f"gate K {k}")

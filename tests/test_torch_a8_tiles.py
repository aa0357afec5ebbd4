"""The row rule of the `a8` products and what each of its kernels takes, on
the CPU.

`ops/quant.py::a8_rows_kernel` decides which kernel an `a8` product
(HIPLLAMA_Q8_MODE=a8: q8_matmul (K15), q8_matmul_silu (K17) and, through
them, q8_matmul_layered (K20); HIPLLAMA_Q4_MODE=a8: q4_matmul, q4_matmul_silu)
launches: the dp4a GEMV up to GEMV_MAX_M rows; above, csrc/a8_wgmma.cuh's
int8 wgmma tiles where the group size is a multiple of 32 (an int4 weight
one nibble plane a CTA), else a8.cuh's mma.sync tiles (group sizes 8-24,
40, 48, ...). `a8_kernel_takes` says which K, N and group sizes each
accepts, as its C launcher decides (the int4 products' cases are in
tests/test_torch_q4_tiles.py). Here the rule runs over every Q8 product shape of
the models the port serves: the golden fixture (dim 64, hidden 192, 8 heads
over 4 KV heads), llama2.c's stories15M (dim 288, 6 heads of 48 over 2 KV
heads, hidden 768: K 288, which 128-deep steps leave 32 short, at group
sizes 32 and 16) and Llama-2-7B (group size 64); then the CUDA wrappers on
the small shapes, their launches recorded instead of made (tests/
test_torch_attention.py's `launches` fixture): the kernel's split argument,
the wgmma tiles' RoPE table and the `a8` wgmma count agree with the rule,
and a shape no kernel takes raises before any launch. The plain `a8`
products, which the kernels are held to on the card (tests/
test_torch_cuda.py), are held to the JAX package's kernels in interpret mode
at the wgmma tiles' K tails (K 64 at groups of 64: half a step; K 96 and 288
at groups of 32: three units and one unit past a step), within one bf16 ulp
at the output's largest magnitude (the tolerance of tests/
test_torch_a8.py: the same cast points, the fp32 sum over the groups in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hip_llama_tpu.ops import quant as jq
from hip_llama_tpu_torch.ops import quant as Q
from test_torch_a8 import assert_within_ulp
from test_torch_attention import _on_card, launches  # noqa: F401 (a fixture)

torch.set_num_threads(1)

# name: (dim, hidden, heads, KV heads, vocab, Q8 group sizes)
MODELS = {
    "golden": (64, 192, 8, 4, 512, (64,)),
    "stories15M": (288, 768, 6, 2, 32000, (32, 16)),
    "7b": (4096, 11008, 32, 32, 32000, (64,)),
}
# rows of a product: 1-8 slots times chunks of T 16, 64 and 256, the bench's
# 8 x 511, the GEMV rows below them and the tiles' edges around 256
ROWS = (1, 8, 16, 17, 32, 64, 128, 255, 256, 257, 512, 1024, 2048, 4088)


def products(model: str) -> dict[str, tuple[int, int, bool]]:
    """Each Q8 product of a layer and the classifier: (K, N, gate), N the
    weight's columns (2H for the W1|W3 gate)."""
    dim, hidden, heads, kvh, vocab, _ = MODELS[model]
    kv_dim = dim * kvh // heads
    return {"qkv": (dim, dim + 2 * kv_dim, False), "wo": (dim, dim, False),
            "w13": (dim, 2 * hidden, True), "w2": (hidden, dim, False),
            "classifier": (dim, vocab, False)}


CASES = [(model, prod, gs) for model in MODELS for prod in products(model)
         for gs in MODELS[model][5]]


@pytest.mark.parametrize("model,prod,gs", CASES)
def test_the_a8_rule_picks_a_kernel_that_takes_the_shape(model, prod, gs):
    k, n, gate = products(model)[prod]
    for m in ROWS:
        kernel = Q.a8_rows_kernel(m, gs)
        want = (("gemv_tc" if gs % 32 == 0 else "gemv") if m <= Q.GEMV_MAX_M
                else "wgmma" if gs % 32 == 0 else "mma")
        assert kernel == want, (m, gs)
        assert Q.a8_kernel_takes(kernel, k, n, gs, gate), (model, prod, m, kernel)
    # an int4 weight of the same contraction (K/2 = k) takes the same rule
    assert Q.a8_kernel_takes(Q.a8_rows_kernel(40, gs), 2 * k, n, gs, gate, int4=True)


# (K, N, gs, gate) that a kernel's launcher refuses: K no multiple of 16,
# N no multiple of 16, a group size no multiple of 8 or not dividing K, a
# gate's H no multiple of 16 (N 400: H 200); the wgmma tiles also refuse
# groups that are no multiple of 32, the GEMVs a group past their slice of
# xi rows, the tensor-core GEMV groups that are no multiple of 32
REFUSED = {
    "gemv": [(40, 128, 8, False), (64, 200, 32, False), (48, 128, 12, False),
             (96, 128, 64, False), (64, 400, 32, True), (0, 128, 32, False),
             (2048, 128, 2048, False)],
    "gemv_tc": [(40, 128, 8, False), (64, 200, 32, False), (48, 128, 12, False),
                (96, 128, 64, False), (64, 400, 32, True), (0, 128, 32, False),
                (2048, 128, 2048, False), (96, 128, 48, False), (288, 480, 16, False),
                (64, 128, 8, False)],
    "mma": [(40, 128, 8, False), (64, 200, 32, False), (48, 128, 12, False),
            (96, 128, 64, False), (64, 400, 32, True), (0, 128, 32, False)],
    "wgmma": [(40, 128, 8, False), (64, 200, 32, False), (48, 128, 12, False),
              (96, 128, 64, False), (64, 400, 32, True), (0, 128, 32, False),
              (96, 128, 48, False), (288, 480, 16, False), (64, 128, 8, False)],
}


@pytest.mark.parametrize("kernel,k,n,gs,gate",
                         [(kern, *c) for kern, cases in REFUSED.items() for c in cases])
def test_a8_kernels_refuse_what_their_launchers_refuse(kernel, k, n, gs, gate):
    assert not Q.a8_kernel_takes(kernel, k, n, gs, gate)
    assert Q.a8_kernel_takes(kernel, 288, 480, 32)
    assert Q.a8_kernel_takes(kernel, 64, 128, 64, gate=True)
    # gs 48 (no multiple of 32) only on the mma.sync tiles among the tiles
    # and on the dp4a GEMV; an int4 weight at gs 32 on every kernel (K/2 64:
    # two 32-deep products a plane), at gs 16 not on the wgmma tiles or the
    # tensor-core GEMV, at gs 32 over K/2 48 on none
    by32 = kernel in ("wgmma", "gemv_tc")
    assert Q.a8_kernel_takes(kernel, 96, 128, 48) == (not by32)
    assert Q.a8_kernel_takes(kernel, 128, 128, 32, int4=True)
    assert Q.a8_kernel_takes(kernel, 128, 128, 16, int4=True) == (not by32)
    assert not Q.a8_kernel_takes(kernel, 96, 128, 32, int4=True)
    with pytest.raises(ValueError):
        Q.a8_kernel_takes("wmma", 64, 128, 32)  # the rule has no other kernel


def _args(fn: str, args: tuple) -> tuple[int, int]:
    """(split, part_ws) of a recorded q8_matmul_a8 / q8_matmul_silu_a8
    launch: the split (0: the tiles) after the pointers and M, K, N (or H),
    gs; part_ws the last pointer before the ints."""
    ptrs = 10 if fn == "q8_matmul_a8" else 8
    return args[ptrs + 4], args[ptrs - 1]


@pytest.mark.parametrize("m", [8, 16, 17, 128, 300])
@pytest.mark.parametrize("model,prod,gs", [c for c in CASES if c[0] != "7b"
                                           and c[1] != "classifier"])
def test_cuda_wrappers_launch_the_a8_kernel_of_the_rule(launches, model, prod, gs, m):
    k, n, gate = products(model)[prod]
    qt = Q.QTensor(_on_card(torch.zeros(k, n, dtype=torch.int8)),
                   _on_card(torch.ones(k // gs, n)))
    x = _on_card(torch.zeros(m, k, dtype=torch.bfloat16))
    g = _on_card(torch.ones(k))
    wrapper = Q.q8_matmul_silu if gate else Q.q8_matmul
    assert Q.q8_a8_engages(m, k, n // 2 if gate else n, gs)
    before = (wrapper.launches, wrapper.launches_a8, wrapper.launches_a8_wgmma,
              wrapper.launches_a8_tc)
    rope = prod == "qkv"
    if gate:
        Q.q8_matmul_silu(x, qt, norm_weight=g, mode="a8")
    elif rope:  # q and k rotate, v passes
        hs = k // MODELS[model][2]
        Q.q8_matmul(x, qt, norm_weight=g, rope_pos=_on_card(torch.zeros(m, dtype=torch.int32)),
                    rope_limit=n - (n - k) // 2, rope_head=hs, mode="a8")
    else:
        Q.q8_matmul(x, qt, residual=_on_card(torch.zeros(m, n, dtype=torch.bfloat16)),
                    mode="a8")
    (fn, args), = launches
    assert fn == wrapper.__name__ + "_a8"
    kernel = Q.a8_rows_kernel(m, gs)
    split, part = _args(fn, args)
    gemv = kernel in ("gemv", "gemv_tc")
    assert (split > 0) == gemv
    # the GEMV's partials, or the wgmma tiles' RoPE table: part_ws
    assert (part != 0) == (gemv or (kernel == "wgmma" and rope))
    assert (wrapper.launches - before[0], wrapper.launches_a8 - before[1],
            wrapper.launches_a8_wgmma - before[2], wrapper.launches_a8_tc - before[3]) == (
        0, 1, int(kernel == "wgmma"), int(kernel == "gemv_tc"))


@pytest.mark.parametrize("m", [8, 40])
def test_cuda_wrappers_refuse_before_launching(launches, m):
    """A shape no `a8` kernel takes raises ValueError and launches nothing
    (no fallback to another kernel or to the plain version), on either side
    of the row rule: groups of 12 (no multiple of 8), a gate of H 200, and
    one group of 2048 (past the GEMVs' slice of xi rows; the wgmma tiles
    take it at 40 rows)."""
    x = _on_card(torch.zeros(m, 48, dtype=torch.bfloat16))
    qt = Q.QTensor(_on_card(torch.zeros(48, 128, dtype=torch.int8)),
                   _on_card(torch.ones(4, 128)))
    assert Q.q8_a8_engages(m, 48, 128, 12)
    with pytest.raises(ValueError):
        Q.q8_matmul(x, qt, mode="a8")
    x = _on_card(torch.zeros(m, 64, dtype=torch.bfloat16))
    qt = Q.QTensor(_on_card(torch.zeros(64, 400, dtype=torch.int8)),
                   _on_card(torch.ones(1, 400)))
    with pytest.raises(ValueError):
        Q.q8_matmul_silu(x, qt, mode="a8")
    assert launches == []
    x = _on_card(torch.zeros(m, 2048, dtype=torch.bfloat16))
    qt = Q.QTensor(_on_card(torch.zeros(2048, 128, dtype=torch.int8)),
                   _on_card(torch.ones(1, 128)))
    assert Q.q8_a8_engages(m, 2048, 128, 2048)
    if Q.a8_rows_kernel(m, 2048) in ("gemv", "gemv_tc"):
        with pytest.raises(ValueError):
            Q.q8_matmul(x, qt, mode="a8")
        assert launches == []
    else:
        Q.q8_matmul(x, qt, mode="a8")
        assert [fn for fn, _ in launches] == ["q8_matmul_a8"]


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _weights(rng, k, n, gs):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return jq.q8_quantize_weights(jnp.asarray(w), gs), Q.q8_quantize_weights(torch.from_numpy(w), gs)


@pytest.mark.parametrize("k,gs", [(64, 64), (96, 32), (288, 32)])
def test_plain_a8_products_match_jax_at_the_tiles_k_tails(k, gs):
    """QKV with the norm and RoPE (q|k rotating in heads of 64, v passing),
    an output with the residual, and the W1|W3 gate with the norm: the
    plain `a8` versions against the JAX kernels in interpret mode with
    dequant_mode="a8", at 40 rows (the wgmma tiles on the card)."""
    m, n, h = 40, 384, 256
    rng = np.random.default_rng(k + gs)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    pos = rng.integers(0, 2048, m).astype(np.int32)
    jt, pt = _weights(rng, k, n, gs)
    assert Q.a8_rows_kernel(m, gs) == "wgmma" and Q.q8_a8_engages(m, k, n, gs)
    rope = dict(rope_limit=256, rope_head=64, rope_theta=10000.0)
    want = jq.q8_matmul(xj, jt, interpret=True, dequant_mode="a8", norm_weight=jnp.asarray(g),
                        rope_pos=jnp.asarray(pos), **rope)
    got = Q.q8_matmul(xp, pt, norm_weight=torch.from_numpy(g), rope_pos=torch.from_numpy(pos),
                      mode="a8", **rope)
    assert_within_ulp(got, want, f"norm + RoPE K {k}")
    rj, rp = _bf16(rng.standard_normal((m, n)))
    want = jq.q8_matmul(xj, jt, interpret=True, dequant_mode="a8", residual=rj)
    got = Q.q8_matmul(xp, pt, residual=rp, mode="a8")
    assert_within_ulp(got, want, f"residual K {k}")
    jt, pt = _weights(rng, k, 2 * h, gs)
    assert Q.q8_a8_engages(m, k, h, gs)
    want = jq.q8_matmul_silu(xj, jt, interpret=True, dequant_mode="a8",
                             norm_weight=jnp.asarray(g))
    got = Q.q8_matmul_silu(xp, pt, norm_weight=torch.from_numpy(g), mode="a8")
    assert got.shape == (m, h)
    assert_within_ulp(got, want, f"gate K {k}")

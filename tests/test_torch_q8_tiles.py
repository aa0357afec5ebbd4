"""The one row rule of the Q8 products and what each of its kernels takes,
on the CPU.

`ops/quant.py::q8_rows_kernel` decides, by row count alone, which kernel
q8_matmul (K15), q8_matmul_silu (K17) and, through them, q8_matmul_layered
(K20) launch in reshape math: the split-K GEMV up to GEMV_MAX_M rows, the
tiles on csrc/q8_wgmma.cuh's pipelined mainloop above. `q8_kernel_takes`
says which K, N and group sizes each accepts, as its C launcher decides.
Here both run over every prefill product shape of the models the port
serves: the golden fixture (dim 64, hidden 192, 8 heads over 4 KV heads),
llama2.c's stories15M (dim 288, 6 heads of 48 over 2 KV heads, hidden 768:
a K that 64-deep steps do not divide, N 480 and 288 that 128-column tiles
do not) and Llama-2-7B; then the CUDA wrappers on the small shapes, their
launches recorded instead of made (tests/test_torch_attention.py's
`launches` fixture): the kernel's split argument and the wgmma count agree
with the rule. The plain versions, which the kernels are held to on the
card (tests/test_torch_cuda.py), are held to the JAX package's kernels in
interpret mode at stories15M's K 288.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.ops import quant as jq
from hip_llama_tpu_torch.ops import quant as Q
from test_torch_attention import _on_card, launches  # noqa: F401 (a fixture)

torch.set_num_threads(1)

# name: (dim, hidden, heads, KV heads, vocab, Q8 group sizes)
MODELS = {
    "golden": (64, 192, 8, 4, 512, (64,)),
    "stories15M": (288, 768, 6, 2, 32000, (32, 16)),
    "7b": (4096, 11008, 32, 32, 32000, (64,)),
}
# rows of a prefill product: 1-8 slots times chunks of T 16, 64 and 256, the
# bench's 8 x 511, and the GEMV rows below them
ROWS = (1, 8, 16, 17, 32, 64, 128, 256, 512, 1024, 2048, 4088)


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
def test_the_row_rule_picks_a_kernel_that_takes_the_shape(model, prod, gs):
    k, n, gate = products(model)[prod]
    for m in ROWS:
        kernel = Q.q8_rows_kernel(m)
        assert kernel == ("gemv" if m <= Q.GEMV_MAX_M else "wgmma"), m
        assert Q.q8_kernel_takes(kernel, k, n, gs, gate), (model, prod, m, kernel)


@pytest.mark.parametrize("kernel", ["gemv", "wgmma"])
@pytest.mark.parametrize("k,n,gs,gate", [(40, 128, 8, False), (64, 200, 64, False),
                                         (64, 128, 48, False), (64, 400, 64, True),
                                         (0, 128, 64, False)])
def test_kernels_refuse_what_their_launchers_refuse(kernel, k, n, gs, gate):
    """K or N no multiple of 16, a group size that does not divide K, a
    gate's H no multiple of 16 (N 400: H 200): the C launchers return
    cudaErrorInvalidValue there, so the rule's check refuses them first."""
    assert not Q.q8_kernel_takes(kernel, k, n, gs, gate)
    assert Q.q8_kernel_takes(kernel, 64, 128, 64)
    with pytest.raises(ValueError):
        Q.q8_kernel_takes("wmma", 64, 128, 64)  # the rule has no other kernel


def _split_arg(fn: str, args: tuple) -> int:
    """The split argument of a recorded q8_matmul / q8_matmul_silu launch
    (0: the tiles), after the pointers and M, K, N (or H), gs."""
    return args[(9 if fn == "q8_matmul" else 7) + 4]


@pytest.mark.parametrize("m", [8, 16, 17, 128, 300])
@pytest.mark.parametrize("model,prod,gs", [c for c in CASES if c[0] != "7b"
                                           and c[1] != "classifier"])
def test_cuda_wrappers_launch_the_kernel_of_the_rule(launches, model, prod, gs, m):
    k, n, gate = products(model)[prod]
    qt = Q.QTensor(_on_card(torch.zeros(k, n, dtype=torch.int8)),
                   _on_card(torch.ones(k // gs, n)))
    x = _on_card(torch.zeros(m, k, dtype=torch.bfloat16))
    g = _on_card(torch.ones(k))
    wrapper = Q.q8_matmul_silu if gate else Q.q8_matmul
    before = (wrapper.launches, wrapper.launches_wgmma)
    if gate:
        Q.q8_matmul_silu(x, qt, norm_weight=g)
    elif prod == "qkv":  # q and k rotate, v passes
        hs = k // MODELS[model][2]
        Q.q8_matmul(x, qt, norm_weight=g, rope_pos=_on_card(torch.zeros(m, dtype=torch.int32)),
                    rope_limit=n - (n - k) // 2, rope_head=hs)
    else:
        Q.q8_matmul(x, qt, residual=_on_card(torch.zeros(m, n, dtype=torch.bfloat16)))
    (fn, args), = launches
    assert fn == wrapper.__name__
    wgmma = Q.q8_rows_kernel(m) == "wgmma"
    assert (_split_arg(fn, args) == 0) == wgmma
    assert (wrapper.launches - before[0], wrapper.launches_wgmma - before[1]) == (1, int(wgmma))


def test_cuda_wrappers_refuse_before_launching(launches):
    """A shape the rule's kernel does not take raises ValueError and
    launches nothing (no fallback to another kernel or to the plain
    version): K 40, and a gate of H 200."""
    x = _on_card(torch.zeros(32, 40, dtype=torch.bfloat16))
    qt = Q.QTensor(_on_card(torch.zeros(40, 128, dtype=torch.int8)),
                   _on_card(torch.ones(5, 128)))
    with pytest.raises(ValueError):
        Q.q8_matmul(x, qt)
    x = _on_card(torch.zeros(32, 64, dtype=torch.bfloat16))
    qt = Q.QTensor(_on_card(torch.zeros(64, 400, dtype=torch.int8)),
                   _on_card(torch.ones(1, 400)))
    with pytest.raises(ValueError):
        Q.q8_matmul_silu(x, qt)
    assert launches == []


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("gs", [16, 32])
def test_plain_products_match_jax_at_stories15m_k(gs):
    """K 288 (a 64-deep step short of 320: the tiles' zero-filled tail),
    QKV N 480 with the norm and RoPE over 6 + 2 heads of 48, and the W1|W3
    gate at H 768: the plain versions against the JAX kernels in interpret
    mode, at 40 rows (tiles on the card)."""
    m, dim, hidden, hs = 40, 288, 768, 48
    rng = np.random.default_rng(gs)
    xj, xp = _bf16(rng.standard_normal((m, dim)))
    g = (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
    pos = rng.integers(0, 256, m).astype(np.int32)
    w = (rng.standard_normal((dim, 480)) / np.sqrt(dim)).astype(np.float32)
    jt, pt = jq.q8_quantize_weights(jnp.asarray(w), gs), Q.q8_quantize_weights(
        torch.from_numpy(w), gs)
    rope = dict(rope_limit=384, rope_head=hs, rope_theta=10000.0)
    want = jq.q8_matmul(xj, jt, interpret=True, norm_weight=jnp.asarray(g),
                        rope_pos=jnp.asarray(pos), **rope)
    got = Q.q8_matmul(xp, pt, norm_weight=torch.from_numpy(g), rope_pos=torch.from_numpy(pos),
                      **rope)
    assert_close(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)
    w13 = (rng.standard_normal((dim, 2 * hidden)) / np.sqrt(dim)).astype(np.float32)
    jt, pt = jq.q8_quantize_weights(jnp.asarray(w13), gs), Q.q8_quantize_weights(
        torch.from_numpy(w13), gs)
    want = jq.q8_matmul_silu(xj, jt, interpret=True, norm_weight=jnp.asarray(g))
    got = Q.q8_matmul_silu(xp, pt, norm_weight=torch.from_numpy(g))
    assert_close(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)

"""The port's int4 host functions and plain matmuls (hip_llama_tpu_torch/
ops/quant4.py, io/checkpoint.py, models/params.py) against the JAX
package's: quantization bit for bit against the eager JAX call (the JAX
package's quantize_params_q4 calls it eagerly, so its `absmax / 7.0` is a
true division; under jit XLA would turn it into a product with 1/7) and the
numpy checkpoint quantizer; write_v4 byte for byte; read_v4 and the dequant
loaders array for array; the plain q4_matmul (K21) against q4_matmul in
interpret mode for each epilogue, at K/2 = 96 and over several K blocks;
the plain q4_matmul_silu (K22) against its kernel (block_n 64, so that it
runs at the fixture's hidden width 192 instead of declining), with and
without the norm.

Tolerance: bf16 outputs at atol = rtol = 2e-2 (tests/test_attention_pallas.py:
83-85): both sides have the same cast points and differ in the fp32
summation order, which can move an output by one bf16 ulp (2^-8 to 2^-7 of
an O(1) value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.config import tiny_config
from hip_llama_tpu.io import checkpoint as jck
from hip_llama_tpu.models import params as jparams
from hip_llama_tpu.ops import quant4 as jq4
from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.io import checkpoint as pck
from hip_llama_tpu_torch.models import params as pparams
from hip_llama_tpu_torch.ops import quant4 as Q4

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

TOL = dict(atol=2e-2, rtol=2e-2)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _weights(rng, k, n, gs):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return (jq4.q4_quantize_weights(jnp.asarray(w), gs),
            Q4.q4_quantize_weights(torch.from_numpy(w), gs))


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("gs,shape", [(32, (128, 96)), (16, (3, 64, 40)), (32, (192, 512))])
def test_quantize_bit_exact_vs_eager_jax_and_numpy(gs, shape):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., :gs, 0] = 0.0  # an all-zero group takes scale 1
    jt = jq4.q4_quantize_weights(jnp.asarray(w), gs)  # eager, as quantize_params_q4 calls it
    pt = Q4.q4_quantize_weights(torch.from_numpy(w), gs)
    nq, ns, _ = pck.quantize_q40(w, gs)
    assert pt.q.dtype == torch.int8 and pt.s.dtype == torch.float32
    assert pt.group_size == gs and pt.k_dim == shape[-2]
    for q, s in ((np.asarray(jt.q), np.asarray(jt.s)), (nq, ns)):
        np.testing.assert_array_equal(pt.q.numpy(), q)
        np.testing.assert_array_equal(pt.s.numpy(), s)
    np.testing.assert_array_equal(Q4.q4_unpack(pt).numpy(), np.asarray(jq4.q4_unpack(jt)))
    np.testing.assert_array_equal(Q4.q4_dequantize(pt).numpy(), np.asarray(jq4.q4_dequantize(jt)))
    # the port's numpy quantizer is the JAX package's
    jq, js, jerr = jck.quantize_q40(w, gs)
    np.testing.assert_array_equal(nq, jq)
    np.testing.assert_array_equal(ns, js)


def test_group_size_rule_matches_jax():
    for k, gs in [(64, 32), (192, 32), (172, 32), (11008, 32), (96, 32), (4096, 64)]:
        assert pck.q4_group_size(k, gs) == jck.q4_group_size(k, gs)


@pytest.fixture(scope="module")
def v4_files(tmp_path_factory):
    """A v4 file of the same tiny weights from each writer; hidden 172 makes
    W2's K/2 = 86 shrink its group to 2."""
    cfg_j = tiny_config(n_layers=2, shared_classifier=False)
    w = jck.random_weights(cfg_j, seed=4)
    d = tmp_path_factory.mktemp("v4")
    jpath, ppath = str(d / "jax.bin"), str(d / "port.bin")
    jerr = jck.write_v4(jpath, cfg_j, w)
    perr = pck.write_v4(ppath, ModelConfig(**vars(cfg_j)), pck.LlamaWeights(**vars(w)))
    assert jerr == perr
    return cfg_j, jpath, ppath


def test_write_v4_byte_identical_to_jax(v4_files):
    _, jpath, ppath = v4_files
    with open(jpath, "rb") as f, open(ppath, "rb") as g:
        assert f.read() == g.read()


def test_read_v4_matches_jax_reader(v4_files):
    cfg_j, jpath, _ = v4_files
    jcfg, jw = jck.read_v4(jpath)
    pcfg, pw = pck.load_checkpoint(jpath)
    assert isinstance(pw, pck.Q4Weights)
    assert vars(pcfg) == vars(jcfg) and pcfg.group_size == 32
    for name in ("rms_att", "rms_ffn", "rms_final", "emb_q", "emb_s"):
        np.testing.assert_array_equal(getattr(pw, name), getattr(jw, name))
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wcls"):
        for part in ("q", "s"):
            a, b = getattr(getattr(pw, name), part), getattr(getattr(jw, name), part)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b)


def test_q4_dequant_loaders_match_jax(v4_files, tmp_path):
    """--dequant of a v4 and of a v2 file: the dense params are the JAX
    package's, value for value (fp32)."""
    cfg_j, jpath, _ = v4_files
    _, jw = jck.read_v4(jpath)
    cfg, pw = pck.load_checkpoint(jpath)
    want = jparams.params_from_q4_dequant(cfg_j, jw)
    got = pparams.params_from_q4_dequant(cfg, pw, device="cpu")
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    v2 = str(tmp_path / "v2.bin")
    jck.write_v2(v2, cfg_j, jck.random_weights(cfg_j, seed=4))
    want = jparams.params_from_quant_dequant(*jck.read_v2(v2))
    got = pparams.params_from_quant_dequant(*pck.load_checkpoint(v2), device="cpu")
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


# (M, K, N, epilogue): every epilogue, decode and prefill rows, the
# fixture's QKV (K 64, head size 8) and K/2 = 96
CASES = [
    (8, 192, 128, "none"), (1, 256, 256, "norm"), (8, 256, 384, "residual"),
    (40, 192, 384, "residual"), (4, 64, 128, "norm_rope_hs8"), (40, 256, 384, "norm_rope_hs32"),
]


@pytest.mark.parametrize("m,k,n,epi", CASES)
def test_plain_q4_matmul_matches_jax(m, k, n, epi):
    rng = np.random.default_rng(m * 100 + k)
    jt, pt = _weights(rng, k, n, 32)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    jkw, pkw = {}, {}
    if "norm" in epi:
        g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
        jkw["norm_weight"], pkw["norm_weight"] = jnp.asarray(g), torch.from_numpy(g)
    if epi == "residual":
        jkw["residual"], pkw["residual"] = _bf16(rng.standard_normal((m, n)))
    if "rope" in epi:
        hs = int(epi.split("hs")[1])
        pos = rng.integers(0, 2048, m).astype(np.int32)
        pos[0] = 0
        # q|k rotate, v (the last third) passes through
        rope = dict(rope_limit=(2 * n // 3) // hs * hs, rope_head=hs, rope_theta=10000.0)
        jkw.update(rope_pos=jnp.asarray(pos), **rope)
        pkw.update(rope_pos=torch.from_numpy(pos), **rope)
    want = jq4.q4_matmul(xj, jt, interpret=True, **jkw)
    got = Q4.q4_matmul(xp, pt, **pkw)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert_close(_np(got), _np(want), **TOL, msg=f"{epi} M {m} K {k}")


def test_plain_q4_matmul_matches_jax_over_k_blocks():
    """More than 2 MiB of x makes the JAX kernel walk K in blocks of
    block_k / 2 packed rows, with the norm taken before it
    (quant4.py:340-347, :382-384)."""
    m, k, n = 1100, 1024, 128
    rng = np.random.default_rng(7)
    jt, pt = _weights(rng, k, n, 32)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    assert m * k * 2 > 2 * 2**20
    want = jq4.q4_matmul(xj, jt, block_k=256, interpret=True, norm_weight=jnp.asarray(g))
    got = Q4.q4_matmul(xp, pt, norm_weight=torch.from_numpy(g))
    assert_close(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("m,k,h,norm", [(4, 64, 192, True), (40, 192, 128, False)])
def test_plain_q4_matmul_silu_matches_jax(m, k, h, norm):
    rng = np.random.default_rng(m + k)
    jt, pt = _weights(rng, k, 2 * h, 32)
    xj, xp = _bf16(rng.standard_normal((m, k)))
    jkw, pkw = {}, {}
    if norm:
        g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
        jkw["norm_weight"], pkw["norm_weight"] = jnp.asarray(g), torch.from_numpy(g)
    want = jq4.q4_matmul_silu(xj, jt, block_n=64, interpret=True, **jkw)
    got = Q4.q4_matmul_silu(xp, pt, **pkw)
    assert got.shape == (m, h)
    assert_close(_np(got), _np(want), **TOL)


def test_wrappers_take_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(9)
    _, pt = _weights(rng, 64, 128, 32)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32)).to(torch.bfloat16)
    n0, n1 = Q4.q4_matmul.launches, Q4.q4_matmul_silu.launches
    assert torch.equal(Q4.q4_matmul(x, pt), Q4.q4_matmul_plain(x, pt))
    assert torch.equal(Q4.q4_matmul_silu(x, pt), Q4.q4_matmul_silu_plain(x, pt))
    assert (Q4.q4_matmul.launches, Q4.q4_matmul_silu.launches) == (n0, n1)

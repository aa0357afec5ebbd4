"""The port's whole-layer Q8 decode (hip_llama_tpu_torch/ops/layer_fused.py,
K23) against the JAX package's q8_layer_fused in interpret mode, at shapes
where the JAX kernel engages (head size 128, 8 query and 8 KV heads, hidden
a multiple of 256, a cache of 128 rows), and against the port's own
four-kernel layer.

Tolerance: bf16 outputs at atol = rtol = 2e-2 (tests/test_attention_pallas.py:
83-85): both sides have the same cast points and differ in the fp32
summation order, which can move an output by one bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.ops import quant as jq
from hip_llama_tpu.ops.layer_fused import q8_layer_fused as jax_layer
from hip_llama_tpu_torch.ops import attention as A
from hip_llama_tpu_torch.ops import layer_fused as LF
from hip_llama_tpu_torch.ops import quant as Q

torch.set_num_threads(1)

TOL = dict(atol=2e-2, rtol=2e-2)
H, KVH, HS, HID, S = 8, 8, 128, 256, 128
D = H * HS


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _weights(rng, k, n, gs):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return jq.q8_quantize_weights(jnp.asarray(w), gs), Q.q8_quantize_weights(torch.from_numpy(w), gs)


def _bf16(a: np.ndarray):
    a = a.astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _layer(b, gs, seed):
    """Both packages' operands for one layer of a 2-layer cache."""
    rng = np.random.default_rng(seed)
    ws = [_weights(rng, k, n, gs) for k, n in
          ((D, D + 2 * KVH * HS), (D, D), (D, 2 * HID), (HID, D))]
    g1, g2 = ((1 + 0.1 * rng.standard_normal(D)).astype(np.float32) for _ in range(2))
    x = _bf16(rng.standard_normal((b, D)))
    kc = _bf16(rng.standard_normal((b, 2, KVH, S, HS)))
    vc = _bf16(rng.standard_normal((b, 2, KVH, S, HS)))
    pos = np.r_[0, S - 1, rng.integers(1, S - 1, b - 2)].astype(np.int32)
    jax_ops = ([w[0] for w in ws], jnp.asarray(g1), jnp.asarray(g2), x[0], kc[0], vc[0],
               jnp.asarray(pos))
    port_ops = ([w[1] for w in ws], torch.from_numpy(g1), torch.from_numpy(g2), x[1], kc[1],
                vc[1], torch.from_numpy(pos))
    return jax_ops, port_ops


@pytest.mark.parametrize("b,gs", [(4, 64), (8, 32)])
def test_plain_layer_matches_jax_kernel(b, gs):
    (jw, jg1, jg2, jx, jk, jv, jpos), (pw, pg1, pg2, px, pk, pv, ppos) = _layer(b, gs, b + gs)
    want = jax_layer(jx, *jw, jg1, jg2, jk, jv, jnp.int32(1), jpos, n_heads=H, head_size=HS,
                     hidden=HID, interpret=True)
    assert want is not None, "the JAX kernel declined these shapes"
    got = LF.q8_layer_fused(px, *pw, pg1, pg2, pk, pv, 1, ppos, n_heads=H)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (b, D)
    assert got[1].shape == (b, 2 * KVH, HS)
    assert_close(_np(got[0]), _np(want[0]), **TOL, msg="layer output")
    assert_close(_np(got[1]), _np(want[1]), **TOL, msg="k|v rows")


def test_plain_layer_is_the_four_kernel_layer():
    """K23 is K15 (norm + RoPE), K5, K15 (residual) and K18 in a row."""
    _, (pw, pg1, pg2, px, pk, pv, ppos) = _layer(3, 64, 5)
    wqkv, wo, w13, w2 = pw
    qkv = Q.q8_matmul(px, wqkv, norm_weight=pg1, rope_pos=ppos, rope_limit=(H + KVH) * HS,
                      rope_head=HS).view(3, H + 2 * KVH, HS)
    att = A.attention_decode_fused(qkv, pk, pv, 0, ppos, H)
    x2 = Q.q8_matmul(att.reshape(3, D), wo, residual=px)
    want = Q.q8_matmul_ffn(x2, w13, w2, x2, pg2)
    got, kv = LF.q8_layer_fused(px, *pw, pg1, pg2, pk, pv, 0, ppos, n_heads=H)
    assert torch.equal(got, want) and torch.equal(kv, qkv[:, H:])

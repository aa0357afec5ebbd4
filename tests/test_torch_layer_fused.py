"""The port's whole-layer Q8 decode (hip_llama_tpu_torch/ops/layer_fused.py,
K23) against the JAX package's q8_layer_fused in interpret mode, at shapes
where the JAX kernel engages (head size 128, 8 query and 8 KV heads, hidden
a multiple of 256, a cache of 128 rows; on an int8 cache 256 and 1024
rows), and against the port's own four-kernel layer.

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
from hip_llama_tpu_torch.ops import cache as C
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


# ---------------------------------------------------------------------------
# the int8 cache


def _layer_int8(b, gs, s, seed):
    """Both packages' operands for one layer over a 2-layer int8 cache of s
    rows, quantized from normal draws by the port's quantize_kv_rows."""
    rng = np.random.default_rng(seed)
    ws = [_weights(rng, k, n, gs) for k, n in
          ((D, D + 2 * KVH * HS), (D, D), (D, 2 * HID), (HID, D))]
    g1, g2 = ((1 + 0.1 * rng.standard_normal(D)).astype(np.float32) for _ in range(2))
    x = _bf16(rng.standard_normal((b, D)))
    (kq, ks), (vq, vs) = (C.quantize_kv_rows(torch.from_numpy(
        rng.standard_normal((b, 2, KVH, s, HS)).astype(np.float32))) for _ in range(2))
    pos = np.r_[0, s - 1, rng.integers(1, s - 1, b - 2)].astype(np.int32)
    cache = (kq, vq, ks, vs)
    jax_ops = ([w[0] for w in ws], jnp.asarray(g1), jnp.asarray(g2), x[0],
               *(jnp.asarray(t.numpy()) for t in cache), jnp.asarray(pos))
    port_ops = ([w[1] for w in ws], torch.from_numpy(g1), torch.from_numpy(g2), x[1], *cache,
                torch.from_numpy(pos))
    return jax_ops, port_ops


def _jax_int8(jops, layer, **kw):
    jw, jg1, jg2, jx, jk, jv, jks, jvs, jpos = jops
    return jax_layer(jx, *jw, jg1, jg2, jk, jv, jnp.int32(layer), jpos, jks, jvs, n_heads=H,
                     head_size=HS, hidden=HID, interpret=True, **kw)


def _port_int8(pops, layer, fn=LF.q8_layer_fused):
    pw, pg1, pg2, px, pk, pv, pks, pvs, ppos = pops
    return fn(px, *pw, pg1, pg2, pk, pv, layer, ppos, pks, pvs, n_heads=H)


def test_plain_layer_int8_matches_jax_kernel():
    """S 256: two 128-row blocks, K23's and K5's alike."""
    jops, pops = _layer_int8(4, 64, 256, 31)
    want = _jax_int8(jops, 1)
    assert want is not None, "the JAX kernel declined these shapes"
    got = _port_int8(pops, 1)
    assert_close(_np(got[0]), _np(want[0]), **TOL, msg="layer output")
    assert_close(_np(got[1]), _np(want[1]), **TOL, msg="k|v rows")


def _peaked_cache(pops, s):
    """Rework layer 0 of the int8 cache so that the block decides the
    result: row 0 of each (slot, head) scores about 8 above the others
    (its int8 row is sign(q) * 127), so the others' probabilities, about
    exp(-8), round to 0 when they share row 0's int8 scale (one block of
    1024 rows) and survive in their own 128-row blocks; the V rows share a
    common offset, so the rows lost move the output by about 0.3 of it."""
    pw, pg1, pg2, px, pk, pv, pks, pvs, ppos = pops
    b = px.shape[0]
    ppos.copy_(torch.tensor([s - 1, s - 300], dtype=torch.int32))
    qkv = Q.q8_matmul(px, pw[0], norm_weight=pg1, rope_pos=ppos, rope_limit=(H + KVH) * HS,
                      rope_head=HS).view(b, H + 2 * KVH, HS).float()
    q = qkv[:, :H]  # kv_mul 1: query head g reads KV head g
    pk[:, 0, :, 0] = torch.where(q >= 0, 127, -127).to(torch.int8)
    pks[:, 0, :, 0] = 8 * HS ** 0.5 / (127 * q.abs().sum(-1))
    pks[:, 0, :, 1:] = 1e-3
    pv[:, 0] = (pv[:, 0].float() * 0.2 + 100).round().to(torch.int8)
    return pops


def test_layer_block_is_k23s_own_at_1024_rows():
    """Where the two rules part (S 1024: K23 takes 128 rows, K5 1024), the
    port's K23 follows K23: its plain version matches the JAX kernel, and
    the same layer at K5's block does not (measured on the CPU: about 2 s,
    most of it the JAX kernel in interpret mode)."""
    s = 1024
    assert LF.layer_block(s, H, KVH, HS, True) == 128 and A.decode_block(s, True) == 1024
    jops, pops = _layer_int8(2, 64, s, 32)
    pw, pg1, pg2, px, pk, pv, pks, pvs, ppos = _peaked_cache(pops, s)
    # the JAX operands with the reworked cache and positions
    jops = (*jops[:4], *(jnp.asarray(t.numpy()) for t in (pk, pv, pks, pvs)),
            jnp.asarray(ppos.numpy()))
    want = _jax_int8(jops, 0)
    assert want is not None, "the JAX kernel declined these shapes"
    got = _port_int8(pops, 0)
    assert_close(_np(got[0]), _np(want[0]), **TOL, msg="layer output at K23's block")
    qkv = Q.q8_matmul(px, pw[0], norm_weight=pg1, rope_pos=ppos, rope_limit=(H + KVH) * HS,
                      rope_head=HS).view(2, H + 2 * KVH, HS)
    at_k5 = A.attention_decode_fused_plain(qkv, pk, pv, 0, ppos, H, pks, pvs, block=s)
    x2 = Q.q8_matmul(at_k5.reshape(2, D), pw[1], residual=px)
    wrong = Q.q8_matmul_ffn(x2, pw[2], pw[3], x2, pg2)
    diff = np.abs(_np(wrong) - _np(want[0]))
    assert (diff > TOL["atol"] + TOL["rtol"] * np.abs(_np(want[0]))).mean() > 0.1, (
        "K5's block passes too: the test cannot tell the rules apart")


def test_plain_layer_int8_is_the_four_kernel_layer():
    _, pops = _layer_int8(3, 64, 256, 33)
    pw, pg1, pg2, px, pk, pv, pks, pvs, ppos = pops
    qkv = Q.q8_matmul(px, pw[0], norm_weight=pg1, rope_pos=ppos, rope_limit=(H + KVH) * HS,
                      rope_head=HS).view(3, H + 2 * KVH, HS)
    att = A.attention_decode_fused(qkv, pk, pv, 0, ppos, H, pks, pvs)
    x2 = Q.q8_matmul(att.reshape(3, D), pw[1], residual=px)
    want = Q.q8_matmul_ffn(x2, pw[2], pw[3], x2, pg2)
    got, kv = _port_int8(pops, 0)
    assert torch.equal(got, want) and torch.equal(kv, qkv[:, H:])


def test_grid_barrier_probe_runs_on_the_card_only():
    """The barrier probe has no plain version: it times K23's grid barrier
    on the card and refuses the CPU."""
    with pytest.raises(ValueError, match="card"):
        LF.grid_barrier_probe(4, 264, "cpu")

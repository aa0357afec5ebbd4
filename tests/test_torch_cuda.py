"""The port's four CUDA kernels against their plain PyTorch versions, on the
card. Run there with `pytest -m cuda tests/test_torch_cuda.py`; without a
card each test skips (decided inside the test, never at import).

Tolerances: the writers move bytes and must match exactly. Attention in
fp32 differs from the plain version only in summation order (atol = rtol =
1e-5 is loose enough at these sizes: outputs are O(1) averages); bf16 uses
2e-2, the bound of tests/test_attention_pallas.py:83-85 (one bf16 ulp of an
O(1) output is 2^-8 to 2^-7, and probabilities round to bf16 before PV).
"""

import numpy as np
import pytest
import torch

from hip_llama_tpu_torch.models.llama import KVCache
from hip_llama_tpu_torch.ops import attention as A
from hip_llama_tpu_torch.ops import cache as C

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (B, H, KVH, S, HS): the golden fixture's GQA head shape, a mid size, and
# Llama-2-7B's head shape
SHAPES = [(4, 8, 4, 96, 8), (3, 8, 2, 200, 64), (8, 32, 32, 512, 128)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_decode_kernel(shape, dtype):
    dev = _card()
    b, h, kvh, s, hs = shape
    rng = np.random.default_rng(0)
    n_layers = 2
    q = _rand(rng, (b, h, hs), dtype, dev)
    k = _rand(rng, (b, n_layers, kvh, s, hs), dtype, dev)
    v = _rand(rng, (b, n_layers, kvh, s, hs), dtype, dev)
    kc = _rand(rng, (b, kvh, hs), dtype, dev)
    vc = _rand(rng, (b, kvh, hs), dtype, dev)
    pos = torch.tensor(np.r_[0, s - 1, rng.integers(0, s, b - 2)], dtype=torch.int32, device=dev)
    got = A.attention_decode(q, k, v, 1, pos, kc, vc)
    want = A.attention_decode_plain(q, k, v, 1, pos, kc, vc)
    torch.cuda.synchronize()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_prefill_kernel(shape, dtype):
    dev = _card()
    b, h, kvh, s, hs = shape
    t = 64 if s < 512 else 256
    rng = np.random.default_rng(1)
    q = _rand(rng, (b, t, h, hs), dtype, dev)
    k = _rand(rng, (b, 2, kvh, s, hs), dtype, dev)
    v = _rand(rng, (b, 2, kvh, s, hs), dtype, dev)
    start = np.r_[0, s - t // 2, rng.integers(0, s - t, b - 2)]
    valid = np.r_[t, t // 2, 0, rng.integers(1, t + 1, b - 3)]
    start_t = torch.tensor(start, dtype=torch.int32, device=dev)
    valid_t = torch.tensor(valid, dtype=torch.int32, device=dev)
    got = A.attention_prefill(q, k, v, 0, start_t, valid_t)
    want = A.attention_prefill_plain(q, k, v, 0, start_t, valid_t)
    torch.cuda.synchronize()
    live = torch.arange(t, device=dev)[None, :] < valid_t[:, None]
    _close(got[live], want[live], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kv_writers_kernel(shape, dtype):
    dev = _card()
    b, _, kvh, s, hs = shape
    n_layers, t = 3, 16
    rng = np.random.default_rng(2)
    base = KVCache(_rand(rng, (b, n_layers, kvh, s, hs), dtype, dev),
                   _rand(rng, (b, n_layers, kvh, s, hs), dtype, dev))
    pos = torch.tensor(np.r_[0, s - 1, rng.integers(0, s, b - 2)], dtype=torch.int32, device=dev)
    valid = torch.tensor(np.r_[1, 0, np.ones(b - 2)], dtype=torch.int32, device=dev)
    kr = _rand(rng, (n_layers, b, kvh, hs), dtype, dev)
    vr = _rand(rng, (n_layers, b, kvh, hs), dtype, dev)
    for vl in (None, valid):
        got = C.kv_commit_rows(KVCache(base.k.clone(), base.v.clone()), kr, vr, pos, vl)
        want = C.kv_commit_rows_plain(KVCache(base.k.clone(), base.v.clone()), kr, vr, pos, vl)
        torch.cuda.synchronize()
        assert torch.equal(got.k, want.k) and torch.equal(got.v, want.v)

    start = torch.tensor(np.r_[s - t // 2, 0, rng.integers(0, s - t, b - 2)],
                         dtype=torch.int32, device=dev)
    cvalid = torch.tensor(np.r_[t, 0, rng.integers(1, t + 1, b - 2)], dtype=torch.int32, device=dev)
    ck = _rand(rng, (b, t, kvh, hs), dtype, dev)
    cv = _rand(rng, (b, t, kvh, hs), dtype, dev)
    got = C.kv_write_chunk(KVCache(base.k.clone(), base.v.clone()), ck, cv, 2, start, cvalid)
    want = C.kv_write_chunk_plain(KVCache(base.k.clone(), base.v.clone()), ck, cv, 2, start, cvalid)
    torch.cuda.synchronize()
    assert torch.equal(got.k, want.k) and torch.equal(got.v, want.v)


def test_wrappers_count_launches_and_reject_bad_operands():
    dev = _card()
    b, h, kvh, s, hs = SHAPES[0]
    rng = np.random.default_rng(3)
    k = _rand(rng, (b, 1, kvh, s, hs), torch.float32, dev)
    q = _rand(rng, (b, h, hs), torch.float32, dev)
    cur = _rand(rng, (b, kvh, hs), torch.float32, dev)
    pos = torch.zeros(b, dtype=torch.int32, device=dev)
    n0 = A.attention_decode.launches
    A.attention_decode(q, k, k, 0, pos, cur, cur)
    assert A.attention_decode.launches == n0 + 1
    with pytest.raises(TypeError):
        A.attention_decode(q, k, k, 0, pos.long(), cur, cur)
    with pytest.raises(ValueError):
        A.attention_decode(q[:, :, :4].contiguous(), k, k, 0, pos, cur, cur)
    assert A.attention_decode.launches == n0 + 1

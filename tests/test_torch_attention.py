"""The port's plain attention (hip_llama_tpu_torch/ops/attention.py) against
the JAX package: decode vs attention_decode_pallas (interpret mode) and
attention_decode_xla; prefill vs attention_prefill_pallas (interpret mode)
on its T-major and head-major branches.

Tolerances: fp32 atol = rtol = 1e-5 (the same math in another summation
order). bf16 2e-2, as tests/test_attention_pallas.py:83-85: the XLA oracle
keeps bf16 probabilities in fp32 on the CPU while the kernels round them to
bf16, and one bf16 ulp of an O(1) output is 2^-8 to 2^-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from hip_llama_tpu.models.llama import attention_decode_xla
from hip_llama_tpu.ops.attention import attention_decode_pallas, attention_prefill_pallas
from hip_llama_tpu_torch.ops import attention as A

# tiny shapes: one intra-op thread per test worker beats oversubscribing
# the cores that the parallel test workers share
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(x: np.ndarray, dtype: str):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,kvh,s,hs,pos",
    [
        (3, 4, 4, 32, 16, [0, 9, 32]),  # MHA: pos 0, ragged, full window
        (3, 8, 2, 64, 16, [63, 0, 17]),  # GQA 4x
        (4, 8, 4, 96, 8, [0, 95, 50, 3]),  # the golden fixture's head shape
    ],
)
def test_plain_decode_matches_jax(b, h, kvh, s, hs, pos, dtype):
    rng = np.random.default_rng(0)
    n_layers = 2
    arrs = [rng.standard_normal(sh).astype(np.float32) for sh in (
        (b, h, hs), (b, n_layers, kvh, s, hs), (b, n_layers, kvh, s, hs),
        (b, kvh, hs), (b, kvh, hs))]
    (qj, qt), (kj, kt), (vj, vt), (kcj, kct), (vcj, vct) = (_pair(a, dtype) for a in arrs)
    pos_j = jnp.asarray(pos, jnp.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    tol = DTYPES[dtype][2]
    for layer in range(n_layers):
        got = A.attention_decode(qt, kt, vt, layer, pos_t, kct, vct)
        assert got.dtype == DTYPES[dtype][1] and got.shape == (b, h, hs)
        for want in (
            attention_decode_pallas(qj, kj, vj, jnp.int32(layer), pos_j, kcj, vcj, interpret=True),
            attention_decode_xla(qj, kj, vj, jnp.int32(layer), pos_j, kcj, vcj),
        ):
            assert_close(_np(got), _np(want), atol=tol, rtol=tol, msg=f"layer {layer}")


def test_plain_decode_ignores_rows_past_pos():
    rng = np.random.default_rng(1)
    b, h, kvh, s, hs = 2, 4, 2, 32, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, h, hs), (b, 1, kvh, s, hs), (b, 1, kvh, s, hs)))
    cur = torch.from_numpy(rng.standard_normal((b, kvh, hs)).astype(np.float32))
    pos = torch.tensor([5, 20], dtype=torch.int32)
    want = A.attention_decode(q, k, v, 0, pos, cur, cur)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, :, 20:] = 1e6
    v2[:, :, :, 20:] = -1e6
    assert torch.equal(A.attention_decode(q, k2, v2, 0, pos, cur, cur), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,t,h,kvh,s,hs",
    [
        (3, 16, 8, 4, 64, 128),  # T-major branch (hs % 128 == 0, 8 heads per block)
        (3, 8, 8, 4, 48, 16),  # head-major branch, GQA
        (3, 16, 4, 4, 96, 8),  # head-major, MHA, the fixture's head size
    ],
)
def test_plain_prefill_matches_jax(b, t, h, kvh, s, hs, dtype):
    rng = np.random.default_rng(2)
    n_layers = 2
    arrs = [rng.standard_normal(sh).astype(np.float32) for sh in (
        (b, t, h, hs), (b, n_layers, kvh, s, hs), (b, n_layers, kvh, s, hs))]
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in arrs)
    # a chunk at 0, a bystander (valid 0), and a window clamped at the end
    # of the cache (start + T > S, start + valid == S)
    start = [0, 7, s - t // 2]
    valid = [t, 0, t // 2]
    start_t = torch.tensor(start, dtype=torch.int32)
    valid_t = torch.tensor(valid, dtype=torch.int32)
    tol = DTYPES[dtype][2]
    for layer in range(n_layers):
        got = A.attention_prefill(qt, kt, vt, layer, start_t, valid_t)
        want = attention_prefill_pallas(
            qj, kj, vj, jnp.int32(layer), jnp.asarray(start, jnp.int32),
            jnp.asarray(valid, jnp.int32), interpret=True)
        assert got.shape == (b, t, h, hs)
        for i in range(b):  # rows t < valid only: the rest are unspecified
            assert_close(_np(got)[i, : valid[i]], _np(want)[i, : valid[i]],
                         atol=tol, rtol=tol, msg=f"layer {layer} slot {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,kvh,s,hs,pos",
    [
        (4, 4, 4, 64, 32, [0, 9, 63, 30]),  # MHA: pos 0 and ragged
        (4, 8, 2, 96, 8, [95, 0, 17, 40]),  # GQA 4x at the fixture's head size
        (2, 8, 4, 32, 16, [0, 0]),  # GQA, every slot at pos 0
    ],
)
def test_plain_decode_fused_matches_jax(b, h, kvh, s, hs, pos, dtype):
    """K5: q, k_cur and v_cur read from the head-split QKV rows, against
    attention_decode_fused in interpret mode (an even batch takes its
    batch-folded kernel)."""
    from hip_llama_tpu.ops.attention import attention_decode_fused

    rng = np.random.default_rng(3)
    n_layers = 2
    arrs = [rng.standard_normal(sh).astype(np.float32) for sh in (
        (b, h + 2 * kvh, hs), (b, n_layers, kvh, s, hs), (b, n_layers, kvh, s, hs))]
    (qkvj, qkvt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in arrs)
    pos_j = jnp.asarray(pos, jnp.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    tol = DTYPES[dtype][2]
    for layer in range(n_layers):
        got = A.attention_decode_fused(qkvt, kt, vt, layer, pos_t, h)
        assert got.dtype == DTYPES[dtype][1] and got.shape == (b, h, hs)
        want = attention_decode_fused(qkvj, kj, vj, jnp.int32(layer), pos_j, n_heads=h,
                                      interpret=True)
        assert_close(_np(got), _np(want), atol=tol, rtol=tol, msg=f"layer {layer}")
        sliced = A.attention_decode(qkvt[:, :h], kt, vt, layer, pos_t, qkvt[:, h:h + kvh],
                                    qkvt[:, h + kvh:])
        assert torch.equal(got, sliced)


# ---------------------------------------------------------------------------
# the KV block the CUDA wrappers give their kernels


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so that a wrapper takes
    its CUDA branch, whose launch the test records instead of making."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_OnCard, t)


def c_arity() -> dict[tuple[str, str], int]:
    """The parameter count of each `extern "C"` entry point of csrc/*.cu."""
    import glob
    import os
    import re

    from hip_llama_tpu_torch.ops import _build

    out = {}
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        lib = os.path.basename(path)[:-3]
        src = open(path).read()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            out[(lib, name)] = params.count(",") + 1
    return out


@pytest.fixture
def launches(monkeypatch):
    """Each CUDA launch a wrapper makes, as (function, arguments); the
    binding's signature is held to the C entry point's parameters and the
    call to the signature."""
    from hip_llama_tpu_torch.ops import _build

    made = []
    arity = c_arity()

    def bind(lib, fn, signature):
        assert arity[(lib, fn)] == len(signature), (lib, fn, signature)

        def call(*args):
            assert len(args) == len(signature), (fn, len(args), signature)
            made.append((fn, args))
            return 0
        return call

    def on_card(make):
        def made_on_card(*shape, device=None, **kw):
            if device is not None and torch.device(device).type == "cuda":
                return _on_card(make(*shape, **kw))
            return make(*shape, device=device, **kw)
        return made_on_card

    monkeypatch.setattr(_build, "bind", bind)
    for name in ("empty", "zeros"):
        monkeypatch.setattr(torch, name, on_card(getattr(torch, name)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    from hip_llama_tpu_torch.ops import layer_fused, quant, quant4
    for mod in (A, layer_fused, quant, quant4):
        monkeypatch.setattr(mod, "_stream", lambda: 0)
    return made


@pytest.mark.parametrize("s", [96, 512, 2048])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_wrappers_take_the_jax_block(launches, s, int8):
    """K1, K5 and K4 (and K23) launch at the JAX kernels' KV block, the
    block at whose running max the probabilities round: decode
    _pick_block_k(S, 1024) (on an int8 cache 128 or S where that is no
    multiple of 128, attention.py:1215-1222), prefill _pick_block_k(S, 512)
    (:983), the fused layer 128 or S (layer_fused.py:362-364). None is
    capped at the kernels' 64-row tiles."""
    from hip_llama_tpu.ops.attention import _pick_block_k
    from hip_llama_tpu_torch.ops import layer_fused as LF
    from hip_llama_tpu_torch.ops import quant as Q

    b, h, kvh, hs = 1, 8, 8, 128
    dt = torch.bfloat16
    shape = (b, 1, kvh, s, hs)
    if int8:
        k, v = torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8)
        sc = [_on_card(torch.ones(shape[:4])) for _ in range(2)]
    else:
        k, v, sc = torch.zeros(shape, dtype=dt), torch.zeros(shape, dtype=dt), [None, None]
    k, v = _on_card(k), _on_card(v)
    pos = _on_card(torch.zeros(b, dtype=torch.int32))
    dec = _pick_block_k(s, 1024)
    if int8 and dec % 128 and dec != s:
        dec = 128 if s % 128 == 0 else s
    A.attention_decode(_on_card(torch.zeros(b, h, hs, dtype=dt)), k, v, 0, pos,
                       _on_card(torch.zeros(b, kvh, hs, dtype=dt)),
                       _on_card(torch.zeros(b, kvh, hs, dtype=dt)), *sc)
    A.attention_decode_fused(_on_card(torch.zeros(b, h + 2 * kvh, hs, dtype=dt)), k, v, 0, pos,
                             h, *sc)
    A.attention_prefill(_on_card(torch.zeros(b, 16, h, hs, dtype=dt)), k, v, 0, pos, pos, *sc)
    d, hid = h * hs, 16

    def qt(kk, n, gs):
        return Q.QTensor(_on_card(torch.zeros(kk, n, dtype=torch.int8)),
                         _on_card(torch.ones(kk // gs, n)))

    g = _on_card(torch.ones(d))
    LF.q8_layer_fused(_on_card(torch.zeros(b, d, dtype=dt)), qt(d, (h + 2 * kvh) * hs, 64),
                      qt(d, d, 64), qt(d, 2 * hid, 64), qt(hid, d, 16), g, g, k, v, 0, pos, *sc,
                      n_heads=h)
    blocks = {fn: args[-5 if fn == "q8_layer_fused" else -2] for fn, args in launches}
    suffix = "_int8" if int8 else ""
    assert blocks == {f"attention_decode{suffix}": dec, f"attention_decode_fused{suffix}": dec,
                      f"attention_prefill{suffix}": _pick_block_k(s, 512),
                      "q8_layer_fused": 128 if s % 128 == 0 else s}, blocks


@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_cuda_wrappers_take_the_page(launches, ps, int8):
    """K6 and K7 launch at the page, the JAX paged kernels' KV block (one
    page per grid step, attention.py:1663-1868)."""
    b, h, kvh, hs, n_pages = 1, 8, 8, 128, 5
    dt = torch.bfloat16
    shape = (1, kvh, n_pages, ps, hs)
    if int8:
        k, v = torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8)
        sc = [_on_card(torch.ones(shape[:4])) for _ in range(2)]
    else:
        k, v, sc = torch.zeros(shape, dtype=dt), torch.zeros(shape, dtype=dt), [None, None]
    k, v = _on_card(k), _on_card(v)
    pos = _on_card(torch.zeros(b, dtype=torch.int32))
    table = _on_card(torch.ones(b, 4, dtype=torch.int32))
    A.attention_decode_paged(_on_card(torch.zeros(b, h, hs, dtype=dt)), k, v, table, 0, pos,
                             _on_card(torch.zeros(b, kvh, hs, dtype=dt)),
                             _on_card(torch.zeros(b, kvh, hs, dtype=dt)), *sc)
    A.attention_prefill_paged(_on_card(torch.zeros(b, 16, h, hs, dtype=dt)), k, v, table, 0, pos,
                              pos, *sc)
    assert [args[-2] for _, args in launches] == [ps, ps]


# ---------------------------------------------------------------------------
# the prefill routes: the tensor-core kernel on bf16 and int8 caches, the
# fp32 CUDA-core kernel on fp32


def _kernel_constant(name: str) -> int:
    """The value of `constexpr int <name> = N;` in csrc/attention.cu."""
    import os
    import re

    from hip_llama_tpu_torch.ops import _build

    src = open(os.path.join(_build.CSRC, "attention.cu")).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("hs", [8, 16, 24, 32, 48, 64, 96, 128, 256])
def test_prefill_smem_matches_the_kernel_layouts(hs):
    """prefill_smem_bytes mirrors csrc/attention.cu at the compiled head
    size HS = prefill_head_size(hs): the tensor-core kernel (TcLayout: a
    ring of kTcStages stages of a K and a V tile of kTcTile rows as copied,
    bf16 rows of HS rounded up to 16 in a power of two of 16-byte chunks,
    int8 rows of HS bytes with their fp32 scales, and on int8 the two tiles
    widened to bf16) takes the same bytes at every block, and fits a CTA;
    the fp32 kernel holds the block's scores, so its bytes grow with the
    block (at HS 128 it takes 640 rows and refuses 704)."""
    assert _kernel_constant("kTcStages") == A._TC_STAGES
    assert _kernel_constant("kTcTile") == _kernel_constant("kTcRows") == A._PF_TILE
    tile = _kernel_constant("kTcTile")
    stages = _kernel_constant("kTcStages")
    hsc = A.prefill_head_size(hs)
    assert hsc >= hs and hsc in (8, 16, 32, 48, 64, 96, 128, 256)
    chunks = {8: 2, 16: 2, 32: 4, 48: 8, 64: 8, 96: 16, 128: 16, 256: 32}[hsc]
    wide = tile * chunks * 16
    want = {torch.bfloat16: stages * 2 * wide,
            torch.int8: stages * (2 * tile * hsc + 2 * tile * 4) + 2 * wide}
    for bk in (8, 64, 96, 128, 256, 512, 576, 1024, 4096):
        for dt, need in want.items():
            assert A.prefill_smem_bytes(hs, bk, dt) == need
            A.check_prefill_block(hs, bk, dt)
    if hsc <= 128:
        assert want[torch.bfloat16] <= 64 * 1024  # three CTAs an SM at HS 128
    f32 = [A.prefill_smem_bytes(hs, bk, torch.float32) for bk in (64, 128, 256, 512)]
    assert f32 == sorted(f32) and len(set(f32)) == 4
    for bk in (64, 576, 640, 704, 1024):
        need = 4 * (64 * hsc + 64 * (hsc + 1) + 64 * (-(-bk // 64) * 64 + 1) + 3 * 64)
        assert A.prefill_smem_bytes(hs, bk, torch.float32) == need
        if need > A.SMEM_PER_CTA:
            assert hsc == 256 or hsc == 128 and bk > 640 or bk > 704
            with pytest.raises(ValueError, match="shared memory"):
                A.check_prefill_block(hs, bk, torch.float32)
        else:
            assert hsc < 128 or bk <= 640
            A.check_prefill_block(hs, bk, torch.float32)


@pytest.mark.parametrize("s", [96, 512, 1024])
@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_prefill_wrappers_take_the_route_of_the_cache_dtype(launches, s, cache):
    """K4 and K7 launch the tensor-core entry point on bf16 (attention_prefill,
    attention_prefill_paged) and int8 caches (..._int8), and the fp32
    CUDA-core one on fp32 caches (..._f32), each at the JAX block: K4
    _pick_block_k(S, 512) (attention.py:983), K7 the page."""
    from hip_llama_tpu.ops.attention import _pick_block_k

    b, h, kvh, hs, ps, n_pages = 2, 8, 4, 64, 16, 9
    int8 = cache == "int8"
    dt = torch.float32 if cache == "float32" else torch.bfloat16
    cdt = torch.int8 if int8 else dt

    def planes(shape):
        k, v = (_on_card(torch.zeros(shape, dtype=cdt)) for _ in range(2))
        sc = [_on_card(torch.ones(shape[:4])) for _ in range(2)] if int8 else [None, None]
        return k, v, sc

    k, v, sc = planes((b, 1, kvh, s, hs))
    zeros = _on_card(torch.zeros(b, dtype=torch.int32))
    A.attention_prefill(_on_card(torch.zeros(b, 16, h, hs, dtype=dt)), k, v, 0, zeros, zeros,
                        *sc)
    kp, vp, scp = planes((1, kvh, n_pages, ps, hs))
    A.attention_prefill_paged(_on_card(torch.zeros(b, 16, h, hs, dtype=dt)), kp, vp,
                              _on_card(torch.ones(b, 4, dtype=torch.int32)), 0, zeros, zeros,
                              *scp)
    suffix = {"float32": "_f32", "bfloat16": "", "int8": "_int8"}[cache]
    got = [(fn, args[-2], args[-3]) for fn, args in launches]
    dtype_code = 0 if dt == torch.float32 else 1
    assert got == [(f"attention_prefill{suffix}", _pick_block_k(s, 512), dtype_code),
                   (f"attention_prefill_paged{suffix}", ps, dtype_code)], got


# ---------------------------------------------------------------------------
# every shape the JAX package serves: head sizes that are multiples of 8 up to
# 256, any number of query heads per KV head, `a8` group sizes that are
# multiples of 8, K16's group sizes, K18's rows


def _cache_planes(shape, cache):
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[cache]
    k, v = (_on_card(torch.zeros(shape, dtype=cdt)) for _ in range(2))
    sc = [_on_card(torch.ones(shape[:4])) for _ in range(2)] if cache == "int8" else [None, None]
    return k, v, sc


@pytest.mark.parametrize("hs", [48, 96])
@pytest.mark.parametrize("m", [3, 16])
@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_cuda_wrappers_take_every_head_size_and_gqa(launches, hs, m, cache):
    """K1, K5, K4, K6 and K7 (and K23 on bf16 and int8 caches) launch at head
    sizes 48 and 96 with 3 and 16 query heads per KV head, shapes the JAX
    package serves, passing the head size and the head counts through; the
    decode kernels hold the scores of at most KV_GROUP heads a task."""
    from hip_llama_tpu_torch.ops import layer_fused as LF
    from hip_llama_tpu_torch.ops import quant as Q

    b, kvh, s, ps, n_pages = 2, 2, 96, 16, 9
    h = m * kvh
    dt = torch.float32 if cache == "float32" else torch.bfloat16
    k, v, sc = _cache_planes((b, 1, kvh, s, hs), cache)
    pos = _on_card(torch.zeros(b, dtype=torch.int32))
    cur = [_on_card(torch.zeros(b, kvh, hs, dtype=dt)) for _ in range(2)]
    A.attention_decode(_on_card(torch.zeros(b, h, hs, dtype=dt)), k, v, 0, pos, *cur, *sc)
    A.attention_decode_fused(_on_card(torch.zeros(b, h + 2 * kvh, hs, dtype=dt)), k, v, 0, pos,
                             h, *sc)
    A.attention_prefill(_on_card(torch.zeros(b, 16, h, hs, dtype=dt)), k, v, 0, pos, pos, *sc)
    kp, vp, scp = _cache_planes((1, kvh, n_pages, ps, hs), cache)
    table = _on_card(torch.ones(b, 4, dtype=torch.int32))
    A.attention_decode_paged(_on_card(torch.zeros(b, h, hs, dtype=dt)), kp, vp, table, 0, pos,
                             *cur, *scp)
    A.attention_prefill_paged(_on_card(torch.zeros(b, 16, h, hs, dtype=dt)), kp, vp, table, 0,
                              pos, pos, *scp)
    suffix = {"float32": "", "bfloat16": "", "int8": "_int8"}[cache]
    pf = {"float32": "_f32", "bfloat16": "", "int8": "_int8"}[cache]
    want = [f"attention_decode{suffix}", f"attention_decode_fused{suffix}",
            f"attention_prefill{pf}", f"attention_decode_paged{suffix}",
            f"attention_prefill_paged{pf}"]
    if cache != "float32":
        d, hid = h * hs, 16

        def qt(kk, n):
            return Q.QTensor(_on_card(torch.zeros(kk, n, dtype=torch.int8)),
                             _on_card(torch.ones(kk // 16, n)))

        g = _on_card(torch.ones(d))
        LF.q8_layer_fused(_on_card(torch.zeros(b, d, dtype=dt)), qt(d, (h + 2 * kvh) * hs),
                          qt(d, d), qt(d, 2 * hid), qt(hid, d), g, g, k, v, 0, pos, *sc,
                          n_heads=h)
        want.append("q8_layer_fused")  # one entry point for both caches
    assert [fn for fn, _ in launches] == want
    for fn, args in launches:
        ints = [a for a in args if isinstance(a, int) and not isinstance(a, bool)]
        assert hs in ints and h in ints and kvh in ints, (fn, args)


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("s", [4000, 4099, 6392, 20008, 51208])
def test_int8_decode_wrappers_take_any_block(launches, s, m):
    """On an int8 cache of s rows that no multiple of 128 divides, the JAX
    block is s itself (`decode_block`); K1, K5, K6 (pages of s rows) and
    K23 launch at it with one or 8 query heads per KV head. The int8 task
    walks a block past a CTA's shared memory in chunks (at 8 heads a block
    past about 4000 rows, at one past about 19700), so no wrapper refuses
    one."""
    from hip_llama_tpu_torch.ops import layer_fused as LF
    from hip_llama_tpu_torch.ops import quant as Q

    b, kvh, hs = 1, 1, 128
    h = m * kvh
    dt = torch.bfloat16
    assert A.decode_block(s, True) == s
    assert LF.layer_block(s, h, kvh, hs, True) == s
    k, v, sc = _cache_planes((b, 1, kvh, s, hs), "int8")
    kp, vp, scp = _cache_planes((1, kvh, 2, s, hs), "int8")
    pos = _on_card(torch.zeros(b, dtype=torch.int32))
    cur = [_on_card(torch.zeros(b, kvh, hs, dtype=dt)) for _ in range(2)]
    q = _on_card(torch.zeros(b, h, hs, dtype=dt))
    d, hid = h * hs, 16

    def qt(kk, n):
        return Q.QTensor(_on_card(torch.zeros(kk, n, dtype=torch.int8)),
                         _on_card(torch.ones(kk // 16, n)))

    g = _on_card(torch.ones(d))
    A.attention_decode(q, k, v, 0, pos, *cur, *sc)
    A.attention_decode_fused(_on_card(torch.zeros(b, h + 2 * kvh, hs, dtype=dt)), k, v, 0, pos,
                             h, *sc)
    A.attention_decode_paged(q, kp, vp, _on_card(torch.ones(b, 1, dtype=torch.int32)), 0, pos,
                             *cur, *scp)
    LF.q8_layer_fused(_on_card(torch.zeros(b, d, dtype=dt)), qt(d, (h + 2 * kvh) * hs),
                      qt(d, d), qt(d, 2 * hid), qt(hid, d), g, g, k, v, 0, pos, *sc, n_heads=h)
    assert [(fn, args[-5 if fn == "q8_layer_fused" else -2]) for fn, args in launches] == [
        ("attention_decode_int8", s), ("attention_decode_fused_int8", s),
        ("attention_decode_paged_int8", s), ("q8_layer_fused", s)]


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,m", [(6404, 8), (51204, 1)])
def test_bf16_decode_wrappers_take_any_block(launches, s, m, cache):
    """On an fp32 or bf16 cache of s rows that no power of two from 8
    divides, the JAX block is s itself (`decode_block`); K1, K5, K6 (pages
    of s rows) and, on bf16, K23 launch at it with 8 query heads per KV head
    (Llama-2-70B's grouping) at 6404 rows and one at 51204. The fp32/bf16
    task walks a block past its shared memory in chunks, so no wrapper
    refuses one."""
    from hip_llama_tpu_torch.ops import layer_fused as LF
    from hip_llama_tpu_torch.ops import quant as Q

    b, kvh, hs = 1, 1, 128
    h = m * kvh
    dt = torch.float32 if cache == "float32" else torch.bfloat16
    assert A.decode_block(s) == s
    assert LF.layer_block(s, h, kvh, hs, False) == s
    k, v, sc = _cache_planes((b, 1, kvh, s, hs), cache)
    kp, vp, scp = _cache_planes((1, kvh, 2, s, hs), cache)
    pos = _on_card(torch.zeros(b, dtype=torch.int32))
    cur = [_on_card(torch.zeros(b, kvh, hs, dtype=dt)) for _ in range(2)]
    q = _on_card(torch.zeros(b, h, hs, dtype=dt))
    A.attention_decode(q, k, v, 0, pos, *cur, *sc)
    A.attention_decode_fused(_on_card(torch.zeros(b, h + 2 * kvh, hs, dtype=dt)), k, v, 0, pos,
                             h, *sc)
    A.attention_decode_paged(q, kp, vp, _on_card(torch.ones(b, 1, dtype=torch.int32)), 0, pos,
                             *cur, *scp)
    want = [("attention_decode", s), ("attention_decode_fused", s),
            ("attention_decode_paged", s)]
    if cache == "bfloat16":
        d, hid = h * hs, 16

        def qt(kk, n):
            return Q.QTensor(_on_card(torch.zeros(kk, n, dtype=torch.int8)),
                             _on_card(torch.ones(kk // 16, n)))

        g = _on_card(torch.ones(d))
        LF.q8_layer_fused(_on_card(torch.zeros(b, d, dtype=dt)), qt(d, (h + 2 * kvh) * hs),
                          qt(d, d), qt(d, 2 * hid), qt(hid, d), g, g, k, v, 0, pos, n_heads=h)
        want.append(("q8_layer_fused", s))
    assert [(fn, args[-5 if fn == "q8_layer_fused" else -2]) for fn, args in launches] == want


def test_int8_decode_wrappers_refuse_misaligned_planes(launches):
    """The int8 task copies K and V rows in 16-byte pieces: K1, K5 and K23
    refuse int8 planes that are not 16-byte aligned before launching (as
    their C launchers do)."""
    from hip_llama_tpu_torch.ops import layer_fused as LF
    from hip_llama_tpu_torch.ops import quant as Q

    b, kvh, s, hs, h = 1, 1, 128, 128, 1
    dt = torch.bfloat16
    k, v, sc = _cache_planes((b, 1, kvh, s, hs), "int8")
    k = _on_card(torch.zeros(k.numel() + 1, dtype=torch.int8)[1:].view(k.shape))
    pos = _on_card(torch.zeros(b, dtype=torch.int32))
    cur = [_on_card(torch.zeros(b, kvh, hs, dtype=dt)) for _ in range(2)]
    q = _on_card(torch.zeros(b, h, hs, dtype=dt))
    d, hid = h * hs, 16

    def qt(kk, n):
        return Q.QTensor(_on_card(torch.zeros(kk, n, dtype=torch.int8)),
                         _on_card(torch.ones(kk // 16, n)))

    g = _on_card(torch.ones(d))
    calls = [
        lambda: A.attention_decode(q, k, v, 0, pos, *cur, *sc),
        lambda: A.attention_decode_fused(_on_card(torch.zeros(b, h + 2 * kvh, hs, dtype=dt)), k,
                                         v, 0, pos, h, *sc),
        lambda: LF.q8_layer_fused(_on_card(torch.zeros(b, d, dtype=dt)),
                                  qt(d, (h + 2 * kvh) * hs), qt(d, d), qt(d, 2 * hid), qt(hid, d),
                                  g, g, k, v, 0, pos, *sc, n_heads=h),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="16-byte aligned"):
            call()
    assert launches == []


@pytest.mark.parametrize("gs", [16, 48])
@pytest.mark.parametrize("m", [8, 40])
def test_a8_wrappers_take_group_sizes_that_are_multiples_of_8(launches, gs, m):
    """The `a8` kernels of K15, K17, K20, K21 and K22 take group sizes 16
    (int4 at dim 288) and 48, on their GEMV (8 rows) and tensor-core (40
    rows) paths, where the JAX rules engage `a8` (q8_a8_engages,
    q4_a8_engages, q8_layered_a8_engages)."""
    from hip_llama_tpu_torch.ops import quant as Q
    from hip_llama_tpu_torch.ops import quant4 as Q4

    k, n = 192, 128
    rng = np.random.default_rng(gs + m)
    x = _on_card(torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
                 .to(torch.bfloat16))

    def card(t):
        return type(t)(_on_card(t.q), _on_card(t.s))

    w = torch.from_numpy(rng.standard_normal((k, 2 * n)).astype(np.float32))
    q8, q8_13 = card(Q.q8_quantize_weights(w[:, :n], gs)), card(Q.q8_quantize_weights(w, gs))
    q4, q4_13 = card(Q4.q4_quantize_weights(w[:, :n], gs)), card(Q4.q4_quantize_weights(w, gs))
    stacked = Q.q8_quantize_weights(w[:, :n][None].repeat(2, 1, 1), gs)
    stacked = Q.QTensor(_on_card(stacked.q), _on_card(stacked.s))
    assert q8.group_size == q4.group_size == gs
    assert Q.q8_a8_engages(m, k, n, gs) and Q4.q4_a8_engages(m, k, n, gs)
    Q.q8_matmul(x, q8, mode="a8")
    Q.q8_matmul_silu(x, q8_13, mode="a8")
    Q.q8_matmul_layered(x, stacked, 1, mode="a8")
    Q4.q4_matmul(x, q4, mode="a8")
    Q4.q4_matmul_silu(x, q4_13, mode="a8")
    assert [fn for fn, _ in launches] == ["q8_matmul_a8", "q8_matmul_silu_a8",
                                          "q8_matmul_layered_a8", "q4_matmul_a8",
                                          "q4_matmul_silu_a8"]
    assert all(gs in args for _, args in launches)


def test_xheads_wrapper_takes_group_size_4(launches):
    """K16 takes every group size xheads_engages admits: 4 at head size 128,
    groups shorter than the mainloop's 8-row dequantization share."""
    from hip_llama_tpu_torch.ops import quant as Q

    m, gh, hs, n, gs = 32, 2, 128, 128, 4
    assert Q.xheads_engages(m, gh, hs, gh * hs, n, gs)
    qt = Q.QTensor(_on_card(torch.zeros(gh * hs, n, dtype=torch.int8)),
                   _on_card(torch.ones(gh * hs // gs, n)))
    Q.q8_matmul_xheads(_on_card(torch.zeros(m, gh, hs, dtype=torch.bfloat16)), qt)
    assert [(fn, args[-2]) for fn, args in launches] == [("q8_matmul_xheads", gs)]


@pytest.mark.parametrize("m", [8, 16, 17, 64, 128, 256])
def test_ffn_wrapper_takes_the_tensor_cores_above_16_rows(launches, m):
    """K18 launches its strip kernel up to 16 rows and the tensor-core
    kernel (csrc/ffn.cu) above, with ffn_splits slices of the hidden width
    and workspaces of the sizes the C entry point reads."""
    from hip_llama_tpu_torch.ops import quant as Q

    k, h, gs = 128, 256, 32

    def qt(kk, n):
        return Q.QTensor(_on_card(torch.zeros(kk, n, dtype=torch.int8)),
                         _on_card(torch.ones(kk // gs, n)))

    x = _on_card(torch.zeros(m, k, dtype=torch.bfloat16))
    n0, t0 = Q.q8_matmul_ffn.launches, Q.q8_matmul_ffn.launches_tc
    Q.q8_matmul_ffn(x, qt(k, 2 * h), qt(h, k), x, _on_card(torch.ones(k)))
    [(fn, args)] = launches
    if m <= 16:
        assert fn == "q8_matmul_ffn" and Q.q8_matmul_ffn.launches == n0 + 1
    else:
        assert fn == "q8_matmul_ffn_tc" and Q.q8_matmul_ffn.launches_tc == t0 + 1
        assert args[11:18] == (m, k, h, k, gs, gs, Q.ffn_splits(m, h, k))

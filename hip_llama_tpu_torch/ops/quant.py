"""Q8_0 weight-only matmuls: `q8_matmul` (K15), `q8_matmul_silu` (K17) and
`q8_matmul_ffn` (K18), with the host-side Q8_0 tensor type.

Weights are symmetric int8 with one fp32 scale per `group_size` rows of a
column, in matmul orientation: q (K, N) int8, s (K / gs, N) fp32, as the
JAX package's `QTensor` (hip_llama_tpu/ops/quant.py:52-83). Activations
are bf16 on the kernel path.

Each product is a CUDA kernel (csrc/quant.cu) behind a wrapper that checks
its operands, allocates the output and the workspaces, and counts its
launches in `<wrapper>.launches`. A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain PyTorch version beside it, which is
also the yardstick the kernel is held against on the card.

Cast points, as in the JAX kernels' default `reshape` dequant mode
(quant.py:237-241, :381-395, :148-180, :603-606, :851-886): w = bf16(f32(q)
* s); xn = bf16(x_f32 * rsqrt(mean(x_f32^2) + eps) * g_f32); products bf16 x
bf16 summed in fp32; residual added to the fp32 sum; RoPE on the fp32 sum
with frequency exp(pair * (-2 ln theta / HS)); the gate bf16(h1 *
sigmoid(h1) * h3) on fp32 sums; one cast at the end. These cast points
hold at every width. Where the hidden width is not a multiple of 128 the
JAX package's FFN kernels decline (a TPU tile rule) and its fallback rounds
h1 and h3 to bf16 before the gate, so there the two packages agree to bf16
tolerance rather than to the summation order (ROADMAP.md, section 3).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from hip_llama_tpu_torch.ops import _build
from hip_llama_tpu_torch.ops.cache import _stream, check_operand

GEMV_MAX_M = 16  # rows the GEMV path takes; more go to the tiled tensor-core path
_GEMV_BN = 256  # columns per GEMV CTA (csrc/quant.cu kGvBN)
_GEMV_KSLICE_MAX = 1024  # contraction rows per GEMV CTA at most (kGvKMax)
_GEMV_CTAS = 264  # GEMV CTAs aimed for: two per SM of an H100
# q8_matmul_ffn takes its one-call kernel by row count (quant.py:934)
FFN_MAX_M = 256
FFN_MAX_X_BYTES = 2 * 2**20
FFN_STRIP = 64  # hidden columns per CTA of q8_matmul_ffn (csrc/q8.cuh kFfBH)


@dataclasses.dataclass
class QTensor:
    """Quantized weight in matmul orientation: q (K, N) int8, s (K // gs, N) f32."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def group_size(self) -> int:
        return self.q.shape[-2] // self.s.shape[-2]


def true_div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d, divided on every device: PyTorch's CUDA kernel turns a
    division by a Python number into a product with its reciprocal, which
    differs in the last bit now and then; the JAX package's quantizers
    divide (they run eagerly), and so does a division by a tensor."""
    return a / torch.tensor(d, dtype=a.dtype, device=a.device)


def q8_quantize_weights(w: torch.Tensor, group_size: int = 64) -> QTensor:
    """Quantize a (K, N) [or (L, K, N)] weight along K in groups (Q8_0),
    bit for bit as the JAX package's q8_quantize_weights: scale =
    absmax / 127 (a true division; 1 where the group is all zeros), q =
    round-half-even(w / scale)."""
    w = w.float()
    k = w.shape[-2]
    if k % group_size:
        raise ValueError(f"contraction dim {k} not a multiple of group size {group_size}")
    g = w.reshape(*w.shape[:-2], k // group_size, group_size, w.shape[-1])
    scale = true_div(g.abs().amax(dim=-2, keepdim=True), 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    # a transposed w gives a strided q: the kernels take row-major q and s
    q = torch.round(g / scale).to(torch.int8).reshape(w.shape).contiguous()
    return QTensor(q=q, s=scale[..., 0, :].contiguous())


def q8_dequantize(qt: QTensor) -> torch.Tensor:
    """fp32 (K, N): f32(q) * s of each value's group."""
    gs = qt.group_size
    k, n = qt.q.shape[-2], qt.q.shape[-1]
    g = qt.q.float().reshape(*qt.q.shape[:-2], k // gs, gs, n)
    return (g * qt.s[..., :, None, :]).reshape(*qt.q.shape[:-2], k, n)


def ffn_takes_kernel(m: int, k: int) -> bool:
    """Whether q8_matmul_ffn (K18) serves an FFN of m rows of width k; else
    the FFN is q8_matmul_silu (K17) and q8_matmul with the residual (K15),
    as the JAX package decides by row count (quant.py:934)."""
    return m <= FFN_MAX_M and m * k * 4 <= FFN_MAX_X_BYTES


def rope_coef(theta: float, head_size: int) -> float:
    """-2 ln(theta) / HS, as the fp32 constant of quant.py:160."""
    return torch.tensor(-2.0 * math.log(theta) / head_size, dtype=torch.float32).item()


# ---------------------------------------------------------------------------
# plain versions


def _normed(x: torch.Tensor, g: torch.Tensor | None, eps: float) -> torch.Tensor:
    if g is None:
        return x
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * g.float()).to(x.dtype)


def _dot(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """bf16(x) @ bf16(dequant(qt)) with exact products summed in fp32."""
    w = q8_dequantize(qt).to(torch.bfloat16)
    return x.to(torch.bfloat16).float() @ w.float()


def _rope_cols(acc, pos, rope_limit: int, head_size: int, theta: float):
    """RoPE of the fp32 rows acc (M, N) at positions pos (M,): consecutive
    (even, odd) column pairs below rope_limit rotate, the rest pass."""
    n = acc.shape[-1]
    col = torch.arange(n, device=acc.device)
    pair = torch.div(col % head_size, 2, rounding_mode="floor").float()
    coef = torch.tensor(rope_coef(theta, head_size), dtype=torch.float32, device=acc.device)
    ang = pos.float()[:, None] * torch.exp(pair * coef)[None, :]
    partner = torch.stack((-acc[:, 1::2], acc[:, 0::2]), dim=-1).reshape(acc.shape)
    rot = acc * torch.cos(ang) + partner * torch.sin(ang)
    return torch.where(col < rope_limit, rot, acc)


def _gate(h13: torch.Tensor) -> torch.Tensor:
    h = h13.shape[-1] // 2
    h1, h3 = h13[:, :h], h13[:, h:]
    return h1 * torch.sigmoid(h1) * h3


def q8_matmul_plain(x, qt: QTensor, *, norm_weight=None, norm_eps: float = 1e-5,
                    residual=None, rope_pos=None, rope_limit: int = 0, rope_head: int = 0,
                    rope_theta: float = 10000.0):
    """Plain version of `q8_matmul`."""
    acc = _dot(_normed(x, norm_weight, norm_eps), qt)
    if residual is not None:
        acc = acc + residual.float()
    if rope_pos is not None:
        acc = _rope_cols(acc, rope_pos, rope_limit, rope_head, rope_theta)
    return acc.to(x.dtype)


def q8_matmul_silu_plain(x, qt13: QTensor, *, norm_weight=None, norm_eps: float = 1e-5):
    """Plain version of `q8_matmul_silu`."""
    return _gate(_dot(_normed(x, norm_weight, norm_eps), qt13)).to(x.dtype)


def q8_matmul_ffn_plain(x, qt13: QTensor, qt2: QTensor, residual, norm_weight, *,
                        norm_eps: float = 1e-5):
    """Plain version of `q8_matmul_ffn`."""
    hb = _gate(_dot(_normed(x, norm_weight, norm_eps), qt13)).to(torch.bfloat16)
    return (residual.float() + _dot(hb, qt2)).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers


def gemv_plan(k: int, n: int, kslice_max: int = _GEMV_KSLICE_MAX,
              mult: int = 64) -> tuple[int, int]:
    """(split, kslice) of the GEMV path: K in `split` slices of `kslice`
    rows (a multiple of `mult`, at most `kslice_max`), as many as the
    ceil(N / 256) column strips times the splits fit in one wave of the
    card's CTAs (more where K needs them)."""
    strips = -(-n // _GEMV_BN)
    split = max(-(-k // kslice_max), _GEMV_CTAS // strips)
    kslice = min(kslice_max, -(-(-(-k // split)) // mult) * mult)
    return -(-k // kslice), kslice


def _check_weight(name: str, qt: QTensor, k: int, dev) -> int:
    """Validate a QTensor with K rows on `dev`; returns N."""
    if qt.q.dim() != 2 or qt.q.shape[0] != k:
        raise ValueError(f"{name}.q: expected ({k}, N), got {tuple(qt.q.shape)}")
    n = qt.q.shape[1]
    gs = qt.group_size
    if gs <= 0 or k % gs or qt.s.shape[0] * gs != k:
        raise ValueError(f"{name}: {k} rows do not split into groups of {qt.s.shape}")
    check_operand(f"{name}.q", qt.q, (k, n), torch.int8, dev)
    check_operand(f"{name}.s", qt.s, (k // gs, n), torch.float32, dev)
    if qt.q.data_ptr() % 16 or qt.s.data_ptr() % 16:
        raise ValueError(f"{name}: q and s storage must be 16-byte aligned")
    if n % 16:
        raise ValueError(f"{name}: the kernels take N % 16 == 0, got {n}")
    return n


def _check_x(name: str, x, k_mult: int = 16):
    if x.dim() != 2:
        raise ValueError(f"{name}: expected (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    if k % k_mult:
        raise ValueError(f"{name}: the kernels take K % {k_mult} == 0, got {k}")
    check_operand(name, x, (m, k), torch.bfloat16, x.device)
    return m, k


def _check_norm(g, k, dev):
    if g is not None:
        check_operand("norm_weight", g, (k,), torch.float32, dev)


def _device(x, what: str):
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        raise ValueError(f"{what}: operands on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return dev


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def q8_matmul(x, qt: QTensor, *, norm_weight=None, norm_eps: float = 1e-5, residual=None,
              rope_pos=None, rope_limit: int = 0, rope_head: int = 0,
              rope_theta: float = 10000.0):
    """x (M, K) @ dequant(qt) -> (M, N) in x's dtype, with the optional
    rmsnorm prologue (norm_weight (K,) fp32), residual epilogue (residual
    (M, N)) and RoPE epilogue (rope_pos (M,) int32: columns below
    rope_limit rotate in heads of rope_head). A head-split (M, N / HS, HS)
    output is a view of the result. Replaces hip_llama_tpu/ops/quant.py::
    q8_matmul."""
    dev = _device(x, "q8_matmul")
    if dev.type == "cpu":
        return q8_matmul_plain(x, qt, norm_weight=norm_weight, norm_eps=norm_eps,
                               residual=residual, rope_pos=rope_pos, rope_limit=rope_limit,
                               rope_head=rope_head, rope_theta=rope_theta)
    m, k = _check_x("x", x)
    n = _check_weight("qt", qt, k, dev)
    _check_norm(norm_weight, k, dev)
    if residual is not None:
        check_operand("residual", residual, (m, n), torch.bfloat16, dev)
    if rope_pos is not None:
        check_operand("rope_pos", rope_pos, (m,), torch.int32, dev)
        if rope_head <= 0 or rope_head % 2 or rope_limit % rope_head or rope_limit > n:
            raise ValueError(f"rope: head size {rope_head}, limit {rope_limit}, N {n}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    xn = torch.empty_like(x) if norm_weight is not None else None
    split, kslice = gemv_plan(k, n) if m <= GEMV_MAX_M else (0, 0)
    part = torch.empty((split, m, n), dtype=torch.float32, device=dev) if split else None
    fn = _build.bind("quant", "q8_matmul", "ppppppppp" + "iiiiiiii" + "ff" + "p")
    rc = fn(x.data_ptr(), qt.q.data_ptr(), qt.s.data_ptr(), _ptr(norm_weight), _ptr(residual),
            _ptr(rope_pos), out.data_ptr(), _ptr(xn), _ptr(part),
            m, k, n, qt.group_size, split, kslice, rope_limit if rope_pos is not None else 0,
            rope_head if rope_pos is not None else 1,
            rope_coef(rope_theta, rope_head) if rope_pos is not None else 0.0,
            norm_eps, _stream())
    _build.check(rc, "quant", "q8_matmul")
    q8_matmul.launches += 1
    return out


q8_matmul.launches = 0


def q8_matmul_silu(x, qt13: QTensor, *, norm_weight=None, norm_eps: float = 1e-5):
    """silu(xn @ W1) * (xn @ W3) -> (M, H) in x's dtype, from the
    concatenated qt13 = W1|W3 (K, 2H), xn = rmsnorm(x, norm_weight) (or x).
    Replaces hip_llama_tpu/ops/quant.py::q8_matmul_silu."""
    dev = _device(x, "q8_matmul_silu")
    if dev.type == "cpu":
        return q8_matmul_silu_plain(x, qt13, norm_weight=norm_weight, norm_eps=norm_eps)
    m, k = _check_x("x", x)
    n2 = _check_weight("qt13", qt13, k, dev)
    h = n2 // 2
    if h % 16:
        raise ValueError(f"q8_matmul_silu takes H % 16 == 0, got {h}")
    _check_norm(norm_weight, k, dev)
    out = torch.empty((m, h), dtype=torch.bfloat16, device=dev)
    xn = torch.empty_like(x) if norm_weight is not None else None
    split, kslice = gemv_plan(k, n2) if m <= GEMV_MAX_M else (0, 0)
    part = torch.empty((split, m, n2), dtype=torch.float32, device=dev) if split else None
    fn = _build.bind("quant", "q8_matmul_silu", "ppppppp" + "iiiiii" + "f" + "p")
    rc = fn(x.data_ptr(), qt13.q.data_ptr(), qt13.s.data_ptr(), _ptr(norm_weight),
            out.data_ptr(), _ptr(xn), _ptr(part), m, k, h, qt13.group_size, split, kslice,
            norm_eps, _stream())
    _build.check(rc, "quant", "q8_matmul_silu")
    q8_matmul_silu.launches += 1
    return out


q8_matmul_silu.launches = 0


def q8_matmul_ffn(x, qt13: QTensor, qt2: QTensor, residual, norm_weight, *,
                  norm_eps: float = 1e-5):
    """residual + W2 bf16(silu(xn @ W1) * (xn @ W3)) -> (M, N) in x's dtype,
    xn = rmsnorm(x, norm_weight), qt13 = W1|W3 (K, 2H), qt2 (H, N). One CTA
    per 64-column hidden strip computes its h and multiplies it by its W2
    rows into a per-strip fp32 partial; a reduce pass seeds each output with
    the residual and adds the strips in order. Replaces hip_llama_tpu/ops/
    quant.py::q8_matmul_ffn (its kernel branch, which the model takes by
    row count: `ffn_takes_kernel`)."""
    dev = _device(x, "q8_matmul_ffn")
    if dev.type == "cpu":
        return q8_matmul_ffn_plain(x, qt13, qt2, residual, norm_weight, norm_eps=norm_eps)
    m, k = _check_x("x", x)
    n2 = _check_weight("qt13", qt13, k, dev)
    h = n2 // 2
    if h % 16:
        raise ValueError(f"q8_matmul_ffn takes H % 16 == 0, got {h}")
    n = _check_weight("qt2", qt2, h, dev)
    check_operand("residual", residual, (m, n), torch.bfloat16, dev)
    check_operand("norm_weight", norm_weight, (k,), torch.float32, dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    xn = torch.empty_like(x)
    part = torch.empty((-(-h // FFN_STRIP), m, n), dtype=torch.float32, device=dev)
    fn = _build.bind("quant", "q8_matmul_ffn", "pppppppppp" + "iiiiii" + "f" + "p")
    rc = fn(x.data_ptr(), qt13.q.data_ptr(), qt13.s.data_ptr(), qt2.q.data_ptr(),
            qt2.s.data_ptr(), norm_weight.data_ptr(), residual.data_ptr(), out.data_ptr(),
            xn.data_ptr(), part.data_ptr(), m, k, h, n, qt13.group_size, qt2.group_size,
            norm_eps, _stream())
    _build.check(rc, "quant", "q8_matmul_ffn")
    q8_matmul_ffn.launches += 1
    return out


q8_matmul_ffn.launches = 0

"""int4 weight-only matmuls: `q4_matmul` (K21) and `q4_matmul_silu` (K22),
with the host-side int4 tensor type.

Weights are symmetric int4 with one fp32 scale per `group_size` rows of a
column, in matmul orientation, packed half-split along K as the JAX
package's `Q4Tensor` (hip_llama_tpu/ops/quant4.py:9-19, :51-68): q (K/2, N)
int8, byte k' holding row k' in its low nibble and row K/2 + k' in its high
nibble, each as code + 8; s (K/gs, N) fp32. Each half holds whole groups, so
row K/2 + k' takes the scale row K/(2 gs) + k'/gs. Activations are bf16.

Each product is a CUDA kernel (csrc/quant4.cu) behind a wrapper that checks
its operands, allocates the output and the workspaces, and counts its
launches in `<wrapper>.launches`. A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain PyTorch version beside it, which is
also the yardstick the kernel is held against on the card.

Cast points, as in the JAX kernels' default `dequant` mode (quant4.py:122-
136, :181-194, :236-259, :528-531): w = bf16(f32(code) * s); xn =
bf16(x_f32 * rsqrt((sum(x_lo^2) + sum(x_hi^2)) / K + eps) * g_f32); products
bf16 x bf16 summed in fp32; the residual added to the fp32 sum; RoPE on the
fp32 sum as in K15; the gate bf16(h1 * sigmoid(h1) * h3) on the fp32 sums
of W1 and W3; one cast at the end. These hold at every width: the JAX
kernels' declines (the XLA fallback of q4_matmul, quant4.py:352-362, and
q4_matmul_silu's where H % 128 != 0, :578-582) are TPU tile rules.
"""

from __future__ import annotations

import dataclasses

import torch

from hip_llama_tpu_torch.ops import _build
from hip_llama_tpu_torch.ops.cache import _stream, check_operand
from hip_llama_tpu_torch.ops.quant import (
    GEMV_MAX_M,
    _check_norm,
    _check_x,
    _device,
    _gate,
    _ptr,
    _rope_cols,
    gemv_plan,
    rope_coef,
    true_div,
)

_GEMV_KSLICE_MAX = 512  # packed rows per GEMV CTA at most (csrc/quant4.cu kQ4KMax)


@dataclasses.dataclass
class Q4Tensor:
    """int4 weight in matmul orientation: q (K/2, N) int8 packed nibbles,
    s (K // gs, N) f32."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def k_dim(self) -> int:
        return 2 * self.q.shape[-2]

    @property
    def group_size(self) -> int:
        return self.k_dim // self.s.shape[-2]


def q4_quantize_weights(w: torch.Tensor, group_size: int = 32) -> Q4Tensor:
    """Quantize a (K, N) [or (L, K, N)] weight along K in groups, bit for
    bit as the JAX package's q4_quantize_weights called eagerly (as its
    quantize_params_q4 calls it) and io/checkpoint.py::quantize_q40: scale =
    absmax / 7 (a true division; 1 where the group is all zeros), codes
    round-half-even(w / scale) clipped to [-8, 7], packed half-split."""
    w = w.float()
    k, n = w.shape[-2], w.shape[-1]
    if k % 2 or (k // 2) % group_size:
        raise ValueError(f"K/2 = {k / 2} must hold whole groups of {group_size}")
    lead = w.shape[:-2]
    g = w.reshape(*lead, k // group_size, group_size, n)
    scale = true_div(g.abs().amax(dim=-2, keepdim=True), 7.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    nib = (torch.clamp(torch.round(g / scale), -8, 7).to(torch.int32) + 8).reshape(w.shape)
    packed = nib[..., : k // 2, :] | (nib[..., k // 2:, :] << 4)
    # a transposed w gives strided halves: the kernels take row-major q and s
    return Q4Tensor(q=packed.to(torch.uint8).view(torch.int8).contiguous(),
                    s=scale[..., 0, :].contiguous())


def q4_unpack(t: Q4Tensor) -> torch.Tensor:
    """Packed bytes -> signed int4 codes (..., K, N) as int32."""
    p = t.q.to(torch.int32)
    return torch.cat([(p & 15) - 8, ((p >> 4) & 15) - 8], dim=-2)


def q4_dequantize(t: Q4Tensor) -> torch.Tensor:
    """fp32 (K, N): f32(code) * s of each value's group."""
    gs, k, n = t.group_size, t.k_dim, t.q.shape[-1]
    g = q4_unpack(t).float().reshape(*t.q.shape[:-2], k // gs, gs, n)
    return (g * t.s[..., :, None, :]).reshape(*t.q.shape[:-2], k, n)


# ---------------------------------------------------------------------------
# plain versions


def _normed(x: torch.Tensor, g: torch.Tensor | None, eps: float) -> torch.Tensor:
    """The JAX kernel's norm prologue: the mean square as the sum over the
    two row halves (quant4.py:181-194)."""
    if g is None:
        return x
    xf = x.float()
    kh = xf.shape[-1] // 2
    ms = ((xf[:, :kh] * xf[:, :kh]).sum(-1, keepdim=True)
          + (xf[:, kh:] * xf[:, kh:]).sum(-1, keepdim=True)) / xf.shape[-1]
    return (xf * torch.rsqrt(ms + eps) * g.float()).to(x.dtype)


def _dot(x: torch.Tensor, qt: Q4Tensor) -> torch.Tensor:
    """bf16(x) @ bf16(dequant(qt)) with exact products summed in fp32."""
    w = q4_dequantize(qt).to(torch.bfloat16)
    return x.to(torch.bfloat16).float() @ w.float()


def q4_matmul_plain(x, qt: Q4Tensor, *, norm_weight=None, norm_eps: float = 1e-5,
                    residual=None, rope_pos=None, rope_limit: int = 0, rope_head: int = 0,
                    rope_theta: float = 10000.0):
    """Plain version of `q4_matmul`."""
    acc = _dot(_normed(x, norm_weight, norm_eps), qt)
    if residual is not None:
        acc = acc + residual.float()
    if rope_pos is not None:
        acc = _rope_cols(acc, rope_pos, rope_limit, rope_head, rope_theta)
    return acc.to(x.dtype)


def q4_matmul_silu_plain(x, qt13: Q4Tensor, *, norm_weight=None, norm_eps: float = 1e-5):
    """Plain version of `q4_matmul_silu`."""
    return _gate(_dot(_normed(x, norm_weight, norm_eps), qt13)).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers


def q4_gemv_plan(kh: int, n: int) -> tuple[int, int]:
    """(split, kslice) of the GEMV path over the kh = K/2 packed rows: the
    Q8 plan with slices of at most 512 packed rows, a multiple of 32."""
    return gemv_plan(kh, n, _GEMV_KSLICE_MAX, 32)


def _check_weight(name: str, qt: Q4Tensor, k: int, dev) -> int:
    """Validate a Q4Tensor for a contraction of K rows on `dev`; returns N."""
    if qt.q.dim() != 2 or qt.q.shape[0] * 2 != k:
        raise ValueError(f"{name}.q: expected ({k // 2}, N), got {tuple(qt.q.shape)}")
    n = qt.q.shape[1]
    gs = qt.group_size
    if gs <= 0 or (k // 2) % gs or qt.s.shape[0] * gs != k:
        raise ValueError(f"{name}: halves of {k // 2} rows do not split into groups of "
                         f"{tuple(qt.s.shape)}")
    check_operand(f"{name}.q", qt.q, (k // 2, n), torch.int8, dev)
    check_operand(f"{name}.s", qt.s, (k // gs, n), torch.float32, dev)
    if qt.q.data_ptr() % 16 or qt.s.data_ptr() % 16:
        raise ValueError(f"{name}: q and s storage must be 16-byte aligned")
    if n % 16:
        raise ValueError(f"{name}: the kernels take N % 16 == 0, got {n}")
    return n


def q4_matmul(x, qt: Q4Tensor, *, norm_weight=None, norm_eps: float = 1e-5, residual=None,
              rope_pos=None, rope_limit: int = 0, rope_head: int = 0,
              rope_theta: float = 10000.0):
    """x (M, K) @ dequant(qt) -> (M, N) in x's dtype, with the optional
    rmsnorm prologue (norm_weight (K,) fp32), residual epilogue (residual
    (M, N)) and RoPE epilogue (rope_pos (M,) int32: columns below
    rope_limit rotate in heads of rope_head). A head-split (M, N / HS, HS)
    output is a view of the result. Replaces hip_llama_tpu/ops/quant4.py::
    q4_matmul (its `dequant` mode)."""
    dev = _device(x, "q4_matmul")
    if dev.type == "cpu":
        return q4_matmul_plain(x, qt, norm_weight=norm_weight, norm_eps=norm_eps,
                               residual=residual, rope_pos=rope_pos, rope_limit=rope_limit,
                               rope_head=rope_head, rope_theta=rope_theta)
    m, k = _check_x("x", x, 32)
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
    split, kslice = q4_gemv_plan(k // 2, n) if m <= GEMV_MAX_M else (0, 0)
    part = torch.empty((split, m, n), dtype=torch.float32, device=dev) if split else None
    fn = _build.bind("quant4", "q4_matmul", "ppppppppp" + "iiiiiiii" + "ff" + "p")
    rc = fn(x.data_ptr(), qt.q.data_ptr(), qt.s.data_ptr(), _ptr(norm_weight), _ptr(residual),
            _ptr(rope_pos), out.data_ptr(), _ptr(xn), _ptr(part),
            m, k, n, qt.group_size, split, kslice, rope_limit if rope_pos is not None else 0,
            rope_head if rope_pos is not None else 1,
            rope_coef(rope_theta, rope_head) if rope_pos is not None else 0.0,
            norm_eps, _stream())
    _build.check(rc, "quant4", "q4_matmul")
    q4_matmul.launches += 1
    return out


q4_matmul.launches = 0


def q4_matmul_silu(x, qt13: Q4Tensor, *, norm_weight=None, norm_eps: float = 1e-5):
    """silu(xn @ W1) * (xn @ W3) -> (M, H) in x's dtype, from the
    concatenated qt13 = W1|W3 (K/2, 2H packed), xn = rmsnorm(x, norm_weight)
    (or x). Replaces hip_llama_tpu/ops/quant4.py::q4_matmul_silu (its
    `dequant` mode)."""
    dev = _device(x, "q4_matmul_silu")
    if dev.type == "cpu":
        return q4_matmul_silu_plain(x, qt13, norm_weight=norm_weight, norm_eps=norm_eps)
    m, k = _check_x("x", x, 32)
    n2 = _check_weight("qt13", qt13, k, dev)
    h = n2 // 2
    if h % 16:
        raise ValueError(f"q4_matmul_silu takes H % 16 == 0, got {h}")
    _check_norm(norm_weight, k, dev)
    out = torch.empty((m, h), dtype=torch.bfloat16, device=dev)
    xn = torch.empty_like(x) if norm_weight is not None else None
    split, kslice = q4_gemv_plan(k // 2, n2) if m <= GEMV_MAX_M else (0, 0)
    part = torch.empty((split, m, n2), dtype=torch.float32, device=dev) if split else None
    fn = _build.bind("quant4", "q4_matmul_silu", "ppppppp" + "iiiiii" + "f" + "p")
    rc = fn(x.data_ptr(), qt13.q.data_ptr(), qt13.s.data_ptr(), _ptr(norm_weight),
            out.data_ptr(), _ptr(xn), _ptr(part), m, k, h, qt13.group_size, split, kslice,
            norm_eps, _stream())
    _build.check(rc, "quant4", "q4_matmul_silu")
    q4_matmul_silu.launches += 1
    return out


q4_matmul_silu.launches = 0

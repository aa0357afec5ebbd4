"""int4 weight-only matmuls: `q4_matmul` (K21) and `q4_matmul_silu` (K22),
with the host-side int4 tensor type.

Weights are symmetric int4 with one fp32 scale per `group_size` rows of a
column, in matmul orientation, packed half-split along K as the JAX
package's `Q4Tensor` (hip_llama_tpu/ops/quant4.py:9-19, :51-68): q (K/2, N)
int8, byte k' holding row k' in its low nibble and row K/2 + k' in its high
nibble, each as code + 8; s (K/gs, N) fp32. Each half holds whole groups, so
row K/2 + k' takes the scale row K/(2 gs) + k'/gs. Activations are bf16.

Each product is a CUDA kernel (csrc/quant4.cu: up to 16 rows the Q8
products' tensor-core GEMV with the int4 format, csrc/q8.cuh::gemv_tasks
at ops/quant.py::gemv_plan's splits of the packed rows; above them
csrc/q8_wgmma.cuh's tiles; `q4_rows_kernel`) behind a wrapper that
checks its operands, allocates the output and the workspaces, and counts
its launches in `<wrapper>.launches` (the tiles' share again in
`.launches_wgmma`). A CUDA tensor launches the kernel or
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

`mode="a8"` (w4a8: HIPLLAMA_Q4_MODE=a8, which the model reads and passes
down) takes the JAX kernels' `a8` branch (quant4.py:139-171, :211-232): x
rounded to bf16 (normed first where a norm weight is given), each half
x[:, :K/2] and x[:, K/2:] quantized per (row, group of gs) as K15's `a8`
(ops/quant.py::a8_quantize_rows), the low nibbles' codes dotted with the
first half and the high nibbles' with the second, each group's exact int32
sum rescaled as (f32(sum) * sx) * s, the low plane's groups summed, then
the high plane's added. Where the JAX wrapper keeps `dequant` math instead
(`q4_a8_engages`), so does the port. The kernels (csrc/quant4.cu) count in
`<wrapper>.launches_a8`, by ops/quant.py's `a8` row rule
(`a8_rows_kernel`): up to 16 rows a8.cuh's GEMV, on the int8 tensor cores
at group sizes that are multiples of 32 (counted again in
`.launches_a8_tc`), else by dp4a, bit for bit alike (`ops/quant.py::
a8_gemv_probe` runs either); above, at group sizes
that are multiples of 32, csrc/a8_wgmma.cuh's int8 wgmma tiles with one
nibble plane a CTA, their two fp32 sums added by the split pass that then
runs the epilogue or gate (counted again in `.launches_a8_wgmma`); a8.cuh's
mma.sync tiles at the other group sizes. Both tiles round alike, and
`q4_a8_tiles_probe` runs either on the same input.
"""

from __future__ import annotations

import dataclasses

import torch

from hip_llama_tpu_torch.ops import _build
from hip_llama_tpu_torch.ops.cache import _stream, check_operand
from hip_llama_tpu_torch.ops.quant import (
    A8_GEMV_ROWS,
    GEMV_MAX_M,
    GEMV_STEP_Q4,
    _block_k,
    _check_epilogue,
    _check_norm,
    _check_x,
    _device,
    _env_int,
    _gate,
    _ptr,
    _rope_cols,
    a8_group_dot,
    a8_kernel_takes,
    a8_launch,
    a8_quantize_rows,
    a8_serves,
    check_mode,
    gemv_plan,
    rope_coef,
    true_div,
)

Q4_MODES = ("dequant", "a8")  # HIPLLAMA_Q4_MODE values the port serves
# the JAX wrappers' block defaults (quant4.py:45-46), which their `a8`
# decision reads
Q4_BLOCK_N = 256
Q4_BLOCK_K = 1024


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


def q4_a8_engages(m: int, k: int, n: int, gs: int, block_n: int | None = None) -> bool:
    """Whether the JAX q4_matmul (and, with n the hidden width H,
    q4_matmul_silu) runs its `a8` branch for an (m, k) x (k, n) product of
    group size gs, or keeps dequant math (quant4.py:331-367, :579-599): only
    where each x half is one K block, i.e. the weight strip (k x block_n)
    fits 4 MiB and the x rows (m x k bf16) 2 MiB. block_n defaults to
    HIPLLAMA_Q4_BLOCK_N (256), halved as the JAX code halves it;
    HIPLLAMA_Q4_BLOCK_K is taken at its default. The Mosaic tile fallbacks
    are not copied (see ops/quant.py::q8_a8_engages)."""
    bn = block_n or _env_int("HIPLLAMA_Q4_BLOCK_N", Q4_BLOCK_N)
    while bn > 128 and n % bn:
        bn //= 2
    if n % bn:
        bn = n
    kh = k // 2
    if kh % gs == 0 and k * bn <= 4 * 2**20 and m * k * 2 <= 2 * 2**20:
        return True
    return _block_k(kh, gs, Q4_BLOCK_K // 2) == kh and kh % gs == 0


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


def _dot_a8(x: torch.Tensor, qt: Q4Tensor) -> torch.Tensor:
    """bf16(x) @ qt in the `a8` arithmetic, fp32: the low plane's sum, then
    the high plane's added (quant4.py:226-232)."""
    xf = x.to(torch.bfloat16).float()
    gs, kh = qt.group_size, qt.q.shape[0]
    codes = q4_unpack(qt)
    planes = [a8_group_dot(*a8_quantize_rows(xf[:, sl], gs), codes[sl], qt.s[sg], gs)
              for sl, sg in ((slice(0, kh), slice(0, kh // gs)),
                             (slice(kh, 2 * kh), slice(kh // gs, 2 * kh // gs)))]
    return planes[0] + planes[1]


def _a8(mode: str, x, n: int, gs: int, widths=None) -> bool:
    check_mode(mode, Q4_MODES, "HIPLLAMA_Q4_MODE")
    return a8_serves(mode, x.shape[0], x.shape[1], widths or (n,), gs, q4_a8_engages,
                     "HIPLLAMA_Q4_MODE")


def q4_matmul_plain(x, qt: Q4Tensor, *, norm_weight=None, norm_eps: float = 1e-5,
                    residual=None, rope_pos=None, rope_limit: int = 0, rope_head: int = 0,
                    rope_theta: float = 10000.0, mode: str = "dequant", widths=None):
    """Plain version of `q4_matmul`."""
    xn = _normed(x, norm_weight, norm_eps)
    a8 = _a8(mode, x, qt.q.shape[1], qt.group_size, widths)
    acc = _dot_a8(xn, qt) if a8 else _dot(xn, qt)
    if residual is not None:
        acc = acc + residual.float()
    if rope_pos is not None:
        acc = _rope_cols(acc, rope_pos, rope_limit, rope_head, rope_theta)
    return acc.to(x.dtype)


def q4_matmul_silu_plain(x, qt13: Q4Tensor, *, norm_weight=None, norm_eps: float = 1e-5,
                         mode: str = "dequant"):
    """Plain version of `q4_matmul_silu`."""
    xn = _normed(x, norm_weight, norm_eps)
    a8 = _a8(mode, x, qt13.q.shape[1] // 2, qt13.group_size)
    return _gate(_dot_a8(xn, qt13) if a8 else _dot(xn, qt13)).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers


def q4_rows_kernel(m: int) -> str:
    """The `dequant`-math kernel that q4_matmul and q4_matmul_silu launch
    for m rows: "gemv" up to GEMV_MAX_M rows (split-K over the packed
    weight on the bf16 tensor cores: csrc/quant4.cu q4_gemv_tc_kernel on
    csrc/q8.cuh::gemv_tasks with the int4 format, ops/quant.py::gemv_plan's
    splits of the packed rows), "wgmma" above (csrc/q8_wgmma.cuh's
    q8_tile_kernel on its pipelined mainloop, with the int4 weight format).
    No other kernel is kept: the wgmma tiles timed faster than the wmma
    tiles they replaced at every row count from 32 to 4088, and the
    tensor-core GEMV than the CUDA-core one it replaced (PERF.md)."""
    return "gemv" if m <= GEMV_MAX_M else "wgmma"


def q4_kernel_takes(kernel: str, k: int, n: int, gs: int, gate: bool = False) -> bool:
    """Whether `kernel` (q4_rows_kernel's) launches at K k (the
    contraction: twice the packed rows), N n (the weight's columns: 2H for
    a gate) and group size gs, as its C launcher decides: K a multiple of
    32, gs dividing K/2 (each half holds whole groups), N a multiple of 16,
    a gate's H a multiple of 16. Both take every such shape: the wgmma
    tiles zero-fill a last step past K/2 % 32 in each half (the dead rows
    in the middle of the step's B tile) and read scales a row at a time
    where gs % 8 != 0; the GEMV guards the columns past N % 128 and reads
    its scales a row at a time where gs % 8 != 0."""
    if kernel not in ("gemv", "wgmma"):
        raise ValueError(f"unknown kernel {kernel!r}")
    return (k > 0 and k % 32 == 0 and 0 < gs and (k // 2) % gs == 0 and n > 0 and n % 16 == 0
            and (not gate or (n // 2) % 16 == 0))


def _check_takes(name: str, m: int, k: int, n: int, gs: int, gate: bool = False) -> str:
    kernel = q4_rows_kernel(m)
    if not q4_kernel_takes(kernel, k, n, gs, gate):
        raise ValueError(f"{name}: the {kernel} kernel does not take K {k}, N {n}, "
                         f"group size {gs}")
    return kernel


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
              rope_theta: float = 10000.0, mode: str = "dequant", widths=None):
    """x (M, K) @ dequant(qt) -> (M, N) in x's dtype, with the optional
    rmsnorm prologue (norm_weight (K,) fp32), residual epilogue (residual
    (M, N)) and RoPE epilogue (rope_pos (M,) int32: columns below
    rope_limit rotate in heads of rope_head). A head-split (M, N / HS, HS)
    output is a view of the result. `mode` is HIPLLAMA_Q4_MODE's value,
    `widths` as q8_matmul's. Replaces hip_llama_tpu/ops/quant4.py::
    q4_matmul."""
    dev = _device(x, "q4_matmul")
    if dev.type == "cpu":
        return q4_matmul_plain(x, qt, norm_weight=norm_weight, norm_eps=norm_eps,
                               residual=residual, rope_pos=rope_pos, rope_limit=rope_limit,
                               rope_head=rope_head, rope_theta=rope_theta, mode=mode,
                               widths=widths)
    m, k = _check_x("x", x, 32)
    n = _check_weight("qt", qt, k, dev)
    _check_norm(norm_weight, k, dev)
    _check_epilogue(residual, rope_pos, rope_limit, rope_head, m, n, dev)
    if _a8(mode, x, n, qt.group_size, widths):
        out, kernel = a8_launch("quant4", "q4_matmul_a8", x, qt, k // 2, n, norm_weight,
                                residual, rope_pos, rope_limit, rope_head, rope_theta, norm_eps,
                                False, A8_GEMV_ROWS // 2, planes=2)
        q4_matmul.launches_a8 += 1
        q4_matmul.launches_a8_tc += kernel == "gemv_tc"
        q4_matmul.launches_a8_wgmma += kernel == "wgmma"
        return out
    kernel = _check_takes("q4_matmul", m, k, n, qt.group_size)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    xn = torch.empty_like(x) if norm_weight is not None else None
    split = gemv_plan(k // 2, n, m, GEMV_STEP_Q4) if kernel == "gemv" else 0
    # the GEMV's split partials, or the tiles' RoPE table of each row's cos
    # and sin (M, rope_head)
    part = (torch.empty((split, m, n), dtype=torch.float32, device=dev) if split else
            torch.empty((m, rope_head), dtype=torch.float32, device=dev)
            if rope_pos is not None else None)
    fn = _build.bind("quant4", "q4_matmul", "ppppppppp" + "iiiiiii" + "ff" + "p")
    rc = fn(x.data_ptr(), qt.q.data_ptr(), qt.s.data_ptr(), _ptr(norm_weight), _ptr(residual),
            _ptr(rope_pos), out.data_ptr(), _ptr(xn), _ptr(part),
            m, k, n, qt.group_size, split, rope_limit if rope_pos is not None else 0,
            rope_head if rope_pos is not None else 1,
            rope_coef(rope_theta, rope_head) if rope_pos is not None else 0.0,
            norm_eps, _stream())
    _build.check(rc, "quant4", "q4_matmul")
    q4_matmul.launches += 1
    q4_matmul.launches_wgmma += kernel == "wgmma"
    return out


q4_matmul.launches = 0
q4_matmul.launches_a8 = 0
q4_matmul.launches_wgmma = 0  # the launches (of .launches) that ran the wgmma tiles
q4_matmul.launches_a8_wgmma = 0  # the launches (of .launches_a8) that ran the a8 wgmma tiles
q4_matmul.launches_a8_tc = 0  # the launches (of .launches_a8) that ran the tensor-core a8 GEMV


def q4_matmul_silu(x, qt13: Q4Tensor, *, norm_weight=None, norm_eps: float = 1e-5,
                   mode: str = "dequant"):
    """silu(xn @ W1) * (xn @ W3) -> (M, H) in x's dtype, from the
    concatenated qt13 = W1|W3 (K/2, 2H packed), xn = rmsnorm(x, norm_weight)
    (or x); `mode` as q4_matmul's. Replaces hip_llama_tpu/ops/quant4.py::
    q4_matmul_silu."""
    dev = _device(x, "q4_matmul_silu")
    if dev.type == "cpu":
        return q4_matmul_silu_plain(x, qt13, norm_weight=norm_weight, norm_eps=norm_eps,
                                    mode=mode)
    m, k = _check_x("x", x, 32)
    n2 = _check_weight("qt13", qt13, k, dev)
    h = n2 // 2
    if h % 16:
        raise ValueError(f"q4_matmul_silu takes H % 16 == 0, got {h}")
    _check_norm(norm_weight, k, dev)
    if _a8(mode, x, h, qt13.group_size):
        out, kernel = a8_launch("quant4", "q4_matmul_silu_a8", x, qt13, k // 2, n2,
                                norm_weight, None, None, 0, 0, 0.0, norm_eps, True,
                                A8_GEMV_ROWS // 2, planes=2)
        q4_matmul_silu.launches_a8 += 1
        q4_matmul_silu.launches_a8_tc += kernel == "gemv_tc"
        q4_matmul_silu.launches_a8_wgmma += kernel == "wgmma"
        return out
    kernel = _check_takes("q4_matmul_silu", m, k, n2, qt13.group_size, gate=True)
    out = torch.empty((m, h), dtype=torch.bfloat16, device=dev)
    xn = torch.empty_like(x) if norm_weight is not None else None
    split = gemv_plan(k // 2, n2, m, GEMV_STEP_Q4) if kernel == "gemv" else 0
    part = torch.empty((split, m, n2), dtype=torch.float32, device=dev) if split else None
    fn = _build.bind("quant4", "q4_matmul_silu", "ppppppp" + "iiiii" + "f" + "p")
    rc = fn(x.data_ptr(), qt13.q.data_ptr(), qt13.s.data_ptr(), _ptr(norm_weight),
            out.data_ptr(), _ptr(xn), _ptr(part), m, k, h, qt13.group_size, split,
            norm_eps, _stream())
    _build.check(rc, "quant4", "q4_matmul_silu")
    q4_matmul_silu.launches += 1
    q4_matmul_silu.launches_wgmma += kernel == "wgmma"
    return out


q4_matmul_silu.launches = 0
q4_matmul_silu.launches_a8 = 0
q4_matmul_silu.launches_wgmma = 0
q4_matmul_silu.launches_a8_wgmma = 0
q4_matmul_silu.launches_a8_tc = 0


def q4_a8_tiles_probe(x, qt: Q4Tensor, gate: bool, variant: int, *, norm_weight=None,
                      norm_eps: float = 1e-5, residual=None, rope_pos=None, rope_limit: int = 0,
                      rope_head: int = 0, rope_theta: float = 10000.0) -> torch.Tensor:
    """q4_matmul's `a8` product (gate: q4_matmul_silu's, qt = W1|W3 and the
    output (M, H)) above 16 rows with its tile kernel chosen, after the same
    quantizer pass: variant 0 the int8 wgmma tiles (csrc/a8_wgmma.cuh's
    a8_plane_kernel and the split pass that adds the planes), 1 a8.cuh's
    mma.sync tiles. For comparing the two tile kernels bit for bit on the
    card, whatever `a8_rows_kernel` and `q4_a8_engages` say; no model path
    runs it."""
    if x.device.type != "cuda":
        raise ValueError("q4_a8_tiles_probe runs on the card only")
    dev = x.device
    m, k = _check_x("x", x, 32)
    n = _check_weight("qt", qt, k, dev)
    gs = qt.group_size
    _check_norm(norm_weight, k, dev)
    if gate and (residual is not None or rope_pos is not None):
        raise ValueError("q4_a8_tiles_probe: the gate takes no residual or RoPE")
    _check_epilogue(residual, rope_pos, rope_limit, rope_head, m, n, dev)
    if variant not in (0, 1):
        raise ValueError(f"q4_a8_tiles_probe: no variant {variant}")
    if m <= GEMV_MAX_M or not a8_kernel_takes("mma" if variant else "wgmma", k, n, gs, gate,
                                              int4=True):
        raise ValueError(f"q4_a8_tiles_probe: variant {variant} does not take M {m}, K {k}, "
                         f"N {n}, group size {gs}")
    out = torch.empty((m, n // 2 if gate else n), dtype=torch.bfloat16, device=dev)
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty((m, k // gs), dtype=torch.float32, device=dev)
    part = torch.empty((2, m, n), dtype=torch.float32, device=dev) if variant == 0 else None
    rope = rope_pos is not None
    f = _build.bind("quant4", "q4_a8_tiles_probe", "p" * 10 + "i" * 8 + "ff" + "p")
    _build.check(f(x.data_ptr(), qt.q.data_ptr(), qt.s.data_ptr(), _ptr(norm_weight),
                   _ptr(residual), _ptr(rope_pos), out.data_ptr(), xi.data_ptr(), sx.data_ptr(),
                   _ptr(part), m, k, n, gs, int(gate), variant, rope_limit if rope else 0,
                   rope_head if rope else 1, rope_coef(rope_theta, rope_head) if rope else 0.0,
                   norm_eps, _stream()), "quant4", "q4_a8_tiles_probe")
    q4_a8_tiles_probe.launches += 1
    return out


q4_a8_tiles_probe.launches = 0

"""Q8_0 weight-only matmuls: `q8_matmul` (K15), `q8_matmul_silu` (K17),
`q8_matmul_ffn` (K18) and `q8_matmul_layered` (K20, K15 on one layer of a
stacked (L, K, N) weight, for `--layout stacked`), with the host-side Q8_0
tensor type and the `a8` mode shared with ops/quant4.py.

Weights are symmetric int8 with one fp32 scale per `group_size` rows of a
column, in matmul orientation: q (K, N) int8, s (K / gs, N) fp32, as the
JAX package's `QTensor` (hip_llama_tpu/ops/quant.py:52-83). Activations
are bf16 on the kernel path.

Each product is a CUDA kernel (csrc/quant.cu) behind a wrapper that checks
its operands, allocates the output and the workspaces, and counts its
launches in `<wrapper>.launches`. A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain PyTorch version beside it, which is
also the yardstick the kernel is held against on the card.

q8_matmul, q8_matmul_silu and q8_matmul_layered take the split-K GEMV up
to GEMV_MAX_M rows (csrc/q8.cuh::gemv_tasks: mma.sync on the bf16 tensor
cores, each warp fed by a cp.async ring; `gemv_plan` slices the
contraction) and, above, tiles on the pipelined wgmma mainloop of
csrc/q8_wgmma.cuh (`q8_rows_kernel`, the one row rule; `q8_kernel_takes`
says which K, N and group sizes each accepts). `.launches` counts both;
`.launches_wgmma` the launches that ran the tiles.

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

q8_matmul_ffn (K18) runs the same tensor-core GEMV twice up to GEMV_MAX_M
rows (the W1|W3 product with a gate pass, then W2 with the residual pass)
and csrc/ffn.cu's two tensor-core products above, counted in
`q8_matmul_ffn.launches_tc`.

`mode="a8"` (w8a8: HIPLLAMA_Q8_MODE=a8, which the model reads and passes
down) takes the JAX kernels' `a8` branch (quant.py:250-296, :541-585), the
reference int8 engine's arithmetic: x, normed and rounded to its dtype, is
quantized per (row, group of gs along K), sx = max|x| * fp32(1/127) (1
where zero) and xi = round-half-even(x / sx); each group's int8 dot is an
exact int32 sum, rescaled as (f32(sum) * sx) * s and summed over the groups
in fp32; the epilogue runs on that sum. The JAX wrappers decide per call,
from shapes, whether `a8` runs or the call keeps its reshape math, and the
decision changes the numbers, so the port copies it (`q8_a8_engages`). The
kernels (csrc/quant.cu, a8.cuh) count in `<wrapper>.launches_a8`;
`a8_rows_kernel` is their row rule: up to GEMV_MAX_M rows a GEMV, on the
int8 tensor cores where the group size is a multiple of 32 (a8.cuh's
a8_gemv_tc_kernel, counted again in `.launches_a8_tc`), else by dp4a, the
two bit for bit alike (`a8_gemv_probe` runs either); above it
csrc/a8_wgmma.cuh's int8 wgmma tiles where the group size is a multiple
of 32 (an int4 weight one nibble plane a CTA; counted again in
`.launches_a8_wgmma`) and a8.cuh's mma.sync tiles for the other group
sizes, which round alike (`a8_kernel_takes` says what each accepts).
q8_matmul_ffn keeps its reshape math in every mode (quant.py:967-971).
q8_matmul_layered decides by K20's own rule (`q8_layered_a8_engages`).

Two prefill variants the JAX package takes behind knobs that the model
reads and passes down (`minner=`):
- HIPLLAMA_PREFILL_MINNER=1 sends large-M products to K19,
  `q8_matmul_minner` and `q8_matmul_silu_minner` (quant.py:1126, :677-731),
  where the TPU kernel dequantizes each weight tile once and sweeps every
  row through it. Here K19 runs K15's and K17's wgmma tile kernel over the
  whole K (csrc/q8_wgmma.cuh) through entry points and launch counters of
  its own (csrc/prefill.cu), each weight tile dequantized once per CTA of
  256 rows, the epilogue or gate in the tile's store (a cluster of CTAs
  along M sharing one dequantized tile timed slower: PERF.md), so its
  outputs are the tiles' bit for bit (the JAX package's K19 sums in
  another order). q8_matmul and q8_matmul_silu take it where the
  JAX wrappers take theirs (`minner_engages`, `minner_silu_engages`):
  above 512 rows, in reshape math (after the `a8` decline), with no norm
  prologue left in the kernel, a flat output and column blocks that fit.
- HIPLLAMA_PREFILL_XHEADS=1 makes the contiguous prefill's wo
  `q8_matmul_xheads` (K16, quant.py:424): the attention output read as
  (M, heads, head size), one fp32 partial per head added in head order.
  It runs reshape math in every mode (the JAX call passes no dequant mode,
  quant.py:491-495); ineligible shapes (`xheads_engages`) flatten and take
  q8_matmul, under the mode and the MINNER decision. Its kernel runs the
  pipelined wgmma mainloop of csrc/q8_wgmma.cuh on 128-row tiles (a
  producer warpgroup copies x and the int8 weight; two consumer warpgroups
  dequantize each weight tile once per CTA and multiply), which takes
  every group size (one that is no multiple of 8 reads its scales a row at
  a time).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os

import torch

from hip_llama_tpu_torch.ops import _build
from hip_llama_tpu_torch.ops.cache import _stream, check_operand

GEMV_MAX_M = 16  # rows the GEMV path takes; more go to the tiled tensor-core path
GEMV_BN = 128  # output columns per task of the Q8 GEMV (csrc/q8.cuh kGemvBN)
GEMV_STEP = 16  # contraction rows per step of the Q8 GEMV (kGemvStep)
GEMV_WARPS = 8  # warps of a Q8 GEMV task, each a run of its steps
GEMV_MIN_RUN = 4  # steps a warp's run of a task has at least where K allows
# GEMV CTAs aimed for: two per SM of an H100 up to 8 rows, one at 9-16
# (the kernels' __launch_bounds__; K23's cooperative grid alike)
GEMV_CTAS = {8: 264, 16: 132}
# packed rows per step of the int4 GEMV (csrc/q8.cuh GemvFormat<4>::kRows):
# K / 16 steps, as the Q8 GEMV's
GEMV_STEP_Q4 = 8
_GEMV_CTAS = 264  # CTAs the `a8` GEMVs' slices aim for: two per SM of an H100
# q8_matmul_ffn takes its one-call kernel by row count (quant.py:934)
FFN_MAX_M = 256
FFN_MAX_X_BYTES = 2 * 2**20
# q8_matmul_ffn above GEMV_MAX_M rows (csrc/ffn.cu): hidden rows per k step
# of the down product, and the CTAs its split-K aims for (two per SM)
FFN_TC_STEP = 64
_FFN_TC_CTAS = 264
# the JAX package's q8_matmul_ffn strip width (HIPLLAMA_FFN_BLOCK_N's
# default, quant.py:31), read by its decline rule
FFN_BLOCK_N = 256
Q8_MODES = ("reshape", "a8")  # HIPLLAMA_Q8_MODE values the port serves
# the JAX wrappers' block defaults (quant.py:26-27), which their `a8`
# decision reads
Q8_BLOCK_N = 512
Q8_BLOCK_K = 1024
A8_GEMV_BN = 128  # columns per GEMV CTA of the a8 kernels (csrc/a8.cuh kGvBN)
A8_GEMV_ROWS = 1024  # xi rows (k) a GEMV CTA of the a8 kernels stages at most
# rows q8_matmul_layered takes itself; more go to q8_matmul on the layer
# (quant.py:1601)
LAYERED_MAX_M = 512
# fp64 bytes of one chunk of int32 group sums in the plain a8 product
_A8_PLAIN_BYTES = 256 * 2**20
# the JAX q8_matmul's rows per M block above 512 rows (quant.py:1320-1331),
# which K19's decision reads
Q8_BLOCK_M = 512
# q8_matmul_xheads's own block_n (quant.py:431), which the JAX model leaves
XHEADS_BLOCK_N = 512
WGMMA_STEP_K = 64  # rows of K a step of csrc/q8_wgmma.cuh's mainloop takes (kBK)


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


def ffn_takes_kernel(m: int, k: int, h: int = 0, gs: int = 0, mode: str = "reshape") -> bool:
    """Whether q8_matmul_ffn (K18) serves an FFN of m rows of width k and
    hidden width h over weights of group size gs; else the FFN is
    q8_matmul_silu (K17) and q8_matmul with the residual (K15). The JAX
    package decides by row count (quant.py:934) and declines where its
    hidden strips do not tile (quant.py:925-933). In `reshape` mode both
    branches round alike, so the port takes K18 at every width, by row
    count only; in another mode the fallback's products run that mode and
    K18 does not, so the port copies the whole rule (the Mosaic tile rule
    at :935 aside). At the golden fixture's hidden 192 the JAX K18 declines:
    there `a8` serves the FFN through K17 and K15."""
    if m > FFN_MAX_M or m * k * 4 > FFN_MAX_X_BYTES:
        return False
    if mode == "reshape":
        return True
    bn = FFN_BLOCK_N
    while bn > 128 and (h % bn or bn % gs):
        bn //= 2
    return not (h % bn or bn % gs or bn % 128 or k % gs or k * bn > 4 * 2**20)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _block_k(k: int, gs: int, block_k: int) -> int:
    """The JAX wrappers' shrink of a requested K block to a divisor of k
    that holds whole groups (quant.py:1280-1286)."""
    while block_k > gs and (k % block_k or block_k % gs):
        block_k //= 2
    if k % block_k or block_k % gs:
        block_k = gs if k % gs == 0 else k
    return block_k


def q8_a8_engages(m: int, k: int, n: int, gs: int, block_n: int | None = None) -> bool:
    """Whether the JAX q8_matmul (and, with n the hidden width H,
    q8_matmul_silu) runs its `a8` branch for an (m, k) x (k, n) product of
    group size gs, or keeps reshape math (quant.py:1257-1316, :640-664).
    block_n defaults to HIPLLAMA_Q8_BLOCK_N (512), halved as the JAX code
    halves it; HIPLLAMA_Q8_BLOCK_K is taken at its default. Prefill rows (m
    > 64) take `a8` where the weight strip fits and K holds at most 64
    groups; decode rows where the whole row is one K block and the group
    sums (groups x m x block_n int32) fit 4 MiB. The Mosaic tile fallbacks
    are not copied: the golden outputs come from interpret mode, where they
    never fire. The head-split output's wider block (quant.py:1337-1340)
    changes no decision: it reaches the `a8` test only above 512 rows, where
    K is at most 64 groups."""
    return _a8_stays(m, k, gs, *_q8_blocks(m, k, n, gs, block_n))


def _a8_stays(m: int, k: int, gs: int, bn: int, bk: int) -> bool:
    """Whether a JAX q8_matmul or q8_matmul_silu in `a8` keeps it at these
    blocks (quant.py:1298-1316, :659-664)."""
    if m > 64 and k % gs == 0 and k * bn <= 8 * 2**20 and k // gs <= 64:
        return True
    return not (m > 64 or bk != k or (bk // gs) * m * bn * 4 > 4 * 2**20)


def _k_block(m: int, k: int, gs: int, bn: int, block_k: int) -> int:
    """The JAX products' K block (quant.py:1270-1290, :650-657): the whole K
    where the weight strip and the rows fit, else block_k shrunk to whole
    groups."""
    if k % gs == 0 and k * bn <= 8 * 2**20 and m * k * 2 <= 2 * 2**20:
        return k
    return _block_k(k, gs, block_k)


def _q8_blocks(m: int, k: int, n: int, gs: int, block_n: int | None) -> tuple[int, int]:
    """(block_n, block_k) of the JAX q8_matmul and q8_matmul_layered
    (quant.py:1257-1290, :1621-1643): block_n (default HIPLLAMA_Q8_BLOCK_N)
    halved to a divisor of n, and the K block of `_k_block` from
    HIPLLAMA_Q8_BLOCK_K's default."""
    bn = block_n or _env_int("HIPLLAMA_Q8_BLOCK_N", Q8_BLOCK_N)
    while bn > 128 and n % bn:
        bn //= 2
    if n % bn:
        bn = n
    return bn, _k_block(m, k, gs, bn, Q8_BLOCK_K)


def q8_layered_a8_engages(m: int, k: int, n: int, gs: int, block_n: int | None = None) -> bool:
    """Whether the JAX q8_matmul_layered (K20) runs its `a8` branch for an
    (m, k) x (k, n) product of group size gs, m <= 512 (above, K20 hands
    the call to q8_matmul, whose decision is q8_a8_engages). K20's own rule
    (quant.py:1621-1665): the same K block as q8_matmul, but `a8` only for
    decode rows (m <= 64) whose whole row is one K block and whose group
    sums (groups x m x block_n int32) fit 4 MiB; unlike q8_matmul it has no
    prefill-row clause, so rows 65-512 keep reshape math. block_n as in
    q8_a8_engages."""
    bn, bk = _q8_blocks(m, k, n, gs, block_n)
    return not (m > 64 or bk != k or (bk // gs) * m * bn * 4 > 4 * 2**20)


def minner_engages(m: int, k: int, n: int, gs: int, mode: str = "reshape", norm: bool = False,
                   out_heads: int = 0, block_n: int | None = None) -> bool:
    """Whether the JAX q8_matmul, with HIPLLAMA_PREFILL_MINNER=1, takes
    `_q8_matmul_minner` (K19) for an (m, k) x (k, n) product of group size
    gs in `mode`, with the rmsnorm prologue (`norm`) and, for out_heads =
    HS, a head-split emission (quant.py:1257-1406): the same blocks as
    q8_a8_engages, then K19 above 512 rows, in reshape math after the `a8`
    decline, where no norm prologue is left (it moves outside where the K
    block is not the whole row), the output is flat and bp * block_n * 4 <=
    12 MiB with block_n % 128 == 0. A head-split emission the JAX kernel
    cannot make (head size % 128, the 8-sublane rule) becomes a flat call
    with its block_n, which may take K19. The Mosaic tile fallbacks are not
    copied (interpret mode never takes them)."""
    bn, _ = _q8_blocks(m, k, n, gs, block_n)
    return _minner_at(m, k, n, gs, mode, norm, out_heads, bn, Q8_BLOCK_K)


def _minner_at(m: int, k: int, n: int, gs: int, mode: str, norm: bool, out_heads: int,
               bn: int, block_k: int) -> bool:
    """minner_engages from the JAX call's block_n and requested block_k
    on, the head-split branch recursing as the JAX call does (quant.py:1340-1375,
    its block_n and K block passed down)."""
    bk = _k_block(m, k, gs, bn, block_k)
    if mode == "a8":
        if _a8_stays(m, k, gs, bn, bk):
            bk = k  # the prefill clause's K block; the decode clause has it already
        else:
            mode = "reshape"
    block_m = m
    if m > Q8_BLOCK_M:
        block_m = 256 if (out_heads or mode == "a8") else Q8_BLOCK_M
    bp = -(-m // block_m) * block_m
    if out_heads:
        if n % (8 * out_heads) == 0 and bn % (8 * out_heads):
            bn = max(8 * out_heads, bn - bn % (8 * out_heads))
        if (n % out_heads or bn % out_heads or (bn // out_heads) % 8 or out_heads % 128
                or (mode == "a8" and m > Q8_BLOCK_M) or n % bn):
            return _minner_at(m, k, n, gs, mode, norm, 0, bn, bk)
        return False
    if norm and bk != k:
        norm = False
    return (bp > block_m and mode == "reshape" and not norm and bn % 128 == 0
            and bp * bn * 4 <= 12 * 2**20)


def minner_silu_engages(m: int, k: int, h: int, gs: int, mode: str = "reshape",
                        norm: bool = False, block_n: int | None = None) -> bool:
    """Whether the JAX q8_matmul_silu, with HIPLLAMA_PREFILL_MINNER=1, runs
    its K19 gate for (m, k) rows over W1|W3 of hidden width h
    (quant.py:637-684): the silu wrapper's own block_n and blocks, then K19
    above 512 rows in reshape math with no norm prologue left and bp *
    block_n * 8 <= 24 MiB (two full-height accumulators). Where h does not
    tile, the JAX wrapper falls back to the norm outside and q8_matmul over
    W1|W3, whose K19 decision (minner_engages on 2h) is taken instead; the
    port's gate kernel serves both."""
    bn = block_n or _env_int("HIPLLAMA_Q8_BLOCK_N", Q8_BLOCK_N)
    while bn > 128 and h % bn:
        bn //= 2
    if h % bn:
        return minner_engages(m, k, 2 * h, gs, mode, False, 0, block_n)
    # q8_matmul's gate with one accumulator per width: bp * bn * 8 <= 24 MiB
    # is its bp * bn * 4 <= 12 MiB
    return _minner_at(m, k, h, gs, mode, norm, 0, bn, Q8_BLOCK_K)


def xheads_engages(m: int, gh: int, hs: int, k: int, n: int, gs: int) -> bool:
    """Whether the JAX q8_matmul_xheads runs its head-split kernel (K16) for
    x3 (m, gh, hs) against a (k, n) weight of group size gs, or flattens and
    takes q8_matmul (quant.py:447-464): head size % 128 == 0, whole groups,
    column blocks of its block_n 512 halved to a divisor of n (at least
    128), the whole K in one block (k * block_n <= 8 MiB), and m a multiple
    of its 256-row block or at most 256 rows."""
    bn = XHEADS_BLOCK_N
    while bn > 128 and n % bn:
        bn //= 2
    bm = min(256, m)
    return (hs % 128 == 0 and k == gh * hs and k % gs == 0 and n % bn == 0 and bn % 128 == 0
            and k * bn <= 8 * 2**20 and (m % bm == 0 or m <= bm))


def _votes(engages, widths, what: str) -> bool:
    """engages(n) for each output width n of the JAX products a call of the
    port stands for; raises where they disagree."""
    votes = {engages(n) for n in widths}
    if len(votes) > 1:
        raise NotImplementedError(f"{what}: the JAX products of widths {tuple(widths)} "
                                  "decide apart at these shapes; not yet ported")
    return votes.pop()


def a8_serves(mode: str, m: int, k: int, widths, gs: int, engages, knob: str) -> bool:
    """Whether a product in `mode` runs its `a8` arithmetic: `engages(m, k,
    n, gs)` for each output width n of the JAX products the call stands for
    (a fused weight of the port may stand for several). Raises where they
    disagree, and on a mode the port does not serve."""
    if mode == "a8":
        return _votes(lambda n: engages(m, k, n, gs), widths, f"{knob}=a8")
    return False


def minner_serves(minner: bool, mode: str, m: int, k: int, widths, gs: int, norm: bool,
                  out_heads: int = 0, block_n: int | None = None) -> bool:
    """Whether a product with HIPLLAMA_PREFILL_MINNER's value `minner` runs
    K19: minner_engages for each output width of the JAX products the call
    stands for; raises where they disagree."""
    if not minner:
        return False
    return _votes(lambda n: minner_engages(m, k, n, gs, mode, norm, out_heads, block_n), widths,
                  "HIPLLAMA_PREFILL_MINNER=1")


def check_mode(mode: str, modes: tuple[str, ...], knob: str) -> None:
    if mode not in modes:
        raise NotImplementedError(f"{knob}={mode}: not yet ported to hip_llama_tpu_torch "
                                  f"(it serves {', '.join(modes)})")


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


def a8_quantize_rows(x: torch.Tensor, gs: int):
    """x (M, K) fp32 quantized per (row, group of gs), as the JAX kernels'
    `a8` stash (quant.py:271-275, quant4.py:139-148): sx = max|x| *
    fp32(1/127), 1 where zero; xi = round-half-even(x / sx), a true
    division. Returns (xi (M, K) fp32 integers, sx (M, K / gs))."""
    m, k = x.shape
    x3 = x.reshape(m, k // gs, gs)
    sx = x3.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0)
    sx = torch.where(sx == 0, torch.ones_like(sx), sx)
    return torch.round(x3 / sx).reshape(m, k), sx[..., 0]


def a8_group_dot(xi, sx, codes, s, gs: int) -> torch.Tensor:
    """The `a8` product of quantized rows xi (M, K) with sx (M, K / gs) and
    integer weight codes (K, N) with scales s (K / gs, N): each group's dot
    summed exactly (fp64), then (f32(sum) * sx) * s summed over the groups
    in fp32 (quant.py:276-296), a chunk of groups at a time."""
    m, k = xi.shape
    n, n_groups = codes.shape[1], k // gs
    xg = xi.double().reshape(m, n_groups, gs).transpose(0, 1)  # (G, M, gs)
    wg = codes.double().reshape(n_groups, gs, n)
    sxt = sx.t()[:, :, None]  # (G, M, 1)
    acc = torch.zeros((m, n), device=xi.device)
    chunk = max(1, _A8_PLAIN_BYTES // (m * n * 8))
    for g0 in range(0, n_groups, chunk):
        ps = torch.bmm(xg[g0:g0 + chunk], wg[g0:g0 + chunk]).float() * sxt[g0:g0 + chunk]
        acc = acc + (ps * s[g0:g0 + chunk, None, :]).sum(dim=0)
    return acc


def _dot_a8(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (rounded to its dtype) @ qt in the `a8` arithmetic, fp32."""
    xi, sx = a8_quantize_rows(x.float(), qt.group_size)
    return a8_group_dot(xi, sx, qt.q, qt.s, qt.group_size)


def _gate(h13: torch.Tensor) -> torch.Tensor:
    h = h13.shape[-1] // 2
    h1, h3 = h13[:, :h], h13[:, h:]
    return h1 * torch.sigmoid(h1) * h3


def _q8_plain(x, qt: QTensor, a8: bool, norm_weight, norm_eps: float, residual, rope_pos,
              rope_limit: int, rope_head: int, rope_theta: float):
    """The product of q8_matmul in `a8` or in reshape arithmetic."""
    xn = _normed(x, norm_weight, norm_eps)
    acc = _dot_a8(xn, qt) if a8 else _dot(xn, qt)
    if residual is not None:
        acc = acc + residual.float()
    if rope_pos is not None:
        acc = _rope_cols(acc, rope_pos, rope_limit, rope_head, rope_theta)
    return acc.to(x.dtype)


def _q8_route(x, qt: QTensor, mode: str, widths, norm: bool, minner: bool, out_heads: int,
              block_n: int | None) -> str:
    """Which kernel q8_matmul runs: "a8", "minner" (K19) or "reshape"
    (K15), as the JAX q8_matmul decides for each JAX product the call
    stands for (`widths`, default N)."""
    check_mode(mode, Q8_MODES, "HIPLLAMA_Q8_MODE")
    m, k = x.shape
    widths = widths or (qt.q.shape[-1],)
    gs = qt.group_size
    engages = q8_a8_engages if block_n is None else (
        lambda *a: q8_a8_engages(*a, block_n=block_n))
    if a8_serves(mode, m, k, widths, gs, engages, "HIPLLAMA_Q8_MODE"):
        return "a8"
    if minner_serves(minner, mode, m, k, widths, gs, norm, out_heads, block_n):
        return "minner"
    return "reshape"


def q8_matmul_plain(x, qt: QTensor, *, norm_weight=None, norm_eps: float = 1e-5,
                    residual=None, rope_pos=None, rope_limit: int = 0, rope_head: int = 0,
                    rope_theta: float = 10000.0, mode: str = "reshape", widths=None,
                    minner: bool = False, out_heads: int = 0, block_n: int | None = None):
    """Plain version of `q8_matmul`."""
    route = _q8_route(x, qt, mode, widths, norm_weight is not None, minner, out_heads, block_n)
    kw = dict(norm_weight=norm_weight, norm_eps=norm_eps, residual=residual, rope_pos=rope_pos,
              rope_limit=rope_limit, rope_head=rope_head, rope_theta=rope_theta)
    if route == "minner":
        return q8_matmul_minner_plain(x, qt, **kw)
    return _q8_plain(x, qt, route == "a8", *kw.values())


def q8_matmul_minner_plain(x, qt: QTensor, *, norm_weight=None, norm_eps: float = 1e-5,
                           residual=None, rope_pos=None, rope_limit: int = 0, rope_head: int = 0,
                           rope_theta: float = 10000.0):
    """Plain version of `q8_matmul_minner` (K19): K15's reshape arithmetic,
    which K19 computes in another schedule."""
    return _q8_plain(x, qt, False, norm_weight, norm_eps, residual, rope_pos, rope_limit,
                     rope_head, rope_theta)


def layer_of(qt: QTensor, layer: int) -> QTensor:
    """Layer `layer` of a stacked QTensor (q (L, K, N), s (L, K / gs, N)):
    views, no copy."""
    return QTensor(q=qt.q[layer], s=qt.s[layer])


def q8_matmul_layered_plain(x, qt: QTensor, layer: int, *, norm_weight=None,
                            norm_eps: float = 1e-5, residual=None, rope_pos=None,
                            rope_limit: int = 0, rope_head: int = 0,
                            rope_theta: float = 10000.0, mode: str = "reshape"):
    """Plain version of `q8_matmul_layered`."""
    check_mode(mode, Q8_MODES, "HIPLLAMA_Q8_MODE")
    g = None if norm_weight is None else norm_weight[layer]
    kw = dict(norm_weight=g, norm_eps=norm_eps, residual=residual, rope_pos=rope_pos,
              rope_limit=rope_limit, rope_head=rope_head, rope_theta=rope_theta)
    m, k = x.shape
    if m > LAYERED_MAX_M:
        return q8_matmul_plain(x, layer_of(qt, layer), mode=mode, **kw)
    a8 = mode == "a8" and q8_layered_a8_engages(m, k, qt.q.shape[-1], qt.group_size)
    return _q8_plain(x, layer_of(qt, layer), a8, **kw)


def _silu_route(x, qt13: QTensor, mode: str, norm: bool, minner: bool) -> str:
    """Which kernel q8_matmul_silu runs: "a8", "minner" (K19 silu) or
    "reshape" (K17), as the JAX q8_matmul_silu decides."""
    check_mode(mode, Q8_MODES, "HIPLLAMA_Q8_MODE")
    m, k = x.shape
    h, gs = qt13.q.shape[1] // 2, qt13.group_size
    if a8_serves(mode, m, k, (h,), gs, q8_a8_engages, "HIPLLAMA_Q8_MODE"):
        return "a8"
    if minner and minner_silu_engages(m, k, h, gs, mode, norm):
        return "minner"
    return "reshape"


def q8_matmul_silu_plain(x, qt13: QTensor, *, norm_weight=None, norm_eps: float = 1e-5,
                         mode: str = "reshape", minner: bool = False):
    """Plain version of `q8_matmul_silu`."""
    route = _silu_route(x, qt13, mode, norm_weight is not None, minner)
    if route == "minner":
        return q8_matmul_silu_minner_plain(x, qt13, norm_weight=norm_weight, norm_eps=norm_eps)
    xn = _normed(x, norm_weight, norm_eps)
    return _gate(_dot_a8(xn, qt13) if route == "a8" else _dot(xn, qt13)).to(x.dtype)


def q8_matmul_silu_minner_plain(x, qt13: QTensor, *, norm_weight=None, norm_eps: float = 1e-5):
    """Plain version of `q8_matmul_silu_minner` (K19 silu):
    q8_matmul_silu_plain in reshape math, the same function, which K19
    computes in another schedule (the normed rows rounded to bf16 first, as
    where the JAX call takes K19 with its norm moved outside)."""
    return q8_matmul_silu_plain(x, qt13, norm_weight=norm_weight, norm_eps=norm_eps)


def _xheads_dot(x3, qt: QTensor) -> torch.Tensor:
    """sum over heads h, in order, of bf16(x3[:, h]) @ bf16(dequant(qt))[the
    head's rows], each head's product a partial from zero in fp32
    (quant.py:371-380)."""
    m, gh, hs = x3.shape
    w = q8_dequantize(qt).to(torch.bfloat16).float()
    acc = torch.zeros((m, w.shape[1]), dtype=torch.float32, device=x3.device)
    for h in range(gh):
        acc = acc + x3[:, h].to(torch.bfloat16).float() @ w[h * hs:(h + 1) * hs]
    return acc


def q8_matmul_xheads_plain(x3, qt: QTensor, *, residual=None, mode: str = "reshape",
                           minner: bool = False):
    """Plain version of `q8_matmul_xheads`."""
    check_mode(mode, Q8_MODES, "HIPLLAMA_Q8_MODE")
    m, gh, hs = x3.shape
    if not xheads_engages(m, gh, hs, *qt.q.shape, qt.group_size):
        return q8_matmul_plain(x3.reshape(m, gh * hs), qt, residual=residual, mode=mode,
                               minner=minner, block_n=XHEADS_BLOCK_N)
    acc = _xheads_dot(x3, qt)
    if residual is not None:
        acc = acc + residual.float()
    return acc.to(x3.dtype)


def q8_matmul_ffn_plain(x, qt13: QTensor, qt2: QTensor, residual, norm_weight, *,
                        norm_eps: float = 1e-5):
    """Plain version of `q8_matmul_ffn`."""
    hb = _gate(_dot(_normed(x, norm_weight, norm_eps), qt13)).to(torch.bfloat16)
    return (residual.float() + _dot(hb, qt2)).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers


def q8_rows_kernel(m: int) -> str:
    """The reshape-math kernel that q8_matmul and q8_matmul_silu (and K20
    through them) launch for m rows: "gemv" up to GEMV_MAX_M rows (split-K
    over the weight on the tensor cores, csrc/quant.cu q8_gemv_kernel on
    q8.cuh::gemv_tasks), "wgmma" above (q8_tile_kernel on csrc/q8_wgmma.cuh's
    pipelined mainloop). No other kernel is kept: the wgmma tiles timed
    faster than the wmma tiles they replaced at every row count from 32 to
    4088, and the tensor-core GEMV than the CUDA-core one it replaced at
    every row count from 1 to 16 (PERF.md)."""
    return "gemv" if m <= GEMV_MAX_M else "wgmma"


def q8_kernel_takes(kernel: str, k: int, n: int, gs: int, gate: bool = False) -> bool:
    """Whether `kernel` (q8_rows_kernel's) launches at K k, N n (the
    weight's columns: 2H for a gate) and group size gs, as its C launcher
    decides: K and N multiples of 16, gs dividing K, a gate's H a multiple
    of 16. The wgmma tiles zero-fill a last step past K % 64 and guard the
    columns past N % 128 (a gate's past H % 64); the GEMV guards the
    columns past N % 128."""
    if kernel not in ("gemv", "wgmma"):
        raise ValueError(f"unknown kernel {kernel!r}")
    return (k > 0 and k % 16 == 0 and n > 0 and n % 16 == 0 and 0 < gs and k % gs == 0
            and (not gate or (n // 2) % 16 == 0))


def _check_takes(name: str, m: int, k: int, n: int, gs: int, gate: bool = False) -> str:
    kernel = q8_rows_kernel(m)
    if not q8_kernel_takes(kernel, k, n, gs, gate):
        raise ValueError(f"{name}: the {kernel} kernel does not take K {k}, N {n}, "
                         f"group size {gs}")
    return kernel


def a8_rows_kernel(m: int, gs: int) -> str:
    """The kernel an `a8` product (q8_matmul, q8_matmul_silu and K20
    through them; q4_matmul, q4_matmul_silu with int4) launches for m rows
    at group size gs: up to GEMV_MAX_M rows the split-K GEMV, "gemv_tc"
    where gs is a multiple of 32 (csrc/a8.cuh::a8_gemv_tc_kernel:
    mma.sync.m16n8k32 s8, a cp.async ring a warp, so that a 32-deep step
    lies in one group), else "gemv" (dp4a, a8_gemv_kernel), the two bit
    for bit alike: the same exact int32 group sums, rescaled by each
    logical warp in its group order, the warps added in order, the same
    part layout; above, "wgmma" where gs is a multiple of 32
    (csrc/a8_wgmma.cuh: int8 wgmma, 32-deep products that no group boundary
    splits; a Q8_0 weight's a8_tile_kernel, an int4 weight's
    a8_plane_kernel, one nibble plane a CTA, whose two sums a split pass
    adds), else "mma" (a8.cuh's a8_mma_kernel: mma.sync, k16 steps where gs
    % 32 != 0). The tiles round alike: exact int32 group sums, the same
    fp32 rescale in group order, an int4 weight's low plane's sum, then
    the high plane's added (PERF.md). One rule for both weights
    (stories15M's int4 groups of 16 stay on "mma")."""
    if m <= GEMV_MAX_M:
        return "gemv_tc" if gs % 32 == 0 else "gemv"
    return "wgmma" if gs % 32 == 0 else "mma"


def a8_kernel_takes(kernel: str, k: int, n: int, gs: int, gate: bool = False,
                    int4: bool = False) -> bool:
    """Whether `kernel` (a8_rows_kernel's) launches at K k (the contraction:
    twice the packed rows for int4), N n (the weight's columns: 2H for a
    gate) and group size gs, as its C launcher decides: every kernel takes
    K a multiple of 16, N a multiple of 16, a gate's H a multiple of 16 and
    gs a multiple of 8 that divides K (int4: K/2); the GEMVs a group of at
    most their slice of A8_GEMV_ROWS rows of xi (half that for int4's two
    planes); the tensor-core GEMV and the wgmma tiles gs a multiple of 32
    (so that an int4 plane's K/2 holds whole 32-deep products; a plane's
    last 128-deep step past K/2 % 128 is zero-filled)."""
    if kernel not in ("gemv", "gemv_tc", "wgmma", "mma"):
        raise ValueError(f"unknown kernel {kernel!r}")
    rows = k // 2 if int4 else k
    ok = (k > 0 and k % 16 == 0 and n > 0 and n % 16 == 0 and (not gate or (n // 2) % 16 == 0)
          and gs > 0 and gs % 8 == 0 and rows % gs == 0)
    if kernel in ("gemv", "gemv_tc"):
        ok = ok and gs <= A8_GEMV_ROWS // (2 if int4 else 1)
    if kernel in ("gemv_tc", "wgmma"):
        return ok and gs % 32 == 0
    return ok


def _check_a8_takes(name: str, m: int, k: int, n: int, gs: int, gate: bool = False,
                   int4: bool = False) -> str:
    """a8_rows_kernel's kernel for the shape, or ValueError where it does
    not take it (no other kernel is tried)."""
    kernel = a8_rows_kernel(m, gs)
    if not a8_kernel_takes(kernel, k, n, gs, gate, int4):
        raise ValueError(f"{name}: the a8 {kernel} kernel does not take K {k}, N {n}, "
                         f"group size {gs}")
    return kernel


def _gemv_rows(m: int) -> int:
    """The rows a Q8 GEMV task takes at most (its MAXM): 8 or 16."""
    return 8 if m <= 8 else 16


def gemv_plan(k: int, n: int, m: int, step: int = GEMV_STEP) -> int:
    """The slices (split) of the tensor-core decode GEMV's contraction for
    m rows of a weight of k rows of q and n columns: a Q8_0 weight's K rows
    in steps of GEMV_STEP, an int4 weight's K/2 packed rows in steps of
    GEMV_STEP_Q4 (K / 16 steps either way, so both weights of one shape take
    the same plan). The tasks are ceil(n / GEMV_BN) column strips x split
    slices of the k / step steps x the row chunks, dealt out to the
    GEMV_CTAS CTAs of a wave; a split costs its whole waves of tasks times
    the steps of a task. Of the splits that leave each warp a run of at
    least GEMV_MIN_RUN steps, the smallest that costs at most 5% above the
    least: fewer, longer tasks timed faster than more, shorter ones at the
    same cost (PERF.md), and they leave fewer partials to add. K23 takes
    the same plan for its products, so that it rounds as the standalone
    kernels do."""
    strips, steps = -(-n // GEMV_BN), k // step
    rows = _gemv_rows(m)
    tasks, ctas = strips * -(-m // rows), GEMV_CTAS[rows]
    splits = range(1, max(1, steps // (GEMV_WARPS * GEMV_MIN_RUN)) + 1)
    cost = {sp: -(-tasks * sp // ctas) * -(-steps // sp) for sp in splits}
    return min(sp for sp in splits if cost[sp] <= 1.05 * min(cost.values()))


def gemv_runs(k: int, n: int, m: int, split: int, step: int = GEMV_STEP) -> list:
    """The tensor-core GEMV's tasks as the kernel (csrc/q8.cuh::gemv_tasks)
    takes them, in task order: (columns [n0, n1), rows [m0, m1), split, the
    rows of q [k0, k1) of each warp's run; k and step as gemv_plan's: an
    int4 weight's runs are of packed rows, each meeting x's columns k0..
    and K/2 + k0..). Task t is strip t % strips, slice t / strips % split,
    row chunk t / strips / split; slice sp holds steps [sp * steps //
    split, (sp + 1) * steps // split), and warp w of a task with s steps
    from s0 the run [s0 + s * w // 8, s0 + s * (w + 1) // 8)."""
    strips, steps, rows = -(-n // GEMV_BN), k // step, _gemv_rows(m)
    out = []
    for t in range(strips * split * -(-m // rows)):
        strip, sp, chunk = t % strips, t // strips % split, t // strips // split
        s0, s1 = sp * steps // split, (sp + 1) * steps // split
        runs = [((s0 + (s1 - s0) * w // GEMV_WARPS) * step,
                 (s0 + (s1 - s0) * (w + 1) // GEMV_WARPS) * step)
                for w in range(GEMV_WARPS)]
        out.append(((strip * GEMV_BN, min(n, (strip + 1) * GEMV_BN)),
                    (chunk * rows, min(m, (chunk + 1) * rows)), sp, runs))
    return out


def kslice_plan(k: int, n: int, kslice_max: int, mult: int) -> tuple[int, int]:
    """(split, kslice) of the `a8` GEMVs (csrc/a8.cuh: a8_gemv_kernel and
    a8_gemv_tc_kernel take the same slices, so that they add the same
    partials): k rows of q (an int4 weight's packed rows) in `split` slices
    of `kslice` rows (a multiple of `mult`, the group size, at most
    `kslice_max`), as many as the ceil(N / A8_GEMV_BN) column strips times
    the splits fit in one wave of _GEMV_CTAS CTAs (more where k needs
    them)."""
    strips = -(-n // A8_GEMV_BN)
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


def a8_launch(lib: str, fn: str, x, qt, k_rows: int, n: int, norm_weight, residual, rope_pos,
              rope_limit: int, rope_head: int, rope_theta: float, norm_eps: float, gate: bool,
              kslice_max: int, planes: int = 1, layer: int | None = None) -> tuple:
    """Launch an `a8` kernel (csrc/a8.cuh, a8_wgmma.cuh) of `lib` on x (M,
    K) and weight qt (k_rows of q, n columns: 2H for a gate, whose output is
    H wide), the kernel of a8_rows_kernel (checked first: ValueError where
    it does not take the shape): allocates the output, the quantized
    activations (M, K) int8 and their scales (M, K / gs) fp32, and the GEMV
    path's split partials, for each of the weight's `planes` (int4: the low
    and high nibbles), or the wgmma tiles' workspace: for an int4 weight
    its nibble planes' sums (2, M, N), else the RoPE table (M, rope_head)
    of each row's cos and sin. With `layer`, qt and norm_weight are stacked
    and the kernel takes the layer index after its other ints. Returns (the
    output, the kernel)."""
    m, k = x.shape
    gs, dev = qt.group_size, x.device
    kernel = _check_a8_takes(fn, m, k, n, gs, gate, int4=planes == 2)
    out = torch.empty((m, n // 2 if gate else n), dtype=torch.bfloat16, device=dev)
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty((m, k // gs), dtype=torch.float32, device=dev)
    split, kslice = (kslice_plan(k_rows, n, kslice_max, gs) if kernel in ("gemv", "gemv_tc")
                     else (0, 0))
    if split:
        part = torch.empty((planes * split, m, n), dtype=torch.float32, device=dev)
    elif kernel == "wgmma" and planes == 2:
        part = torch.empty((2, m, n), dtype=torch.float32, device=dev)
    elif kernel == "wgmma" and rope_pos is not None:
        part = torch.empty((m, rope_head), dtype=torch.float32, device=dev)
    else:
        part = None
    if gate:
        f = _build.bind(lib, fn, "pppppppp" + "iiiiii" + "f" + "p")
        rc = f(x.data_ptr(), qt.q.data_ptr(), qt.s.data_ptr(), _ptr(norm_weight),
               out.data_ptr(), xi.data_ptr(), sx.data_ptr(), _ptr(part), m, k, n // 2, gs, split,
               kslice, norm_eps, _stream())
    else:
        ints = [m, k, n, gs, split, kslice, rope_limit if rope_pos is not None else 0,
                rope_head if rope_pos is not None else 1] + ([] if layer is None else [layer])
        f = _build.bind(lib, fn, "pppppppppp" + "i" * len(ints) + "ff" + "p")
        rc = f(x.data_ptr(), qt.q.data_ptr(), qt.s.data_ptr(), _ptr(norm_weight), _ptr(residual),
               _ptr(rope_pos), out.data_ptr(), xi.data_ptr(), sx.data_ptr(), _ptr(part), *ints,
               rope_coef(rope_theta, rope_head) if rope_pos is not None else 0.0,
               norm_eps, _stream())
    _build.check(rc, lib, fn)
    return out, kernel


def q8_matmul(x, qt: QTensor, *, norm_weight=None, norm_eps: float = 1e-5, residual=None,
              rope_pos=None, rope_limit: int = 0, rope_head: int = 0,
              rope_theta: float = 10000.0, mode: str = "reshape", widths=None,
              minner: bool = False, out_heads: int = 0, block_n: int | None = None):
    """x (M, K) @ dequant(qt) -> (M, N) in x's dtype, with the optional
    rmsnorm prologue (norm_weight (K,) fp32), residual epilogue (residual
    (M, N)) and RoPE epilogue (rope_pos (M,) int32: columns below
    rope_limit rotate in heads of rope_head). A head-split (M, N / HS, HS)
    output is a view of the result. `mode` is HIPLLAMA_Q8_MODE's value,
    `minner` HIPLLAMA_PREFILL_MINNER's (K19 then runs where the JAX call
    takes it); `widths` the output widths of the JAX products the call
    stands for (default: N), `out_heads` the head size of a JAX call that
    emits head-split rows and `block_n` a JAX caller's own block_n, which
    enter those decisions only. Replaces hip_llama_tpu/ops/quant.py::
    q8_matmul."""
    dev = _device(x, "q8_matmul")
    kw = dict(norm_weight=norm_weight, norm_eps=norm_eps, residual=residual, rope_pos=rope_pos,
              rope_limit=rope_limit, rope_head=rope_head, rope_theta=rope_theta)
    if dev.type == "cpu":
        return q8_matmul_plain(x, qt, mode=mode, widths=widths, minner=minner,
                               out_heads=out_heads, block_n=block_n, **kw)
    m, k = _check_x("x", x)
    n = _check_weight("qt", qt, k, dev)
    _check_norm(norm_weight, k, dev)
    _check_epilogue(residual, rope_pos, rope_limit, rope_head, m, n, dev)
    route = _q8_route(x, qt, mode, widths, norm_weight is not None, minner, out_heads, block_n)
    if route == "minner":
        return q8_matmul_minner(x, qt, **kw)
    if route == "a8":
        out, kernel = a8_launch("quant", "q8_matmul_a8", x, qt, k, n, norm_weight, residual,
                                rope_pos, rope_limit, rope_head, rope_theta, norm_eps, False,
                                A8_GEMV_ROWS)
        q8_matmul.launches_a8 += 1
        q8_matmul.launches_a8_tc += kernel == "gemv_tc"
        q8_matmul.launches_a8_wgmma += kernel == "wgmma"
        return out
    out = _reshape_launch("q8_matmul", x, qt, n, norm_weight, residual, rope_pos, rope_limit,
                          rope_head, rope_theta, norm_eps)
    q8_matmul.launches += 1
    q8_matmul.launches_wgmma += q8_rows_kernel(m) == "wgmma"
    return out


q8_matmul.launches = 0
q8_matmul.launches_a8 = 0
q8_matmul.launches_wgmma = 0  # the launches (of .launches) that ran the wgmma tiles
q8_matmul.launches_a8_wgmma = 0  # the launches (of .launches_a8) that ran the a8 wgmma tiles
q8_matmul.launches_a8_tc = 0  # the launches (of .launches_a8) that ran the tensor-core a8 GEMV


def _check_epilogue(residual, rope_pos, rope_limit: int, rope_head: int, m: int, n: int, dev):
    if residual is not None:
        check_operand("residual", residual, (m, n), torch.bfloat16, dev)
    if rope_pos is not None:
        check_operand("rope_pos", rope_pos, (m,), torch.int32, dev)
        if rope_head <= 0 or rope_head % 2 or rope_limit % rope_head or rope_limit > n:
            raise ValueError(f"rope: head size {rope_head}, limit {rope_limit}, N {n}")


def _reshape_launch(fn: str, x, qt: QTensor, n: int, norm_weight, residual, rope_pos,
                    rope_limit: int, rope_head: int, rope_theta: float, norm_eps: float,
                    layer: int | None = None):
    """Launch csrc/quant.cu's `fn` (q8_matmul's reshape kernels) on x (M,
    K): allocates the output, the normed rows, and the GEMV path's split
    partials or the tiles' RoPE table (M, rope_head) of each row's cos and
    sin. With `layer`, qt and norm_weight are stacked and the kernel takes
    the layer index after its other ints."""
    m, k = x.shape
    dev = x.device
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    xn = torch.empty_like(x) if norm_weight is not None else None
    kernel = _check_takes(fn, m, k, n, qt.group_size)
    split = gemv_plan(k, n, m) if kernel == "gemv" else 0
    part = (torch.empty((split, m, n), dtype=torch.float32, device=dev) if split else
            torch.empty((m, rope_head), dtype=torch.float32, device=dev)
            if rope_pos is not None else None)
    ints = [m, k, n, qt.group_size, split, rope_limit if rope_pos is not None else 0,
            rope_head if rope_pos is not None else 1] + ([] if layer is None else [layer])
    f = _build.bind("quant", fn, "p" * 9 + "i" * len(ints) + "ff" + "p")
    rc = f(x.data_ptr(), qt.q.data_ptr(), qt.s.data_ptr(), _ptr(norm_weight), _ptr(residual),
           _ptr(rope_pos), out.data_ptr(), _ptr(xn), _ptr(part), *ints,
           rope_coef(rope_theta, rope_head) if rope_pos is not None else 0.0,
           norm_eps, _stream())
    _build.check(rc, "quant", fn)
    return out


def q8_matmul_layered(x, qt: QTensor, layer: int, *, norm_weight=None, norm_eps: float = 1e-5,
                      residual=None, rope_pos=None, rope_limit: int = 0, rope_head: int = 0,
                      rope_theta: float = 10000.0, mode: str = "reshape"):
    """q8_matmul on layer `layer` of a stacked weight: qt q (L, K, N) int8,
    s (L, K / gs, N) fp32, norm_weight (L, K) fp32 (the norm prologue uses
    row `layer`); x, the epilogues and `mode` as q8_matmul's. The kernels
    take the stacked base pointers and the layer index and address the
    layer themselves: no layer of the weight is copied. `a8` runs where the
    JAX K20 takes it (q8_layered_a8_engages), which is not q8_matmul's rule;
    above 512 rows the call is q8_matmul on the layer's views, under
    q8_matmul's decision, as the JAX K20 routes it. Replaces hip_llama_tpu/
    ops/quant.py::q8_matmul_layered."""
    dev = _device(x, "q8_matmul_layered")
    if dev.type == "cpu":
        return q8_matmul_layered_plain(x, qt, layer, norm_weight=norm_weight, norm_eps=norm_eps,
                                       residual=residual, rope_pos=rope_pos,
                                       rope_limit=rope_limit, rope_head=rope_head,
                                       rope_theta=rope_theta, mode=mode)
    check_mode(mode, Q8_MODES, "HIPLLAMA_Q8_MODE")
    if qt.q.dim() != 3 or qt.s.dim() != 3:
        raise ValueError(f"q8_matmul_layered takes a stacked (L, K, N) weight, got "
                         f"{tuple(qt.q.shape)}")
    n_layers = qt.q.shape[0]
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range [0, {n_layers})")
    if x.dim() == 2 and x.shape[0] > LAYERED_MAX_M:
        return q8_matmul(x, layer_of(qt, layer),
                         norm_weight=None if norm_weight is None else norm_weight[layer],
                         norm_eps=norm_eps, residual=residual, rope_pos=rope_pos,
                         rope_limit=rope_limit, rope_head=rope_head, rope_theta=rope_theta,
                         mode=mode)
    m, k = _check_x("x", x)
    check_operand("qt.q", qt.q, (n_layers, k, qt.q.shape[2]), torch.int8, dev)
    check_operand("qt.s", qt.s, (n_layers, qt.s.shape[1], qt.q.shape[2]), torch.float32, dev)
    n = _check_weight("qt", layer_of(qt, layer), k, dev)
    if norm_weight is not None:
        check_operand("norm_weight", norm_weight, (n_layers, k), torch.float32, dev)
    _check_epilogue(residual, rope_pos, rope_limit, rope_head, m, n, dev)
    if mode == "a8" and q8_layered_a8_engages(m, k, n, qt.group_size):
        out, kernel = a8_launch("quant", "q8_matmul_layered_a8", x, qt, k, n, norm_weight,
                                residual, rope_pos, rope_limit, rope_head, rope_theta, norm_eps,
                                False, A8_GEMV_ROWS, layer=layer)
        q8_matmul_layered.launches_a8 += 1
        q8_matmul_layered.launches_a8_tc += kernel == "gemv_tc"
        q8_matmul_layered.launches_a8_wgmma += kernel == "wgmma"
        return out
    out = _reshape_launch("q8_matmul_layered", x, qt, n, norm_weight, residual, rope_pos,
                          rope_limit, rope_head, rope_theta, norm_eps, layer=layer)
    q8_matmul_layered.launches += 1
    q8_matmul_layered.launches_wgmma += q8_rows_kernel(m) == "wgmma"
    return out


q8_matmul_layered.launches = 0
q8_matmul_layered.launches_a8 = 0
q8_matmul_layered.launches_wgmma = 0
q8_matmul_layered.launches_a8_wgmma = 0
q8_matmul_layered.launches_a8_tc = 0


def q8_matmul_silu(x, qt13: QTensor, *, norm_weight=None, norm_eps: float = 1e-5,
                   mode: str = "reshape", minner: bool = False):
    """silu(xn @ W1) * (xn @ W3) -> (M, H) in x's dtype, from the
    concatenated qt13 = W1|W3 (K, 2H), xn = rmsnorm(x, norm_weight) (or x);
    `mode` and `minner` as q8_matmul's. Replaces hip_llama_tpu/ops/quant.py::
    q8_matmul_silu."""
    dev = _device(x, "q8_matmul_silu")
    if dev.type == "cpu":
        return q8_matmul_silu_plain(x, qt13, norm_weight=norm_weight, norm_eps=norm_eps,
                                    mode=mode, minner=minner)
    m, k = _check_x("x", x)
    n2 = _check_weight("qt13", qt13, k, dev)
    h = n2 // 2
    if h % 16:
        raise ValueError(f"q8_matmul_silu takes H % 16 == 0, got {h}")
    _check_norm(norm_weight, k, dev)
    route = _silu_route(x, qt13, mode, norm_weight is not None, minner)
    if route == "minner":
        return q8_matmul_silu_minner(x, qt13, norm_weight=norm_weight, norm_eps=norm_eps)
    if route == "a8":
        out, kernel = a8_launch("quant", "q8_matmul_silu_a8", x, qt13, k, n2, norm_weight, None,
                                None, 0, 0, 0.0, norm_eps, True, A8_GEMV_ROWS)
        q8_matmul_silu.launches_a8 += 1
        q8_matmul_silu.launches_a8_tc += kernel == "gemv_tc"
        q8_matmul_silu.launches_a8_wgmma += kernel == "wgmma"
        return out
    out = torch.empty((m, h), dtype=torch.bfloat16, device=dev)
    xn = torch.empty_like(x) if norm_weight is not None else None
    kernel = _check_takes("q8_matmul_silu", m, k, n2, qt13.group_size, gate=True)
    split = gemv_plan(k, n2, m) if kernel == "gemv" else 0
    part = torch.empty((split, m, n2), dtype=torch.float32, device=dev) if split else None
    fn = _build.bind("quant", "q8_matmul_silu", "p" * 7 + "iiiii" + "f" + "p")
    rc = fn(x.data_ptr(), qt13.q.data_ptr(), qt13.s.data_ptr(), _ptr(norm_weight),
            out.data_ptr(), _ptr(xn), _ptr(part), m, k, h, qt13.group_size, split,
            norm_eps, _stream())
    _build.check(rc, "quant", "q8_matmul_silu")
    q8_matmul_silu.launches += 1
    q8_matmul_silu.launches_wgmma += kernel == "wgmma"
    return out


q8_matmul_silu.launches = 0
q8_matmul_silu.launches_a8 = 0
q8_matmul_silu.launches_wgmma = 0
q8_matmul_silu.launches_a8_wgmma = 0
q8_matmul_silu.launches_a8_tc = 0


def ffn_splits(m: int, h: int, n: int) -> int:
    """The slices of the hidden width that q8_matmul_ffn's down product
    (csrc/ffn.cu, above GEMV_MAX_M rows) sums apart: whole k steps of
    FFN_TC_STEP rows, as many as the (row tile, 128-column) output tiles
    can take within one wave of _FFN_TC_CTAS CTAs, none empty."""
    bm = 64 if m <= 64 else 128
    tiles = -(-n // 128) * -(-m // bm)
    steps = -(-h // FFN_TC_STEP)
    per = -(-steps // max(1, min(steps, _FFN_TC_CTAS // tiles)))
    return -(-steps // per)


def q8_matmul_ffn(x, qt13: QTensor, qt2: QTensor, residual, norm_weight, *,
                  norm_eps: float = 1e-5):
    """residual + W2 bf16(silu(xn @ W1) * (xn @ W3)) -> (M, N) in x's dtype,
    xn = rmsnorm(x, norm_weight), qt13 = W1|W3 (K, 2H), qt2 (H, N). Up to
    GEMV_MAX_M rows, the tensor-core GEMV (csrc/q8.cuh::gemv_tasks) runs
    the W1|W3 product into split-K partials, a pass adds them in order and
    writes the gated hb (M, H) bf16, the GEMV runs hb @ W2, and a pass adds
    its partials in order to the residual (`.launches`). More rows run on the tensor cores of csrc/ffn.cu
    (`.launches_tc`): the gate product writes hb, the down product sums hb
    @ W2 in `ffn_splits` slices of the hidden width, and a reduce pass
    seeds each output with the residual and adds the slices in order.
    Replaces hip_llama_tpu/ops/quant.py::
    q8_matmul_ffn (its kernel branch, which the model takes by row count:
    `ffn_takes_kernel`)."""
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
    hb = torch.empty((m, h), dtype=torch.bfloat16, device=dev)
    if m > GEMV_MAX_M:
        splits = ffn_splits(m, h, n)
        part = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
        fn = _build.bind("ffn", "q8_matmul_ffn_tc", "p" * 11 + "i" * 7 + "f" + "p")
        rc = fn(x.data_ptr(), qt13.q.data_ptr(), qt13.s.data_ptr(), qt2.q.data_ptr(),
                qt2.s.data_ptr(), norm_weight.data_ptr(), residual.data_ptr(), out.data_ptr(),
                xn.data_ptr(), hb.data_ptr(), part.data_ptr(), m, k, h, n, qt13.group_size,
                qt2.group_size, splits, norm_eps, _stream())
        _build.check(rc, "ffn", "q8_matmul_ffn_tc")
        q8_matmul_ffn.launches_tc += 1
        return out
    split13, split2 = gemv_plan(k, n2, m), gemv_plan(h, n, m)
    part = torch.empty(max(split13 * m * n2, split2 * m * n), dtype=torch.float32, device=dev)
    fn = _build.bind("quant", "q8_matmul_ffn", "p" * 11 + "i" * 8 + "f" + "p")
    rc = fn(x.data_ptr(), qt13.q.data_ptr(), qt13.s.data_ptr(), qt2.q.data_ptr(),
            qt2.s.data_ptr(), norm_weight.data_ptr(), residual.data_ptr(), out.data_ptr(),
            xn.data_ptr(), hb.data_ptr(), part.data_ptr(), m, k, h, n, qt13.group_size,
            qt2.group_size, split13, split2, norm_eps, _stream())
    _build.check(rc, "quant", "q8_matmul_ffn")
    q8_matmul_ffn.launches += 1
    return out


q8_matmul_ffn.launches = 0
q8_matmul_ffn.launches_tc = 0


# ---------------------------------------------------------------------------
# the prefill variants: K19 (HIPLLAMA_PREFILL_MINNER) and K16
# (HIPLLAMA_PREFILL_XHEADS)


def q8_matmul_minner(x, qt: QTensor, *, norm_weight=None, norm_eps: float = 1e-5,
                     residual=None, rope_pos=None, rope_limit: int = 0, rope_head: int = 0,
                     rope_theta: float = 10000.0):
    """q8_matmul's function in reshape math where the JAX package takes
    `_q8_matmul_minner` (K19): K15's tile kernel (csrc/q8_wgmma.cuh; entry
    point in csrc/prefill.cu), 256 x 128 output tiles over the whole K, each
    weight tile dequantized once per CTA into shared memory while the
    previous step's wgmmas run, the sums in registers and the residual or
    RoPE epilogue in the tile's store. The norm, when given, is a pass of its own first, as
    where the JAX call takes K19. Allocates the output and, where given a
    norm or RoPE, the normed rows and the RoPE table: no workspace.
    q8_matmul routes here under HIPLLAMA_PREFILL_MINNER=1. Replaces
    hip_llama_tpu/ops/quant.py::_q8_matmul_minner."""
    dev = _device(x, "q8_matmul_minner")
    if dev.type == "cpu":
        return q8_matmul_minner_plain(x, qt, norm_weight=norm_weight, norm_eps=norm_eps,
                                      residual=residual, rope_pos=rope_pos,
                                      rope_limit=rope_limit, rope_head=rope_head,
                                      rope_theta=rope_theta)
    m, k = _check_x("x", x)
    n = _check_weight("qt", qt, k, dev)
    _check_norm(norm_weight, k, dev)
    _check_epilogue(residual, rope_pos, rope_limit, rope_head, m, n, dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    xn = torch.empty_like(x) if norm_weight is not None else None
    cs = (torch.empty((m, rope_head), dtype=torch.float32, device=dev)
          if rope_pos is not None else None)
    f = _build.bind("prefill", "q8_matmul_minner", "p" * 9 + "i" * 6 + "ff" + "p")
    rc = f(x.data_ptr(), qt.q.data_ptr(), qt.s.data_ptr(), _ptr(norm_weight), _ptr(residual),
           _ptr(rope_pos), out.data_ptr(), _ptr(xn), _ptr(cs), m, k, n, qt.group_size,
           rope_limit if rope_pos is not None else 0,
           rope_head if rope_pos is not None else 1,
           rope_coef(rope_theta, rope_head) if rope_pos is not None else 0.0, norm_eps, _stream())
    _build.check(rc, "prefill", "q8_matmul_minner")
    q8_matmul_minner.launches += 1
    return out


q8_matmul_minner.launches = 0


def q8_matmul_silu_minner(x, qt13: QTensor, *, norm_weight=None, norm_eps: float = 1e-5):
    """q8_matmul_silu's function in reshape math on K17's tile kernel: a B
    tile of 64 columns of W1 beside the same 64 of W3, the gate bf16(h1 *
    sigmoid(h1) * h3) on the fp32 sums in the tile's store. Allocates the
    output and, where given a norm, the normed rows. q8_matmul_silu routes
    here under HIPLLAMA_PREFILL_MINNER=1. Replaces the K19 branch of
    hip_llama_tpu/ops/quant.py::q8_matmul_silu (:677-731,
    `_q8_kernel_silu_minner`)."""
    dev = _device(x, "q8_matmul_silu_minner")
    if dev.type == "cpu":
        return q8_matmul_silu_minner_plain(x, qt13, norm_weight=norm_weight, norm_eps=norm_eps)
    m, k = _check_x("x", x)
    n2 = _check_weight("qt13", qt13, k, dev)
    h = n2 // 2
    if h % 16:
        raise ValueError(f"q8_matmul_silu_minner takes H % 16 == 0, got {h}")
    _check_norm(norm_weight, k, dev)
    out = torch.empty((m, h), dtype=torch.bfloat16, device=dev)
    xn = torch.empty_like(x) if norm_weight is not None else None
    f = _build.bind("prefill", "q8_matmul_silu_minner", "p" * 6 + "i" * 4 + "f" + "p")
    rc = f(x.data_ptr(), qt13.q.data_ptr(), qt13.s.data_ptr(), _ptr(norm_weight), out.data_ptr(),
           _ptr(xn), m, k, h, qt13.group_size, norm_eps, _stream())
    _build.check(rc, "prefill", "q8_matmul_silu_minner")
    q8_matmul_silu_minner.launches += 1
    return out


q8_matmul_silu_minner.launches = 0


def minner_launch_plan(m: int, n: int, gate: bool = False) -> dict:
    """K19's launch plan for an (m, n) product (the gate: n = H), as
    csrc/prefill.cu builds its launches: the grid (x, y), a CTA's tile
    (rows, output columns) and the dimension that blockIdx.x runs over ("N":
    the column tiles of a row tile together). The launch sets no cluster
    dimension. Needs the card's build."""
    plan = (ctypes.c_int * 4)()
    f = _build.bind("prefill", "q8_minner_plan", "iiip")
    _build.check(f(m, n, int(gate), ctypes.addressof(plan)), "prefill", "q8_minner_plan")
    gx, gy, bm, bn = plan
    return {"grid": (gx, gy), "tile": (bm, bn), "x_over": "N" if gx == -(-n // bn) else "M"}


def q8_matmul_xheads(x3, qt: QTensor, *, residual=None, mode: str = "reshape",
                     minner: bool = False):
    """residual + x3 @ dequant(qt) -> (M, N) in x3's dtype for head-split
    rows x3 (M, GH, HS), read in place through its strides (the last one
    1): each head's rows times its HS rows of the tile form a partial sum
    from zero in fp32, added to the running sum in head order, then the
    residual, one cast (K16, reshape math in every mode). Where the JAX
    call flattens (`xheads_engages`), so does this one, and q8_matmul takes
    the rows under `mode` and `minner`. Replaces hip_llama_tpu/ops/
    quant.py::q8_matmul_xheads."""
    dev = _device(x3, "q8_matmul_xheads")
    if dev.type == "cpu":
        return q8_matmul_xheads_plain(x3, qt, residual=residual, mode=mode, minner=minner)
    check_mode(mode, Q8_MODES, "HIPLLAMA_Q8_MODE")
    if x3.dim() != 3:
        raise ValueError(f"x3: expected (M, GH, HS), got {tuple(x3.shape)}")
    m, gh, hs = x3.shape
    if not xheads_engages(m, gh, hs, *qt.q.shape, qt.group_size):
        return q8_matmul(x3.reshape(m, gh * hs), qt, residual=residual, mode=mode, minner=minner,
                         block_n=XHEADS_BLOCK_N)
    if x3.dtype != torch.bfloat16 or x3.device != dev:
        raise TypeError(f"x3: expected bfloat16 on {dev}, got {x3.dtype} on {x3.device}")
    sm, sh, sd = x3.stride()
    if sd != 1 or sm % 8 or sh % 8 or x3.data_ptr() % 16:
        raise ValueError(f"x3: the kernel takes a unit last stride and 16-byte aligned rows, "
                         f"got strides {x3.stride()}")
    n = _check_weight("qt", qt, gh * hs, dev)
    _check_epilogue(residual, None, 0, 0, m, n, dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    f = _build.bind("prefill", "q8_matmul_xheads", "ppppp" + "iiiiiii" + "p")
    rc = f(x3.data_ptr(), qt.q.data_ptr(), qt.s.data_ptr(), _ptr(residual), out.data_ptr(), m,
           gh, hs, sm, sh, n, qt.group_size, _stream())
    _build.check(rc, "prefill", "q8_matmul_xheads")
    q8_matmul_xheads.launches += 1
    return out


q8_matmul_xheads.launches = 0


def wgmma_mainloop_probe(ctas: int, n_steps: int, in_flight: int, dev) -> torch.Tensor:
    """Launch csrc/quant.cu's products-only mainloop (no copy, no
    dequantization): `ctas` CTAs of `n_steps` steps of WGMMA_STEP_K rows of
    K of a 128 x 128 bf16 tile, 2 x 128 x 128 x WGMMA_STEP_K flops a step,
    each step drained before the consumers' barrier (in_flight 0, the
    schedule before the pipelining) or left in flight across it (1,
    q8_wgmma.cuh's). Returns (ctas, 256) fp32 sums, so that nothing is
    dead. For timing only; no model path runs it."""
    if torch.device(dev).type != "cuda":
        raise ValueError("wgmma_mainloop_probe runs on the card only")
    out = torch.empty((ctas, 256), dtype=torch.float32, device=dev)
    f = _build.bind("quant", "wgmma_mainloop_probe", "p" + "iii" + "p")
    _build.check(f(out.data_ptr(), ctas, n_steps, in_flight, _stream()), "quant",
                 "wgmma_mainloop_probe")
    wgmma_mainloop_probe.launches += 1
    return out


wgmma_mainloop_probe.launches = 0


def q8_a8_tiles_probe(xi, sx, qt: QTensor, gate: bool, variant: int) -> torch.Tensor:
    """Launch one `a8` tile kernel of csrc/quant.cu alone (no quantizer
    pass, no epilogue) on quantized rows xi (M, K) int8 and their scales sx
    (M, K / gs) fp32: variant 0 the int8 wgmma tiles (a8_wgmma.cuh), 1
    a8.cuh's mma.sync tiles. gate: qt is W1|W3 (K, 2H) and the output the
    gate (M, H); else (M, N). For comparing the tile kernels on the same
    inputs; no model path runs it."""
    if xi.device.type != "cuda":
        raise ValueError("q8_a8_tiles_probe runs on the card only")
    m, k = xi.shape
    gs = qt.group_size
    n = _check_weight("qt", qt, k, xi.device)
    check_operand("xi", xi, (m, k), torch.int8, xi.device)
    check_operand("sx", sx, (m, k // gs), torch.float32, xi.device)
    ncols = n // 2 if gate else n
    if variant not in (0, 1):
        raise ValueError(f"q8_a8_tiles_probe: no variant {variant}")
    if not a8_kernel_takes("mma" if variant else "wgmma", k, n, gs, gate):
        raise ValueError(f"q8_a8_tiles_probe: variant {variant} does not take K {k}, N {n}, "
                         f"group size {gs}")
    out = torch.empty((m, ncols), dtype=torch.bfloat16, device=xi.device)
    f = _build.bind("quant", "q8_a8_tiles_probe", "ppppp" + "iiiiii" + "p")
    _build.check(f(xi.data_ptr(), sx.data_ptr(), qt.q.data_ptr(), qt.s.data_ptr(),
                   out.data_ptr(), m, k, ncols, gs, int(gate), variant, _stream()), "quant",
                 "q8_a8_tiles_probe")
    q8_a8_tiles_probe.launches += 1
    return out


q8_a8_tiles_probe.launches = 0


def a8_gemv_probe(x, qt, gate: bool, variant: int, *, norm_weight=None, norm_eps: float = 1e-5,
                  residual=None, rope_pos=None, rope_limit: int = 0, rope_head: int = 0,
                  rope_theta: float = 10000.0) -> torch.Tensor:
    """The `a8` product of q8_matmul (qt a QTensor) or q4_matmul (an int4
    Q4Tensor: q (K/2, N)) at up to GEMV_MAX_M rows, gate: their W1|W3 gate
    products (qt = W1|W3, the output (M, H)), with its GEMV chosen, after
    the same quantizer pass and before the same split pass: variant 0 the
    int8 tensor cores (csrc/a8.cuh::a8_gemv_tc_kernel, group sizes that are
    multiples of 32), 1 dp4a (a8_gemv_kernel). For comparing the two GEMVs
    bit for bit on the card, whatever a8_rows_kernel and the `a8` decisions
    say; no model path runs it."""
    if x.device.type != "cuda":
        raise ValueError("a8_gemv_probe runs on the card only")
    dev = x.device
    int4 = x.dim() == 2 and qt.q.dim() == 2 and 2 * qt.q.shape[0] == x.shape[1]
    if int4:
        from hip_llama_tpu_torch.ops import quant4 as Q4

        m, k = _check_x("x", x, 32)
        n = Q4._check_weight("qt", qt, k, dev)
        lib, fn, planes, rows = "quant4", "q4_a8_gemv_probe", 2, k // 2
    else:
        m, k = _check_x("x", x)
        n = _check_weight("qt", qt, k, dev)
        lib, fn, planes, rows = "quant", "q8_a8_gemv_probe", 1, k
    gs = qt.group_size
    _check_norm(norm_weight, k, dev)
    if gate and (residual is not None or rope_pos is not None):
        raise ValueError("a8_gemv_probe: the gate takes no residual or RoPE")
    _check_epilogue(residual, rope_pos, rope_limit, rope_head, m, n, dev)
    if variant not in (0, 1):
        raise ValueError(f"a8_gemv_probe: no variant {variant}")
    if m > GEMV_MAX_M or not a8_kernel_takes("gemv" if variant else "gemv_tc", k, n, gs, gate,
                                             int4):
        raise ValueError(f"a8_gemv_probe: variant {variant} does not take M {m}, K {k}, N {n}, "
                         f"group size {gs}")
    out = torch.empty((m, n // 2 if gate else n), dtype=torch.bfloat16, device=dev)
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty((m, k // gs), dtype=torch.float32, device=dev)
    split, kslice = kslice_plan(rows, n, A8_GEMV_ROWS // planes, gs)
    part = torch.empty((planes * split, m, n), dtype=torch.float32, device=dev)
    rope = rope_pos is not None
    f = _build.bind(lib, fn, "p" * 10 + "i" * 10 + "ff" + "p")
    _build.check(f(x.data_ptr(), qt.q.data_ptr(), qt.s.data_ptr(), _ptr(norm_weight),
                   _ptr(residual), _ptr(rope_pos), out.data_ptr(), xi.data_ptr(), sx.data_ptr(),
                   part.data_ptr(), m, k, n, gs, split, kslice, int(gate), variant,
                   rope_limit if rope else 0, rope_head if rope else 1,
                   rope_coef(rope_theta, rope_head) if rope else 0.0, norm_eps, _stream()),
                 lib, fn)
    a8_gemv_probe.launches += 1
    return out


a8_gemv_probe.launches = 0

"""The device-memory bandwidth probes of tools/hbm_bw.py (K24-K27): reads
and a copy whose only work is moving the bytes, in the access patterns of
the TPU probes, so that the port bench can grade the model step against a
bandwidth this card delivers (hip_llama_tpu_torch/tools/hbm_bw.py).

Each probe is a CUDA kernel (csrc/hbm_bw.cu) that moves its bytes with the
Tensor Memory Accelerator's bulk copies into shared memory, behind a wrapper
that checks its operands, allocates the output and counts its launches in
`<wrapper>.launches`. A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain PyTorch version beside it, which is also what the
kernel is held against on the card. The outputs are the TPU kernels': an
(8, 128) fp32 tile of seed + int8 values, exact while the sums stay below
2^24 (each wrapper checks its block count), and for the copy the copied
rows.

The arrays are the TPU probes': x (n, 1024) int8 read in blocks of bm rows
(bm KiB), or for wshape_read x (bk, n_cols) int8 read in (bk, bn) tiles.
The seed is one int32 on x's device.
"""

from __future__ import annotations

import torch

from hip_llama_tpu_torch.ops import _build
from hip_llama_tpu_torch.ops.cache import _stream
from hip_llama_tpu_torch.ops.quant import _device

ROW = 1024  # bytes per row of the (n, 1024) arrays
CORNER = (8, 128)
# a ring of 4 slots of up to 32 KiB for K24-K26 (128 KiB of shared memory);
# K27's slots are its depth
SLOTS = 4
PIECE_MAX = 32 * 1024
DEEP_BYTES = 192 * 1024  # K27's ring, at most
DEEP_PIECE_MAX = 16 * 1024
# sums of int8 corners stay exact in fp32 below 2^24; half of it leaves room
# for the seed
EXACT_BLOCKS = 2 ** 23 // 128


def _check(x: torch.Tensor, seed: torch.Tensor | None, what: str, width: int | None = ROW):
    if x.dim() != 2 or (width is not None and x.shape[1] != width):
        raise ValueError(f"{what}: x must be (n, {width or 'n_cols'}), got {tuple(x.shape)}")
    if x.dtype != torch.int8 or not x.is_contiguous():
        raise TypeError(f"{what}: x must be contiguous int8, got {x.dtype}")
    if x.is_cuda and x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 16-byte aligned")
    if seed is not None and (seed.shape != (1,) or seed.dtype != torch.int32
                             or seed.device != x.device):
        raise ValueError(f"{what}: seed must be one int32 on {x.device}, got "
                         f"{tuple(seed.shape)} {seed.dtype} on {seed.device}")


def _streamed(x: torch.Tensor, bm: int, streams: int, what: str) -> int:
    """Blocks per stream of the TPU read and copy kernels: `streams`
    regions of per = (n // bm) // streams blocks of bm rows."""
    if bm < 8 or bm % 8 or streams < 1:
        raise ValueError(f"{what}: bm must be a positive multiple of 8 and streams >= 1, "
                         f"got {bm}, {streams}")
    per = (x.shape[0] // bm) // streams
    if per < 1:
        raise ValueError(f"{what}: {x.shape[0]} rows hold no {streams} blocks of {bm}")
    return per


def stream_piece(block_bytes: int) -> int:
    """K24 and K25's piece: the largest power of two up to 32 KiB that
    divides a block (at least 8 KiB, so a block's corner is in its first)."""
    p = PIECE_MAX
    while block_bytes % p:
        p //= 2
    return p


def _exact(n_blocks: int, what: str) -> None:
    if n_blocks > EXACT_BLOCKS:
        raise ValueError(f"{what}: {n_blocks} blocks of int8 corners could sum past 2^23, "
                         "where fp32 stops adding them exactly")


# ---------------------------------------------------------------------------
# K24: the read probe


def dma_read_plain(seed: torch.Tensor, x: torch.Tensor, bm: int, streams: int = 1):
    """Plain version of `dma_read`."""
    per = _streamed(x, bm, streams, "dma_read")
    corners = x[:per * streams * bm].view(per * streams, bm, ROW)[:, :CORNER[0], :CORNER[1]]
    return corners.to(torch.int32).sum(0).float() + seed.float()


def dma_read(seed: torch.Tensor, x: torch.Tensor, bm: int, streams: int = 1) -> torch.Tensor:
    """seed + the sum of the [:8, :128] corners of x's first per * streams
    blocks of bm rows, (8, 128) fp32: every byte of those blocks is read
    (streams regions of per blocks, interleaved as the TPU grid reads them).
    Replaces tools/hbm_bw.py::dma_probe's read kernel."""
    _check(x, seed, "dma_read")
    if _device(x, "dma_read").type == "cpu":
        return dma_read_plain(seed, x, bm, streams)
    per = _streamed(x, bm, streams, "dma_read")
    _exact(per * streams, "dma_read")
    block = bm * ROW
    out = torch.zeros(CORNER, dtype=torch.float32, device=x.device)
    fn = _build.bind("hbm_bw", "dma_read", "ppp" + "li" + "l" + "ii" + "p")
    rc = fn(x.data_ptr(), seed.data_ptr(), out.data_ptr(), per, streams, block,
            stream_piece(block), SLOTS, _stream())
    _build.check(rc, "hbm_bw", "dma_read")
    dma_read.launches += 1
    return out


dma_read.launches = 0


# ---------------------------------------------------------------------------
# K25: the copy probe


def dma_copy_plain(x: torch.Tensor, bm: int, streams: int = 1) -> list[torch.Tensor]:
    """Plain version of `dma_copy`."""
    per = _streamed(x, bm, streams, "dma_copy")
    rows = per * bm
    return [x[c * rows:(c + 1) * rows].clone() for c in range(streams)]


def dma_copy(x: torch.Tensor, bm: int, streams: int = 1) -> list[torch.Tensor]:
    """The TPU copy kernel's `streams` outputs, (per * bm, 1024) int8 each:
    output c is rows [c per bm, (c + 1) per bm) of x. They are views of one
    buffer, side by side. Replaces tools/hbm_bw.py::dma_probe(copy=True)'s
    kernel."""
    _check(x, None, "dma_copy")
    if _device(x, "dma_copy").type == "cpu":
        return dma_copy_plain(x, bm, streams)
    per = _streamed(x, bm, streams, "dma_copy")
    block = bm * ROW
    out = torch.empty((streams, per * bm, ROW), dtype=torch.int8, device=x.device)
    fn = _build.bind("hbm_bw", "dma_copy", "pp" + "li" + "l" + "ii" + "p")
    rc = fn(x.data_ptr(), out.data_ptr(), per, streams, block, stream_piece(block), SLOTS,
            _stream())
    _build.check(rc, "hbm_bw", "dma_copy")
    dma_copy.launches += 1
    return list(out.unbind(0))


dma_copy.launches = 0


# ---------------------------------------------------------------------------
# K26: reads in the Q8 weight stream's tiles


def wshape_rows(bk: int, bn: int) -> int:
    """Rows of a K26 piece: the most that fit 32 KiB, a multiple of 8
    dividing bk."""
    r = min(bk, PIECE_MAX // bn) // 8 * 8
    while r >= 8 and bk % r:
        r -= 8
    if r < 8:
        raise ValueError(f"wshape_read: no piece of 8k rows of {bn} bytes divides bk {bk}")
    return r


def wshape_read_plain(seed: torch.Tensor, x: torch.Tensor, bn: int) -> torch.Tensor:
    """Plain version of `wshape_read`."""
    n_tiles = x.shape[1] // bn
    corners = x[:CORNER[0], :n_tiles * bn].reshape(CORNER[0], n_tiles, bn)[:, :, :CORNER[1]]
    return corners.to(torch.int32).sum(1).float() + seed.float()


def wshape_read(seed: torch.Tensor, x: torch.Tensor, bn: int) -> torch.Tensor:
    """seed + sum over the (bk, bn) tiles j of x (bk, n_cols) of x[:8,
    j bn : j bn + 128], (8, 128) fp32, every byte of the n_cols // bn tiles
    read. Replaces tools/hbm_bw.py::wshape_probe's kernel."""
    _check(x, seed, "wshape_read", width=None)
    if _device(x, "wshape_read").type == "cpu":
        return wshape_read_plain(seed, x, bn)
    bk, n_cols = x.shape
    if bn % 16 or bn < CORNER[1] or bk < CORNER[0] or n_cols % 16:
        raise ValueError(f"wshape_read: bn must be a multiple of 16 of at least 128, bk at "
                         f"least 8 and the rows 16-byte multiples, got bn {bn}, bk {bk}, "
                         f"n_cols {n_cols}")
    n_tiles = n_cols // bn
    if n_tiles < 1:
        raise ValueError(f"wshape_read: {n_cols} columns hold no tile of {bn}")
    _exact(n_tiles, "wshape_read")
    out = torch.zeros(CORNER, dtype=torch.float32, device=x.device)
    fn = _build.bind("hbm_bw", "wshape_read", "ppp" + "l" + "ii" + "l" + "ii" + "p")
    rc = fn(x.data_ptr(), seed.data_ptr(), out.data_ptr(), n_tiles, bk, bn, n_cols,
            wshape_rows(bk, bn), SLOTS, _stream())
    _build.check(rc, "hbm_bw", "wshape_read")
    wshape_read.launches += 1
    return out


wshape_read.launches = 0


# ---------------------------------------------------------------------------
# K27: reads with `depth` copies in flight


def deep_target(n_blocks: int, depth: int) -> int:
    """The block whose corner the TPU deep kernel returns: the last one its
    loop (block i in slot i % depth) leaves in slot 0."""
    return (n_blocks - 1) // depth * depth


def deep_piece(depth: int) -> int:
    """K27's piece: 16 KiB, less where `depth` of them would pass 192 KiB
    (a multiple of 1024, so a row's corner is never cut)."""
    return min(DEEP_PIECE_MAX, DEEP_BYTES // depth // ROW * ROW)


def deep_read_plain(seed: torch.Tensor, x: torch.Tensor, bm: int, depth: int) -> torch.Tensor:
    """Plain version of `deep_read`."""
    b = deep_target(x.shape[0] // bm, depth)
    return x[b * bm:b * bm + CORNER[0], :CORNER[1]].float() + seed.float()


def deep_read(seed: torch.Tensor, x: torch.Tensor, bm: int, depth: int) -> torch.Tensor:
    """seed + the [:8, :128] corner of block (n_blocks - 1) // depth * depth
    of x's blocks of bm rows, (8, 128) fp32, after reading every byte of the
    n_blocks * bm rows with `depth` copies in flight per SM. Replaces
    tools/hbm_bw.py::deep_probe's kernel."""
    _check(x, seed, "deep_read")
    if _device(x, "deep_read").type == "cpu":
        return deep_read_plain(seed, x, bm, depth)
    if bm < 8 or depth < 1 or depth > 32:
        raise ValueError(f"deep_read: bm must be at least 8 and depth in 1..32, got {bm}, "
                         f"{depth}")
    n_blocks = x.shape[0] // bm
    if n_blocks < 1:
        raise ValueError(f"deep_read: {x.shape[0]} rows hold no block of {bm}")
    out = torch.empty(CORNER, dtype=torch.float32, device=x.device)
    fn = _build.bind("hbm_bw", "deep_read", "ppp" + "l" + "ii" + "l" + "p")
    rc = fn(x.data_ptr(), seed.data_ptr(), out.data_ptr(), n_blocks * bm * ROW,
            deep_piece(depth), depth, deep_target(n_blocks, depth) * bm * ROW, _stream())
    _build.check(rc, "hbm_bw", "deep_read")
    deep_read.launches += 1
    return out


deep_read.launches = 0

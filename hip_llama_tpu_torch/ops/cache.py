"""In-place KV cache writers: the decode step's row commit (K2), its
four-write form (one plane's rows, K8, and one scale plane's, K9), the
prefill chunk writer (K3) and its scale companion for int8 caches (K12),
their paged counterparts (K11 and K10, K13 and K14), and the rowwise int8
quantization of KV rows.

The cache is the reference layout (B, L, KVH, S, HS), held by any object
with `.k` and `.v` tensors (models/llama.py::KVCache): fp32 or bf16 planes,
or int8 planes with one fp32 scale per cached row in `.k_scale` and
`.v_scale` (B, L, KVH, S). Where the JAX writers donate the cache and
return a new one, these write the tensors in place and return the same
object.

Each writer is a CUDA kernel (csrc/cache.cu) behind a wrapper that checks
its operands and counts its launches: `<wrapper>.launches` on an fp32 or
bf16 cache, `<wrapper>.launches_int8` on an int8 one. A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain PyTorch version
beside it, which is also the yardstick the kernel is held against on the
card.

The paged pool (models/paged.py::PagedKVCache) holds planes (L, KVH, P, PS,
HS) shared by all slots, int8 ones with scale planes (L, KVH, P, PS); a
page table (B, MAX_PAGES) int32 names each slot's physical pages in order,
so row r of slot b lives in page table[b, r // PS] at offset r % PS.
"""

from __future__ import annotations

import torch

from hip_llama_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_cache(k: torch.Tensor, v: torch.Tensor,
                layout: str = "(B, L, KVH, S, HS)") -> tuple[int, int, int, int, int]:
    """Validate a KV cache's two planes; returns their shape, (B, L, KVH,
    S, HS) (or the paged pool's (L, KVH, P, PS, HS), `layout`)."""
    if k.dim() != 5 or k.shape != v.shape:
        raise ValueError(f"cache planes must be {layout} alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype not in _CACHE_DTYPES or v.dtype != k.dtype:
        raise TypeError(f"cache dtype must be float32, bfloat16 or int8, got {k.dtype}/{v.dtype}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("cache planes must be contiguous")
    if k.device != v.device:
        raise ValueError("cache planes on different devices")
    if k.is_cuda:
        if k.data_ptr() % 16 or v.data_ptr() % 16:
            raise ValueError("cache planes must be 16-byte aligned")
        if k.device.index != torch.cuda.current_device():
            # the kernels launch on the current device's stream
            raise ValueError(f"cache on {k.device} but the current device is "
                             f"cuda:{torch.cuda.current_device()}")
    return tuple(k.shape)


def check_pages(k: torch.Tensor, v: torch.Tensor) -> tuple[int, int, int, int, int]:
    """Validate the paged pool's two planes; returns (L, KVH, P, PS, HS)."""
    return check_cache(k, v, "(L, KVH, P, PS, HS)")


def check_table(page_table: torch.Tensor, bsz: int, dev) -> int:
    """Validate a page table of `bsz` slots; returns its width MAX_PAGES."""
    if page_table.dim() != 2:
        raise ValueError(f"page_table: expected (B, MAX_PAGES), got {tuple(page_table.shape)}")
    check_operand("page_table", page_table, (bsz, page_table.shape[1]), torch.int32, dev)
    return page_table.shape[1]


def check_scales(k: torch.Tensor, k_scale, v_scale) -> bool:
    """Validate an int8 cache's scale planes against its K plane; returns
    whether the cache is quantized (int8 planes, which need both scale
    planes; fp32 and bf16 planes take none)."""
    if k.dtype != torch.int8:
        if k_scale is not None or v_scale is not None:
            raise ValueError(f"scale planes given for a {k.dtype} cache")
        return False
    if k_scale is None or v_scale is None:
        raise ValueError("an int8 cache needs its k_scale and v_scale planes")
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        check_operand(name, sc, k.shape[:4], torch.float32, k.device)
    return True


def check_operand(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, cache on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.dtype != torch.int32 and t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernels load 16-byte vectors; storage must be 16-byte aligned")


# fp32 1/127: the JAX package writes absmax / 127.0, and XLA compiles the
# division by that constant into a product with its reciprocal wherever the
# package runs it (under jit: the model's step and prefill, and the TPU
# kernels); the port computes that product, bit-equal to the jitted
# reference (tests/test_torch_kv_int8.py)
INV_127 = 1.0 / 127.0


def quantize_kv_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of KV rows (..., HS): scale =
    absmax * (1/127) over the head dim (1 where the row is zero), q =
    round(x / scale) with ties to even. Returns (int8 rows, fp32 scales of
    shape rows.shape[:-1]). hip_llama_tpu/ops/cache.py::quantize_kv_rows
    as XLA compiles it (XLA there too, no kernel)."""
    rf = rows.float()
    absmax = rf.abs().amax(dim=-1)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax * INV_127)
    return torch.round(rf / scale[..., None]).to(torch.int8), scale


def _count(wrapper, quantized: bool) -> None:
    if quantized:
        wrapper.launches_int8 += 1
    else:
        wrapper.launches += 1


# ---------------------------------------------------------------------------
# K2: one decode step's K/V rows for every layer


def _put_step_rows(plane, rows, pos, valid=None):
    """plane[b, :, :, pos[b]] = rows[:, b] for each slot b with valid[b] != 0
    and 0 <= pos[b] < S: rows (L, B, KVH, HS) into a cache plane (B, L, KVH,
    S, HS), or (L, B, KVH) into a scale plane (B, L, KVH, S)."""
    keep = (pos >= 0) & (pos < plane.shape[3])
    if valid is not None:
        keep &= valid != 0
    bi = torch.nonzero(keep).flatten()
    plane[bi, :, :, pos[bi].long()] = rows.transpose(0, 1)[bi].to(plane.dtype)
    return plane


def kv_commit_rows_plain(cache, k_rows, v_rows, pos, valid=None):
    """Plain version of `kv_commit_rows` (the XLA `_commit_kv_rows` math,
    hip_llama_tpu/models/llama.py:425-454 and :477-503): cache[b, :, :,
    pos[b]] = rows[:, b] (quantized by row on an int8 cache, its scale to
    the scale planes) for each slot b with valid[b] != 0 and 0 <= pos[b] <
    S."""
    planes = [(cache.k, k_rows), (cache.v, v_rows)]
    if cache.k.dtype == torch.int8:
        (kq, ks), (vq, vs) = quantize_kv_rows(k_rows), quantize_kv_rows(v_rows)
        planes = [(cache.k, kq), (cache.v, vq), (cache.k_scale, ks), (cache.v_scale, vs)]
    for plane, rows in planes:
        _put_step_rows(plane, rows, pos, valid)
    return cache


def kv_commit_rows(cache, k_rows, v_rows, pos, valid=None):
    """Write one decode step's rows, k_rows/v_rows (L, B, KVH, HS), into the
    cache in place at (b, :, :, pos[b]) for every layer, for each slot with
    valid[b] != 0 (default: all). One launch writes K and V. On an int8
    cache the rows come in fp32 or bf16 and the kernel quantizes each (layer,
    slot, head) row as quantize_kv_rows does, writing the int8 row and its
    scale. Replaces hip_llama_tpu/ops/cache.py::kv_commit_rows (dense and
    int8 branches). A position outside [0, S) writes nothing."""
    bsz, n_layers, kvh, s, hs = check_cache(cache.k, cache.v)
    quantized = check_scales(cache.k, getattr(cache, "k_scale", None),
                             getattr(cache, "v_scale", None))
    dev = cache.k.device
    if dev.type == "cpu":
        return kv_commit_rows_plain(cache, k_rows, v_rows, pos, valid)
    if dev.type != "cuda":
        raise ValueError(f"kv_commit_rows: unsupported device {dev}")
    row_dt = k_rows.dtype if quantized else cache.k.dtype
    if row_dt not in _DTYPES:
        raise TypeError(f"k_rows: expected float32 or bfloat16, got {row_dt}")
    for name, t in (("k_rows", k_rows), ("v_rows", v_rows)):
        check_operand(name, t, (n_layers, bsz, kvh, hs), row_dt, dev)
    check_operand("pos", pos, (bsz,), torch.int32, dev)
    if valid is not None:
        check_operand("valid", valid, (bsz,), torch.int32, dev)
    vptr = 0 if valid is None else valid.data_ptr()
    if quantized:
        fn = _build.bind("cache", "kv_commit_rows_int8", "pppppppp" + "iiiiii" + "p")
        rc = fn(cache.k.data_ptr(), cache.v.data_ptr(), cache.k_scale.data_ptr(),
                cache.v_scale.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(), pos.data_ptr(),
                vptr, bsz, n_layers, kvh, s, hs, _DTYPES[row_dt], _stream())
    else:
        fn = _build.bind("cache", "kv_commit_rows", "pppppp" + "iiiii" + "p")
        rc = fn(cache.k.data_ptr(), cache.v.data_ptr(), k_rows.data_ptr(),
                v_rows.data_ptr(), pos.data_ptr(), vptr,
                bsz, n_layers, kvh, s, hs * cache.k.element_size(), _stream())
    _build.check(rc, "cache", "kv_commit_rows")
    _count(kv_commit_rows, quantized)
    return cache


kv_commit_rows.launches = 0
kv_commit_rows.launches_int8 = 0


# ---------------------------------------------------------------------------
# K8 and K9: the four-write commit, one plane per launch


def kv_write_rows_plain(plane, rows, pos, valid=None):
    """Plain version of `kv_write_rows` (the XLA `_write_kv_rows`,
    hip_llama_tpu/models/llama.py:425-454, with K2's position rule)."""
    return _put_step_rows(plane, rows, pos, valid)


def kv_write_rows(plane, rows, pos, valid=None):
    """Write one decode step's rows of one cache plane, rows (L, B, KVH, HS)
    in the plane's dtype (int8 rows from quantize_kv_rows on an int8
    cache), into the plane (B, L, KVH, S, HS) in place at (b, :, :, pos[b])
    for every layer, for each slot with valid[b] != 0 (default: all); one
    launch. A position outside [0, S) writes nothing. Replaces
    hip_llama_tpu/ops/cache.py::kv_write_rows, which read-modify-writes a
    window around each row: here each row is stored alone and the plane is
    never read."""
    bsz, n_layers, kvh, s, hs = check_cache(plane, plane)
    dev = plane.device
    if dev.type == "cpu":
        return kv_write_rows_plain(plane, rows, pos, valid)
    if dev.type != "cuda":
        raise ValueError(f"kv_write_rows: unsupported device {dev}")
    check_operand("rows", rows, (n_layers, bsz, kvh, hs), plane.dtype, dev)
    check_operand("pos", pos, (bsz,), torch.int32, dev)
    if valid is not None:
        check_operand("valid", valid, (bsz,), torch.int32, dev)
    fn = _build.bind("cache", "kv_write_rows", "pppp" + "iiiii" + "p")
    rc = fn(plane.data_ptr(), rows.data_ptr(), pos.data_ptr(),
            0 if valid is None else valid.data_ptr(), bsz, n_layers, kvh, s,
            hs * plane.element_size(), _stream())
    _build.check(rc, "cache", "kv_write_rows")
    _count(kv_write_rows, plane.dtype == torch.int8)
    return plane


kv_write_rows.launches = 0
kv_write_rows.launches_int8 = 0


def scale_write_rows_plain(plane, srows, pos):
    """Plain version of `scale_write_rows` (the XLA `_write_scale_rows`,
    hip_llama_tpu/models/llama.py:494-503, with K2's position rule)."""
    return _put_step_rows(plane, srows, pos)


def scale_write_rows(plane, srows, pos):
    """Write one decode step's row scales, srows (L, B, KVH) fp32 (from
    quantize_kv_rows), into one scale plane (B, L, KVH, S) of an int8 cache
    in place at (b, :, :, pos[b]); one launch. A position outside [0, S)
    writes nothing. Replaces hip_llama_tpu/ops/cache.py::scale_write_rows."""
    if plane.dim() != 4:
        raise ValueError(f"scale plane: expected (B, L, KVH, S), got {tuple(plane.shape)}")
    bsz, n_layers, kvh, s = plane.shape
    dev = plane.device
    check_operand("plane", plane, (bsz, n_layers, kvh, s), torch.float32, dev)
    if dev.type == "cpu":
        return scale_write_rows_plain(plane, srows, pos)
    if dev.type != "cuda":
        raise ValueError(f"scale_write_rows: unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"scale plane on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    check_operand("srows", srows, (n_layers, bsz, kvh), torch.float32, dev)
    check_operand("pos", pos, (bsz,), torch.int32, dev)
    fn = _build.bind("cache", "scale_write_rows", "ppp" + "iiii" + "p")
    rc = fn(plane.data_ptr(), srows.data_ptr(), pos.data_ptr(), bsz, n_layers, kvh, s, _stream())
    _build.check(rc, "cache", "scale_write_rows")
    scale_write_rows.launches += 1
    return plane


scale_write_rows.launches = 0


# ---------------------------------------------------------------------------
# K3: one layer's prefill chunk; K12: its scales on an int8 cache


def _chunk_targets(t: int, s: int, start, valid):
    """(slot, chunk row, cache position) of the rows a chunk writer keeps:
    row j of slot b lands at start[b] + j iff j < valid[b] and 0 <=
    start[b] + j < S."""
    j = torch.arange(t, device=start.device)
    tgt = start[:, None].long() + j[None, :]  # (B, T)
    keep = (j[None, :] < valid[:, None]) & (tgt < s) & (tgt >= 0)
    bi, ti = torch.nonzero(keep, as_tuple=True)
    return bi, ti, tgt[bi, ti]


def kv_write_chunk_plain(cache, k_rows, v_rows, layer: int, start, valid):
    """Plain version of `kv_write_chunk` (the `scatter_kv_chunk` semantics,
    hip_llama_tpu/models/llama.py:390-410): row j of slot b lands at
    start[b] + j iff j < valid[b] and start[b] + j < S."""
    bi, ti, pi = _chunk_targets(k_rows.shape[1], cache.k.shape[3], start, valid)
    for plane, rows in ((cache.k, k_rows), (cache.v, v_rows)):
        plane[bi, layer, :, pi] = rows[bi, ti].to(plane.dtype)
    return cache


def kv_write_chunk(cache, k_rows, v_rows, layer: int, start, valid):
    """Write one layer's prefill chunk, k_rows/v_rows (B, T, KVH, HS) in the
    cache's dtype (int8 rows from quantize_kv_rows on an int8 cache), into
    the cache in place: row j of slot b goes to position start[b] + j iff
    j < valid[b] and start[b] + j < S; every other row keeps its value
    (valid[b] == 0 makes slot b a bystander). One launch per layer writes
    K and V together. Replaces hip_llama_tpu/ops/cache.py::kv_write_chunk."""
    bsz, n_layers, kvh, s, hs = check_cache(cache.k, cache.v)
    dev = cache.k.device
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range [0, {n_layers})")
    if dev.type == "cpu":
        return kv_write_chunk_plain(cache, k_rows, v_rows, layer, start, valid)
    if dev.type != "cuda":
        raise ValueError(f"kv_write_chunk: unsupported device {dev}")
    t = k_rows.shape[1]
    for name, r in (("k_rows", k_rows), ("v_rows", v_rows)):
        check_operand(name, r, (bsz, t, kvh, hs), cache.k.dtype, dev)
    check_operand("start", start, (bsz,), torch.int32, dev)
    check_operand("valid", valid, (bsz,), torch.int32, dev)
    fn = _build.bind("cache", "kv_write_chunk", "pppppp" + "iiiiiii" + "p")
    rc = fn(cache.k.data_ptr(), cache.v.data_ptr(), k_rows.data_ptr(),
            v_rows.data_ptr(), start.data_ptr(), valid.data_ptr(),
            bsz, n_layers, kvh, s, hs * cache.k.element_size(), t, layer, _stream())
    _build.check(rc, "cache", "kv_write_chunk")
    _count(kv_write_chunk, cache.k.dtype == torch.int8)
    return cache


kv_write_chunk.launches = 0
kv_write_chunk.launches_int8 = 0


def scale_write_chunk_plain(cache, k_srows, v_srows, layer: int, start, valid):
    """Plain version of `scale_write_chunk` (the `scatter_scale_chunk`
    semantics, hip_llama_tpu/models/llama.py:413-422): the scales of row j
    of slot b land at start[b] + j iff j < valid[b] and start[b] + j < S."""
    bi, ti, pi = _chunk_targets(k_srows.shape[1], cache.k_scale.shape[3], start, valid)
    for plane, srows in ((cache.k_scale, k_srows), (cache.v_scale, v_srows)):
        plane[bi, layer, :, pi] = srows[bi, ti].float()
    return cache


def scale_write_chunk(cache, k_srows, v_srows, layer: int, start, valid):
    """Write one layer's prefill-chunk scales, k_srows/v_srows (B, T, KVH)
    fp32 (from quantize_kv_rows), into an int8 cache's scale planes in
    place, with kv_write_chunk's rule: row j of slot b goes to start[b] + j
    iff j < valid[b] and start[b] + j < S; every other scale keeps its
    value. One launch writes both planes. Replaces hip_llama_tpu/ops/
    cache.py::scale_write_chunk (which the JAX prefill calls once per
    plane)."""
    bsz, n_layers, kvh, s, _ = check_cache(cache.k, cache.v)
    if not check_scales(cache.k, getattr(cache, "k_scale", None), getattr(cache, "v_scale", None)):
        raise ValueError("scale_write_chunk takes an int8 cache")
    dev = cache.k.device
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range [0, {n_layers})")
    if dev.type == "cpu":
        return scale_write_chunk_plain(cache, k_srows, v_srows, layer, start, valid)
    if dev.type != "cuda":
        raise ValueError(f"scale_write_chunk: unsupported device {dev}")
    t = k_srows.shape[1]
    for name, r in (("k_srows", k_srows), ("v_srows", v_srows)):
        check_operand(name, r, (bsz, t, kvh), torch.float32, dev)
    check_operand("start", start, (bsz,), torch.int32, dev)
    check_operand("valid", valid, (bsz,), torch.int32, dev)
    fn = _build.bind("cache", "scale_write_chunk", "pppppp" + "iiiiii" + "p")
    rc = fn(cache.k_scale.data_ptr(), cache.v_scale.data_ptr(), k_srows.data_ptr(),
            v_srows.data_ptr(), start.data_ptr(), valid.data_ptr(),
            bsz, n_layers, kvh, s, t, layer, _stream())
    _build.check(rc, "cache", "scale_write_chunk")
    scale_write_chunk.launches += 1
    return cache


scale_write_chunk.launches = 0


# ---------------------------------------------------------------------------
# the paged pool: K11 and K10, one decode step's rows and scales; K13 and
# K14, one layer's prefill chunk and its scales


def _row_slots(pos, page_table, ps: int):
    """(slot, page, offset) of each slot's row at pos[b]: page table[b, pos[b]
    // PS]; a position outside the table writes nothing."""
    keep = (pos >= 0) & (pos < page_table.shape[1] * ps)
    bi = torch.nonzero(keep).flatten()
    p = pos[bi].long()
    return bi, page_table[bi, p // ps].long(), p % ps


def kv_write_rows_paged_plain(cache, k_rows, v_rows, page_table, pos):
    """Plain version of `kv_write_rows_paged` (the XLA `_write_kv_rows_paged`
    of hip_llama_tpu/models/paged.py:79-101): pages[:, :, table[b, pos[b] //
    PS], pos[b] % PS] = rows[:, b] for each slot b."""
    bi, page, off = _row_slots(pos, page_table, cache.k.shape[3])
    for plane, rows in ((cache.k, k_rows), (cache.v, v_rows)):
        plane[:, :, page, off] = rows[:, bi].to(plane.dtype).transpose(1, 2)
    return cache


def kv_write_rows_paged(cache, k_rows, v_rows, page_table, pos):
    """Write one decode step's rows, k_rows/v_rows (L, B, KVH, HS) in the
    pages' dtype (int8 rows from quantize_kv_rows on int8 pages), into the
    paged pool in place: layer l, head g of slot b lands in page table[b,
    pos[b] // PS] at offset pos[b] % PS, for every slot (an idle slot's
    table names the trash page). One launch writes K and V for all layers.
    Replaces hip_llama_tpu/ops/cache.py::kv_write_rows_paged (one plane per
    call there). A position past the table writes nothing."""
    n_layers, kvh, n_pages, ps, hs = check_pages(cache.k, cache.v)
    dev = cache.k.device
    if dev.type == "cpu":
        return kv_write_rows_paged_plain(cache, k_rows, v_rows, page_table, pos)
    if dev.type != "cuda":
        raise ValueError(f"kv_write_rows_paged: unsupported device {dev}")
    bsz = k_rows.shape[1]
    for name, r in (("k_rows", k_rows), ("v_rows", v_rows)):
        check_operand(name, r, (n_layers, bsz, kvh, hs), cache.k.dtype, dev)
    max_pages = check_table(page_table, bsz, dev)
    check_operand("pos", pos, (bsz,), torch.int32, dev)
    fn = _build.bind("cache", "kv_write_rows_paged", "pppppp" + "iiiiiii" + "p")
    rc = fn(cache.k.data_ptr(), cache.v.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
            page_table.data_ptr(), pos.data_ptr(), bsz, n_layers, kvh, n_pages, ps, max_pages,
            hs * cache.k.element_size(), _stream())
    _build.check(rc, "cache", "kv_write_rows_paged")
    _count(kv_write_rows_paged, cache.k.dtype == torch.int8)
    return cache


kv_write_rows_paged.launches = 0
kv_write_rows_paged.launches_int8 = 0


def scale_write_rows_paged_plain(cache, k_srows, v_srows, page_table, pos):
    """Plain version of `scale_write_rows_paged` (the XLA
    `_write_scale_rows_paged`, hip_llama_tpu/models/paged.py:104-122)."""
    bi, page, off = _row_slots(pos, page_table, cache.k.shape[3])
    for plane, srows in ((cache.k_scale, k_srows), (cache.v_scale, v_srows)):
        plane[:, :, page, off] = srows[:, bi].float().transpose(1, 2)
    return cache


def scale_write_rows_paged(cache, k_srows, v_srows, page_table, pos):
    """Write one decode step's row scales, k_srows/v_srows (L, B, KVH) fp32
    (from quantize_kv_rows), into int8 pages' scale planes in place, at
    kv_write_rows_paged's slots. One launch writes both planes. Replaces
    hip_llama_tpu/ops/cache.py::scale_write_rows_paged."""
    n_layers, kvh, n_pages, ps, _ = check_pages(cache.k, cache.v)
    if not check_scales(cache.k, getattr(cache, "k_scale", None), getattr(cache, "v_scale", None)):
        raise ValueError("scale_write_rows_paged takes int8 pages")
    dev = cache.k.device
    if dev.type == "cpu":
        return scale_write_rows_paged_plain(cache, k_srows, v_srows, page_table, pos)
    if dev.type != "cuda":
        raise ValueError(f"scale_write_rows_paged: unsupported device {dev}")
    bsz = k_srows.shape[1]
    for name, r in (("k_srows", k_srows), ("v_srows", v_srows)):
        check_operand(name, r, (n_layers, bsz, kvh), torch.float32, dev)
    max_pages = check_table(page_table, bsz, dev)
    check_operand("pos", pos, (bsz,), torch.int32, dev)
    fn = _build.bind("cache", "scale_write_rows_paged", "pppppp" + "iiiiii" + "p")
    rc = fn(cache.k_scale.data_ptr(), cache.v_scale.data_ptr(), k_srows.data_ptr(),
            v_srows.data_ptr(), page_table.data_ptr(), pos.data_ptr(), bsz, n_layers, kvh,
            n_pages, ps, max_pages, _stream())
    _build.check(rc, "cache", "scale_write_rows_paged")
    scale_write_rows_paged.launches += 1
    return cache


scale_write_rows_paged.launches = 0


def _chunk_slots(t: int, page_table, ps: int, start, valid):
    """(slot, chunk row, page) of the rows a paged chunk writer keeps: row j
    of slot b lands in page table[b, start[b] // PS] at offset j iff j <
    valid[b] (and start[b] lies inside the table)."""
    j = torch.arange(t, device=start.device)
    keep = (j[None, :] < valid[:, None]) & ((start >= 0) & (start < page_table.shape[1] * ps))[:, None]
    bi, ti = torch.nonzero(keep, as_tuple=True)
    return bi, ti, page_table[bi, start[bi].long() // ps].long()


def kv_write_chunk_paged_plain(cache, k_rows, v_rows, layer: int, page_table, start, valid):
    """Plain version of `kv_write_chunk_paged` (the XLA merge of
    hip_llama_tpu/models/paged.py:333-356)."""
    bi, ti, page = _chunk_slots(k_rows.shape[1], page_table, cache.k.shape[3], start, valid)
    for plane, rows in ((cache.k, k_rows), (cache.v, v_rows)):
        plane[layer][:, page, ti] = rows[bi, ti].to(plane.dtype).transpose(0, 1)
    return cache


def _check_chunk(cache, layer: int, t: int):
    n_layers, kvh, n_pages, ps, hs = check_pages(cache.k, cache.v)
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range [0, {n_layers})")
    if t > ps:
        raise ValueError(f"a paged chunk of {t} rows must fit one page of {ps}")
    return n_layers, kvh, n_pages, ps, hs


def kv_write_chunk_paged(cache, k_rows, v_rows, layer: int, page_table, start, valid):
    """Write one layer's prefill chunk, k_rows/v_rows (B, T, KVH, HS) in the
    pages' dtype (int8 rows from quantize_kv_rows on int8 pages), T <= PS,
    into the paged pool in place: row j of slot b goes to page table[b,
    start[b] // PS] at offset j iff j < valid[b] (the chunk starts on a page
    boundary); every other row keeps its value (valid[b] == 0 makes slot b
    a bystander). One launch per layer writes K and V. Replaces
    hip_llama_tpu/ops/cache.py::kv_write_chunk_paged."""
    _, kvh, n_pages, ps, hs = _check_chunk(cache, layer, k_rows.shape[1])
    dev = cache.k.device
    if dev.type == "cpu":
        return kv_write_chunk_paged_plain(cache, k_rows, v_rows, layer, page_table, start, valid)
    if dev.type != "cuda":
        raise ValueError(f"kv_write_chunk_paged: unsupported device {dev}")
    bsz, t = k_rows.shape[:2]
    for name, r in (("k_rows", k_rows), ("v_rows", v_rows)):
        check_operand(name, r, (bsz, t, kvh, hs), cache.k.dtype, dev)
    max_pages = check_table(page_table, bsz, dev)
    check_operand("start", start, (bsz,), torch.int32, dev)
    check_operand("valid", valid, (bsz,), torch.int32, dev)
    fn = _build.bind("cache", "kv_write_chunk_paged", "ppppppp" + "iiiiiiii" + "p")
    rc = fn(cache.k.data_ptr(), cache.v.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
            page_table.data_ptr(), start.data_ptr(), valid.data_ptr(), bsz, kvh, n_pages, ps,
            max_pages, hs * cache.k.element_size(), t, layer, _stream())
    _build.check(rc, "cache", "kv_write_chunk_paged")
    _count(kv_write_chunk_paged, cache.k.dtype == torch.int8)
    return cache


kv_write_chunk_paged.launches = 0
kv_write_chunk_paged.launches_int8 = 0


def scale_write_chunk_paged_plain(cache, k_srows, v_srows, layer: int, page_table, start, valid):
    """Plain version of `scale_write_chunk_paged` (the XLA merge of
    hip_llama_tpu/models/paged.py:358-377)."""
    bi, ti, page = _chunk_slots(k_srows.shape[1], page_table, cache.k.shape[3], start, valid)
    for plane, srows in ((cache.k_scale, k_srows), (cache.v_scale, v_srows)):
        plane[layer][:, page, ti] = srows[bi, ti].float().t()
    return cache


def scale_write_chunk_paged(cache, k_srows, v_srows, layer: int, page_table, start, valid):
    """Write one layer's prefill-chunk scales, k_srows/v_srows (B, T, KVH)
    fp32 (from quantize_kv_rows), into int8 pages' scale planes in place,
    with kv_write_chunk_paged's rule. One launch writes both planes.
    Replaces hip_llama_tpu/ops/cache.py::scale_write_chunk_paged."""
    _, kvh, n_pages, ps, _ = _check_chunk(cache, layer, k_srows.shape[1])
    if not check_scales(cache.k, getattr(cache, "k_scale", None), getattr(cache, "v_scale", None)):
        raise ValueError("scale_write_chunk_paged takes int8 pages")
    dev = cache.k.device
    if dev.type == "cpu":
        return scale_write_chunk_paged_plain(cache, k_srows, v_srows, layer, page_table, start,
                                             valid)
    if dev.type != "cuda":
        raise ValueError(f"scale_write_chunk_paged: unsupported device {dev}")
    bsz, t = k_srows.shape[:2]
    for name, r in (("k_srows", k_srows), ("v_srows", v_srows)):
        check_operand(name, r, (bsz, t, kvh), torch.float32, dev)
    max_pages = check_table(page_table, bsz, dev)
    check_operand("start", start, (bsz,), torch.int32, dev)
    check_operand("valid", valid, (bsz,), torch.int32, dev)
    fn = _build.bind("cache", "scale_write_chunk_paged", "ppppppp" + "iiiiiii" + "p")
    rc = fn(cache.k_scale.data_ptr(), cache.v_scale.data_ptr(), k_srows.data_ptr(),
            v_srows.data_ptr(), page_table.data_ptr(), start.data_ptr(), valid.data_ptr(), bsz,
            kvh, n_pages, ps, max_pages, t, layer, _stream())
    _build.check(rc, "cache", "scale_write_chunk_paged")
    scale_write_chunk_paged.launches += 1
    return cache


scale_write_chunk_paged.launches = 0

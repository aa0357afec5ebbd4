"""In-place KV cache writers: the decode step's row commit (K2) and the
prefill chunk writer (K3).

The cache is the reference layout (B, L, KVH, S, HS) in fp32 or bf16, held
by any object with `.k` and `.v` tensors (models/llama.py::KVCache). Where
the JAX writers donate the cache and return a new one, these write the
tensors in place and return the same object.

Each writer is a CUDA kernel (csrc/cache.cu) behind a wrapper that checks
its operands and counts its launches in `<wrapper>.launches`. A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain PyTorch version
beside it, which is also the yardstick the kernel is held against on the
card.
"""

from __future__ import annotations

import torch

from hip_llama_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_cache(k: torch.Tensor, v: torch.Tensor) -> tuple[int, int, int, int, int]:
    """Validate a KV cache's two planes; returns (B, L, KVH, S, HS)."""
    if k.dim() != 5 or k.shape != v.shape:
        raise ValueError(f"cache planes must be (B, L, KVH, S, HS) alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"cache dtype must be float32 or bfloat16, got {k.dtype}/{v.dtype}")
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


def check_operand(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, cache on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.is_floating_point() and t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernels load 16-byte vectors; storage must be 16-byte aligned")


# ---------------------------------------------------------------------------
# K2: one decode step's K/V rows for every layer


def kv_commit_rows_plain(cache, k_rows, v_rows, pos, valid=None):
    """Plain version of `kv_commit_rows` (the XLA `_write_kv_rows` math,
    hip_llama_tpu/models/llama.py:425-454): cache[b, :, :, pos[b]] =
    rows[:, b] for each slot b with valid[b] != 0 and 0 <= pos[b] < S."""
    b, s = cache.k.shape[0], cache.k.shape[3]
    keep = (pos >= 0) & (pos < s)
    if valid is not None:
        keep &= valid != 0
    bi = torch.nonzero(keep).flatten()
    pi = pos[bi].long()
    for plane, rows in ((cache.k, k_rows), (cache.v, v_rows)):
        plane[bi, :, :, pi] = rows.permute(1, 0, 2, 3)[bi].to(plane.dtype)
    return cache


def kv_commit_rows(cache, k_rows, v_rows, pos, valid=None):
    """Write one decode step's rows, k_rows/v_rows (L, B, KVH, HS), into the
    cache in place at (b, :, :, pos[b]) for every layer, for each slot with
    valid[b] != 0 (default: all). One launch writes K and V. Replaces
    hip_llama_tpu/ops/cache.py::kv_commit_rows (dense branch). A position
    outside [0, S) writes nothing."""
    bsz, n_layers, kvh, s, hs = check_cache(cache.k, cache.v)
    dev = cache.k.device
    if dev.type == "cpu":
        return kv_commit_rows_plain(cache, k_rows, v_rows, pos, valid)
    if dev.type != "cuda":
        raise ValueError(f"kv_commit_rows: unsupported device {dev}")
    for name, t in (("k_rows", k_rows), ("v_rows", v_rows)):
        check_operand(name, t, (n_layers, bsz, kvh, hs), cache.k.dtype, dev)
    check_operand("pos", pos, (bsz,), torch.int32, dev)
    if valid is not None:
        check_operand("valid", valid, (bsz,), torch.int32, dev)
    fn = _build.bind("cache", "kv_commit_rows", "pppppp" + "iiiiii" + "p")
    rc = fn(cache.k.data_ptr(), cache.v.data_ptr(), k_rows.data_ptr(),
            v_rows.data_ptr(), pos.data_ptr(),
            0 if valid is None else valid.data_ptr(),
            bsz, n_layers, kvh, s, hs, _DTYPES[cache.k.dtype], _stream())
    _build.check(rc, "cache", "kv_commit_rows")
    kv_commit_rows.launches += 1
    return cache


kv_commit_rows.launches = 0


# ---------------------------------------------------------------------------
# K3: one layer's prefill chunk


def kv_write_chunk_plain(cache, k_rows, v_rows, layer: int, start, valid):
    """Plain version of `kv_write_chunk` (the `scatter_kv_chunk` semantics,
    hip_llama_tpu/models/llama.py:390-410): row j of slot b lands at
    start[b] + j iff j < valid[b] and start[b] + j < S."""
    t = k_rows.shape[1]
    s = cache.k.shape[3]
    j = torch.arange(t, device=start.device)
    tgt = start[:, None].long() + j[None, :]  # (B, T)
    keep = (j[None, :] < valid[:, None]) & (tgt < s) & (tgt >= 0)
    bi, ti = torch.nonzero(keep, as_tuple=True)
    pi = tgt[bi, ti]
    for plane, rows in ((cache.k, k_rows), (cache.v, v_rows)):
        plane[bi, layer, :, pi] = rows[bi, ti].to(plane.dtype)
    return cache


def kv_write_chunk(cache, k_rows, v_rows, layer: int, start, valid):
    """Write one layer's prefill chunk, k_rows/v_rows (B, T, KVH, HS), into
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
    fn = _build.bind("cache", "kv_write_chunk", "pppppp" + "iiiiiiii" + "p")
    rc = fn(cache.k.data_ptr(), cache.v.data_ptr(), k_rows.data_ptr(),
            v_rows.data_ptr(), start.data_ptr(), valid.data_ptr(),
            bsz, n_layers, kvh, s, hs, t, layer, _DTYPES[cache.k.dtype],
            _stream())
    _build.check(rc, "cache", "kv_write_chunk")
    kv_write_chunk.launches += 1
    return cache


kv_write_chunk.launches = 0

"""llama2.c checkpoint formats: v0 (legacy), v1 (fp32 "ak42"), v2 (Q8_0) and
v4 (int4).

Byte layouts re-derived from the reference:
- v0: 7-int32 header {dim, hidden_dim, n_layers, n_heads, n_kv_heads,
  vocab_size, seq_len}; negative vocab_size signals an unshared classifier;
  fp32 tensors in fixed order; two legacy freq_cis blocks are skipped before
  wcls (reference: src/utils.cpp:119-170, writer train/export.py:75-127).
- v1: magic 0x616b3432 ("ak42"), version=1, same 7 ints, shared_classifier
  byte, zero-pad to a 256-byte header; fp32 tensors with all norms first
  (reference: train/export.py:132-180).
- v2: same 256-byte header plus group_size int32; norms fp32 first, then each
  weight as [int8 values][fp32 per-group scales] (reference: runq.c:189-251,
  train/export.py:182-260).

- v4: the same 256-byte header plus group_size int32; norms fp32 first,
  then the embedding as Q8_0 rows (group size 64), then each weight stacked
  over the layers in matmul orientation as [packed int4 nibbles (L, K/2,
  N)][fp32 scales (L, K/gs, N)], the classifier last (the JAX package's
  format, hip_llama_tpu/io/checkpoint.py:351-400, :540-579).

All 2-D weights of v0-v2 are stored row-major as (out_features, in_features),
matching the reference's `matmul` W(d,n) @ x(n) convention
(src/seq.cpp:40-51). This module keeps that orientation; models/params.py
transposes into (in, out) for `x @ W`. v4 weights are already (in, out).
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import BinaryIO

import numpy as np

from hip_llama_tpu_torch.config import ModelConfig

MAGIC_AK42 = 0x616B3432
HEADER_SIZE_V12 = 256
V4_EMB_GROUP = 64  # embedding rows stay Q8_0 in v4 files


@dataclasses.dataclass
class LlamaWeights:
    """fp32 weights in file orientation: 2-D arrays are (out, in)."""

    tok_emb: np.ndarray  # (V, D)
    rms_att: np.ndarray  # (L, D)
    wq: np.ndarray  # (L, D, D)
    wk: np.ndarray  # (L, kv_dim, D)
    wv: np.ndarray  # (L, kv_dim, D)
    wo: np.ndarray  # (L, D, D)
    rms_ffn: np.ndarray  # (L, D)
    w1: np.ndarray  # (L, H, D)
    w2: np.ndarray  # (L, D, H)
    w3: np.ndarray  # (L, H, D)
    rms_final: np.ndarray  # (D,)
    wcls: np.ndarray  # (V, D); aliases tok_emb when shared


@dataclasses.dataclass
class QuantTensor:
    """Q8_0 tensor: int8 values + fp32 scale per `group_size` values.

    float value[i] = q[i] * s[i // group_size]  (reference: runq.c:139-143).
    """

    q: np.ndarray  # int8, flat or original shape
    s: np.ndarray  # float32, numel(q) // group_size

    def dequantize(self, group_size: int) -> np.ndarray:
        q = self.q.reshape(-1)
        return (
            q.astype(np.float32).reshape(-1, group_size) * self.s.reshape(-1, 1)
        ).reshape(self.q.shape)


@dataclasses.dataclass
class QuantWeights:
    """v2 Q8_0 checkpoint contents (norms fp32, weights quantized), in file
    orientation: each per-layer weight is (out, in) with groups along in."""

    rms_att: np.ndarray
    rms_ffn: np.ndarray
    rms_final: np.ndarray
    q_tokens: QuantTensor  # (V, D)
    wq: list[QuantTensor]  # per layer, (D, D)
    wk: list[QuantTensor]
    wv: list[QuantTensor]
    wo: list[QuantTensor]
    w1: list[QuantTensor]
    w2: list[QuantTensor]
    w3: list[QuantTensor]
    wcls: QuantTensor  # aliases q_tokens when shared


@dataclasses.dataclass
class Q4Tensorfile:
    """One v4 int4 weight in matmul orientation: q (..., K/2, N) int8 packed
    nibbles (byte k' holds row k' in its low nibble and row K/2 + k' in its
    high nibble, each as the code + 8), s (..., K/gs, N) fp32 — the layout
    of ops/quant4.py::Q4Tensor."""

    q: np.ndarray
    s: np.ndarray


@dataclasses.dataclass
class Q4Weights:
    """v4 int4 checkpoint contents: norms fp32, the embedding as Q8_0 rows,
    every matmul weight stacked over the layers in matmul orientation."""

    rms_att: np.ndarray  # (L, D) f32
    rms_ffn: np.ndarray
    rms_final: np.ndarray
    emb_q: np.ndarray  # (V, D) int8 (Q8_0 rows)
    emb_s: np.ndarray  # (V, D // V4_EMB_GROUP) f32
    wq: Q4Tensorfile  # (L, D/2, D)
    wk: Q4Tensorfile  # (L, D/2, KV)
    wv: Q4Tensorfile
    wo: Q4Tensorfile
    w1: Q4Tensorfile  # (L, D/2, H)
    w2: Q4Tensorfile  # (L, H/2, D)
    w3: Q4Tensorfile
    wcls: Q4Tensorfile  # (D/2, V), never aliased to the int8 embedding


def q4_group_size(k: int, group_size: int) -> int:
    """The group size along a contraction of `k` rows: each half of the
    half-split packing must hold whole groups, so a K/2 that the requested
    size does not divide takes their gcd (every Llama-2 width keeps it)."""
    return group_size if (k // 2) % group_size == 0 else math.gcd(k // 2, group_size)


def quantize_q40(w: np.ndarray, group_size: int) -> tuple[np.ndarray, np.ndarray, float]:
    """Symmetric int4 group quantization of a matmul-oriented (..., K, N)
    array: scale = absmax / 7 (a true fp32 division; 1 where a group is all
    zeros), codes round-half-even(w / scale) clipped to [-8, 7], packed
    half-split along K as code + 8. Returns (packed int8, fp32 scales, max
    abs error); bit for bit ops/quant4.py::q4_quantize_weights."""
    w = np.asarray(w, np.float32)
    k, n = w.shape[-2], w.shape[-1]
    gs = q4_group_size(k, group_size)
    lead = w.shape[:-2]
    g = w.reshape(*lead, k // gs, gs, n)
    scale = np.abs(g).max(axis=-2, keepdims=True) / 7.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(g / scale), -8, 7)
    maxerr = float(np.abs(q * scale - g).max()) if g.size else 0.0
    nib = (q.astype(np.int32) + 8).reshape(*lead, k, n)
    packed = nib[..., : k // 2, :] | (nib[..., k // 2 :, :] << 4)
    return (packed.astype(np.uint8).astype(np.int8),
            np.ascontiguousarray(scale[..., 0, :], np.float32), maxerr)


def quantize_q80(w: np.ndarray, group_size: int) -> tuple[np.ndarray, np.ndarray, float]:
    """Symmetric int8 group quantization, scale = absmax/127; returns
    (int8 values, fp32 scales, max abs error). Matches train/export.py:46-70
    and runq.c:145-171 (round half to even, as np.round)."""
    flat = w.astype(np.float32).reshape(-1, group_size)
    wmax = np.abs(flat).max(axis=1)
    scale = wmax / 127.0
    scale_safe = np.where(scale == 0.0, 1.0, scale)
    int8val = np.round(flat / scale_safe[:, None]).astype(np.int8)
    fp32val = int8val.astype(np.float32) * scale[:, None]
    maxerr = float(np.abs(fp32val - flat).max()) if flat.size else 0.0
    return int8val.reshape(w.shape), scale.astype(np.float32), maxerr


def dequantize(qt: QuantTensor, group_size: int) -> np.ndarray:
    return qt.dequantize(group_size)


def _shapes(c: ModelConfig) -> dict[str, tuple[int, ...]]:
    return {
        "tok_emb": (c.vocab_size, c.dim),
        "rms_att": (c.n_layers, c.dim),
        "wq": (c.n_layers, c.dim, c.dim),
        "wk": (c.n_layers, c.kv_dim, c.dim),
        "wv": (c.n_layers, c.kv_dim, c.dim),
        "wo": (c.n_layers, c.dim, c.dim),
        "rms_ffn": (c.n_layers, c.dim),
        "w1": (c.n_layers, c.hidden_dim, c.dim),
        "w2": (c.n_layers, c.dim, c.hidden_dim),
        "w3": (c.n_layers, c.hidden_dim, c.dim),
        "rms_final": (c.dim,),
    }


_V0_ORDER = ("tok_emb", "rms_att", "wq", "wk", "wv", "wo", "rms_ffn",
             "w1", "w2", "w3", "rms_final")
_V1_ORDER = ("rms_att", "rms_ffn", "rms_final", "tok_emb", "wq", "wk", "wv",
             "wo", "w1", "w2", "w3")


def _take(data: np.ndarray, cfg: ModelConfig, order, skip_after: int = 0
          ) -> dict[str, np.ndarray]:
    """Slice the named tensors out of a flat fp32 memmap in `order`, then
    `skip_after` floats, then wcls (aliasing tok_emb when shared)."""
    shapes = _shapes(cfg)
    out: dict[str, np.ndarray] = {}
    off = 0
    for name in order:
        n = int(np.prod(shapes[name]))
        out[name] = np.asarray(data[off : off + n]).reshape(shapes[name])
        off += n
    off += skip_after
    if cfg.shared_classifier:
        out["wcls"] = out["tok_emb"]
    else:
        n = cfg.vocab_size * cfg.dim
        out["wcls"] = np.asarray(data[off : off + n]).reshape(cfg.vocab_size, cfg.dim)
    return out


def read_v0(path: str) -> tuple[ModelConfig, LlamaWeights]:
    """Read a legacy v0 checkpoint via zero-copy memmap (src/utils.cpp:150-170)."""
    with open(path, "rb") as f:
        dim, hidden, n_layers, n_heads, n_kv_heads, vocab, seq_len = struct.unpack(
            "7i", f.read(28)
        )
    cfg = ModelConfig(
        dim=dim, hidden_dim=hidden, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv_heads, vocab_size=abs(vocab), seq_len=seq_len,
        shared_classifier=vocab > 0,
    )
    data = np.memmap(path, dtype=np.float32, mode="r", offset=28)
    # skip legacy freq_cis_real / freq_cis_imag (src/utils.cpp:145-146)
    return cfg, LlamaWeights(**_take(data, cfg, _V0_ORDER, cfg.seq_len * cfg.head_size))


def _read_header_v12(path: str, want_version: int) -> ModelConfig:
    """The 256-byte ak42 header of a v1, v2 or v4 file (v2 and v4 add
    group_size)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("Ii", f.read(8))
        if magic != MAGIC_AK42:
            raise ValueError(f"bad magic 0x{magic:08x}, expected 'ak42'")
        if version != want_version:
            raise ValueError(f"bad version {version}, expected {want_version}")
        dim, hidden, n_layers, n_heads, n_kv_heads, vocab, seq_len = struct.unpack(
            "7i", f.read(28)
        )
        shared = struct.unpack("B", f.read(1))[0]
        group_size = struct.unpack("i", f.read(4))[0] if want_version in (2, 4) else 0
    return ModelConfig(
        dim=dim, hidden_dim=hidden, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv_heads, vocab_size=vocab, seq_len=seq_len,
        shared_classifier=bool(shared), group_size=group_size or None,
    )


def read_v1(path: str) -> tuple[ModelConfig, LlamaWeights]:
    """Read a v1 fp32 checkpoint (train/export.py:132-180 layout)."""
    cfg = _read_header_v12(path, 1)
    data = np.memmap(path, dtype=np.float32, mode="r", offset=HEADER_SIZE_V12)
    return cfg, LlamaWeights(**_take(data, cfg, _V1_ORDER))


def read_v2(path: str) -> tuple[ModelConfig, QuantWeights]:
    """Read a v2 Q8_0 checkpoint (runq.c:189-251 layout), zero-copy."""
    cfg = _read_header_v12(path, 2)
    c, gs = cfg, cfg.group_size
    raw = np.memmap(path, dtype=np.uint8, mode="r", offset=HEADER_SIZE_V12)
    off = 0

    def take(dtype, n: int) -> np.ndarray:
        nonlocal off
        nbytes = n * np.dtype(dtype).itemsize
        arr = np.frombuffer(raw[off : off + nbytes], dtype=dtype)
        off += nbytes
        return arr

    def take_quant(shape) -> QuantTensor:
        n = int(np.prod(shape))
        q = take(np.int8, n).reshape(shape)
        return QuantTensor(q=q, s=take(np.float32, n // gs))

    norms = {name: take(np.float32, int(np.prod(shape))).reshape(shape) for name, shape in (
        ("rms_att", (c.n_layers, c.dim)), ("rms_ffn", (c.n_layers, c.dim)),
        ("rms_final", (c.dim,)))}
    q_tokens = take_quant((c.vocab_size, c.dim))
    layers = {name: [take_quant(shape) for _ in range(c.n_layers)] for name, shape in (
        ("wq", (c.dim, c.dim)), ("wk", (c.kv_dim, c.dim)), ("wv", (c.kv_dim, c.dim)),
        ("wo", (c.dim, c.dim)), ("w1", (c.hidden_dim, c.dim)),
        ("w2", (c.dim, c.hidden_dim)), ("w3", (c.hidden_dim, c.dim)))}
    wcls = q_tokens if c.shared_classifier else take_quant((c.vocab_size, c.dim))
    return cfg, QuantWeights(**norms, q_tokens=q_tokens, **layers, wcls=wcls)


def read_v4(path: str) -> tuple[ModelConfig, Q4Weights]:
    """Read a v4 int4 checkpoint, zero-copy: the weights memmap in the packed
    layout the int4 kernels take."""
    cfg = _read_header_v12(path, 4)
    c, gs = cfg, cfg.group_size
    raw = np.memmap(path, dtype=np.uint8, mode="r", offset=HEADER_SIZE_V12)
    off = 0

    def take(dtype, shape) -> np.ndarray:
        nonlocal off
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        arr = np.frombuffer(raw[off : off + n], dtype=dtype).reshape(shape)
        off += n
        return arr

    def take_q4(k: int, n: int, lead=(c.n_layers,)) -> Q4Tensorfile:
        q = take(np.int8, (*lead, k // 2, n))
        return Q4Tensorfile(q=q, s=take(np.float32, (*lead, k // q4_group_size(k, gs), n)))

    norms = {name: take(np.float32, shape) for name, shape in (
        ("rms_att", (c.n_layers, c.dim)), ("rms_ffn", (c.n_layers, c.dim)),
        ("rms_final", (c.dim,)))}
    emb_q = take(np.int8, (c.vocab_size, c.dim))
    emb_s = take(np.float32, (c.vocab_size, c.dim // V4_EMB_GROUP))
    layers = {name: take_q4(k, n) for name, k, n in (
        ("wq", c.dim, c.dim), ("wk", c.dim, c.kv_dim), ("wv", c.dim, c.kv_dim),
        ("wo", c.dim, c.dim), ("w1", c.dim, c.hidden_dim), ("w2", c.hidden_dim, c.dim),
        ("w3", c.dim, c.hidden_dim))}
    wcls = take_q4(c.dim, c.vocab_size, lead=())
    return cfg, Q4Weights(**norms, emb_q=emb_q, emb_s=emb_s, **layers, wcls=wcls)


def sniff_version(path: str) -> int:
    """Return 0, 1, 2, or 4 depending on the checkpoint format."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("Ii", f.read(8))
    return version if magic == MAGIC_AK42 else 0


def load_checkpoint(path: str) -> tuple[ModelConfig, LlamaWeights | QuantWeights | Q4Weights]:
    """Dispatch on format; returns (config, LlamaWeights | QuantWeights |
    Q4Weights)."""
    v = sniff_version(path)
    if v == 0:
        return read_v0(path)
    if v == 1:
        return read_v1(path)
    if v == 2:
        return read_v2(path)
    if v == 4:
        return read_v4(path)
    raise ValueError(f"unsupported checkpoint version {v}")


# ---------------------------------------------------------------------------
# writers (parity with train/export.py)


def _f32(f: BinaryIO, arr: np.ndarray) -> None:
    f.write(np.ascontiguousarray(arr, dtype=np.float32).tobytes())


def write_v0(path: str, cfg: ModelConfig, w: LlamaWeights) -> None:
    with open(path, "wb") as f:
        vocab = cfg.vocab_size if cfg.shared_classifier else -cfg.vocab_size
        f.write(struct.pack("7i", cfg.dim, cfg.hidden_dim, cfg.n_layers,
                            cfg.n_heads, cfg.n_kv_heads, vocab, cfg.seq_len))
        for name in _V0_ORDER:
            _f32(f, getattr(w, name))
        # legacy freq_cis blocks (skipped by readers but must occupy space)
        _f32(f, np.zeros(cfg.seq_len * cfg.head_size, dtype=np.float32))
        if not cfg.shared_classifier:
            _f32(f, w.wcls)


def _write_header_v12(f: BinaryIO, cfg: ModelConfig, version: int,
                      group_size: int | None = None) -> None:
    f.write(struct.pack("Ii", MAGIC_AK42, version))
    f.write(struct.pack("7i", cfg.dim, cfg.hidden_dim, cfg.n_layers,
                        cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size,
                        cfg.seq_len))
    f.write(struct.pack("B", int(cfg.shared_classifier)))
    if version in (2, 4):
        f.write(struct.pack("i", group_size))
    f.write(b"\0" * (HEADER_SIZE_V12 - f.tell()))


def write_v1(path: str, cfg: ModelConfig, w: LlamaWeights) -> None:
    with open(path, "wb") as f:
        _write_header_v12(f, cfg, 1)
        for name in _V1_ORDER:
            _f32(f, getattr(w, name))
        if not cfg.shared_classifier:
            _f32(f, w.wcls)


def write_v2(path: str, cfg: ModelConfig, w: LlamaWeights, group_size: int = 64) -> float:
    """Write Q8_0 (train/export.py:182-260); returns the max quantization
    group error. The group size halves until it divides dim."""
    while cfg.dim % group_size != 0:
        group_size //= 2
    maxerr = 0.0
    with open(path, "wb") as f:
        _write_header_v12(f, cfg, 2, group_size)
        for name in ("rms_att", "rms_ffn", "rms_final"):
            _f32(f, getattr(w, name))

        def q(arr: np.ndarray) -> None:
            nonlocal maxerr
            int8val, scale, err = quantize_q80(arr.reshape(arr.shape[0], -1), group_size)
            maxerr = max(maxerr, err)
            f.write(int8val.tobytes())
            f.write(scale.tobytes())

        q(w.tok_emb)
        for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
            for layer in getattr(w, name):
                q(layer)
        if not cfg.shared_classifier:
            q(w.wcls)
    return maxerr


def write_v4(path: str, cfg: ModelConfig, w: LlamaWeights, group_size: int = 32) -> float:
    """Write an int4 (v4) checkpoint from dense fp32 weights, byte for byte
    the JAX package's writer; returns the max quantization group error.
    Weights are transposed to matmul orientation (K = in, N = out) and
    packed as quantize_q40 does, so read_v4 loads them zero-copy."""
    if cfg.dim % V4_EMB_GROUP:
        # read_v4 sizes the embedding scales (V, D // 64): another dim would
        # shift every later tensor's offset
        raise ValueError(f"v4 checkpoints need dim divisible by {V4_EMB_GROUP} "
                         f"(Q8 embedding groups); got dim={cfg.dim}")
    maxerr = 0.0
    with open(path, "wb") as f:
        _write_header_v12(f, cfg, 4, group_size)
        for name in ("rms_att", "rms_ffn", "rms_final"):
            _f32(f, getattr(w, name))
        emb_q, emb_s, maxerr = quantize_q80(
            np.asarray(w.tok_emb, np.float32).reshape(-1, V4_EMB_GROUP), V4_EMB_GROUP)
        f.write(emb_q.tobytes())
        f.write(emb_s.tobytes())
        for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wcls"):
            packed, scale, err = quantize_q40(
                np.swapaxes(np.asarray(getattr(w, name), np.float32), -1, -2), group_size)
            maxerr = max(maxerr, err)
            f.write(np.ascontiguousarray(packed).tobytes())
            f.write(scale.tobytes())
    return maxerr


# ---------------------------------------------------------------------------
# fixtures


def random_weights(cfg: ModelConfig, seed: int = 0, scale: float | None = None) -> LlamaWeights:
    """Random weights for tests/benchmarks; scaled like a trained init. The
    same seed gives the same arrays as the JAX package's random_weights."""
    rng = np.random.default_rng(seed)
    c = cfg

    def mat(*shape, fan_in):
        s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
        return rng.normal(0.0, s, size=shape).astype(np.float32)

    tok_emb = mat(c.vocab_size, c.dim, fan_in=c.dim)
    w = LlamaWeights(
        tok_emb=tok_emb,
        rms_att=np.ones((c.n_layers, c.dim), np.float32)
        + rng.normal(0, 0.02, (c.n_layers, c.dim)).astype(np.float32),
        wq=mat(c.n_layers, c.dim, c.dim, fan_in=c.dim),
        wk=mat(c.n_layers, c.kv_dim, c.dim, fan_in=c.dim),
        wv=mat(c.n_layers, c.kv_dim, c.dim, fan_in=c.dim),
        wo=mat(c.n_layers, c.dim, c.dim, fan_in=c.dim),
        rms_ffn=np.ones((c.n_layers, c.dim), np.float32)
        + rng.normal(0, 0.02, (c.n_layers, c.dim)).astype(np.float32),
        w1=mat(c.n_layers, c.hidden_dim, c.dim, fan_in=c.dim),
        w2=mat(c.n_layers, c.dim, c.hidden_dim, fan_in=c.hidden_dim),
        w3=mat(c.n_layers, c.hidden_dim, c.dim, fan_in=c.dim),
        rms_final=np.ones((c.dim,), np.float32),
        wcls=tok_emb,
    )
    if not c.shared_classifier:
        w.wcls = mat(c.vocab_size, c.dim, fan_in=c.dim)
    return w

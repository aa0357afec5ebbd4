"""llama2.c checkpoint formats: v0 (legacy) and v1 (fp32 "ak42").

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

The int4 (v4) format belongs to a path this package has not ported yet:
`load_checkpoint` names it and raises.

All 2-D weights are stored row-major as (out_features, in_features), matching
the reference's `matmul` W(d,n) @ x(n) convention (src/seq.cpp:40-51). This
module keeps that orientation; models/params.py transposes into (in, out)
for `x @ W`.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO

import numpy as np

from hip_llama_tpu_torch.config import ModelConfig

MAGIC_AK42 = 0x616B3432
HEADER_SIZE_V12 = 256


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
    """The 256-byte ak42 header of a v1 or v2 file (v2 adds group_size)."""
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
        group_size = struct.unpack("i", f.read(4))[0] if want_version == 2 else 0
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


def sniff_version(path: str) -> int:
    """Return 0, 1, 2, or 4 depending on the checkpoint format."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("Ii", f.read(8))
    return version if magic == MAGIC_AK42 else 0


def load_checkpoint(path: str) -> tuple[ModelConfig, LlamaWeights | QuantWeights]:
    """Dispatch on format; returns (config, LlamaWeights | QuantWeights)."""
    v = sniff_version(path)
    if v == 0:
        return read_v0(path)
    if v == 1:
        return read_v1(path)
    if v == 2:
        return read_v2(path)
    if v == 4:
        raise NotImplementedError(
            "v4 (int4) checkpoints are not yet ported to hip_llama_tpu_torch; "
            "use a v0/v1 fp32 or a v2 Q8_0 checkpoint"
        )
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
    if version == 2:
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

"""llama2.c checkpoint formats: v0 (legacy) and v1 (fp32 "ak42").

Byte layouts re-derived from the reference:
- v0: 7-int32 header {dim, hidden_dim, n_layers, n_heads, n_kv_heads,
  vocab_size, seq_len}; negative vocab_size signals an unshared classifier;
  fp32 tensors in fixed order; two legacy freq_cis blocks are skipped before
  wcls (reference: src/utils.cpp:119-170, writer train/export.py:75-127).
- v1: magic 0x616b3432 ("ak42"), version=1, same 7 ints, shared_classifier
  byte, zero-pad to a 256-byte header; fp32 tensors with all norms first
  (reference: train/export.py:132-180).

The Q8_0 (v2) and int4 (v4) formats belong to the quantized path, which this
package has not ported yet: `load_checkpoint` names them and raises.

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


def read_v1(path: str) -> tuple[ModelConfig, LlamaWeights]:
    """Read a v1 fp32 checkpoint (train/export.py:132-180 layout)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("Ii", f.read(8))
        if magic != MAGIC_AK42:
            raise ValueError(f"bad magic 0x{magic:08x}, expected 'ak42'")
        if version != 1:
            raise ValueError(f"bad version {version}, expected 1")
        dim, hidden, n_layers, n_heads, n_kv_heads, vocab, seq_len = struct.unpack(
            "7i", f.read(28)
        )
        shared = struct.unpack("B", f.read(1))[0]
    cfg = ModelConfig(
        dim=dim, hidden_dim=hidden, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv_heads, vocab_size=vocab, seq_len=seq_len,
        shared_classifier=bool(shared),
    )
    data = np.memmap(path, dtype=np.float32, mode="r", offset=HEADER_SIZE_V12)
    return cfg, LlamaWeights(**_take(data, cfg, _V1_ORDER))


def sniff_version(path: str) -> int:
    """Return 0, 1, 2, or 4 depending on the checkpoint format."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("Ii", f.read(8))
    return version if magic == MAGIC_AK42 else 0


def load_checkpoint(path: str) -> tuple[ModelConfig, LlamaWeights]:
    """Dispatch on format; returns (config, LlamaWeights)."""
    v = sniff_version(path)
    if v == 0:
        return read_v0(path)
    if v == 1:
        return read_v1(path)
    if v in (2, 4):
        raise NotImplementedError(
            f"v{v} ({'Q8_0' if v == 2 else 'int4'}) checkpoints are not yet "
            "ported to hip_llama_tpu_torch; use a v0/v1 fp32 checkpoint"
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


def write_v1(path: str, cfg: ModelConfig, w: LlamaWeights) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("Ii", MAGIC_AK42, 1))
        f.write(struct.pack("7i", cfg.dim, cfg.hidden_dim, cfg.n_layers,
                            cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size,
                            cfg.seq_len))
        f.write(struct.pack("B", int(cfg.shared_classifier)))
        f.write(b"\0" * (HEADER_SIZE_V12 - f.tell()))
        for name in _V1_ORDER:
            _f32(f, getattr(w, name))
        if not cfg.shared_classifier:
            _f32(f, w.wcls)


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

"""Parameters of the dense, the Q8_0 and the int4 model.

Weights are transposed from the checkpoint's (out, in) row-major layout into
(in, out) so the hot path is `x @ W`, the orientation of the JAX package's
`LlamaParams` (hip_llama_tpu/models/params.py) — the tests hand the same
arrays to both packages. Dense per-layer tensors are stacked on a leading
layer axis; the decode step indexes one layer at a time.

`QuantLlamaParams` holds Q8_0 weights (QTensors) or int4 weights
(Q4Tensors) in the JAX package's unrolled fused layout
(`unstack_quant_params(fuse=True)`): one tensor per layer, with Q, K and V
concatenated along N in `wq` and W1 and W3 in `w1` (`wk`, `wv` and `w3` are
empty), and per-layer fp32 norm vectors. The embedding is Q8_0 rows either
way (group size 64 for int4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.io.checkpoint import (
    V4_EMB_GROUP,
    LlamaWeights,
    Q4Weights,
    QuantTensor,
    QuantWeights,
    q4_group_size,
    quantize_q80,
)
from hip_llama_tpu_torch.ops.quant import QTensor, q8_quantize_weights
from hip_llama_tpu_torch.ops.quant4 import Q4Tensor, q4_dequantize, q4_quantize_weights

_FIELDS = ("tok_emb", "rms_att", "wq", "wk", "wv", "wo", "rms_ffn",
           "w1", "w2", "w3", "rms_final", "wcls")
# fields stored (L, out, in) / (out, in) in a checkpoint, (.., in, out) here
_TRANSPOSED = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wcls")


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. A CUDA device that is asked for
    but absent raises: there is no silent fall-back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass
class LlamaParams:
    tok_emb: torch.Tensor  # (V, D)
    rms_att: torch.Tensor  # (L, D)
    wq: torch.Tensor  # (L, D, D)        x @ wq
    wk: torch.Tensor  # (L, D, KV)
    wv: torch.Tensor  # (L, D, KV)
    wo: torch.Tensor  # (L, D, D)
    rms_ffn: torch.Tensor  # (L, D)
    w1: torch.Tensor  # (L, D, H)
    w2: torch.Tensor  # (L, H, D)
    w3: torch.Tensor  # (L, D, H)
    rms_final: torch.Tensor  # (D,)
    wcls: torch.Tensor  # (D, V)

    @property
    def dtype(self) -> torch.dtype:
        return self.tok_emb.dtype

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device


def params_from_jax_numpy(
    arrays: dict[str, np.ndarray], dtype=torch.float32, device="cuda"
) -> LlamaParams:
    """Carry the JAX package's parameters across: `arrays` maps the 12
    field names of its `LlamaParams` to `np.asarray(leaf)`, already in
    (in, out) orientation. bf16 leaves arrive as ml_dtypes arrays and are
    widened to fp32 first (exact) so torch can take them."""
    dev = resolve_device(device)
    missing = set(_FIELDS) - set(arrays)
    if missing:
        raise KeyError(f"missing LlamaParams fields: {sorted(missing)}")

    def put(a: np.ndarray) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.kind != "f" or a.dtype.itemsize < 4:
            a = a.astype(np.float32)
        elif not a.flags.writeable:  # a checkpoint memmap: torch wants writable
            a = a.copy()
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=dev, dtype=dtype).contiguous()

    return LlamaParams(**{name: put(arrays[name]) for name in _FIELDS})


def params_from_weights(
    w: LlamaWeights, dtype=torch.float32, device="cuda"
) -> LlamaParams:
    """Build the params from checkpoint-oriented numpy weights — the same
    tensors as the JAX `params_from_weights` carried by
    `params_from_jax_numpy`."""
    arrays = {}
    for name in _FIELDS:
        a = np.asarray(getattr(w, name))
        if name in _TRANSPOSED:
            a = np.swapaxes(a, -1, -2)
        arrays[name] = a
    return params_from_jax_numpy(arrays, dtype=dtype, device=device)


def dense_weights_from_quant(cfg: ModelConfig, qw: QuantWeights) -> LlamaWeights:
    """Dequantize a v2 Q8_0 checkpoint to dense fp32 weights on the host, in
    file orientation (the JAX package's dense_weights_from_quant)."""
    gs = cfg.group_size

    def dq_stack(tensors) -> np.ndarray:
        return np.stack([t.dequantize(gs) for t in tensors])

    tok_emb = qw.q_tokens.dequantize(gs)
    return LlamaWeights(
        tok_emb=tok_emb, rms_att=qw.rms_att, rms_ffn=qw.rms_ffn, rms_final=qw.rms_final,
        wcls=tok_emb if cfg.shared_classifier else qw.wcls.dequantize(gs),
        **{name: dq_stack(getattr(qw, name)) for name in ("wq", "wk", "wv", "wo", "w1", "w2",
                                                          "w3")},
    )


def params_from_quant_dequant(cfg: ModelConfig, qw: QuantWeights, dtype=torch.float32,
                              device="cuda") -> LlamaParams:
    """A v2 Q8_0 checkpoint through the dense path (`--dequant`)."""
    return params_from_weights(dense_weights_from_quant(cfg, qw), dtype=dtype, device=device)


def params_from_q4_dequant(cfg: ModelConfig, w4: Q4Weights, dtype=torch.float32,
                           device="cuda") -> LlamaParams:
    """A v4 int4 checkpoint through the dense path (`--dequant`): the same
    values as the JAX package's params_from_q4_dequant (f32(code) * s, one
    rounding; the embedding's Q8_0 rows likewise)."""

    def dq(t) -> np.ndarray:
        return q4_dequantize(Q4Tensor(q=torch.from_numpy(np.array(t.q)),
                                      s=torch.from_numpy(np.array(t.s, np.float32)))).numpy()

    arrays = {name: dq(getattr(w4, name))
              for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wcls")}
    emb = QuantTensor(q=w4.emb_q, s=w4.emb_s).dequantize(w4.emb_q.shape[1] // w4.emb_s.shape[1])
    arrays.update(tok_emb=emb, rms_att=w4.rms_att, rms_ffn=w4.rms_ffn, rms_final=w4.rms_final)
    return params_from_jax_numpy(arrays, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Q8_0 and int4


@dataclasses.dataclass
class QuantLlamaParams:
    """Quantized weight-only params: Q8_0 (the runq engine, runq.c:317-342)
    or int4 (every matmul weight a Q4Tensor). The embedding stays int8 with
    per-row-group scales and is dequantized per gathered token
    (runq.c:360-364); norms are fp32 (runq.c:383)."""

    tok_emb_q: torch.Tensor  # (V, D) int8
    tok_emb_s: torch.Tensor  # (V, D // gs) f32
    rms_att: tuple[torch.Tensor, ...]  # per layer (D,) f32
    wq: tuple[QTensor | Q4Tensor, ...]  # per layer Q|K|V (D, D + 2 KV)
    wk: tuple  # () in the fused layout
    wv: tuple  # ()
    wo: tuple[QTensor | Q4Tensor, ...]  # per layer (D, D)
    rms_ffn: tuple[torch.Tensor, ...]
    w1: tuple[QTensor | Q4Tensor, ...]  # per layer W1|W3 (D, 2H)
    w2: tuple[QTensor | Q4Tensor, ...]  # per layer (H, D)
    w3: tuple  # ()
    rms_final: torch.Tensor  # (D,) f32
    wcls: QTensor | Q4Tensor  # (D, V)

    @property
    def group_size(self) -> int:
        """The embedding's group size."""
        return self.tok_emb_q.shape[1] // self.tok_emb_s.shape[1]

    @property
    def device(self) -> torch.device:
        return self.tok_emb_q.device

    @property
    def int4(self) -> bool:
        """Whether the matmul weights are Q4Tensors."""
        return isinstance(self.wcls, Q4Tensor)


def _cat(*ts):
    """Concatenate QTensors or Q4Tensors along N; groups run along K, so
    this is bit-identical to quantizing the concatenated weight."""
    return type(ts[0])(q=torch.cat([t.q for t in ts], dim=-1).contiguous(),
                       s=torch.cat([t.s for t in ts], dim=-1).contiguous())


def _fused_layers(n_layers: int, qt) -> dict:
    """The per-layer fused layout from qt(name, layer) -> QTensor."""
    return dict(
        wq=tuple(_cat(qt("wq", l), qt("wk", l), qt("wv", l)) for l in range(n_layers)),
        wk=(), wv=(),
        wo=tuple(qt("wo", l) for l in range(n_layers)),
        w1=tuple(_cat(qt("w1", l), qt("w3", l)) for l in range(n_layers)),
        w2=tuple(qt("w2", l) for l in range(n_layers)),
        w3=(),
    )


def _f32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


def qparams_from_quant_weights(cfg: ModelConfig, qw: QuantWeights,
                               device="cuda") -> QuantLlamaParams:
    """Load a v2 Q8_0 checkpoint into the fused-int8 path, losslessly: a
    file tensor (out, in) with groups along `in` transposes to q (in, out),
    s (in // gs, out) with the same int8 payload."""
    dev = resolve_device(device)
    c, gs = cfg, cfg.group_size
    if gs is None:
        raise ValueError("a Q8_0 config needs its group_size")

    def qt_file(t: QuantTensor, out_dim: int, in_dim: int) -> QTensor:
        q = np.array(np.asarray(t.q).reshape(out_dim, in_dim).T, order="C")
        s = np.array(np.asarray(t.s, np.float32).reshape(out_dim, in_dim // gs).T, order="C")
        return QTensor(q=torch.from_numpy(q).to(dev), s=torch.from_numpy(s).to(dev))

    dims = {"wq": (c.dim, c.dim), "wk": (c.kv_dim, c.dim), "wv": (c.kv_dim, c.dim),
            "wo": (c.dim, c.dim), "w1": (c.hidden_dim, c.dim), "w2": (c.dim, c.hidden_dim),
            "w3": (c.hidden_dim, c.dim)}
    return QuantLlamaParams(
        tok_emb_q=torch.from_numpy(np.array(qw.q_tokens.q).reshape(c.vocab_size, c.dim)).to(dev),
        tok_emb_s=_f32(np.asarray(qw.q_tokens.s).reshape(c.vocab_size, c.dim // gs), dev),
        rms_att=tuple(_f32(a, dev) for a in qw.rms_att),
        rms_ffn=tuple(_f32(a, dev) for a in qw.rms_ffn),
        rms_final=_f32(qw.rms_final, dev),
        wcls=qt_file(qw.wcls, c.vocab_size, c.dim),
        **_fused_layers(c.n_layers, lambda name, l: qt_file(getattr(qw, name)[l], *dims[name])),
    )


def quantize_params_q8(cfg: ModelConfig, w: LlamaWeights, group_size: int = 64,
                       device="cuda") -> QuantLlamaParams:
    """Quantize fp32 checkpoint weights to the Q8_0 path at load (what
    `export.py 2` does offline, train/export.py:182-260), one layer's weight
    at a time on `device`: bit for bit the JAX package's
    unstack_quant_params(quantize_params_q8(cfg, w, group_size))."""
    dev = resolve_device(device)
    gs = group_size

    def qt(a) -> QTensor:  # (out, in) -> quantized (in, out)
        return q8_quantize_weights(_f32(a, dev).t(), gs)

    q_emb, s_emb, _ = quantize_q80(np.asarray(w.tok_emb), gs)  # groups along each row
    return QuantLlamaParams(
        tok_emb_q=torch.from_numpy(q_emb).to(dev),
        tok_emb_s=_f32(s_emb.reshape(q_emb.shape[0], -1), dev),
        rms_att=tuple(_f32(a, dev) for a in w.rms_att),
        rms_ffn=tuple(_f32(a, dev) for a in w.rms_ffn),
        rms_final=_f32(w.rms_final, dev),
        wcls=qt(w.wcls),
        **_fused_layers(cfg.n_layers, lambda name, l: qt(getattr(w, name)[l])),
    )


def qparams_from_q4_weights(cfg: ModelConfig, w4: Q4Weights, device="cuda") -> QuantLlamaParams:
    """Load a v4 int4 checkpoint into the fused-int4 path, losslessly: the
    file stores the packed matmul-oriented layout, so each layer's weight is
    a slice of the stacked arrays (the JAX package's
    unstack_quant_params(qparams_from_q4_weights(...)))."""
    dev = resolve_device(device)

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(dev)

    def qt(name, l) -> Q4Tensor:
        t = getattr(w4, name)
        return Q4Tensor(q=put(t.q[l]), s=put(np.asarray(t.s[l], np.float32)))

    return QuantLlamaParams(
        tok_emb_q=put(w4.emb_q), tok_emb_s=_f32(w4.emb_s, dev),
        rms_att=tuple(_f32(a, dev) for a in w4.rms_att),
        rms_ffn=tuple(_f32(a, dev) for a in w4.rms_ffn),
        rms_final=_f32(w4.rms_final, dev),
        wcls=Q4Tensor(q=put(w4.wcls.q), s=_f32(w4.wcls.s, dev)),
        **_fused_layers(cfg.n_layers, qt),
    )


def quantize_params_q4(cfg: ModelConfig, w: LlamaWeights, group_size: int = 32,
                       device="cuda") -> QuantLlamaParams:
    """Quantize fp32 checkpoint weights to the int4 path at load, one
    layer's weight at a time on `device`: each matmul weight a Q4Tensor with
    the group size q4_group_size(K, group_size), the embedding Q8_0 rows of
    group size 64 — bit for bit the JAX package's
    unstack_quant_params(quantize_params_q4(cfg, w, group_size))."""
    dev = resolve_device(device)

    def qt(a) -> Q4Tensor:  # (out, in) -> quantized (in, out)
        wt = _f32(a, dev).t()
        return q4_quantize_weights(wt, q4_group_size(wt.shape[0], group_size))

    q_emb, s_emb, _ = quantize_q80(np.asarray(w.tok_emb), V4_EMB_GROUP)
    return QuantLlamaParams(
        tok_emb_q=torch.from_numpy(q_emb).to(dev),
        tok_emb_s=_f32(s_emb.reshape(q_emb.shape[0], -1), dev),
        rms_att=tuple(_f32(a, dev) for a in w.rms_att),
        rms_ffn=tuple(_f32(a, dev) for a in w.rms_ffn),
        rms_final=_f32(w.rms_final, dev),
        wcls=qt(w.wcls),
        **_fused_layers(cfg.n_layers, lambda name, l: qt(getattr(w, name)[l])),
    )


def qparams_from_jax_numpy(arrays: dict, device="cuda", int4: bool = False) -> QuantLlamaParams:
    """Carry the JAX package's quantized params across, after its
    `unstack_quant_params` (fused): `arrays` maps the 13 field names of its
    `QuantLlamaParams` to numpy leaves — arrays, per-layer tuples of norm
    vectors, and (q, s) pairs (its QTensors, or with `int4` its Q4Tensors)
    or tuples of them. The caller says which: a packed int4 weight and an
    int8 one can have the same shapes."""
    dev = resolve_device(device)
    tensor = Q4Tensor if int4 else QTensor

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(dev)

    def qt(pair):
        q, s = pair
        return tensor(q=put(q), s=put(s))

    return QuantLlamaParams(
        tok_emb_q=put(arrays["tok_emb_q"]), tok_emb_s=put(arrays["tok_emb_s"]),
        rms_att=tuple(put(a) for a in arrays["rms_att"]),
        wq=tuple(qt(t) for t in arrays["wq"]), wk=(), wv=(),
        wo=tuple(qt(t) for t in arrays["wo"]),
        rms_ffn=tuple(put(a) for a in arrays["rms_ffn"]),
        w1=tuple(qt(t) for t in arrays["w1"]),
        w2=tuple(qt(t) for t in arrays["w2"]), w3=(),
        rms_final=put(arrays["rms_final"]), wcls=qt(arrays["wcls"]),
    )

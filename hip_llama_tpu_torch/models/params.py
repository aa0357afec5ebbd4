"""Parameters of the dense model.

Weights are transposed from the checkpoint's (out, in) row-major layout into
(in, out) so the hot path is `x @ W`, the orientation of the JAX package's
`LlamaParams` (hip_llama_tpu/models/params.py) — the tests hand the same
arrays to both packages. Per-layer tensors are stacked on a leading layer
axis; the decode step indexes one layer at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hip_llama_tpu_torch.io.checkpoint import LlamaWeights

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

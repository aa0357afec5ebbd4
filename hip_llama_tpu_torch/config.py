"""Model configuration.

Mirrors the reference `Config` struct (reference: include/models.hpp:10-18,
seven int32 fields read straight from the checkpoint header at
src/utils.cpp:150-170). `shared_classifier` is carried separately because the
v0 format encodes it as the sign of `vocab_size`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    shared_classifier: bool = True
    # Q8_0 quantization group size (v2 checkpoints; reference: runq.c:227-232).
    group_size: int | None = None
    norm_eps: float = 1e-5
    # RoPE base frequency. The reference hardcodes 10000 (seq.cpp:88); kept
    # configurable so HF imports of Llama-3-era checkpoints (theta 500000)
    # and CodeLlama (1e6) work. The llama2.c .bin headers cannot carry it —
    # run.py --rope-theta overrides after load.
    rope_theta: float = 10000.0

    @property
    def head_size(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return (self.dim * self.n_kv_heads) // self.n_heads

    @property
    def kv_mul(self) -> int:
        """GQA group size (reference: src/seq.cpp:61)."""
        return self.n_heads // self.n_kv_heads

    def __post_init__(self) -> None:
        if self.dim % self.n_heads != 0:
            raise ValueError(f"dim={self.dim} not divisible by n_heads={self.n_heads}")
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(
                f"n_heads={self.n_heads} not divisible by n_kv_heads={self.n_kv_heads}"
            )


def tiny_config(**overrides) -> ModelConfig:
    """A tiny config for tests (stories260K-scale; cheap on CPU)."""
    base = dict(
        dim=64,
        hidden_dim=172,
        n_layers=5,
        n_heads=8,
        n_kv_heads=4,
        vocab_size=512,
        seq_len=128,
        shared_classifier=True,
    )
    base.update(overrides)
    return ModelConfig(**base)

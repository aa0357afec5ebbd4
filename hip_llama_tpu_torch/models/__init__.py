from hip_llama_tpu_torch.models.params import (
    LlamaParams,
    params_from_jax_numpy,
    params_from_weights,
)
from hip_llama_tpu_torch.models.llama import (
    KVCache,
    init_kv_cache,
    make_decode_step,
    make_prefill,
)

__all__ = [
    "LlamaParams",
    "params_from_jax_numpy",
    "params_from_weights",
    "KVCache",
    "init_kv_cache",
    "make_decode_step",
    "make_prefill",
]

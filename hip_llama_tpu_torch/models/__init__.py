from hip_llama_tpu_torch.models.params import (
    LlamaParams,
    QuantLlamaParams,
    params_from_jax_numpy,
    params_from_q4_dequant,
    params_from_quant_dequant,
    params_from_weights,
    qparams_from_jax_numpy,
    qparams_from_q4_weights,
    qparams_from_quant_weights,
    quantize_params_q4,
    quantize_params_q8,
)
from hip_llama_tpu_torch.models.llama import (
    KVCache,
    act_dtype,
    init_kv_cache,
    make_decode_step,
    make_prefill,
)

__all__ = [
    "LlamaParams",
    "QuantLlamaParams",
    "params_from_jax_numpy",
    "params_from_q4_dequant",
    "params_from_quant_dequant",
    "params_from_weights",
    "qparams_from_jax_numpy",
    "qparams_from_q4_weights",
    "qparams_from_quant_weights",
    "quantize_params_q4",
    "quantize_params_q8",
    "KVCache",
    "act_dtype",
    "init_kv_cache",
    "make_decode_step",
    "make_prefill",
]

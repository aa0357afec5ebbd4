from hip_llama_tpu_torch.ops.attention import (
    attention_decode,
    attention_decode_fused,
    attention_prefill,
)
from hip_llama_tpu_torch.ops.cache import kv_commit_rows, kv_write_chunk
from hip_llama_tpu_torch.ops.layer_fused import q8_layer_fused
from hip_llama_tpu_torch.ops.quant import q8_matmul, q8_matmul_ffn, q8_matmul_silu

# every kernel wrapper of the package; each counts its launches in `.launches`
KERNELS = (attention_decode, kv_commit_rows, kv_write_chunk, attention_prefill,
           q8_matmul, attention_decode_fused, q8_matmul_ffn, q8_matmul_silu, q8_layer_fused)

__all__ = [
    "KERNELS",
    "attention_decode",
    "attention_decode_fused",
    "attention_prefill",
    "kv_commit_rows",
    "kv_write_chunk",
    "q8_matmul",
    "q8_layer_fused",
    "q8_matmul_ffn",
    "q8_matmul_silu",
]

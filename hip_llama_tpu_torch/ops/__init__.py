from hip_llama_tpu_torch.ops.attention import (
    attention_decode,
    attention_decode_fused,
    attention_prefill,
)
from hip_llama_tpu_torch.ops.cache import (
    kv_commit_rows,
    kv_write_chunk,
    quantize_kv_rows,
    scale_write_chunk,
)
from hip_llama_tpu_torch.ops.layer_fused import q8_layer_fused
from hip_llama_tpu_torch.ops.quant import q8_matmul, q8_matmul_ffn, q8_matmul_silu
from hip_llama_tpu_torch.ops.quant4 import q4_matmul, q4_matmul_silu

# every kernel wrapper of the package; each counts its launches in `.launches`
KERNELS = (attention_decode, kv_commit_rows, kv_write_chunk, attention_prefill,
           q8_matmul, attention_decode_fused, q8_matmul_ffn, q8_matmul_silu, q8_layer_fused,
           scale_write_chunk, q4_matmul, q4_matmul_silu)
# the wrappers with an int8-cache branch, which counts in `.launches_int8`
INT8_BRANCHES = (attention_decode, kv_commit_rows, kv_write_chunk, attention_prefill,
                 attention_decode_fused, q8_layer_fused)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for w in KERNELS:
        w.launches = 0
    for w in INT8_BRANCHES:
        w.launches_int8 = 0


def launch_counts() -> dict[str, int]:
    """Launches by kernel: `<wrapper>` and, for an int8 branch,
    `<wrapper>_int8`."""
    counts = {w.__name__: w.launches for w in KERNELS}
    counts.update({f"{w.__name__}_int8": w.launches_int8 for w in INT8_BRANCHES})
    return counts


__all__ = [
    "INT8_BRANCHES",
    "KERNELS",
    "attention_decode",
    "attention_decode_fused",
    "attention_prefill",
    "kv_commit_rows",
    "kv_write_chunk",
    "launch_counts",
    "q8_matmul",
    "q8_layer_fused",
    "q8_matmul_ffn",
    "q8_matmul_silu",
    "q4_matmul",
    "q4_matmul_silu",
    "quantize_kv_rows",
    "reset_launches",
    "scale_write_chunk",
]

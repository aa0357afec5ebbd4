from hip_llama_tpu_torch.ops.attention import attention_decode, attention_prefill
from hip_llama_tpu_torch.ops.cache import kv_commit_rows, kv_write_chunk

# every kernel wrapper of the package; each counts its launches in `.launches`
KERNELS = (attention_decode, kv_commit_rows, kv_write_chunk, attention_prefill)

__all__ = [
    "KERNELS",
    "attention_decode",
    "attention_prefill",
    "kv_commit_rows",
    "kv_write_chunk",
]

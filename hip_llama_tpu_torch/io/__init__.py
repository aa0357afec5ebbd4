from hip_llama_tpu_torch.io.checkpoint import (
    LlamaWeights,
    QuantTensor,
    QuantWeights,
    dequantize,
    load_checkpoint,
    quantize_q80,
    random_weights,
    read_v0,
    read_v1,
    read_v2,
    write_v0,
    write_v1,
    write_v2,
)
from hip_llama_tpu_torch.io.tokenizer_io import read_tokenizer_bin, write_tokenizer_bin

__all__ = [
    "LlamaWeights",
    "QuantTensor",
    "QuantWeights",
    "dequantize",
    "load_checkpoint",
    "quantize_q80",
    "random_weights",
    "read_v0",
    "read_v1",
    "read_v2",
    "write_v0",
    "write_v1",
    "write_v2",
    "read_tokenizer_bin",
    "write_tokenizer_bin",
]

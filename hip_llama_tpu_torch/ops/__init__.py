from hip_llama_tpu_torch.ops.attention import (
    attention_decode,
    attention_decode_fused,
    attention_decode_paged,
    attention_prefill,
    attention_prefill_paged,
)
from hip_llama_tpu_torch.ops.cache import (
    kv_commit_rows,
    kv_write_chunk,
    kv_write_chunk_paged,
    kv_write_rows,
    kv_write_rows_paged,
    quantize_kv_rows,
    scale_write_chunk,
    scale_write_chunk_paged,
    scale_write_rows,
    scale_write_rows_paged,
)
from hip_llama_tpu_torch.ops.hbm_bw import deep_read, dma_copy, dma_read, wshape_read
from hip_llama_tpu_torch.ops.layer_fused import q8_layer_fused
from hip_llama_tpu_torch.ops.quant import (
    a8_gemv_probe,
    q8_matmul,
    q8_matmul_ffn,
    q8_matmul_layered,
    q8_matmul_minner,
    q8_matmul_silu,
    q8_matmul_silu_minner,
    q8_a8_tiles_probe,
    q8_matmul_xheads,
    wgmma_mainloop_probe,
)
from hip_llama_tpu_torch.ops.quant4 import q4_a8_tiles_probe, q4_matmul, q4_matmul_silu

# every kernel wrapper of the package; each counts its launches in `.launches`
KERNELS = (attention_decode, kv_commit_rows, kv_write_chunk, attention_prefill,
           q8_matmul, attention_decode_fused, q8_matmul_ffn, q8_matmul_silu, q8_layer_fused,
           scale_write_chunk, q4_matmul, q4_matmul_silu, attention_decode_paged,
           attention_prefill_paged, kv_write_rows_paged, scale_write_rows_paged,
           kv_write_chunk_paged, scale_write_chunk_paged, q8_matmul_layered, kv_write_rows,
           scale_write_rows, q8_matmul_minner, q8_matmul_silu_minner, q8_matmul_xheads,
           dma_read, dma_copy, wshape_read, deep_read, wgmma_mainloop_probe, q8_a8_tiles_probe,
           q4_a8_tiles_probe, a8_gemv_probe)
# the wrappers with an int8-cache branch, which counts in `.launches_int8`
INT8_BRANCHES = (attention_decode, kv_commit_rows, kv_write_chunk, attention_prefill,
                 attention_decode_fused, q8_layer_fused, attention_decode_paged,
                 attention_prefill_paged, kv_write_rows_paged, kv_write_chunk_paged,
                 kv_write_rows)
# the wrappers with an `a8` branch (HIPLLAMA_Q8_MODE / HIPLLAMA_Q4_MODE=a8),
# which counts in `.launches_a8`
A8_BRANCHES = (q8_matmul, q8_matmul_silu, q4_matmul, q4_matmul_silu, q8_matmul_layered)
# the wrappers with a tensor-core branch beside their kernel, which counts in
# `.launches_tc` (q8_matmul_ffn above 16 rows)
TC_BRANCHES = (q8_matmul_ffn,)
# the wrappers whose launches above GEMV_MAX_M rows run the wgmma tiles
# (csrc/q8_wgmma.cuh), counted again in `.launches_wgmma`
WGMMA_BRANCHES = (q8_matmul, q8_matmul_silu, q8_matmul_layered, q4_matmul, q4_matmul_silu)
# the `a8` branches whose launches above GEMV_MAX_M rows run the int8 wgmma
# tiles (csrc/a8_wgmma.cuh), counted again in `.launches_a8_wgmma`
A8_WGMMA_BRANCHES = (q8_matmul, q8_matmul_silu, q8_matmul_layered, q4_matmul, q4_matmul_silu)
# the `a8` branches whose launches up to GEMV_MAX_M rows run the GEMV on the
# int8 tensor cores (csrc/a8.cuh::a8_gemv_tc_kernel, group sizes that are
# multiples of 32), counted again in `.launches_a8_tc`
A8_TC_BRANCHES = A8_WGMMA_BRANCHES


def reset_launches() -> None:
    """Set every launch count to 0."""
    for w in KERNELS:
        w.launches = 0
    for w in INT8_BRANCHES:
        w.launches_int8 = 0
    for w in A8_BRANCHES:
        w.launches_a8 = 0
    for w in TC_BRANCHES:
        w.launches_tc = 0
    for w in WGMMA_BRANCHES:
        w.launches_wgmma = 0
    for w in A8_WGMMA_BRANCHES:
        w.launches_a8_wgmma = 0
    for w in A8_TC_BRANCHES:
        w.launches_a8_tc = 0


def launch_counts() -> dict[str, int]:
    """Launches by kernel: `<wrapper>` and, for an int8 branch,
    `<wrapper>_int8`, for an `a8` branch `<wrapper>_a8`, for a tensor-core
    branch `<wrapper>_tc`, for the wgmma tiles `<wrapper>_wgmma` (a share
    of `<wrapper>`'s count), for the `a8` wgmma tiles `<wrapper>_a8_wgmma`
    and the `a8` tensor-core GEMV `<wrapper>_a8_tc` (shares of
    `<wrapper>_a8`'s)."""
    counts = {w.__name__: w.launches for w in KERNELS}
    counts.update({f"{w.__name__}_int8": w.launches_int8 for w in INT8_BRANCHES})
    counts.update({f"{w.__name__}_a8": w.launches_a8 for w in A8_BRANCHES})
    counts.update({f"{w.__name__}_tc": w.launches_tc for w in TC_BRANCHES})
    counts.update({f"{w.__name__}_wgmma": w.launches_wgmma for w in WGMMA_BRANCHES})
    counts.update({f"{w.__name__}_a8_wgmma": w.launches_a8_wgmma for w in A8_WGMMA_BRANCHES})
    counts.update({f"{w.__name__}_a8_tc": w.launches_a8_tc for w in A8_TC_BRANCHES})
    return counts


__all__ = [
    "A8_BRANCHES",
    "A8_TC_BRANCHES",
    "A8_WGMMA_BRANCHES",
    "INT8_BRANCHES",
    "KERNELS",
    "TC_BRANCHES",
    "WGMMA_BRANCHES",
    "a8_gemv_probe",
    "attention_decode",
    "attention_decode_fused",
    "attention_decode_paged",
    "attention_prefill",
    "attention_prefill_paged",
    "deep_read",
    "dma_copy",
    "dma_read",
    "kv_commit_rows",
    "kv_write_chunk",
    "kv_write_chunk_paged",
    "kv_write_rows",
    "kv_write_rows_paged",
    "launch_counts",
    "q8_matmul",
    "q8_a8_tiles_probe",
    "q8_layer_fused",
    "q8_matmul_ffn",
    "q8_matmul_layered",
    "q8_matmul_minner",
    "q8_matmul_silu",
    "q8_matmul_silu_minner",
    "q8_matmul_xheads",
    "q4_a8_tiles_probe",
    "q4_matmul",
    "q4_matmul_silu",
    "quantize_kv_rows",
    "reset_launches",
    "scale_write_chunk",
    "scale_write_chunk_paged",
    "scale_write_rows",
    "scale_write_rows_paged",
    "wgmma_mainloop_probe",
    "wshape_read",
]

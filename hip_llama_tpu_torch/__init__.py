"""hip_llama_tpu_torch — the PyTorch/CUDA port of hip_llama_tpu.

The same Llama-2 serving system on an NVIDIA Hopper card: plain tensor code
is PyTorch, and each Pallas TPU kernel of the JAX package becomes a CUDA C++
kernel under `csrc/`, built with nvcc for sm_90a at first use and bound with
ctypes (ops/_build.py). Every kernel has a plain PyTorch version beside it,
which runs for CPU tensors. The module layout mirrors `hip_llama_tpu/`.
"""

from hip_llama_tpu_torch.config import ModelConfig

__version__ = "0.1.0"

__all__ = ["ModelConfig", "__version__"]

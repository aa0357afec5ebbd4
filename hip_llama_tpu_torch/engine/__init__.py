from hip_llama_tpu_torch.engine.engine import GenerationResult, InferenceEngine
from hip_llama_tpu_torch.engine.requests import Requests, read_inputfile, write_outputfile

__all__ = [
    "InferenceEngine",
    "GenerationResult",
    "Requests",
    "read_inputfile",
    "write_outputfile",
]

"""Command-line tools of the port: `python -m hip_llama_tpu_torch.tools.hbm_bw`."""

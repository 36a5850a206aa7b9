"""The benchmark of altro_tpu_torch on one NVIDIA H100: `run.py` runs one cell."""

"""ddbench: the benchmark of ddo_tpu_torch on an NVIDIA H100 (see run.py)."""

"""The benchmark of golf_tpu_torch on NVIDIA GPUs (see README.md)."""

"""The benchmark of s2tpu_torch on an NVIDIA H100: see README.md."""

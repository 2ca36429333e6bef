"""Plain PyTorch references of the benchmark's configurations: float32, no
kernels, no caches, nothing imported from the system under test."""

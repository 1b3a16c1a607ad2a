"""Compact-WY trailing update (the TTD engine's GEMM stage): CUDA kernels,
dispatch and plain oracle."""

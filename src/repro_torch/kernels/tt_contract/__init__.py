"""Fused TT-chain contraction: CUDA kernels, dispatch and plain oracle."""

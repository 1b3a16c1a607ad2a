"""Flash attention (prefill): CUDA kernel, dispatch and plain oracle."""

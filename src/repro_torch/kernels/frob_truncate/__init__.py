"""δ-truncation (the TRUNCATION module): CUDA kernel, dispatch and plain
oracle."""

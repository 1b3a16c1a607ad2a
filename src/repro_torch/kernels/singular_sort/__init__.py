"""Descending singular-value sort (the SORTING module): CUDA kernel,
dispatch and plain oracle."""

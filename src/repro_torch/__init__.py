"""PyTorch / CUDA port of the TT-Edge system for one NVIDIA H100.

Mirrors the layout of the JAX package ``repro`` (configs, core,
kernels/tt_contract, models, launch) and is held against it by the
``tests/test_torch_*.py`` parity tests.  Imports ``torch`` only.
"""

"""Householder panel factorization (the HBD-ACC datapath) and the blocked
QR built from it: CUDA kernels, dispatch and plain oracle."""

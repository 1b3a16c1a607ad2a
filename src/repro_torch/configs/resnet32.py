"""The paper's own workload: ResNet-32 (CIFAR-10) parameters, 0.47M.

The port's copy of the JAX repo's ``benchmarks/workload_resnet32.py``
(``resnet32_params``, ``_spectral_weight``), in numpy: the same seed gives
the same arrays.  No trained CIFAR-10 checkpoint ships with the repo, so
each conv/fc weight is drawn as U diag(s) Vᵀ of its (out, in·kh·kw)
matricization with s_i ∝ i^-α (the power-law decay of trained convnets),
at He-init scale.  Compress it on the card with

    params = {k: torch.from_numpy(v).cuda()
              for k, v in resnet32_params(seed=0).items()}
    payload, report = TTCompressor(CompressionPolicy(
        eps=0.2, hbd_impl="blocked")).compress(params)

Architecture (He et al. 2016, CIFAR variant, n = 5 → 6n+2 = 32 layers):
conv1 3×3×3×16; three stages of 5 blocks × 2 convs at widths 16, 32, 64
(the first conv of stages 2 and 3 widens); fc 64×10 (+bias); BN (γ, β) per
conv.  Conv kernels are (C_out, C_in, kh, kw).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _spectral_weight(rng: np.random.Generator, shape: Tuple[int, ...],
                     alpha: float = 1.0) -> np.ndarray:
    """Weight tensor whose (out, in·kh·kw) matricization has s_i ∝ i^-α."""
    m, n = shape[0], int(np.prod(shape[1:]))
    k = min(m, n)
    qu, _ = np.linalg.qr(rng.standard_normal((m, k)))
    qv, _ = np.linalg.qr(rng.standard_normal((n, k)))
    s = np.arange(1, k + 1, dtype=np.float64) ** (-alpha)
    w = (qu * s) @ qv.T
    w *= np.sqrt(2.0 / np.prod(shape[1:])) / np.linalg.norm(w) * np.sqrt(w.size)
    return w.reshape(shape).astype(np.float32)


def resnet32_params(seed: int = 0, alpha: float = 1.0) -> Dict[str, np.ndarray]:
    """Parameter dict (name → array), in the reference's insertion order."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}

    def conv(name: str, c_out: int, c_in: int):
        params[f"{name}.w"] = _spectral_weight(rng, (c_out, c_in, 3, 3), alpha)
        params[f"{name}.bn.g"] = np.ones((c_out,), np.float32)
        params[f"{name}.bn.b"] = np.zeros((c_out,), np.float32)

    conv("conv1", 16, 3)
    widths = [16, 32, 64]
    for s, w in enumerate(widths):
        w_in = 16 if s == 0 else widths[s - 1]
        for b in range(5):
            conv(f"s{s}.b{b}.conv1", w, w_in if b == 0 else w)
            conv(f"s{s}.b{b}.conv2", w, w)
    params["fc.w"] = _spectral_weight(rng, (10, 64), alpha)
    params["fc.b"] = np.zeros((10,), np.float32)
    return params


def total_params(params: Dict[str, np.ndarray]) -> int:
    return int(sum(int(p.size) for p in params.values()))

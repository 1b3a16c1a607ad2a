"""Inputs for holding each chain kernel against its plain version.

One table of chain shapes and one way to draw a chain's inputs, shared by
``chip_smoke.py`` (which checks and times the kernels on the card) and
``tests/test_torch_kernels_cuda.py``:

    name, kernel, plain, library = chain_case(kind, shape, b, dtype, gen, dev)

``kind`` is the chain depth (2 or 3); ``shape`` is ``(n1, r1, n2)`` for
depth 2 and ``(split, n1, r1, n2, r2, n3)`` for depth 3.  The tail cores
come in ``dtype``: float32, bfloat16 (how ``tt_native_params`` serves them)
or int8 with one absmax scale per core (how ``quantize_tt`` stores them).

    name, kernel, plain, library = batched_case(kind, shape, e, c, dtype,
                                                gen, dev)

is the same for the expert-batched routes: E experts of C tokens each, one
lead-absorbed first core per expert, the tail cores shared.
"""

from __future__ import annotations

import torch

from repro_torch.core.tt_linear import dequantize_array, quantize_array
from repro_torch.kernels.tt_contract import ops

# full-width qwen1.5-0.5b chains (eps 0.2): MLP gate/up, MLP down, wq/wk/wv
# (split 1), wo (split 2)
FULL_WIDTH_SHAPES = {2: [(1024, 31, 2816), (2816, 31, 1024)],
                     3: [(1, 1024, 417, 16, 18, 64),
                         (2, 16, 322, 64, 38, 1024)]}
# ragged small chains: no dimension a multiple of the kernels' tiles
RAGGED_SHAPES = {2: [(70, 5, 300)],
                 3: [(1, 9, 5, 4, 7, 200), (2, 3, 5, 4, 7, 200)]}
TAIL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
# expert-batched chains: olmoe-1b-7b's banks at full width (64 experts,
# gate/up 2048 -> 1024, down 1024 -> 2048, depth 2, eps 0.2, ranks of seed
# 0; chip_smoke.py takes them from its own compression) and a ragged one;
# synthetic depth-3 chains (split 1 and 2), which no config's bank has;
# (E, C) pairs: decode (C = 1), more tokens per expert, a ragged count
BATCHED_SHAPES = {2: [(2048, 43, 1024), (1024, 44, 2048), (70, 5, 300)],
                  3: [(1, 64, 20, 32, 24, 64), (2, 16, 20, 32, 24, 256),
                      (1, 9, 5, 4, 7, 200), (2, 3, 5, 4, 7, 200)]}
BATCHED_EC = ((64, 1), (64, 4), (64, 64), (3, 9))


def _tail(dtype, t):
    """(stored core, its scale or None, the core widened to f32)."""
    if dtype == torch.int8:
        q, s = quantize_array(t)
        return q, s, dequantize_array(q, s)
    t = t.to(dtype)
    return t, None, t.float()


def batched_case(kind: int, shape, e: int, c: int, dtype: torch.dtype,
                 gen: torch.Generator, device):
    """(launch key, kernel call, plain call, library call) for ``e``
    chains of ``c`` tokens each: x (E, C, N_in) and the first cores
    (E, n1, r1) in float32, the shared tail cores in ``dtype``.  The
    library call is one ``torch.einsum`` over the batched chain."""
    def rn(*s):
        return torch.randn(*s, generator=gen, device=device)

    quant = dtype == torch.int8
    if kind == 2:
        n1, r1, n2 = shape
        x, g0 = rn(e, c, n1), rn(e, n1, r1)
        g1, s1, w1 = _tail(dtype, rn(r1, n2) / r1 ** 0.5)
        s = None if s1 is None else s1.reshape(1)
        if quant:
            def kernel():
                return ops.tt_contract_2q_batched(x, g0, g1, s)
        else:
            def kernel():
                return ops.tt_contract_2_batched(x, g0, g1)
        return ("tt_contract_2q_batched" if quant else
                "tt_contract_2_batched", kernel,
                lambda: ops.tt_contract_2_batched_plain(x, g0, g1, s),
                lambda: torch.einsum("ecn,enr,rm->ecm", x, g0, w1))

    split, n1, r1, n2, r2, n3 = shape
    x = rn(e, c, n1 if split == 1 else n1 * n2)
    g0 = rn(e, n1, r1)
    g1, s1, w1 = _tail(dtype, rn(r1, n2, r2) / r1 ** 0.5)
    g2, s2, w2 = _tail(dtype, rn(r2, n3) / r2 ** 0.5)
    s = None if s1 is None else (s1 * s2).reshape(1)
    if quant:
        def kernel():
            return ops.tt_contract_3q_batched(x, g0, g1, g2, s, split)
    else:
        def kernel():
            return ops.tt_contract_3_batched(x, g0, g1, g2, split)
    if split == 1:
        def library():
            return torch.einsum("ecn,enr,rms,sj->ecmj", x, g0, w1,
                                w2).reshape(e, c, -1)
    else:
        x4 = x.reshape(e, c, n1, n2)

        def library():
            return torch.einsum("ecam,ear,rms,sj->ecj", x4, g0, w1, w2)
    return ("tt_contract_3q_batched" if quant else "tt_contract_3_batched",
            kernel,
            lambda: ops.tt_contract_3_batched_plain(x, g0, g1, g2, split, s),
            library)


def chain_case(kind: int, shape, b: int, dtype: torch.dtype,
               gen: torch.Generator, device):
    """(kernel name, kernel call, plain call, library call) for one chain
    at batch ``b``: x and the lead-absorbed first core in float32, the tail
    cores in ``dtype``.  The library call is one ``torch.einsum`` over the
    chain, with the tail cores widened to float32 beforehand."""
    def rn(*s):
        return torch.randn(*s, generator=gen, device=device)

    quant = dtype == torch.int8
    if kind == 2:
        n1, r1, n2 = shape
        x, g0 = rn(b, n1), rn(n1, r1)
        g1, s1, w1 = _tail(dtype, rn(r1, n2) / r1 ** 0.5)
        s = None if s1 is None else s1.reshape(1)
        name = "tt_contract_2q" if quant else "tt_contract_2"
        if quant:
            def kernel():
                return ops.tt_contract_2q(x, g0, g1, s)
        else:
            def kernel():
                return ops.tt_contract_2(x, g0, g1)
        return (name, kernel,
                lambda: ops.tt_contract_2_plain(x, g0, g1, s),
                lambda: torch.einsum("bn,nr,rm->bm", x, g0, w1))

    split, n1, r1, n2, r2, n3 = shape
    x = rn(b, n1 if split == 1 else n1 * n2)
    g0 = rn(n1, r1)
    g1, s1, w1 = _tail(dtype, rn(r1, n2, r2) / r1 ** 0.5)
    g2, s2, w2 = _tail(dtype, rn(r2, n3) / r2 ** 0.5)
    s = None if s1 is None else (s1 * s2).reshape(1)
    name = "tt_contract_3q" if quant else "tt_contract_3"
    if quant:
        def kernel():
            return ops.tt_contract_3q(x, g0, g1, g2, s, split)
    else:
        def kernel():
            return ops.tt_contract_3(x, g0, g1, g2, split)
    if split == 1:
        def library():
            return torch.einsum("bn,nr,rms,sj->bmj", x, g0, w1,
                                w2).reshape(b, -1)
    else:
        x3 = x.reshape(b, n1, n2)

        def library():
            return torch.einsum("bam,ar,rms,sj->bj", x3, g0, w1, w2)
    return (name, kernel,
            lambda: ops.tt_contract_3_plain(x, g0, g1, g2, split, s),
            library)

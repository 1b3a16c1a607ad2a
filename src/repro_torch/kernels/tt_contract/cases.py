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

    name, kernel, plain, library = stored_case(split, shapes, b, dtype, gen,
                                               dev, experts=None)

is one TTLinear call from its stored tensors, as ``tt_apply`` (or, with
``experts`` E, ``tt_apply_experts``) runs it: the lead row(s), the first
core (r_s, n1, r1) and the tail cores all in ``dtype`` (int8: one absmax
scale per core and per lead row, as ``quantize_tt`` stores them); x in
float32.  The library call is one ``torch.einsum`` of x, the cores and the
lead (widened, and dequantized, beforehand).  ``STORED_SHAPES`` and
``STORED_BANKS`` are the main paths' stored chains at full width.
"""

from __future__ import annotations

import torch

from repro_torch.core.tt_linear import (
    TTLinear, dequantize_array, quantize_array, tt_apply, tt_apply_experts,
)
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
# stored chains (split, [first core (r_s, n1, r1), tail cores]) of the main
# paths at full width, eps 0.2, seed 0 (the ranks chip_smoke.py's
# compressions give): qwen1.5-0.5b, olmoe-1b-7b's attention,
# recurrentgemma-2b, mamba2-1.3b (w_in's 8,512 outputs: a multiple of 64,
# not of 128), gemma3-1b (1,152 = 2^7·9 wide, a single KV head of 256,
# 6,912 = 2^8·27 MLP rows); and ragged ones (no dimension a multiple of a
# tile)
STORED_SHAPES = {
    "qwen1.5-0.5b wq/wk/wv": (1, [(24, 1024, 417), (417, 16, 18), (18, 64, 1)]),
    "qwen1.5-0.5b wo": (2, [(24, 16, 323), (323, 64, 38), (38, 1024, 1)]),
    "qwen1.5-0.5b mlp gate/up": (1, [(24, 1024, 31), (31, 2816, 1)]),
    "qwen1.5-0.5b mlp down": (1, [(24, 2816, 31), (31, 1024, 1)]),
    "olmoe-1b-7b wq/wk/wv": (1, [(16, 2048, 526), (526, 16, 20), (20, 128, 1)]),
    "olmoe-1b-7b wo": (2, [(16, 16, 238), (238, 128, 43), (43, 2048, 1)]),
    "recurrentgemma-2b wq": (1, [(8, 2560, 377), (377, 10, 22), (22, 256, 1)]),
    "recurrentgemma-2b wk/wv": (1, [(8, 2560, 40), (40, 1, 22), (22, 256, 1)]),
    "recurrentgemma-2b wo": (2, [(8, 10, 79), (79, 256, 45), (45, 2560, 1)]),
    "recurrentgemma-2b mlp gate/up": (1, [(8, 2560, 31), (31, 7680, 1)]),
    "recurrentgemma-2b mlp down": (1, [(8, 7680, 31), (31, 2560, 1)]),
    "mamba2-1.3b w_in": (1, [(48, 2048, 31), (31, 8512, 1)]),
    "mamba2-1.3b w_out": (1, [(48, 4096, 31), (31, 2048, 1)]),
    "gemma3-1b wq": (1, [(26, 1152, 154), (154, 4, 22), (22, 256, 1)]),
    "gemma3-1b wk/wv": (1, [(26, 1152, 40), (40, 1, 22), (22, 256, 1)]),
    "gemma3-1b wo": (2, [(26, 4, 102), (102, 256, 44), (44, 1152, 1)]),
    "gemma3-1b mlp gate/up": (1, [(26, 1152, 31), (31, 6912, 1)]),
    "gemma3-1b mlp down": (1, [(26, 6912, 31), (31, 1152, 1)]),
}
RAGGED_STORED = {
    "ragged depth 2": (1, [(3, 70, 5), (5, 300, 1)]),
    "ragged split 1": (1, [(5, 9, 5), (5, 4, 7), (7, 200, 1)]),
    "ragged split 2": (2, [(2, 3, 5), (5, 4, 7), (7, 200, 1)]),
}
# expert banks (split, cores) shared by E experts with lead rows (E, r_s):
# olmoe-1b-7b's three banks at full width, a ragged one and a depth-3 one
STORED_BANKS = {
    "olmoe-1b-7b w_gate/w_up": (1, [(992, 2048, 43), (43, 1024, 1)]),
    "olmoe-1b-7b w_down": (1, [(977, 1024, 44), (44, 2048, 1)]),
    "ragged bank": (1, [(37, 70, 5), (5, 300, 1)]),
    "depth-3 bank": (1, [(40, 64, 20), (20, 32, 24), (24, 64, 1)]),
}


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


def stored_tensors(shapes, dtype: torch.dtype, gen: torch.Generator, device,
                   experts=None, integer: bool = False):
    """(lead, lead scale, cores, scales) of a stored leaf in ``dtype``: lead
    (r_s,) or (experts, r_s), cores of ``shapes``.  int8 quantizes
    unit-normal values as ``quantize_tt`` does.  ``integer`` draws values in
    {-1, 0, 1} instead, at most about 64 of them nonzero in a lead row, and
    int8 scales of 1: with x in {-1, 0, 1} too, every partial sum of a
    full-width chain is an integer below 2^24, exact in float32."""
    rs = shapes[0][0]
    lshape = (experts, rs) if experts else (rs,)

    def draw(shape, scale):
        if integer:
            return torch.randint(-1, 2, shape, generator=gen,
                                 device=device).float()
        return torch.randn(*shape, generator=gen, device=device) * scale

    lead = draw(lshape, 1.0)
    if integer and rs > 64:
        keep = torch.rand(lshape, generator=gen, device=device) < 64 / rs
        lead = lead * keep
    cores = [draw(c, c[0] ** -0.5) for c in shapes]
    if dtype != torch.int8:
        return lead.to(dtype), None, [c.to(dtype) for c in cores], None
    if integer:
        one = torch.ones((), device=device)
        return (lead.to(torch.int8),
                torch.ones(lshape[:-1], device=device),
                [c.to(torch.int8) for c in cores], [one] * len(cores))
    lq, ls = quantize_array(lead, axis=-1)
    qs = [quantize_array(c) for c in cores]
    return lq, ls, [q for q, _ in qs], [sc for _, sc in qs]


def stored_leaf(split: int, shapes, lead, lead_scale, cores, scales,
                experts=None) -> TTLinear:
    """The TTLinear of one layer (lead already selected) over these
    tensors, with flat in/out shapes."""
    depth = len(shapes)
    n_in = shapes[0][1] * (shapes[1][1] if split == 2 else 1)
    n_out = 1
    for c in shapes[split:]:
        n_out *= c[1]
    return TTLinear(lead=lead, cores=cores, split=split, in_shape=(n_in,),
                    out_shape=(n_out,), experts=experts, scales=scales,
                    lead_scale=lead_scale if scales is not None else None)


def stored_case(split: int, shapes, b: int, dtype: torch.dtype,
                gen: torch.Generator, device, experts=None,
                x_dtype=torch.float32, integer: bool = False):
    """(launch key, kernel call, plain call, library call) of one stored
    call at ``b`` rows (``experts``: E experts of ``b`` tokens each).  The
    kernel call is ``tt_apply`` / ``tt_apply_experts`` on the leaf; the
    plain call ``ref.tt_chain_ref`` / ``tt_chain_experts_ref`` (float32)."""
    lead, ls, cores, scales = stored_tensors(shapes, dtype, gen, device,
                                             experts, integer)
    leaf = stored_leaf(split, shapes, lead, ls, cores, scales, experts)
    n_in = leaf.in_shape[0]
    xs = (experts, b, n_in) if experts else (b, n_in)
    if integer:
        x = torch.randint(-1, 2, xs, generator=gen, device=device).float()
    else:
        x = torch.randn(*xs, generator=gen, device=device)
    x = x.to(x_dtype)
    depth = len(shapes)
    name = f"tt_contract_{depth}{'q' if dtype == torch.int8 else ''}"
    wide = [c.float() if scales is None else dequantize_array(c, sc)
            for c, sc in zip(cores, scales or [None] * depth)]
    lw = lead.float() if ls is None else dequantize_array(
        lead, ls, axis=-1 if experts else None)
    last = wide[-1].reshape(wide[-1].shape[:2])
    xf = x.float()
    if experts:
        name += "_batched"

        def kernel():
            return tt_apply_experts(x, leaf)

        def plain():
            return ops.tt_chain_experts_ref(x, lead, leaf.lead_scale, cores,
                                            scales, split)
        if depth == 2:
            def library():
                return torch.einsum("ecn,snr,es,rm->ecm", xf, wide[0], lw,
                                    last)
        else:
            def library():
                return torch.einsum("ecn,snr,es,rpq,qj->ecpj", xf, wide[0],
                                    lw, wide[1], last).reshape(experts, b, -1)
        return name, kernel, plain, library

    def kernel():
        return tt_apply(x, leaf)

    def plain():
        return ops.tt_chain_ref(x, lead, leaf.lead_scale, cores, scales,
                                split)
    if depth == 2:
        def library():
            return torch.einsum("bn,snr,s,rm->bm", xf, wide[0], lw, last)
    elif split == 1:
        def library():
            return torch.einsum("bn,snr,s,rpq,qj->bpj", xf, wide[0], lw,
                                wide[1], last).reshape(b, -1)
    else:
        x3 = xf.reshape(b, shapes[0][1], shapes[1][1])

        def library():
            return torch.einsum("bap,sar,s,rpq,qj->bj", x3, wide[0], lw,
                                wide[1], last)
    return name, kernel, plain, library

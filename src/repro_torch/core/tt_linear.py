"""TTLinear — apply a dense layer straight from its TT cores.

Port of the JAX package's ``core/tt_linear.py``.  A ``TTLinear`` wraps
one layer-stacked weight:

  * ``lead``    — ``(L, r_s)`` per-layer boundary vectors: the layer-stack
                  modes of the joint TT contracted at every layer index.
                  ``None`` for unstacked weights.
  * ``cores``   — the remaining input/output cores, shared by every layer.
  * ``split``   — how many of ``cores`` are input cores.
  * ``experts`` — MoE expert banks keep one more lead mode: the stacked
                  lead table is ``(L, E, r_s)`` and ``select_layer`` yields
                  ``(E, r_s)``, a family of chains over the same cores that
                  ``tt_apply_experts`` runs as one expert-batched chain.

Quantized storage: ``quantize_tt`` rounds every core to a symmetric int8
grid with one scale per core and one scale per lead row (per layer, and per
(layer, expert) for a bank); the int8 kernels widen the stored cores in
registers and apply the scale product (lead row's and every core's) once
to the output.  Round-to-nearest
bounds the error per element by ``amax / (2·qmax)``.

``tt_apply`` runs the chain from the stored tensors through
``kernels/tt_contract`` — on CUDA tensors the hand-written kernels, which
absorb the selected layer's lead vector into the first core while it
streams, apply the scales and write y in x's dtype, in two launches; on
CPU tensors their plain version (the reference's einsum absorption, then
the chain).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.core import tt as _tt


@dataclass
class TTLinear:
    lead: Optional[torch.Tensor]     # (L[, E], r_s) stacked | ([E,] r_s) | None
    cores: List[torch.Tensor]        # [g (r, n, s), ...]; cores[0] r == r_s
    split: int                       # number of input cores
    in_shape: Tuple[int, ...]        # dense-weight input dims, e.g. (D,)
    out_shape: Tuple[int, ...]       # dense-weight output dims, e.g. (H, K)
    dtype: torch.dtype = torch.bfloat16   # activation dtype of the original
    experts: Optional[int] = None    # expert-bank size E (a lead batch axis)
    scales: Optional[List[torch.Tensor]] = None   # per-core () f32 scales
    lead_scale: Optional[torch.Tensor] = None     # per-lead-row f32 scales:
                                     # (L,) stacked / (L, E) experts / ()

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    @property
    def stacked(self) -> bool:
        """True while the lead table still carries its layer axis."""
        return (self.lead is not None
                and self.lead.ndim == (3 if self.experts else 2))

    @property
    def num_layers(self) -> Optional[int]:
        return int(self.lead.shape[0]) if self.stacked else None

    def tensors(self) -> List[torch.Tensor]:
        """Every resident tensor: lead, cores, scales, lead scales."""
        out = [] if self.lead is None else [self.lead]
        out += list(self.cores)
        out += list(self.scales or [])
        if self.lead_scale is not None:
            out.append(self.lead_scale)
        return out


def is_tt_linear(x) -> bool:
    return isinstance(x, TTLinear)


def select_layer(t: TTLinear, idx: Union[int, torch.Tensor]) -> TTLinear:
    """Layer ``idx``'s view of a stacked TTLinear (cores are shared).
    Out-of-range indices clamp to the last layer, as the reference pins."""
    if not t.stacked:
        return t
    i = min(max(int(idx), 0), t.lead.shape[0] - 1)
    return TTLinear(
        lead=t.lead[i], cores=t.cores, split=t.split, in_shape=t.in_shape,
        out_shape=t.out_shape, dtype=t.dtype, experts=t.experts,
        scales=t.scales,
        lead_scale=None if t.lead_scale is None else t.lead_scale[i],
    )


# ---------------------------------------------------------------------------
# Quantization: symmetric integer cores, per-core / per-lead-row scales
# ---------------------------------------------------------------------------

QUANT_DTYPES = {"int8": torch.int8}


def quant_dtype(name: str) -> torch.dtype:
    """Resolve a ``--weights tt-<name>`` / ``quant=<name>`` storage format."""
    try:
        return QUANT_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown quantized core format {name!r} "
            f"(supported: {sorted(QUANT_DTYPES)})") from None


def _percentile(mag: torch.Tensor, pct: float, axis) -> torch.Tensor:
    """numpy's default (linear) percentile, over ``axis`` or everything."""
    if axis is None:
        srt = mag.reshape(-1).sort().values
        dim = 0
    else:
        srt = mag.sort(dim=axis).values
        dim = axis
    n = srt.shape[dim]
    pos = pct / 100.0 * (n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    a = srt.select(dim, lo)
    b = srt.select(dim, hi)
    return a + (b - a) * (pos - lo)


def _calib_amax(a: torch.Tensor, calib: str, axis=None) -> torch.Tensor:
    """``absmax`` (default) or ``pXX[.X]``: the XX-th percentile of |a|."""
    mag = a.float().abs()
    if calib == "absmax":
        return mag.amax() if axis is None else mag.amax(dim=axis)
    if calib.startswith("p"):
        try:
            pct = float(calib[1:])
        except ValueError:
            pct = -1.0
        if 0.0 < pct <= 100.0:
            return _percentile(mag, pct, axis)
    raise ValueError(
        f"quant calibration must be 'absmax' or 'pXX' (percentile of |w|, "
        f"0 < XX <= 100), got {calib!r}")


def quantize_array(a: torch.Tensor, dtype=torch.int8, calib: str = "absmax",
                   axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, scale) of a symmetric integer quantization of ``a``:
    scale = amax/qmax per group (whole array, or per row over ``axis``),
    values = clip(round(a/scale)); all-zero groups get scale 1."""
    qmax = torch.iinfo(dtype).max
    amax = _calib_amax(a, calib, axis=axis)
    scale = torch.where(amax > 0, amax / qmax,
                        torch.ones_like(amax)).float()
    s = scale if axis is None else scale.unsqueeze(axis)
    q = torch.clamp(torch.round(a.float() / s), -qmax, qmax)
    return q.to(dtype), scale


def dequantize_array(q: torch.Tensor, scale: torch.Tensor,
                     axis=None) -> torch.Tensor:
    """Inverse of ``quantize_array`` (f32 values; exact for the grid)."""
    s = scale if axis is None else scale.unsqueeze(axis)
    return q.float() * s


def quantize_tt(t: TTLinear, dtype=torch.int8,
                calib: str = "absmax") -> TTLinear:
    """One scale per core, one scale per lead row over its rank axis (per
    layer, and per (layer, expert) for an expert bank)."""
    if t.quantized:
        raise ValueError("TTLinear is already quantized")
    cores, scales = [], []
    for g in t.cores:
        q, s = quantize_array(g, dtype=dtype, calib=calib)
        cores.append(q)
        scales.append(s)
    lead, lead_scale = t.lead, None
    if lead is not None:
        lead, lead_scale = quantize_array(lead, dtype=dtype, calib=calib,
                                          axis=-1)
    return TTLinear(lead=lead, cores=cores, split=t.split,
                    in_shape=t.in_shape, out_shape=t.out_shape,
                    dtype=t.dtype, experts=t.experts, scales=scales,
                    lead_scale=lead_scale)


def dequantize_tt(t: TTLinear) -> TTLinear:
    """Back to wide (f32) storage — the oracle for the int8 path."""
    if not t.quantized:
        raise ValueError("TTLinear is not quantized")
    cores = [dequantize_array(g, s) for g, s in zip(t.cores, t.scales)]
    lead = t.lead
    if lead is not None:
        lead = dequantize_array(lead, t.lead_scale, axis=-1)
    return TTLinear(lead=lead, cores=cores, split=t.split,
                    in_shape=t.in_shape, out_shape=t.out_shape,
                    dtype=t.dtype, experts=t.experts)


def quantize_tt_tree(params, dtype=torch.int8, calib: str = "absmax"):
    """Quantize every TTLinear leaf of a params tree (raw leaves pass)."""
    def one(leaf):
        if is_tt_linear(leaf) and not leaf.quantized:
            return quantize_tt(leaf, dtype=dtype, calib=calib)
        return leaf
    return _tree.map_leaves(one, params, is_leaf=is_tt_linear)


def tt_apply(x: torch.Tensor, t: TTLinear) -> torch.Tensor:
    """y = x · W from cores alone; x (..., *in_shape) → (..., *out_shape)."""
    if t.experts:
        raise ValueError("expert-bank TTLinear: use tt_apply_experts")
    if t.lead is not None and t.lead.ndim != 1:
        raise ValueError("stacked TTLinear: select_layer() before apply")
    nin = len(t.in_shape)
    if tuple(x.shape[x.ndim - nin:]) != tuple(t.in_shape):
        raise ValueError(f"input {tuple(x.shape)} does not end in "
                         f"{t.in_shape}")
    batch = x.shape[: x.ndim - nin]
    x2 = x.reshape(math.prod(batch), -1).contiguous()
    if t.lead is None and t.cores[0].shape[0] != 1:
        raise ValueError(f"unstacked first core must have r0 == 1, "
                         f"got {tuple(t.cores[0].shape)}")

    from repro_torch.kernels.tt_contract.ops import tt_chain
    y2 = tt_chain(x2, t.lead, t.lead_scale if t.quantized else None,
                  t.cores, t.scales, t.split)
    return y2.reshape(*batch, *t.out_shape)


def tt_apply_experts(x: torch.Tensor, t: TTLinear) -> torch.Tensor:
    """Expert-banked apply: y[e] = x[e] · W[e] straight from cores.

    x (E, C, *in_shape) → (E, C, *out_shape).  The experts share every
    core and differ only in their lead rows, so the bank runs as one
    expert-batched chain (``tt_chain_experts``); neither the dense
    (E, N_in, N_out) bank nor the absorbed (E, n_1, r_1) first cores exist:
    on CUDA the kernel absorbs the lead rows (E, r_s)·(r_s, n_1, r_1) on the
    tensor cores while the stored first core streams past (bf16, int8).  On
    the CPU the plain version absorbs by einsum, as the reference does."""
    if not t.experts:
        raise ValueError("plain TTLinear: use tt_apply")
    if t.lead is None or t.lead.ndim != 2:
        raise ValueError("stacked expert TTLinear: select_layer() before "
                         "apply")
    e = int(t.lead.shape[0])
    if x.shape[0] != e:
        raise ValueError(f"input {tuple(x.shape)} has no leading axis of "
                         f"{e} experts")
    nin = len(t.in_shape)
    if tuple(x.shape[x.ndim - nin:]) != tuple(t.in_shape):
        raise ValueError(f"input {tuple(x.shape)} does not end in "
                         f"{t.in_shape}")
    batch = x.shape[1: x.ndim - nin]
    x3 = x.reshape(e, math.prod(batch), -1).contiguous()

    from repro_torch.kernels.tt_contract.ops import tt_chain_experts
    y3 = tt_chain_experts(x3, t.lead, t.lead_scale if t.quantized else None,
                          t.cores, t.scales, t.split)
    return y3.reshape(e, *batch, *t.out_shape)


# ---------------------------------------------------------------------------
# Conversion: compressor payload (whole stacked tensor) → TTLinear
# ---------------------------------------------------------------------------

def _group_dims(tt_dims: Sequence[int], orig_shape: Sequence[int]):
    """Partition the tensorized dims into per-original-axis groups (greedy
    prefix products); None when they are not a per-axis concatenation."""
    groups, i = [], 0
    for n in orig_shape:
        prod, start = 1, i
        while prod < n and i < len(tt_dims):
            prod *= tt_dims[i]
            i += 1
        if prod != n:
            return None
        groups.append(i - start)
    return groups if i == len(tt_dims) else None


def tt_linear_from_tt(tt: _tt.TTTensor, orig_shape: Sequence[int],
                      stack: int, in_ndim: int, dtype=torch.bfloat16,
                      core_dtype=torch.float32,
                      experts: int = 0) -> Optional[TTLinear]:
    """Build a TTLinear from a whole-tensor TT of a (stacked) dense weight.

    orig_shape = (*stack_dims, *in_dims, *out_dims).  The stack modes are
    contracted at every layer index into the ``(L, r_s)`` lead table; the
    in/out cores are shared.  ``experts``: how many trailing stack axes
    form an expert bank (MoE weights (L, E, D, F) use stack=2, experts=1);
    they stay a batch axis of the lead table, ``(L, E, r_s)``.  Returns None
    when the TT's dims do not map onto the axes (the caller then
    reconstructs)."""
    if not 0 <= experts <= stack:
        raise ValueError(f"experts {experts} outside 0..stack {stack}")
    groups = _group_dims(tt.shape, orig_shape)
    if groups is None:
        return None
    ns = sum(groups[:stack])
    split = sum(groups[stack: stack + in_ndim])
    if split < 1 or len(tt.cores) - ns - split < 1:
        return None
    if experts and ns == 0:
        return None                  # an expert bank needs its stack modes
    lead = None
    n_experts = None
    cores = [c.float() for c in tt.cores]
    if ns > 0:
        acc = cores[0].reshape(-1, cores[0].shape[2])  # (n_1, r_1)
        for k in range(1, ns):
            r, n, s = cores[k].shape
            acc = (acc @ cores[k].reshape(r, n * s)).reshape(-1, s)
        lead = acc                                     # (L[·E], r_s)
        if experts:
            n_experts = int(np.prod(orig_shape[stack - experts: stack]))
            lead = lead.reshape(-1, n_experts, lead.shape[-1])
        cores = cores[ns:]
    return TTLinear(
        lead=None if lead is None else lead.to(core_dtype).contiguous(),
        cores=[c.to(core_dtype).contiguous() for c in cores], split=split,
        in_shape=tuple(orig_shape[stack: stack + in_ndim]),
        out_shape=tuple(orig_shape[stack + in_ndim:]), dtype=dtype,
        experts=n_experts,
    )


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def tt_param_bytes(tree) -> int:
    """Resident weight bytes: TT leaves count cores, lead, and every scale;
    dense leaves their full tensor."""
    total = 0
    for leaf in _tree.leaves(tree, is_leaf=is_tt_linear):
        if is_tt_linear(leaf):
            total += sum(_nbytes(a) for a in leaf.tensors())
        elif isinstance(leaf, torch.Tensor):
            total += _nbytes(leaf)
    return total


def tt_call_bytes(t: TTLinear) -> int:
    """Stored bytes one apply of a (stacked) leaf reads: one layer's lead
    row(s) and lead scales, every core and core scale."""
    layers = t.num_layers or 1
    total = sum(_nbytes(a) for a in list(t.cores) + list(t.scales or []))
    for a in (t.lead, t.lead_scale):
        if a is not None:
            total += _nbytes(a) // layers
    return total


def tt_leaf_bytes(tree) -> Tuple[int, int]:
    """(resident bytes of the TT-served leaves, dense bytes those leaves
    would occupy un-decomposed)."""
    tt_b, dense_b = 0, 0
    for leaf in _tree.leaves(tree, is_leaf=is_tt_linear):
        if not is_tt_linear(leaf):
            continue
        tt_b += sum(_nbytes(a) for a in leaf.tensors())
        n = int(np.prod(leaf.in_shape)) * int(np.prod(leaf.out_shape))
        n *= (leaf.num_layers or 1) * (leaf.experts or 1)
        dense_b += n * torch.empty((), dtype=leaf.dtype).element_size()
    return tt_b, dense_b


def spectral_decay_pytree(params, alpha: float = 1.0, min_size: int = 8192):
    """Impose a power-law singular spectrum (σ_i ∝ i^-α) on every big ≥2-D
    leaf, as trained weights have (random init is incompressible): the
    leaf reshaped to (rows, last axis) keeps its singular vectors and takes
    σ_i = σ_1·i^-α, on the tensor's own device.

    The reference takes a full SVD.  Here the singular pairs come from the
    float64 Gram matrix of the narrow side (AᵀA = V Σ² Vᵀ, summed over row
    chunks), and the result is A·V diag(σ_target / σ) Vᵀ = U diag(σ_target)
    Vᵀ, streamed in row chunks: no (rows × n) U is formed, and cuSOLVER's
    dense SVD, which refuses an unfolding as tall as an olmoe-1b-7b expert
    bank's (2,097,152 × 1,024), is not needed.  Random leaves are well
    conditioned, so the squared condition number of the Gram matrix costs
    nothing in float64."""
    def one(p):
        if not isinstance(p, torch.Tensor) or p.ndim < 2 or p.numel() < min_size:
            return p
        mat = p.reshape(-1, p.shape[-1])
        wide = mat.shape[0] < mat.shape[1]
        if wide:
            mat = mat.T
        n = mat.shape[1]
        chunks = torch.split(mat, max(1, _DECAY_CHUNK // n))
        gram = torch.zeros((n, n), dtype=torch.float64, device=p.device)
        for rows in chunks:
            r = rows.double()
            gram += r.T @ r
        lam, v = torch.linalg.eigh(gram)                 # ascending
        sig = lam.flip(0).clamp(min=0).sqrt()
        v = v.flip(1)
        k = torch.arange(1, n + 1, dtype=torch.float64, device=p.device)
        target = sig[0] * k ** -alpha
        ratio = torch.where(sig > 0, target / sig.clamp(min=1e-300), 0.0)
        m = ((v * ratio) @ v.T).float()
        out = torch.cat([(rows.float() @ m).to(p.dtype) for rows in chunks])
        return (out.T if wide else out).reshape(p.shape)

    return _tree.map_leaves(one, params)


_DECAY_CHUNK = 1 << 27       # elements per row chunk of spectral_decay_pytree

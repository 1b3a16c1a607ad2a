"""Plain PyTorch versions of the TT-chain contraction (the kernels' oracle).

Same lead-absorbed chain representation as the JAX package's
``kernels/tt_contract/ref.py``: ``cores[0]`` is 2-D ``(n_1, r_1)``, every
later core is 3-D ``(r_{k-1}, n_k, r_k)`` with ``r_N == 1``; the first
``split`` cores are input cores.  The contraction order matches
``tt_reconstruct`` (left to right, one mode at a time).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def tt_contract_ref(x2: torch.Tensor, cores: Sequence[torch.Tensor],
                    split: int) -> torch.Tensor:
    """y = x · W where W is the TT chain; (B, N_in) → (B, N_out) float32."""
    if not 1 <= split <= len(cores):
        raise ValueError(f"split {split} outside 1..{len(cores)}")
    b = x2.shape[0]
    g0 = cores[0]
    if g0.ndim != 2:
        raise ValueError("cores[0] must be lead-absorbed (n1, r1)")
    t = x2.float().reshape(b, g0.shape[0], -1)
    t = torch.einsum("bnm,ns->bms", t, g0.float())
    for g in cores[1:split]:
        r = g.shape[0]
        t = t.reshape(b, g.shape[1], -1, r)
        t = torch.einsum("bnmr,rns->bms", t, g.float())
    t = t.reshape(b, 1, -1)
    for g in cores[split:]:
        t = torch.einsum("bmr,rns->bmns", t, g.float())
        t = t.reshape(b, -1, g.shape[2])
    return t.reshape(b, -1)


def tt_contract_batched_ref(x3: torch.Tensor, g0b: torch.Tensor,
                            cores: Sequence[torch.Tensor],
                            split: int) -> torch.Tensor:
    """Expert-batched chain: y[e] = x[e] · W[e], where the experts differ
    only in their lead-absorbed first core ``g0b`` (E, n1, r1) and share
    the tail ``cores``.  (E, B, N_in) → (E, B, N_out) float32; one einsum
    chain with a leading expert axis, in ``tt_contract_ref``'s order."""
    if not 1 <= split <= 1 + len(cores):
        raise ValueError(f"split {split} outside 1..{1 + len(cores)}")
    e, b, _ = x3.shape
    if g0b.ndim != 3 or g0b.shape[0] != e:
        raise ValueError(f"g0b must be (E={e}, n1, r1), got "
                         f"{tuple(g0b.shape)}")
    t = x3.float().reshape(e, b, g0b.shape[1], -1)
    t = torch.einsum("ebnm,ens->ebms", t, g0b.float())
    for g in cores[: split - 1]:
        r = g.shape[0]
        t = t.reshape(e, b, g.shape[1], -1, r)
        t = torch.einsum("ebnmr,rns->ebms", t, g.float())
    t = t.reshape(e, b, 1, -1)
    for g in cores[split - 1:]:
        t = torch.einsum("ebmr,rns->ebmns", t, g.float())
        t = t.reshape(e, b, -1, g.shape[2])
    return t.reshape(e, b, -1)


def _tail_scale(scales):
    """Product of the tail cores' scales (``None`` entries are wide)."""
    combined = None
    for s in scales:
        if s is not None:
            s = torch.as_tensor(s, dtype=torch.float32)
            combined = s if combined is None else combined * s
    return combined


def tt_chain_ref(x2: torch.Tensor, lead: Optional[torch.Tensor],
                 lead_scale: Optional[torch.Tensor],
                 cores: Sequence[torch.Tensor],
                 scales: Optional[Sequence[Optional[torch.Tensor]]],
                 split: int) -> torch.Tensor:
    """One TTLinear call from its stored tensors, (B, N_in) → (B, N_out)
    float32: the lead row ``lead`` (r_s,) (``None``: the first core is
    (1, n1, r1)) and its ``lead_scale``, the stored first core (r_s, n1, r1)
    and the tail cores, ``scales`` one per core for a quantized leaf.

    The reference's order: dequantize the lead, absorb it into the first
    core (an einsum), apply the first core's scale, run the absorbed chain,
    multiply by the tail scales' product."""
    g0 = cores[0]
    if lead is not None:
        if lead_scale is not None:
            lead = lead.float() * lead_scale
        g0 = torch.einsum("r,rns->ns", lead.float(), g0.float())
    else:
        g0 = g0[0].float()
    combined = None
    if scales is not None:
        g0 = g0 * scales[0]
        combined = _tail_scale(scales[1:])
    y = tt_contract_ref(x2, [g0] + list(cores[1:]), split)
    return y if combined is None else y * combined.reshape(())


def tt_chain_experts_ref(x3: torch.Tensor, lead: torch.Tensor,
                         lead_scale: Optional[torch.Tensor],
                         cores: Sequence[torch.Tensor],
                         scales: Optional[Sequence[Optional[torch.Tensor]]],
                         split: int) -> torch.Tensor:
    """An expert bank's call from its stored tensors: x3 (E, C, N_in), the
    lead rows (E, r_s) with their per-expert ``lead_scale`` (E,), the shared
    cores → (E, C, N_out) float32, in the reference's order (per-expert
    absorption by einsum, then ``tt_contract_batched_ref``)."""
    if lead_scale is not None:
        lead = lead.float() * lead_scale.unsqueeze(-1)
    g0e = torch.einsum("er,rns->ens", lead.float(), cores[0].float())
    combined = None
    if scales is not None:
        g0e = g0e * scales[0]
        combined = _tail_scale(scales[1:])
    y = tt_contract_batched_ref(x3, g0e, list(cores[1:]), split)
    return y if combined is None else y * combined.reshape(())


def tt_dequant_chain(cores: Sequence[torch.Tensor],
                     scales: Sequence[Optional[torch.Tensor]]):
    """Each core widened to f32 and multiplied by its scale (``None`` = the
    core is already wide).  The unfused oracle of the int8 kernels."""
    if len(cores) != len(scales):
        raise ValueError(f"{len(cores)} cores but {len(scales)} scales")
    out = []
    for g, s in zip(cores, scales):
        g = g.float()
        if s is not None:
            g = g * torch.as_tensor(s, dtype=torch.float32, device=g.device)
        out.append(g)
    return out


def tt_dense_ref(cores: Sequence[torch.Tensor], split: int) -> torch.Tensor:
    """Materialize the chain into the dense (N_in, N_out) matrix."""
    acc = cores[0].float()
    n_in = cores[0].shape[0]
    for k, g in enumerate(cores[1:], start=1):
        r = g.shape[0]
        acc = acc.reshape(-1, r) @ g.float().reshape(r, -1)
        if k < split:
            n_in *= g.shape[1]
    return acc.reshape(n_in, -1)

"""Device choice for the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the first CUDA card.

    Without a card and with no device given this raises: the entry points
    never carry on quietly on the CPU.  Pass ``device="cpu"`` to run the
    plain PyTorch paths there (as the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` / a torch dtype → torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt

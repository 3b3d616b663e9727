"""Shared layer initializers (counterpart of ``repro.models.layers``)."""

from __future__ import annotations

import torch


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               device, dtype=torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """[d_in, d_out] normal weights scaled by ``d_in ** -0.5`` (or
    ``scale``), drawn from ``generator`` on its device, returned on
    ``device``."""
    if scale is None:
        scale = d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator,
                    dtype=torch.float32, device=generator.device) * scale
    return w.to(device=device, dtype=dtype)

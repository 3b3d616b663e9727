"""Materialised oracles (counterpart of ``repro.kernels.ref``):
``attention_ref``, the S x S attention that the flash-attention kernel
(``kernels.flash_attention``) computes block by block."""

from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """[B, H, S, D] attention oracle with optional sliding window, in
    float32 (k and v have as many heads as q)."""
    s = q.shape[2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((s, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))

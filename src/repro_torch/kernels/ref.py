"""Materialised oracles (counterpart of ``repro.kernels.ref``), plain
PyTorch on the tensors' device: the spectral Hadamard
(``spectral_hadamard_ref``, of ``kernels.spectral_hadamard``), one
channel's masked Hadamard (``sparse_hadamard_ref``, of the Alg-2 table
executor ``kernels.sparse_hadamard``), the tile FFT and IFFT
(``fft2_tiles_ref``, ``ifft2_tiles_ref``, of ``kernels.fft8``) and the
S x S attention that the flash-attention kernel
(``kernels.flash_attention``) computes block by block
(``attention_ref``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

import repro_torch


def spectral_hadamard_ref(wr: torch.Tensor, wi: torch.Tensor,
                          xr: torch.Tensor, xi: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Y[f,n,p] = sum_m W[f,n,m] X[f,m,p] (complex, f32 planes; TF32 off
    on the card)."""
    if wr.is_cuda:
        repro_torch.strict_fp32()
    w = torch.complex(wr.to(torch.float32), wi.to(torch.float32))
    x = torch.complex(xr.to(torch.float32), xi.to(torch.float32))
    y = torch.einsum("fnm,fmp->fnp", w, x)
    return y.real, y.imag


def sparse_hadamard_ref(values: torch.Tensor, mask: torch.Tensor,
                        xr: torch.Tensor, xi: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked dense Hadamard of one channel: out[n,f,p] = W[n,f] X[f,p].

    values: complex [N, F] (zeros off the pattern), mask [N, F];
    x: [F, P] planes."""
    w = values * mask
    x = torch.complex(xr.to(torch.float32), xi.to(torch.float32))
    y = w[:, :, None] * x[None, :, :]
    return y.real, y.imag


def fft2_tiles_ref(tiles: torch.Tensor, fft_size: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """2-D FFT of square tiles zero-padded to K x K: [..., t, t] ->
    (re, im) [..., K, K] f32."""
    pad = fft_size - tiles.shape[-1]
    y = torch.fft.fft2(F.pad(tiles.to(torch.float32), (0, pad, 0, pad)))
    return y.real.to(torch.float32), y.imag.to(torch.float32)


def ifft2_tiles_ref(yr: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """Real part of the 2-D inverse FFT, f32."""
    return torch.fft.ifft2(torch.complex(yr, yi)).real.to(torch.float32)


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

"""The staged spectral conv and the standalone table executor, as the
user calls them (counterpart of ``repro.kernels.ops``).

``spectral_conv2d_staged`` is the reference's ``spectral_conv2d_pallas``:
three kernel launches per layer (tile-FFT, spectral Hadamard, tile-IFFT)
whose spectral intermediates round-trip through device memory — the
traffic the fused kernel removes — computing the same function.
``hadamard`` is Eq 3 on complex tensors, and
``scheduled_sparse_conv_group`` runs one PE group's Alg-2 schedule
through the Fig-6 table executor, and ``attention`` is the LM's flash
attention.  The [F, N, M] / [F, M, P] plane
relayouts around the kernels are plain PyTorch, made per call, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dataflow import FLOWS
from repro_torch.core.scheduler import SCHEDULERS, build_tables
from repro_torch.core.spectral import (SpectralGeometry,
                                       assemble_valid_tiles,
                                       extract_tiles_overlapping)
from repro_torch.kernels import fft8
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import sparse_hadamard as sh
from repro_torch.kernels import spectral_hadamard as shad

OS = FLOWS[0]


def _w_planes(w_f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex [N, M, K, K] -> (re, im) [F, N, M] f32 planes."""
    n, m = w_f.shape[:2]
    w = w_f.reshape(n, m, -1)
    return tuple(a.permute(2, 0, 1).to(torch.float32).contiguous()
                 for a in (w.real, w.imag))


def _x_plane(a: torch.Tensor, b: int, m: int) -> torch.Tensor:
    """Real [B, M, T, K, K] (or [B*M*T, K, K]) -> [F, M, B*T] f32."""
    kk = a.shape[-1] * a.shape[-1]
    a = a.reshape(b, m, -1, kk)
    return a.permute(3, 1, 0, 2).reshape(kk, m, -1).to(
        torch.float32).contiguous()


def _y_tiles(a: torch.Tensor, b: int, t: int, kk: int) -> torch.Tensor:
    """[F, N, B*T] -> [B*N*T, K, K] (contiguous)."""
    n = a.shape[1]
    return (a.reshape(kk, kk, n, b, t).permute(3, 2, 4, 0, 1)
            .reshape(b * n * t, kk, kk).contiguous())


def hadamard(w_f: torch.Tensor, x_f: torch.Tensor, *, flow: str = OS,
             block_m: int = shad.BLOCK_M_MAX) -> torch.Tensor:
    """Eq 3 through the spectral Hadamard kernel.

    w_f: complex [N, M, K, K];  x_f: complex [B, M, T, K, K]
    returns complex [B, N, T, K, K].  ``flow`` / ``block_m``: the reuse
    flow and, for weight-/input-stationary, the m-range width.
    """
    b, m, t, kk, _ = x_f.shape
    wr, wi = _w_planes(w_f)
    yr, yi = shad.spectral_hadamard(
        wr, wi, _x_plane(x_f.real, b, m), _x_plane(x_f.imag, b, m),
        flow=flow, block_m=block_m)
    n = wr.shape[1]
    y = torch.complex(yr, yi).reshape(kk, kk, n, b, t)
    return y.permute(3, 2, 4, 0, 1).contiguous()


def spectral_conv2d_staged(x: torch.Tensor, w_f: torch.Tensor,
                           geo: SpectralGeometry) -> torch.Tensor:
    """Full spectral conv forward on the staged path: host overlap-save
    windows -> tile-FFT kernel -> spectral Hadamard kernel (output-
    stationary, as the reference's staged backend runs it) -> tile-IFFT
    kernel -> valid-row crop and tile assembly on the host.

    x: [B, M, H, W] f32; w_f: complex [N, M, K, K] spectral kernels (the
    plan's pruned ``kernels.values``; zeros at pruned bins).  Returns
    [B, N, H_out, W_out] before bias and ReLU.  Matches
    ``core.spectral.spectral_conv2d_pretransformed``.
    """
    b, m = x.shape[:2]
    kk = geo.fft_size
    windows = extract_tiles_overlapping(x.to(torch.float32), geo)
    t = windows.shape[2]
    xr, xi = fft8.fft2_tiles(windows.reshape(b * m * t, kk, kk).contiguous(),
                             fft_size=kk)
    wr, wi = _w_planes(w_f)
    yr, yi = shad.spectral_hadamard(wr, wi, _x_plane(xr, b, m),
                                    _x_plane(xi, b, m))
    y_sp = fft8.ifft2_tiles(_y_tiles(yr, b, t, kk), _y_tiles(yi, b, t, kk))
    ov = geo.ksize - 1
    y_tiles = y_sp.reshape(b, wr.shape[1], t, kk, kk)[..., ov:, ov:]
    return assemble_valid_tiles(y_tiles.to(x.dtype), geo)


def group_tables(sk_values, sk_indices, *, r: int = 10,
                 method: str = "exact_cover"
                 ) -> tuple[tuple[torch.Tensor, ...], dict]:
    """One PE group's schedule, per input channel, compiled to stacked
    Fig-6 tables on the host: ``sh.stack_tables`` of every channel's
    ``build_tables``, and the schedule stats (cycles, operations, PE
    utilization).

    sk_values: complex [N', M, K, K]; sk_indices: int [N', M, nnz]
    (tensors or numpy arrays)."""
    vals = np.asarray(torch.as_tensor(sk_values).cpu())
    idx = np.asarray(torch.as_tensor(sk_indices).cpu())
    n_pe, m = vals.shape[:2]
    f = vals.shape[2] * vals.shape[3]
    vals = vals.reshape(n_pe, m, f)
    fn = SCHEDULERS[method]
    tables, cycles, ops = [], 0, 0
    for mm in range(m):
        s = fn(idx[:, mm, :], f, r)
        tables.append(build_tables(s, vals[:, mm, :], idx[:, mm, :]))
        cycles += s.n_cycles
        ops += s.total_ops
    stats = {"cycles": cycles, "ops": ops,
             "utilization": ops / max(1, cycles * n_pe)}
    return sh.stack_tables(tables), stats


def scheduled_sparse_conv_group(sk_values, sk_indices, x_f: torch.Tensor, *,
                                r: int = 10, method: str = "exact_cover"
                                ) -> tuple[torch.Tensor, dict]:
    """Sparse Hadamard for ONE group of N' kernels across all channels,
    executed through the exact-cover schedule's INDEX/VALUE tables
    (``group_tables``, compiled on the host and moved to x_f's device).

    sk_values: complex [N', M, K, K]; sk_indices: int [N', M, nnz];
    x_f: complex [1, M, T, K, K] (batch 1, as in the reference) ->
    returns complex [N', T, K, K] plus the schedule stats.
    """
    b, m, t, kk, _ = x_f.shape
    if b != 1:
        raise ValueError(f"the table executor takes batch 1, got {b}")
    packed, stats = group_tables(sk_values, sk_indices, r=r, method=method)
    x = x_f.reshape(m, t, kk * kk)
    xr = x.real.permute(0, 2, 1).to(torch.float32).contiguous()  # [M, F, T]
    xi = x.imag.permute(0, 2, 1).to(torch.float32).contiguous()
    yr, yi = sh.scheduled_sparse_hadamard(
        *(a.to(x_f.device) for a in packed), xr, xi)
    y = torch.complex(yr, yi).permute(0, 2, 1)                   # [N', T, F]
    return y.reshape(-1, t, kk, kk), stats


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Flash attention, q [B, Hq, S, D], k/v [B, Hkv, S, D]: the kernel
    on a CUDA tensor, its plain version on a CPU tensor."""
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=block_q, block_k=block_k)

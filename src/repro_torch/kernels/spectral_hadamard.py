"""Frequency-binned batched complex GEMM, the spectral Hadamard of Eq 3
(counterpart of ``repro.kernels.spectral_hadamard``).

Per frequency bin f the Hadamard-accumulate stage of a spectral conv is a
complex GEMM contracting input channels:

    Y[f, n, p] = sum_m W[f, n, m] * X[f, m, p]

in the reference's 3-multiplication Karatsuba form (m1 = Wr Xr,
m2 = Wi Xi, m3 = (Wr + Wi)(Xr + Xi); re = m1 - m2, im = m3 - m1 - m2),
which the plain version keeps.  The kernel forms it from four real
products instead (re = Wr Xr - Wi Xi, im = Wr Xi + Wi Xr): in 3xTF32,
Karatsuba's m3 - m1 - m2 lost 4.7e-6 of max|Y| at M = 512 to its
cancellation.  The paper's three dataflows are which operand stays
resident while the other streams: 'output_stationary' sums all M
channels per output tile; 'weight_stationary' keeps a W block of an m
range of ``block_m`` channels and walks every tile; 'input_stationary'
keeps an X block and walks every output-channel block.  The latter two
sum their m ranges' partials in ascending order (the reference's
read-modify-write order).

One hand-written CUDA kernel per flow (``csrc/spectral_hadamard.cu``: the
real products on the tensor cores in 3xTF32, operands through a cp.async
ring; the ws/is ranges go through a split-K workspace and a finish pass,
as does an output-stationary launch whose grid would not fill the card),
with its plain PyTorch version beside it: the wrapper runs the plain
version for CPU tensors, and the tests and the on-card smoke run hold the
kernel to it.  ``launch_geometry`` chooses the output tile and the m
ranges of a launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

import repro_torch
from repro_torch.core.dataflow import FLOWS
from repro_torch.kernels import _build

OS, WS, IS = FLOWS
SOURCES = {"spectral_hadamard": {}}

# The m-range widths (``block_m``) the weight-/input-stationary kernels
# take: whole 16-channel chunks, at most 128 (the reference's default,
# which fits the resident block in a CTA's shared memory).
BLOCK_M_CHUNK, BLOCK_M_MAX = 16, 128

ENTRY_POINTS = {OS: "spectral_hadamard", WS: "spectral_hadamard_ws",
                IS: "spectral_hadamard_is"}
# Kernel launches per entry point (a split-K finish pass belongs to its
# launch), counted where the kernel is launched.
LAUNCHES = dict.fromkeys(ENTRY_POINTS.values(), 0)

# Output-stationary splits M over CTAs when its grid is under one CTA an SM:
# into ranges of whole 16-channel chunks, up to two CTAs an SM.
OS_SPLIT_CTAS_PER_SM = 2


class Geometry(NamedTuple):
    """One launch: an output tile of ``tile_n`` x ``tile_p``, m ranges of
    ``range_m`` channels (``ranges`` of them; more than one goes through a
    split-K workspace of ``workspace`` floats, [ranges, 2, F, N, P])."""
    tile_n: int
    tile_p: int
    ranges: int
    range_m: int
    workspace: int


def launch_geometry(flow: str, f: int, n: int, m: int, p: int,
                    block_m: int, sms: int) -> Geometry:
    """The kernel's tile and m ranges for a flow at [F, N, M] x [F, M, P]:
    the narrowest p tile of 8, 16 or 32 that covers P, with 128 n rows
    (W, which then carries the bytes, streams once), else 64 x 64; ws/is
    ranges of ``block_m``; output-stationary one range, or, where
    F x n tiles x p tiles is under ``sms``, enough 16-channel-aligned
    ranges to bring the grid to two CTAs an SM."""
    tile_p = next((w for w in (8, 16, 32) if p <= w), 64)
    tile_n = 64 if tile_p == 64 else 128
    if flow != OS:
        range_m = block_m
    else:
        base = f * -(-n // tile_n) * -(-p // tile_p)
        g = 1 if base >= sms else min(
            -(-OS_SPLIT_CTAS_PER_SM * sms // base), -(-m // BLOCK_M_CHUNK))
        range_m = m if g == 1 else BLOCK_M_CHUNK * -(-m // (
            BLOCK_M_CHUNK * g))
    g = -(-m // range_m)
    return Geometry(tile_n, tile_p, g, range_m, g * 2 * f * n * p
                    if g > 1 else 0)


def _karatsuba(wr, wi, xr, xi) -> torch.Tensor:
    """[2, F, N, P] (re, im) of one m range: three real ``bmm``s."""
    m1 = torch.bmm(wr, xr)
    m2 = torch.bmm(wi, xi)
    m3 = torch.bmm(wr + wi, xr + xi)
    return torch.stack((m1 - m2, m3 - m1 - m2))


def spectral_hadamard_reference(wr, wi, xr, xi, *, flow: str = OS,
                                block_m: int = BLOCK_M_MAX
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``spectral_hadamard``: the Karatsuba GEMMs over
    all channels (output-stationary) or per m range of ``block_m``
    channels, the ranges' partials summed in ascending order."""
    if wr.is_cuda:
        repro_torch.strict_fp32()
    m = wr.shape[2]
    if flow == OS:
        y = _karatsuba(wr, wi, xr, xi)
    else:
        y = _karatsuba(wr[..., :block_m], wi[..., :block_m], xr[:, :block_m],
                       xi[:, :block_m])
        for m0 in range(block_m, m, block_m):
            m1 = min(m0 + block_m, m)
            y = y + _karatsuba(wr[..., m0:m1], wi[..., m0:m1], xr[:, m0:m1],
                               xi[:, m0:m1])
    return y[0], y[1]


@functools.cache
def library() -> ctypes.CDLL:
    """The spectral Hadamard kernels' library (built at first use)."""
    lib = _build.build(SOURCES)["spectral_hadamard"]
    for name in ENTRY_POINTS.values():
        fn = getattr(lib, name + "_f32")
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(wr, wi, xr, xi) -> None:
    """Shapes, devices, dtypes and contiguity of the four planes."""
    if wr.dim() != 3 or xr.dim() != 3:
        raise ValueError(f"wr/wi must be [F, N, M] and xr/xi [F, M, P], got "
                         f"{tuple(wr.shape)} and {tuple(xr.shape)}")
    f, n, m = wr.shape
    p = xr.shape[2]
    want = dict(wr=(f, n, m), wi=(f, n, m), xr=(f, m, p), xi=(f, m, p))
    for name, t in dict(wr=wr, wi=wi, xr=xr, xi=xi).items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
        if t.device != wr.device:
            raise ValueError(f"{name} is on {t.device}, wr on {wr.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def spectral_hadamard(wr, wi, xr, xi, *, flow: str = OS,
                      block_m: int = BLOCK_M_MAX
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched complex GEMM  Y[f,n,p] = sum_m W[f,n,m] X[f,m,p].

    wr/wi: [F, N, M] f32, xr/xi: [F, M, P] f32 (real and imaginary
    planes, contiguous).  ``flow`` is one of ``FLOWS``; the weight-/
    input-stationary flows sum m ranges of ``block_m`` channels (a
    multiple of 16, at most 128).  Returns (yr, yi): [F, N, P] f32.

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    the flow (``launch_geometry``'s tile and m ranges, plus its split-K
    finish pass when there is more than one range) or raise.
    """
    if flow not in FLOWS:
        raise ValueError(f"flow must be one of {FLOWS}, got {flow!r}")
    if flow != OS and (block_m < BLOCK_M_CHUNK or block_m > BLOCK_M_MAX
                       or block_m % BLOCK_M_CHUNK):
        raise ValueError(f"flow {flow!r}: block_m must be a multiple of "
                         f"{BLOCK_M_CHUNK} up to {BLOCK_M_MAX}, got "
                         f"{block_m}")
    _check(wr, wi, xr, xi)
    if wr.device.type == "cpu":
        return spectral_hadamard_reference(wr, wi, xr, xi, flow=flow,
                                           block_m=block_m)
    if wr.device.type != "cuda":
        raise ValueError(f"no kernel for device {wr.device}")
    f, n, m = wr.shape
    p = xr.shape[2]
    name = ENTRY_POINTS[flow]
    with torch.cuda.device(wr.device):
        yr = torch.empty((f, n, p), dtype=torch.float32, device=wr.device)
        yi = torch.empty_like(yr)
        if min(f, n, m, p) == 0:
            return yr.zero_(), yi.zero_()
        fn = getattr(library(), name + "_f32")
        geo = launch_geometry(flow, f, n, m, p, block_m,
                              _build.sm_count(wr.device))
        ws = (torch.empty(geo.workspace, dtype=torch.float32,
                          device=wr.device) if geo.workspace else None)
        err = fn(wr.data_ptr(), wi.data_ptr(), xr.data_ptr(), xi.data_ptr(),
                 yr.data_ptr(), yi.data_ptr(),
                 0 if ws is None else ws.data_ptr(), f, n, m, p, geo.range_m,
                 geo.tile_p, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        LAUNCHES[name] += 1
    return yr, yi

"""Fused spectral conv: ONE kernel launch per conv layer (counterpart of
``repro.kernels.fused_spectral_conv``).

``fused_spectral_pipeline`` runs tile-FFT -> complex Hadamard summed
over input channels -> valid-row IFFT -> bias + ReLU in one launch of
the hand-written CUDA kernel ``csrc/fused_spectral_conv.cu``
(output-stationary flow); the spectra never reach device memory.
``fused_spectral_pipeline_reference`` is the same function in plain
PyTorch (FFT GEMM -> Karatsuba ``bmm`` -> IFFT GEMM -> bias/ReLU): the
wrapper runs it for CPU tensors, and the tests and the on-card smoke
run hold the kernel to it.

Around the kernel, ``execute_layer_plan`` does the windowed input
path's host-side layout work: overlap-save window extraction into the
s-leading ``[S, M, B*T]`` layout, and valid-tile assembly of the
``[t^2, N, B*T]`` output.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

import repro_torch
from repro_torch.core.spectral import (SpectralGeometry,
                                       assemble_valid_tiles,
                                       extract_tiles_overlapping)
from repro_torch.kernels import _build

# CUDA kernel block sizes (compiled in as -DFSC_*): output channels and
# tiles per CTA, input channels per pipeline step, frequency bins per CTA
# (a cluster of ceil(Fa / BIN_CHUNK) CTAs covers the active bins), threads
# per CTA.  One CTA per SM; its shared memory (laid out in the source)
# fits the 227 KB limit at K = 8.
BLOCK_N, BLOCK_P, BLOCK_M, BIN_CHUNK, THREADS = 64, 16, 8, 8, 512
MAX_CLUSTER = 8       # portable thread-block cluster size

# Kernel launches per wrapper, counted where the kernel is launched.
LAUNCHES = {"fused_spectral_pipeline": 0}


# ---------------------------------------------------------------------------
# DFT operators in flattened (kron) form, overlap-save + active-bin layout
# ---------------------------------------------------------------------------

def dft_matrices(fft_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag parts of the DFT matrix W = exp(-2 pi i jk / K)."""
    j, k = np.meshgrid(np.arange(fft_size), np.arange(fft_size),
                       indexing="ij")
    theta = 2.0 * np.pi * j * k / fft_size
    return (np.cos(theta).astype(np.float32),
            (-np.sin(theta)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def overlap_save_operators(fft_size: int, ksize: int,
                           active: tuple[int, ...] | None = None
                           ) -> tuple[np.ndarray, ...]:
    """(dfr, dfi, dvr, dvi) for the fused kernel.

    dfr/dfi [Fa, K^2]: forward 2-D DFT on flattened K x K windows, rows
        restricted to the active frequency bins.
    dvr/dvi [t^2, Fa]: inverse 2-D DFT restricted to the t^2
        wraparound-free output rows and the active columns.
    """
    cr, ci = dft_matrices(fft_size)
    w = cr + 1j * ci
    d = np.kron(w, w)                                   # [K^2, K^2]
    winv = (cr - 1j * ci) / fft_size                    # conj(W) / K
    dv = np.kron(winv, winv)
    valid = [u * fft_size + v
             for u in range(ksize - 1, fft_size)
             for v in range(ksize - 1, fft_size)]
    dv = dv[valid]                                      # [t^2, K^2]
    if active is not None:
        a = np.asarray(active)
        d = d[a]
        dv = dv[:, a]
    return tuple(np.ascontiguousarray(p, np.float32)
                 for p in (d.real, d.imag, dv.real, dv.imag))


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------

def fused_spectral_pipeline_reference(xt, wr, wi, dfr, dfi, dvr, dvi,
                                      bias, *, relu: bool) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel (same contract as
    ``fused_spectral_pipeline``): FFT GEMM, Karatsuba complex ``bmm``,
    valid-row IFFT GEMM, bias + ReLU."""
    if xt.is_cuda:
        repro_torch.strict_fp32()
    s, m, p = xt.shape
    fa, n, _ = wr.shape
    s2 = dvr.shape[0]
    x2 = xt.reshape(s, m * p)
    xfr = (dfr @ x2).reshape(fa, m, p)
    xfi = (dfi @ x2).reshape(fa, m, p)
    m1 = torch.bmm(wr, xfr)
    m2 = torch.bmm(wi, xfi)
    m3 = torch.bmm(wr + wi, xfr + xfi)
    re = (m1 - m2).reshape(fa, n * p)
    im = (m3 - m1 - m2).reshape(fa, n * p)
    y = (dvr @ re - dvi @ im).reshape(s2, n, p) + bias[0][None, :, None]
    return torch.relu(y) if relu else y


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = _build.build({"fused_spectral_conv": {
        "FSC_BN": BLOCK_N, "FSC_BP": BLOCK_P, "FSC_BM": BLOCK_M,
        "FSC_FC": BIN_CHUNK, "FSC_THREADS": THREADS}})["fused_spectral_conv"]
    fn = lib.fused_spectral_pipeline_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_operands(xt, wr, wi, dfr, dfi, dvr, dvi, bias) -> None:
    ops = dict(xt=xt, wr=wr, wi=wi, dfr=dfr, dfi=dfi, dvr=dvr, dvi=dvi,
               bias=bias)
    for name, t in ops.items():
        if t.device != xt.device:
            raise ValueError(f"{name} is on {t.device}, xt on {xt.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if name != "xt" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    s, m, p = xt.shape
    pitch = xt.stride(1)
    if xt.stride(2) != 1 or pitch < p or xt.stride(0) != m * pitch:
        raise ValueError(f"xt must be rows of P contiguous floats at one "
                         f"pitch, got strides {xt.stride()} for shape "
                         f"{tuple(xt.shape)}")
    fa, n, m_w = wr.shape
    s2 = dvr.shape[0]
    want = dict(wr=(fa, n, m), wi=(fa, n, m), dfr=(fa, s), dfi=(fa, s),
                dvr=(s2, fa), dvi=(s2, fa), bias=(1, n))
    for name, shape in want.items():
        if tuple(ops[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(ops[name].shape)}, "
                             f"expected {shape}")
    if fa > MAX_CLUSTER * BIN_CHUNK:
        raise ValueError(f"active bins {fa} must be at most "
                         f"{MAX_CLUSTER * BIN_CHUNK}")
    if min(s, m, p, fa, n, s2) < 1:
        raise ValueError(f"empty operand: xt {tuple(xt.shape)}, "
                         f"wr {tuple(wr.shape)}, dvr {tuple(dvr.shape)}")


def fused_spectral_pipeline(xt, wr, wi, dfr, dfi, dvr, dvi, bias, *,
                            relu: bool) -> torch.Tensor:
    """FFT -> Hadamard -> IFFT (+ bias/ReLU) in one kernel launch.

    xt:  [S, M, P] f32       overlap-save windows, s-leading (S = K^2,
                             P = B*T); contiguous, or rows of P floats
                             at a larger pitch (``_windows_layout``
                             pads it to a multiple of 4 floats so the
                             kernel copies whole 16-byte vectors)
    wr/wi: [Fa, N, M] f32    spectral kernel planes on the active bins
    dfr/dfi: [Fa, S]         forward DFT rows (active bins)
    dvr/dvi: [S2, Fa]        inverse DFT, valid rows x active columns
    bias: [1, N] f32         per-output-channel bias
    returns [S2, N, P] f32 finished outputs (epilogue applied).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (or raise: also when S and S2 need more shared memory per CTA than
    the card has, which the launch reports).
    """
    if xt.device.type == "cpu":
        return fused_spectral_pipeline_reference(
            xt, wr, wi, dfr, dfi, dvr, dvi, bias, relu=relu)
    if xt.device.type != "cuda":
        raise ValueError(f"no kernel for device {xt.device}")
    _check_operands(xt, wr, wi, dfr, dfi, dvr, dvi, bias)
    s, m, p = xt.shape
    fa, n, _ = wr.shape
    s2 = dvr.shape[0]
    lib = library()
    with torch.cuda.device(xt.device):
        y = torch.empty((s2, n, p), dtype=torch.float32, device=xt.device)
        err = lib.fused_spectral_pipeline_f32(
            xt.data_ptr(), wr.data_ptr(), wi.data_ptr(), dfr.data_ptr(),
            dfi.data_ptr(), dvr.data_ptr(), dvi.data_ptr(),
            bias.data_ptr(), y.data_ptr(), s, m, p, xt.stride(1), fa, n, s2,
            int(relu),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_spectral_pipeline launch failed: "
                           f"cudaError {err}")
    LAUNCHES["fused_spectral_pipeline"] += 1
    return y


# ---------------------------------------------------------------------------
# Layer execution around the kernel (windowed input path)
# ---------------------------------------------------------------------------

def _windows_layout(x: torch.Tensor, geo: SpectralGeometry
                    ) -> tuple[torch.Tensor, int]:
    """Overlap-save windows in the kernel's s-leading layout [S, M, B*T]:
    a view whose rows lie at a pitch rounded up to 4 floats, so every
    row starts 16-byte aligned (the pad columns are never read)."""
    b, m = x.shape[:2]
    windows = extract_tiles_overlapping(x, geo)         # [B, M, T, K, K]
    t_cnt = windows.shape[2]
    s = geo.fft_size * geo.fft_size
    p = b * t_cnt
    buf = torch.empty((s, m, -(-p // 4) * 4), dtype=windows.dtype,
                      device=windows.device)
    xt = buf[:, :, :p]
    xt.view(s, m, b, t_cnt).copy_(
        windows.reshape(b, m, t_cnt, s).permute(3, 1, 0, 2))
    return xt, t_cnt


def _assemble_output(y: torch.Tensor, geo: SpectralGeometry, b: int,
                     n: int, t_cnt: int, dtype) -> torch.Tensor:
    """[t^2, N, B*T] kernel output -> assembled [B, N, H, W]."""
    s2 = geo.tile * geo.tile
    y_tiles = (y.reshape(s2, n, b, t_cnt).permute(2, 1, 3, 0)
               .reshape(b, n, t_cnt, geo.tile, geo.tile))
    return assemble_valid_tiles(y_tiles.to(dtype), geo)


def _fused_conv(x: torch.Tensor, wr, wi, dfr, dfi, dvr, dvi, bias, *,
                geo: SpectralGeometry, relu: bool) -> torch.Tensor:
    """Window layout -> fused kernel -> valid-tile assembly."""
    b = x.shape[0]
    n = wr.shape[1]
    xt, t_cnt = _windows_layout(x.to(torch.float32), geo)
    y = fused_spectral_pipeline(xt, wr, wi, dfr, dfi, dvr, dvi, bias,
                                relu=relu)              # [t^2, N, B*T]
    return _assemble_output(y, geo, b, n, t_cnt, x.dtype)


def execute_layer_plan(x: torch.Tensor, lp) -> torch.Tensor:
    """Run one conv layer from a precompiled ``core.plan.LayerPlan``:
    x [B, M, H, W] -> [B, N, H_out, W_out] (bias and ReLU applied as the
    plan's epilogue says; stride and pooling stay with the caller)."""
    if lp.input_mode != "windowed" or lp.hadamard not in ("dense", "bin"):
        raise NotImplementedError(
            f"layer {lp.layer.name}: input_mode={lp.input_mode!r}, "
            f"hadamard={lp.hadamard!r} are not ported yet (ROADMAP B3/B4)")
    if lp.tuning.flow != "output_stationary":
        raise NotImplementedError(
            f"layer {lp.layer.name}: flow {lp.tuning.flow!r} is not "
            f"ported yet (ROADMAP B2)")
    bias = lp.bias if lp.epilogue.bias else torch.zeros_like(lp.bias)
    return _fused_conv(x, lp.wr, lp.wi, lp.dfr, lp.dfi, lp.dvr, lp.dvi,
                       bias, geo=lp.geo, relu=lp.epilogue.relu)

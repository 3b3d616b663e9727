"""2-D (I)FFT of small tiles (counterpart of ``repro.kernels.fft8``).

The staged spectral conv transforms every K x K overlap-save window on
its own, and every Hadamard output tile back: a batch of small 2-D DFTs,
which for K = 8 are two 8 x 8 products against the DFT matrix

    Y = W X W^T,      W[j, k] = exp(-2 pi i jk / K)

(``fused_spectral_conv.dft_matrices``).  The forward transform maps
real tiles to (re, im) planes; the inverse returns the real part only
(the spectral conv consumes Re(IFFT)).

Each transform is one hand-written CUDA kernel (``csrc/fft_tiles.cu``:
radix-2 butterflies in registers, no DFT-matrix operand) with its plain
PyTorch version (``torch.fft``) beside it: the wrapper runs the plain
version for CPU tensors, and the tests and the on-card smoke run hold the
kernel to it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# The tile size the CUDA kernels are compiled for.
FFT_SIZE = 8
SOURCES = {"fft_tiles": {"FFT_K": FFT_SIZE}}

# Kernel launches per entry point, counted where the kernel is launched.
LAUNCHES = {"fft2_tiles": 0, "ifft2_tiles": 0}

def fft2_tiles_reference(x: torch.Tensor, fft_size: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``fft2_tiles``: zero-pad the [B, t, t] tiles to
    K x K and take ``torch.fft.fft2``."""
    pad = fft_size - x.shape[-1]
    x = torch.nn.functional.pad(x.to(torch.float32), (0, pad, 0, pad))
    y = torch.fft.fft2(x)
    return y.real.contiguous(), y.imag.contiguous()


def ifft2_tiles_reference(yr: torch.Tensor, yi: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version of ``ifft2_tiles``: Re of ``torch.fft.ifft2``."""
    return torch.fft.ifft2(torch.complex(yr, yi)).real.contiguous()


def library() -> ctypes.CDLL:
    """The tile-FFT kernels' library (built at first use)."""
    lib = _build.build(SOURCES)["fft_tiles"]
    lib.fft2_tiles_f32.argtypes = ([ctypes.c_void_p] * 3
                                   + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_void_p])
    lib.ifft2_tiles_f32.argtypes = ([ctypes.c_void_p] * 3
                                    + [ctypes.c_longlong, ctypes.c_void_p])
    lib.fft2_tiles_f32.restype = lib.ifft2_tiles_f32.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32, got {t.dtype} "
                         f"with strides {t.stride()}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def fft2_tiles(x: torch.Tensor, *, fft_size: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, t, t] real tiles (t <= K, zero-padded to K x K) -> (re, im)
    [B, K, K] f32 planes of their 2-D DFT.

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    built for K = ``FFT_SIZE`` (8), which pads t < K tiles as it loads
    them (or raise)."""
    if x.dim() != 3 or x.shape[1] != x.shape[2] or x.shape[1] > fft_size:
        raise ValueError(f"x must be [B, t, t] with t <= {fft_size}, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return fft2_tiles_reference(x, fft_size)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if fft_size != FFT_SIZE:
        raise ValueError(f"the CUDA kernel is built for K = {FFT_SIZE}, "
                         f"got fft_size {fft_size}")
    b, t = x.shape[0], x.shape[1]
    _check("x", x, (b, t, t))
    with torch.cuda.device(x.device):
        yr = torch.empty((b, fft_size, fft_size), dtype=torch.float32,
                         device=x.device)
        yi = torch.empty_like(yr)
        if b:
            _launched("fft2_tiles", library().fft2_tiles_f32(
                x.data_ptr(), yr.data_ptr(), yi.data_ptr(), b, t,
                torch.cuda.current_stream().cuda_stream))
    return yr, yi


def ifft2_tiles(yr: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """(re, im) [B, K, K] f32 planes -> [B, K, K] f32, the real part of
    their 2-D inverse DFT.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (K = ``FFT_SIZE``) or raise."""
    if yr.dim() != 3 or yr.shape[1] != yr.shape[2] or yr.shape != yi.shape:
        raise ValueError(f"yr/yi must be two [B, K, K] planes, got "
                         f"{tuple(yr.shape)} and {tuple(yi.shape)}")
    if yr.device.type == "cpu":
        return ifft2_tiles_reference(yr, yi)
    if yr.device.type != "cuda":
        raise ValueError(f"no kernel for device {yr.device}")
    b = yr.shape[0]
    shape = (b, FFT_SIZE, FFT_SIZE)
    _check("yr", yr, shape)
    _check("yi", yi, shape)
    if yi.device != yr.device:
        raise ValueError(f"yi is on {yi.device}, yr on {yr.device}")
    with torch.cuda.device(yr.device):
        y = torch.empty(shape, dtype=torch.float32, device=yr.device)
        if b:
            _launched("ifft2_tiles", library().ifft2_tiles_f32(
                yr.data_ptr(), yi.data_ptr(), y.data_ptr(), b,
                torch.cuda.current_stream().cuda_stream))
    return y

"""PyTorch + CUDA implementation of the spectral-CNN inference path and
the LM pillar's serving path.

A second implementation of the ``repro`` package, written against
``torch`` and hand-written CUDA kernels for Hopper (``sm_90a``).  The
subpackages mirror ``repro``'s layout so each counterpart is easy to
find:

- ``core``:    tile geometry, spectral transform and pruning, the
               compile-once network plan;
- ``kernels``: the fused spectral-conv kernels, the staged path's
               tile-FFT, spectral Hadamard and tile-IFFT kernels, the
               Alg-2 table executor and the LM's flash attention (CUDA
               sources under ``kernels/csrc``), their plain PyTorch
               versions, the build helper;
- ``models``:  the spectral VGG16 / ResNet-18 forward pass and its
               spatial oracle; the dense LM (config, layers, attention,
               transformer, api);
- ``distributed``, ``launch``: sharded inference (the executor of a
               sharded plan and the device mesh it runs on) and the LM
               server;
- ``configs``: model presets and the LM architecture registry.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain
PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    the CUDA device.  Raises when CUDA is requested but unavailable
    (there is no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def strict_fp32() -> None:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions, so fp32
    work on the card is computed in full fp32 (the parity gates are
    1e-5 relative; TF32 keeps ~3 decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

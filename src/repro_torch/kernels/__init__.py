"""Hand-written CUDA kernels for Hopper, with their plain PyTorch
versions beside them.

- fused_spectral_conv: ONE launch per conv layer — tile-FFT -> complex
  Hadamard over input channels -> valid-row IFFT -> bias + ReLU, spectra
  kept on chip (source: csrc/fused_spectral_conv.cu).

``_build`` compiles ``csrc/*.cu`` with nvcc at first use and loads the
libraries with ctypes.
"""

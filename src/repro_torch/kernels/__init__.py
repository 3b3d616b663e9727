"""Hand-written CUDA kernels for Hopper, with their plain PyTorch
versions beside them.

- fused_spectral_conv: ONE launch per conv layer — tile-FFT -> complex
  Hadamard over input channels (kernel planes, or the Alg-2 tables) ->
  valid-row IFFT -> bias + ReLU, spectra kept on chip; each on host-built
  windows or, on the halo path, on the raw activation, under the
  output-, weight- or input-stationary flow (the latter two add a
  split-K finish launch) (sources: csrc/fused_spectral_conv.cu,
  csrc/fused_spectral_conv_scheduled.cu, csrc/halo.cuh,
  csrc/split_k.cuh).

``_build`` compiles ``csrc/*.cu`` with nvcc at first use and loads the
libraries with ctypes.
"""

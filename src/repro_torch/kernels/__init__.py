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
- fft8, spectral_hadamard: the staged path's three launches per layer —
  tile-FFT, the frequency-binned complex GEMM (three flows), tile-IFFT —
  with the spectra in device memory between them (csrc/fft_tiles.cu,
  csrc/spectral_hadamard.cu); ``ops.spectral_conv2d_staged`` chains them.
- sparse_hadamard: the standalone Alg-2 table executor of one PE group
  (csrc/sparse_hadamard.cu); ``ops.scheduled_sparse_conv_group`` compiles
  the schedule and runs it.
- flash_attention: blocked online-softmax attention, the LM prefill's
  attention at S >= 4096: bf16 on the tensor cores (wgmma, a TMA K/V
  ring; csrc/flash_attention_bf16.cu, csrc/sm90.cuh), f32 on the CUDA
  cores (csrc/flash_attention.cu); ``ops.attention`` is its user entry
  point.

``_build`` compiles ``csrc/*.cu`` with nvcc at first use and loads the
libraries with ctypes; ``build_all`` builds every source at once.
"""


def build_all() -> dict:
    """Build (at first use; one nvcc per source, all started together)
    and load every kernel library of the package, keyed by source name,
    with each entry point's ctypes signature set."""
    from repro_torch.kernels import (_build, fft8, flash_attention,
                                     sparse_hadamard, spectral_hadamard)
    from repro_torch.kernels import fused_spectral_conv as fsc
    mods = (fsc, fft8, spectral_hadamard, sparse_hadamard, flash_attention)
    libs = _build.build({k: v for mod in mods for k, v in mod.SOURCES.items()})
    fsc.library()
    for mod in mods[1:]:
        mod.library()
    return libs

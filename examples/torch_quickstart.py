"""Quickstart on the PyTorch/CUDA port: the paper's three contributions in
~70 lines (the port of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the CUDA device unless given ``--device cpu`` (then the kernels'
plain PyTorch versions run); without a CUDA device and without
``--device cpu`` it fails.
"""

import argparse

import numpy as np
import torch

import repro_torch
from repro_torch.core import optimizer, scheduler, sparse, spectral

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="'cpu' for the plain versions (default: the card)")
args = ap.parse_args()
dev = repro_torch.resolve_device(args.device)
gen = torch.Generator().manual_seed(0)

# 1. Spectral convolution (FFT tiling + Hadamard + IFFT) ----------------
x = torch.randn((1, 8, 56, 56), generator=gen).to(dev)   # NCHW activations
w = torch.randn((16, 8, 3, 3), generator=gen).to(dev)    # OIHW kernel
y_spec = spectral.spectral_conv2d(x, w, fft_size=8)
y_ref = spectral.spatial_conv2d(x, w)
print(f"spectral == spatial:  max|err| = "
      f"{float((y_spec - y_ref).abs().max()):.2e}")

# 2. Sparse spectral kernels + flexible dataflow (Alg 1) -----------------
wf = spectral.spectral_kernel(w, 8)
sk = sparse.prune_magnitude(wf, alpha=4.0)          # K^2/4 nnz per kernel
print(f"pruned kernels: {sk.nnz}/{8 * 8} non-zeros each (alpha=4)")

# Alg 1 on the paper's FPGA model (16-bit words, 1024-deep BRAMs, a
# 2160-BRAM cap, a 20 ms frame): the paper's design point, not a
# measurement of this device
plan = optimizer.optimize(arch_candidates=[(9, 64)])
print(f"Alg 1: P'={plan.p_par} N'={plan.n_par}  "
      f"max bandwidth {plan.bw_max_gbps:.1f} GB/s @ 20 ms (FPGA model)")
lp = plan.layers[0]
print(f"  {lp.layer}: stream params Ps={lp.ps} Ns={lp.ns} "
      f"({lp.n_bram} BRAMs, {lp.transfers_words / 1e6:.1f} Mwords)")

# 3. Exact-cover memory-access scheduling (Alg 2) ------------------------
rng = np.random.default_rng(0)
idx = np.stack([np.sort(rng.choice(64, 16, replace=False))
                for _ in range(64)])                # 64 sparse kernels
for method in ("exact_cover", "lowest_index", "random"):
    s = scheduler.SCHEDULERS[method](idx, 64, r=10)
    scheduler.verify_schedule(s, idx, 64)
    print(f"  {method:12s}: {s.n_cycles:3d} cycles, "
          f"PE utilization {s.pe_utilization:.1%}")

# The schedule compiles to the Fig-6 INDEX/VALUE tables and executes on
# the Alg-2 table executor (B8, csrc/sparse_hadamard.cu), whose user
# entry is repro_torch.kernels.ops.scheduled_sparse_conv_group; the fused
# scheduled kernel runs the same tables inside one launch a layer.

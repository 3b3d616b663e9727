"""End-to-end sparse spectral CNN inference on the PyTorch/CUDA port (the
port of ``examples/spectral_cnn_inference.py``).

Runs the VGG16-family spectral CNN the compile-once way:
``build_network_plan`` does all the offline work in one pass (kernel
transform and per-layer pruning, Alg-2 schedule statistics, active-bin
compaction, the Hopper flow choice, fused-epilogue wiring), and the plan
is then reused across every inference call.

  PYTHONPATH=src python examples/torch_spectral_cnn_inference.py [--full]
      [--backend einsum|staged|fused] [--batch N] [--calls N]
      [--device cpu]

Runs on the CUDA device unless given ``--device cpu`` (then the kernels'
plain PyTorch versions run); without a CUDA device and without
``--device cpu`` it fails.
"""

import argparse
import subprocess
import time

import torch

import repro_torch
from repro_torch.configs import vgg16_spectral
from repro_torch.core import optimizer, sparse
from repro_torch.core.plan import build_network_plan
from repro_torch.models import cnn


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name(0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full 224x224 VGG16 (slow on the CPU)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--backend", default="einsum", choices=cnn.BACKENDS,
                    help="conv-stack implementation (staged / fused run "
                    "the kernels' plain versions on the CPU)")
    ap.add_argument("--calls", type=int, default=3,
                    help="inference calls against the same plan")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions (default: the card)")
    args = ap.parse_args()
    dev = repro_torch.resolve_device(args.device)
    cfg = vgg16_spectral.CONFIG if args.full else vgg16_spectral.SMOKE

    gen = torch.Generator().manual_seed(0)
    params = cnn.init(cfg, generator=gen, device=dev)

    print("[1/4] Alg 1 dataflow plan (the paper's FPGA model, its "
          "baseline; not a measurement of this device)")
    alphas = sparse.per_layer_alphas(cfg.alpha, len(cfg.layers))
    plan_fpga = optimizer.optimize(layers=list(cfg.layers)[1:],
                                   fft_size=cfg.fft_size,
                                   alpha=sum(alphas) / len(alphas),
                                   arch_candidates=[(9, 64)])
    print(f"      max layer bandwidth {plan_fpga.bw_max_gbps:.2f} GB/s, "
          f"total transfers {plan_fpga.total_transfers_words / 1e6:.1f} "
          "Mwords")

    print("[2/4] build NetworkPlan ONCE (prune + Alg 2 + compaction + "
          "flow choice + epilogue wiring)")
    where = card_name() if dev.type == "cuda" else "the CPU"
    t0 = time.time()
    plan = build_network_plan(params, cfg, batch=args.batch, device=dev)
    print(f"      built in {time.time() - t0:.2f}s "
          f"(K={cfg.fft_size}, alpha={cfg.alpha}) [{where}]")

    print("[3/4] per-layer plan: flow / Hadamard mode / input mode / "
          "nnz / active bins / Alg-2 cycles")
    print(f"      {'layer':>9} {'flow':>18} {'hadamard':>9} {'input':>8} "
          f"{'blocks':>12} {'nnz':>4} {'Fa':>3} {'cycles':>6} {'mu':>6}")
    for row in plan.summary():
        blocks = f"{row['block_n']}/{row['block_m']}/{row['block_p']}"
        mu = ("  --" if row["pe_utilization"] is None
              else f"{row['pe_utilization']:.1%}")
        cyc = row["schedule_cycles"] if row["schedule_cycles"] else "--"
        print(f"      {row['layer']:>9} {row['flow']:>18} "
              f"{row['hadamard']:>9} {row['input_mode']:>8} {blocks:>12} "
              f"{row['nnz']:>4} {row['active_bins']:>3} {cyc!s:>6} {mu:>6}")

    print(f"[4/4] inference x{args.calls} reusing the SAME plan "
          f"(backend={args.backend}) on {where}")
    x = torch.randn((args.batch, 3, cfg.image_size, cfg.image_size),
                    generator=gen).to(dev)
    logits = None
    for i in range(args.calls):
        t0 = time.time()
        logits = cnn.forward_spectral(params, plan, x, backend=args.backend)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        note = " (first call)" if i == 0 else ""
        print(f"      call {i + 1}: {(time.time() - t0) * 1e3:7.1f} ms"
              f"{note} [{where}]")
    dense = cnn.forward_spatial(params, cfg, x)
    agree = float((logits.argsort(-1)[:, -5:]
                   == dense.argsort(-1)[:, -5:]).to(torch.float32).mean())
    print(f"      logits {tuple(logits.shape)}; top-5 agreement with dense "
          f"spatial model: {agree:.0%} (alpha={cfg.alpha} pruning changes "
          "logits, as in the paper)")


if __name__ == "__main__":
    main()

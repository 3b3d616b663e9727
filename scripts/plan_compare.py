#!/usr/bin/env python3
"""The autotuned plans of VGG16 and ResNet-18, their choices and times.

    python3 scripts/plan_compare.py [--src SRC] [--reps N] [--json OUT]

Needs one CUDA device and nvcc.  For each model (full width, weights from
``init`` seed 0) it builds the plan ``chip_smoke.py`` (d5) and (dr) build
(``hadamard="auto"``, ``input_mode="auto"``, ``measure=True``, batch 1)
and prints, per conv layer, what the tuner chose (Hadamard kind, input
path, flow, m-range width, shortcut placement) and the measured time of
its choice; then it times ``forward_spectral`` on random images two
ways: the host clock over a forward ending in ``torch.cuda.synchronize()``
(the p50 ``chip_smoke.py`` reports) and CUDA events around a forward that
the host enqueued behind a spin kernel long enough to hide its enqueueing
(the device's own time for the forward).  p50 minus the device time is
the host's share.  ``--src`` puts another checkout's ``src`` first on the
path (its kernels, tuner and plan), so the same call can time a parent
commit unpacked beside this one: run parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPIN_CYCLES = 60_000_000      # ~34 ms at 1.755 GHz: longer than a forward's
                              # enqueueing on the host


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("plan_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.configs.resnet18_spectral import CONFIG as RCFG
    from repro_torch.configs.vgg16_spectral import CONFIG as VCFG
    from repro_torch.core.plan import build_network_plan
    from repro_torch.models import cnn

    repro_torch.strict_fp32()
    dev = torch.device("cuda", 0)
    print(f"plan_compare: {torch.cuda.get_device_name(0)}; plans from "
          f"{Path(repro_torch.__file__).parent}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    out = {}
    for model, cfg in (("vgg16", VCFG), ("resnet18", RCFG)):
        params = cnn.init(cfg, generator=torch.Generator().manual_seed(0),
                          device=dev)
        t0 = time.perf_counter()
        plan = build_network_plan(params, cfg, batch=1, hadamard="auto",
                                  input_mode="auto", measure=True,
                                  device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        rows = []
        for lp in plan.layers:
            tn = lp.tuning
            rows.append({"layer": lp.layer.name, "hadamard": lp.hadamard,
                         "input_mode": lp.input_mode, "flow": tn.flow,
                         "block_m": tn.block_m, "residual": tn.residual,
                         "measured_ms": 1e3 * tn.measured_s})
        kernel_ms = sum(r["measured_ms"] for r in rows)
        x = torch.randn((1, 3, cfg.image_size, cfg.image_size),
                        generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
        run = lambda: cnn.forward_spectral(params, plan, x, backend="fused")
        run()
        torch.cuda.synchronize()
        host, device = [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
        for _ in range(args.reps):
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end))
        p50, dev_ms = statistics.median(host), statistics.median(device)
        print(f"{model}: plan built in {build_s:.1f} s")
        for r in rows:
            print(f"  {r['layer']:8s} {r['hadamard']:9s} "
                  f"{r['input_mode']:8s} {r['flow']:18s} block_m "
                  f"{r['block_m']:3d} residual {str(r['residual']):4s} "
                  f"measured {r['measured_ms']:.4f} ms")
        print(f"{model}: sum of measured choices {kernel_ms:.4f} ms; "
              f"forward p50 (host clock) {p50:.4f} ms; forward device time "
              f"{dev_ms:.4f} ms; p50 minus device {p50 - dev_ms:+.4f} ms")
        out[model] = {"layers": rows, "kernel_ms": kernel_ms,
                      "p50_ms": p50, "device_ms": dev_ms,
                      "build_s": build_s}
        del plan, params
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

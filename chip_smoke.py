#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device (Hopper, sm_90a) and nvcc; exits non-zero without
a result when there is none, and never falls back to the CPU.  Phases,
each of which fails the run on error:

  (a) device: torch/CUDA versions, device name and count, the card's
      name and power limit from nvidia-smi;
  (b) build: compile every CUDA kernel of the port from the sources in
      this checkout, print build time and the ptxas report;
  (c) kernel vs plain version at the 13 full-width VGG16 layer shapes,
      at every batch size (d) serves (1 and 4: the plan's own operands,
      windows of a random activation in the main path's layout): max
      relative error (gate 1e-4, TF32 off); at batch 1 also kernel /
      plain / dense F.conv2d times (CUDA events, L2 flushed before every
      launch, median of 25) and the layer's bound;
  (d) the main path: full VGG16 (alpha 4) weights from ``init`` and a
      plan from ``build_network_plan`` on the card, four batch-1
      forwards and one batch-4 forward through
      ``forward_spectral(backend="fused")``; launch counts checked (13
      per forward), logits held to ``backend="einsum")`` on the same
      plan (gate 1e-4 relative, top-1 equal), p50 latency per batch
      size and peak device memory;
  (e) one status line per kernel, then one JSON line with every
      kernel's numbers, then the device JSON as the last line.

Bounds use the H100 SXM data-sheet peaks: 67 TFLOP/s fp32 on CUDA
cores, 3.35 TB/s HBM3.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
KERNEL_TOL = 1e-4      # max|kernel - plain| / max|plain|, fp32, TF32 off
LOGITS_TOL = 1e-4      # max|fused - einsum| / max|einsum| on the logits
REPS = 25
SEED = 0
BATCHES = (1, 1, 1, 1, 4)   # the main path's requests, images each


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def timed_ms(fn, flush) -> float:
    """Median device time of ``fn`` over REPS launches, L2 flushed
    before each (CUDA events around every launch)."""
    import torch
    fn()
    times = []
    for _ in range(REPS):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def layer_bound(s, m, p, fa, n, s2) -> tuple[float, float, str]:
    """(flops, bytes, bound_by) of one fused layer: tile-FFT (2 real
    GEMMs), Karatsuba Hadamard (3 real GEMMs), valid-row IFFT (2 real
    GEMMs) and epilogue; each operand read once, the output written
    once."""
    flops = (4 * fa * s * m * p + 6 * fa * n * m * p + 4 * s2 * fa * n * p
             + 2 * s2 * n * p)
    nbytes = 4 * (s * m * p + 2 * fa * n * m + 2 * fa * s + 2 * s2 * fa
                  + n + s2 * n * p)
    by = ("operations" if flops / PEAK_FP32_FLOPS >= nbytes / HBM_BYTES_PER_S
          else "bytes")
    return flops, nbytes, by


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    import repro_torch
    from repro_torch.configs.vgg16_spectral import CONFIG
    from repro_torch.core.plan import build_network_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_spectral_conv as fsc
    from repro_torch.models import cnn

    repro_torch.strict_fp32()
    dev = torch.device("cuda", 0)

    # (a) device ---------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"(a) torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name!r}, count {count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)

    # (b) build ----------------------------------------------------------
    t0 = time.perf_counter()
    fsc.library()
    log = _build.BUILD_LOG["fused_spectral_conv"]
    print(f"(b) built fused_spectral_conv.cu for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {log['seconds']:.2f} s)")
    for line in log["ptxas"]:
        print(f"    {line.strip()}")

    # main-path setup: full VGG16 weights and plan on the card ------------
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    params = cnn.init(CONFIG, generator=gen, device=dev)
    plan = build_network_plan(params, CONFIG, batch=1, device=dev)
    torch.cuda.synchronize()
    print(f"    plan {plan.name}: {len(plan.layers)} conv layers, built in "
          f"{time.perf_counter() - t0:.1f} s; active bins "
          f"{[lp.n_active_bins for lp in plan.layers]}")

    # (c) kernel vs plain at every layer shape ----------------------------
    flush_buf = torch.empty(128 * 2 ** 20 // 4, device=dev)
    flush = flush_buf.zero_
    xgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = []
    print("(c) layer      M    N     P  Fa   rel_err  max_abs   kernel_ms"
          "   plain_ms   bound_ms  bound_by    conv2d_ms   (batch-4 P, "
          "rel_err, max_abs)")
    for lp in plan.layers:
        layer = lp.layer
        s, fa = lp.dfr.shape[1], lp.dfr.shape[0]
        s2, m, n = lp.dvr.shape[0], layer.c_in, layer.c_out
        checked = {}
        for b in sorted(set(BATCHES), reverse=True):   # batch 1 last
            x_img = torch.randn((b, m, layer.h_in, layer.w_in),
                                generator=xgen, device=dev)
            xt, t_cnt = fsc._windows_layout(x_img, lp.geo)
            ops = (xt, lp.wr, lp.wi, lp.dfr, lp.dfi, lp.dvr, lp.dvi,
                   lp.bias)
            y = fsc.fused_spectral_pipeline(*ops, relu=True)
            torch.cuda.synchronize()
            ref = fsc.fused_spectral_pipeline_reference(*ops, relu=True)
            err, abs_err = rel_err(y, ref), float((y - ref).abs().max())
            if not torch.isfinite(y).all() or err > KERNEL_TOL:
                fail(f"{layer.name} batch {b}: kernel vs plain rel err "
                     f"{err:.3e} > {KERNEL_TOL:g}")
            checked[b] = (b * t_cnt, err, abs_err)
        p, err, _ = checked[1]
        abs_err = max(c[2] for c in checked.values())
        k_ms = timed_ms(lambda: fsc.fused_spectral_pipeline(*ops, relu=True),
                        flush)
        p_ms = timed_ms(
            lambda: fsc.fused_spectral_pipeline_reference(*ops, relu=True),
            flush)
        w_sp = torch.randn((n, m, 3, 3), generator=xgen, device=dev)
        c_ms = timed_ms(lambda: F.conv2d(x_img, w_sp, padding=1), flush)
        flops, nbytes, by = layer_bound(s, m, p, fa, n, s2)
        b_ms = 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
        rows.append(dict(layer=layer.name, err=err, abs_err=abs_err,
                         ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, by=by,
                         flops=flops, bytes=nbytes, conv2d_ms=c_ms))
        p4, err4, abs4 = checked[max(checked)]
        print(f"    {layer.name:8s} {m:4d} {n:4d} {p:5d} {fa:3d} {err:9.2e} "
              f"{checked[1][2]:8.2e} {k_ms:10.4f} {p_ms:10.4f} {b_ms:10.4f}  "
              f"{by:10s} {c_ms:10.4f}   ({p4}, {err4:.2e}, {abs4:.2e})")
    del flush_buf
    tot = {k: sum(r[k] for r in rows)
           for k in ("ms", "plain_ms", "bound_ms", "conv2d_ms", "flops",
                     "bytes")}
    ops_s = tot["flops"] / PEAK_FP32_FLOPS
    bytes_s = tot["bytes"] / HBM_BYTES_PER_S
    print(f"    total (one batch-1 forward): kernel {tot['ms']:.4f} ms, "
          f"plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
          f"({tot['flops'] / 1e9:.2f} GFLOP, {tot['bytes'] / 1e9:.3f} GB), "
          f"dense conv2d {tot['conv2d_ms']:.4f} ms")

    # (d) the main path ---------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    images = [torch.randn((b, 3, CONFIG.image_size, CONFIG.image_size),
                          generator=xgen, device=dev)
              for b in BATCHES]
    for k in fsc.LAUNCHES:
        fsc.LAUNCHES[k] = 0
    latency: dict[int, list[float]] = {}
    logits = []
    for x in images:
        t0 = time.perf_counter()
        out = cnn.forward_spectral(params, plan, x, backend="fused")
        torch.cuda.synchronize()
        latency.setdefault(x.shape[0], []).append(
            1e3 * (time.perf_counter() - t0))
        logits.append(out)
    launches = dict(fsc.LAUNCHES)
    want = len(plan.layers) * len(images)
    if launches["fused_spectral_pipeline"] != want:
        fail(f"main path launched the fused kernel "
             f"{launches['fused_spectral_pipeline']} times, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    for x, out in zip(images, logits):
        b = x.shape[0]
        if out.shape != (b, CONFIG.n_classes) or not torch.isfinite(out).all():
            fail(f"batch-{b} logits: shape {tuple(out.shape)} or not finite")
        ref = cnn.forward_spectral(params, plan, x, backend="einsum")
        err = rel_err(out, ref)
        top1 = bool((out.argmax(-1) == ref.argmax(-1)).all())
        print(f"(d) batch {b}: fused vs einsum logits rel err {err:.3e}, "
              f"max|logit| {float(ref.abs().max()):.3e}, top-1 equal {top1}")
        if err > LOGITS_TOL or not top1:
            fail(f"batch-{b} fused logits disagree with the einsum oracle")
    for b, ts in sorted(latency.items()):
        print(f"    p50 latency batch {b}: {statistics.median(ts):.2f} ms "
              f"over {len(ts)} forwards {[round(t, 2) for t in ts]}")
    print(f"    launches {launches}; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB")

    # (e) kernels ---------------------------------------------------------
    print(f"(e) fused_spectral_pipeline: ok, "
          f"launches={launches['fused_spectral_pipeline']}")
    kernels = [{
        "name": "fused_spectral_pipeline",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_spectral_conv.cu",
        "replaces": "src/repro/kernels/fused_spectral_conv.py:775",
        "launches": launches["fused_spectral_pipeline"],
        "max_abs_err": max(r["abs_err"] for r in rows),
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

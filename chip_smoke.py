#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device (Hopper, sm_90a) and nvcc; exits non-zero without
a result when there is none, and never falls back to the CPU.  Phases,
each of which fails the run on error:

  (a) device: torch/CUDA versions, device name and count, the card's
      name and power limit from nvidia-smi;
  (b) build: compile every CUDA kernel of the port from the sources in
      this checkout (one nvcc per source, started together), print build
      time and the ptxas report;
  (c) plane kernel vs its plain version at the 13 full-width VGG16
      layer shapes, at every batch size (d) serves (1 and 4: the plan's
      own operands, windows of a random activation in the main path's
      layout): max relative error (gate 1e-4, TF32 off); at batch 1
      also kernel / plain / dense F.conv2d times (CUDA events, L2
      flushed before every launch, median of REPS) and the layer's
      bound;
  (d) the main path: full VGG16 (alpha 4) weights from ``init`` and a
      plan from ``build_network_plan`` on the card, four batch-1
      forwards and one batch-4 forward through
      ``forward_spectral(backend="fused")``; launch counts checked (13
      per forward), logits held to ``backend="einsum"`` on the same
      plan (gate 1e-4 relative, top-1 equal), p50 latency per batch
      size and peak device memory;
  (c2) the scheduled plan (``hadamard="scheduled"``, Alg-2 tables for
      all 13 layers) from the same weights: plan-build and
      schedule-compile seconds, per layer T, exact Eq-14 utilization,
      table and plane bytes; the scheduled kernel vs its plain version
      at every layer shape at batch 1 and 4 (gate 1e-4), batch-1 times
      and bound as in (c);
  (d2) the same five forwards on the scheduled plan: 13 scheduled-kernel
      launches per forward and none of the plane kernel, logits vs
      einsum, p50 latency and peak memory;
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


def bound_of(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms on the card, what bounds it)."""
    ops_s, bytes_s = flops / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def layer_bound(s, m, p, fa, n, s2) -> tuple[float, float]:
    """(flops, bytes) of one plane-kernel layer: tile-FFT (2 real GEMMs),
    Karatsuba Hadamard (3 real GEMMs), valid-row IFFT (2 real GEMMs) and
    epilogue; each operand read once, the output written once."""
    flops = (4 * fa * s * m * p + 6 * fa * n * m * p + 4 * s2 * fa * n * p
             + 2 * s2 * n * p)
    nbytes = 4 * (s * m * p + 2 * fa * n * m + 2 * fa * s + 2 * s2 * fa
                  + n + s2 * n * p)
    return flops, nbytes


def sched_layer_bound(s, m, p, fa, n, s2, entries, table_bytes
                      ) -> tuple[float, float]:
    """(flops, bytes) of one scheduled-kernel layer: tile-FFT, one
    complex MAC (8 flops) per non-zero table entry and tile, valid-row
    IFFT, epilogue; windows, the four tables, operators, bias and output
    each moved once."""
    flops = (4 * fa * s * m * p + 8 * entries * p + 4 * s2 * fa * n * p
             + 2 * s2 * n * p)
    nbytes = (4 * (s * m * p + 2 * fa * s + 2 * s2 * fa + n + s2 * n * p)
              + table_bytes)
    return flops, nbytes


def check_layers(plan, label, kernel, plain, make_ops, bound, xgen, flush,
                 extra=None):
    """Hold ``kernel`` to ``plain`` at every layer of ``plan``, at every
    batch size of BATCHES (the plan's operands, windows of a random
    activation in the main path's layout); time both at batch 1.
    ``make_ops(lp, xt)`` gives the arguments that ``kernel(lp, ops)``
    and ``plain(lp, ops)`` take, ``bound(lp, p)`` the call's (flops,
    bytes), ``extra(lp, x_img, flush)`` one more timed context number.
    Returns the rows and their totals."""
    import torch
    from repro_torch.kernels import fused_spectral_conv as fsc
    rows = []
    for lp in plan.layers:
        layer = lp.layer
        checked = {}
        for b in sorted(set(BATCHES), reverse=True):   # batch 1 last
            x_img = torch.randn((b, layer.c_in, layer.h_in, layer.w_in),
                                generator=xgen, device=flush.device)
            xt, t_cnt = fsc._windows_layout(x_img, lp.geo)
            ops = make_ops(lp, xt)
            y = kernel(lp, ops)
            torch.cuda.synchronize()
            ref = plain(lp, ops)
            err, abs_err = rel_err(y, ref), float((y - ref).abs().max())
            if not torch.isfinite(y).all() or err > KERNEL_TOL:
                fail(f"{label} {layer.name} batch {b}: kernel vs plain rel "
                     f"err {err:.3e} > {KERNEL_TOL:g}")
            checked[b] = (b * t_cnt, err, abs_err)
        p, err, abs1 = checked[1]
        k_ms = timed_ms(lambda: kernel(lp, ops), flush.zero_)
        p_ms = timed_ms(lambda: plain(lp, ops), flush.zero_)
        flops, nbytes = bound(lp, p)
        b_ms, by = bound_of(flops, nbytes)
        row = dict(layer=layer.name, m=layer.c_in, n=layer.c_out, p=p,
                   fa=lp.n_active_bins, err=err, abs_err=max(
                       c[2] for c in checked.values()), ms=k_ms,
                   plain_ms=p_ms, bound_ms=b_ms, by=by, flops=flops,
                   bytes=nbytes, batch4=checked[max(checked)])
        if extra is not None:
            row["extra_ms"] = extra(lp, x_img, flush.zero_)
        rows.append(row)
        p4, err4, abs4 = row["batch4"]
        extra_s = f"{row['extra_ms']:10.4f}" if extra else " " * 10
        print(f"    {layer.name:8s} {row['m']:4d} {row['n']:4d} {p:5d} "
              f"{row['fa']:3d} {err:9.2e} {abs1:8.2e} {k_ms:10.4f} "
              f"{p_ms:10.4f} {b_ms:10.4f}  {by:10s} {extra_s}   "
              f"({p4}, {err4:.2e}, {abs4:.2e})")
    tot = {k: sum(r[k] for r in rows)
           for k in ("ms", "plain_ms", "bound_ms", "flops", "bytes")}
    tot["by"] = bound_of(tot["flops"], tot["bytes"])[1]
    tot["abs_err"] = max(r["abs_err"] for r in rows)
    print(f"    total (one batch-1 forward): kernel {tot['ms']:.4f} ms, "
          f"plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
          f"({tot['flops'] / 1e9:.2f} GFLOP, {tot['bytes'] / 1e9:.3f} GB)")
    return rows, tot


def serve(params, plan, cfg, images, label, kernel_name, other_name):
    """Drive the main path once: every image batch through
    ``forward_spectral(backend="fused")`` with the launch counts set to 0
    just before and read just after; hold the logits to einsum."""
    import torch
    from repro_torch.kernels import fused_spectral_conv as fsc
    from repro_torch.models import cnn
    torch.cuda.reset_peak_memory_stats()
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
    if launches[kernel_name] != want or launches[other_name] != 0:
        fail(f"{label} launched {launches}, expected {want} launches of "
             f"{kernel_name} and none of {other_name}")
    peak = torch.cuda.max_memory_allocated()
    for x, out in zip(images, logits):
        b = x.shape[0]
        if out.shape != (b, cfg.n_classes) or not torch.isfinite(out).all():
            fail(f"{label} batch-{b} logits: shape {tuple(out.shape)} or "
                 f"not finite")
        ref = cnn.forward_spectral(params, plan, x, backend="einsum")
        err = rel_err(out, ref)
        top1 = bool((out.argmax(-1) == ref.argmax(-1)).all())
        print(f"{label} batch {b}: fused vs einsum logits rel err "
              f"{err:.3e}, max|logit| {float(ref.abs().max()):.3e}, top-1 "
              f"equal {top1}")
        if err > LOGITS_TOL or not top1:
            fail(f"{label} batch-{b} fused logits disagree with the einsum "
                 f"oracle")
    for b, ts in sorted(latency.items()):
        print(f"    p50 latency batch {b}: {statistics.median(ts):.2f} ms "
              f"over {len(ts)} forwards {[round(t, 2) for t in ts]}")
    print(f"    launches {launches}; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB")
    return launches[kernel_name]


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
    fsc.build_all()
    print(f"(b) built {sorted(_build.BUILD_LOG)} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s")
    for src, log in sorted(_build.BUILD_LOG.items()):
        print(f"    {src}.cu: nvcc {log['seconds']:.2f} s")
        for line in log["ptxas"]:
            print(f"      {line.strip()}")

    # main-path setup: full VGG16 weights and plan on the card ------------
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    params = cnn.init(CONFIG, generator=gen, device=dev)
    plan = build_network_plan(params, CONFIG, batch=1, device=dev)
    torch.cuda.synchronize()
    print(f"    plan {plan.name}: {len(plan.layers)} conv layers, built in "
          f"{time.perf_counter() - t0:.1f} s; active bins "
          f"{[lp.n_active_bins for lp in plan.layers]}")

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    xgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    header = ("layer      M    N     P  Fa   rel_err  max_abs   kernel_ms"
              "   plain_ms   bound_ms  bound_by   {:>9s}   (batch-4 P, "
              "rel_err, max_abs)")

    # (c) plane kernel vs plain at every layer shape ----------------------
    def conv2d_ms(lp, x_img, flush_fn):
        w_sp = torch.randn((lp.layer.c_out, lp.layer.c_in, 3, 3),
                           generator=xgen, device=dev)
        return timed_ms(lambda: F.conv2d(x_img, w_sp, padding=1), flush_fn)

    print("(c) " + header.format("conv2d_ms"))
    rows, tot = check_layers(
        plan, "(c)",
        lambda lp, ops: fsc.fused_spectral_pipeline(*ops, relu=True),
        lambda lp, ops: fsc.fused_spectral_pipeline_reference(*ops,
                                                               relu=True),
        lambda lp, xt: (xt, lp.wr, lp.wi, lp.dfr, lp.dfi, lp.dvr, lp.dvi,
                        lp.bias),
        lambda lp, p: layer_bound(lp.dfr.shape[1], lp.layer.c_in, p,
                                  lp.n_active_bins, lp.layer.c_out,
                                  lp.dvr.shape[0]),
        xgen, flush, extra=conv2d_ms)
    print(f"    dense conv2d total {sum(r['extra_ms'] for r in rows):.4f} ms")

    # (d) the main path, plane plan ---------------------------------------
    images = [torch.randn((b, 3, CONFIG.image_size, CONFIG.image_size),
                          generator=xgen, device=dev)
              for b in BATCHES]
    plane_launches = serve(params, plan, CONFIG, images, "(d)",
                           "fused_spectral_pipeline",
                           "fused_spectral_pipeline_scheduled")
    del plan

    # (c2) scheduled plan and kernel vs plain at every layer shape --------
    t0 = time.perf_counter()
    splan = build_network_plan(params, CONFIG, batch=1, hadamard="scheduled",
                               device=dev)
    torch.cuda.synchronize()
    print(f"(c2) scheduled plan: built in {time.perf_counter() - t0:.1f} s, "
          f"of which Alg-2 table compile {splan.schedule_seconds:.1f} s")
    if any(lp.hadamard != "scheduled" for lp in splan.layers):
        fail("(c2) not every layer of the scheduled plan is scheduled")
    entries = {}
    print("     layer      T   Eq-14 mu   cycles    table_MB   plane_MB")
    for lp in splan.layers:
        tb = lp.tables
        entries[lp.layer.name] = int(((tb.vr != 0) | (tb.vi != 0)).sum())
        print(f"     {lp.layer.name:8s} {tb.idx.shape[2]:3d} "
              f"{lp.pe_utilization:9.4f} {lp.schedule_cycles:8d} "
              f"{tb.nbytes / 1e6:10.3f} {2 * lp.wr.nbytes / 1e6:10.3f}")
    print(f"     total: tables "
          f"{sum(lp.tables.nbytes for lp in splan.layers) / 1e9:.3f} GB, "
          f"planes {sum(2 * lp.wr.nbytes for lp in splan.layers) / 1e9:.3f}"
          f" GB")
    print("     " + header.format(""))
    srows, stot = check_layers(
        splan, "(c2)",
        lambda lp, ops: fsc.fused_spectral_pipeline_scheduled(
            *ops, n_out=lp.layer.c_out, relu=True),
        lambda lp, ops: fsc.fused_spectral_pipeline_scheduled_reference(
            *ops, n_out=lp.layer.c_out, relu=True),
        lambda lp, xt: (xt, *lp.tables, lp.dfr, lp.dfi, lp.dvr, lp.dvi,
                        lp.bias),
        lambda lp, p: sched_layer_bound(
            lp.dfr.shape[1], lp.layer.c_in, p, lp.n_active_bins,
            lp.layer.c_out, lp.dvr.shape[0], entries[lp.layer.name],
            lp.tables.nbytes),
        xgen, flush)
    del flush

    # (d2) the main path, scheduled plan ----------------------------------
    sched_launches = serve(params, splan, CONFIG, images, "(d2)",
                           "fused_spectral_pipeline_scheduled",
                           "fused_spectral_pipeline")

    # (e) kernels ---------------------------------------------------------
    print(f"(e) fused_spectral_pipeline: ok, launches={plane_launches}")
    print(f"(e) fused_spectral_pipeline_scheduled: ok, "
          f"launches={sched_launches}")
    kernels = [{
        "name": "fused_spectral_pipeline",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_spectral_conv.cu",
        "replaces": "src/repro/kernels/fused_spectral_conv.py:775",
        "launches": plane_launches,
        "max_abs_err": tot["abs_err"],
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": tot["by"],
        "library_ms": None,
    }, {
        "name": "fused_spectral_pipeline_scheduled",
        "route": "cuda",
        "source": ("src/repro_torch/kernels/csrc/"
                   "fused_spectral_conv_scheduled.cu"),
        "replaces": "src/repro/kernels/fused_spectral_conv.py:1114",
        "launches": sched_launches,
        "max_abs_err": stot["abs_err"],
        "ms": stot["ms"],
        "plain_ms": stot["plain_ms"],
        "bound_ms": stot["bound_ms"],
        "bound_by": stot["by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

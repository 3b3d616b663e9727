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
  (c3) the halo plane kernel (B3, raw NCHW activation in, no host window
      tensor) vs its plain version at every layer shape and batch as in
      (c), on the plane plan moved to ``input_mode="halo"``; per layer
      also the windowed kernel's time on the same input, max|halo -
      windowed| after assembly, and the share of idle tile slots;
  (d3) the main path on that halo plan: 13 launches of the halo kernel
      per forward and none of the others, logits vs einsum, p50 latency
      and p50 minus the kernel sum beside (d)'s, peak memory;
  (c4), (d4) the same for the halo scheduled kernel (B5) on the
      scheduled plan moved to ``input_mode="halo"`` (the tables do not
      depend on the input path, so nothing is recompiled);
  (e) a check that no process this run started is still running, one
      status line per kernel, then one JSON line with every kernel's
      numbers, then the device JSON as the last line.

Bounds use the H100 SXM data-sheet peaks: 67 TFLOP/s fp32 on CUDA
cores, 3.35 TB/s HBM3.
"""

from __future__ import annotations

import json
import os
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


def child_processes() -> list[str]:
    """Command lines of this process's live children (Linux /proc)."""
    me = str(os.getpid())
    found = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            if (d / "stat").read_text().rsplit(")", 1)[1].split()[1] == me:
                found.append((d / "cmdline").read_bytes()
                             .replace(b"\0", b" ").decode().strip())
        except OSError:         # the process ended while we looked
            continue
    return found


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


def halo_layer_bound(lp, b, ops_bytes, flops) -> tuple[float, float]:
    """(flops, bytes) of one halo-kernel layer: the windowed kernel's
    operations on the real tiles (``flops``), and bytes = the raw
    activation read once + the kernel's other operands (``ops_bytes``:
    planes or tables, operators, bias) + the [B, N, H_out, W_out]
    output written once."""
    layer = lp.layer
    x_bytes = 4 * b * layer.c_in * layer.h_in * layer.w_in
    out_bytes = 4 * b * layer.c_out * layer.out_hw[0] * layer.out_hw[1]
    return flops, x_bytes + ops_bytes + out_bytes


def idle_share(lp, slots: int) -> float:
    """Share of a halo kernel's tile slots that hold no tile: slots per
    CTA times halo blocks, against the layer's tiles."""
    from repro_torch.core import spectral as spec
    hg = spec.halo_block_geometry(lp.geo, lp.tuning.block_p)
    return 1.0 - lp.geo.n_tiles / (hg.n_blocks * slots)


def check_layers(plan, label, kernel, plain, make_ops, bound, xgen, flush,
                 extra=None, twin=None):
    """Hold ``kernel`` to ``plain`` at every layer of ``plan``, at every
    batch size of BATCHES (the plan's operands, a random activation);
    time both at batch 1.  ``make_ops(lp, x_img)`` gives the arguments
    that ``kernel(lp, ops)`` and ``plain(lp, ops)`` take (windows in the
    main path's layout, or the raw activation), ``bound(lp, b)`` the
    batch-b call's (flops, bytes), ``extra(lp, x_img, flush)`` more
    batch-1 columns {name: value}, ``twin(lp, x_img)`` the windowed
    twin kernel's assembled [B, N, H, W] output on the same input, held
    as max|y - twin|.  Returns the rows and their totals."""
    import torch
    rows = []
    for lp in plan.layers:
        layer = lp.layer
        checked, twin_diff = {}, 0.0
        for b in sorted(set(BATCHES), reverse=True):   # batch 1 last
            x_img = torch.randn((b, layer.c_in, layer.h_in, layer.w_in),
                                generator=xgen, device=flush.device)
            ops = make_ops(lp, x_img)
            y = kernel(lp, ops)
            torch.cuda.synchronize()
            ref = plain(lp, ops)
            err, abs_err = rel_err(y, ref), float((y - ref).abs().max())
            if not torch.isfinite(y).all() or err > KERNEL_TOL:
                fail(f"{label} {layer.name} batch {b}: kernel vs plain rel "
                     f"err {err:.3e} > {KERNEL_TOL:g}")
            if twin is not None:
                twin_diff = max(twin_diff,
                                float((y - twin(lp, x_img)).abs().max()))
            checked[b] = (b * lp.geo.n_tiles, err, abs_err)
        p, err, abs1 = checked[1]
        k_ms = timed_ms(lambda: kernel(lp, ops), flush.zero_)
        p_ms = timed_ms(lambda: plain(lp, ops), flush.zero_)
        flops, nbytes = bound(lp, 1)
        b_ms, by = bound_of(flops, nbytes)
        row = dict(layer=layer.name, m=layer.c_in, n=layer.c_out, p=p,
                   fa=lp.n_active_bins, err=err, abs_err=max(
                       c[2] for c in checked.values()), ms=k_ms,
                   plain_ms=p_ms, bound_ms=b_ms, by=by, flops=flops,
                   bytes=nbytes, batch4=checked[max(checked)])
        if twin is not None:
            row["twin_abs"] = twin_diff
        if extra is not None:
            row.update(extra(lp, x_img, flush.zero_))
        rows.append(row)
        p4, err4, abs4 = row["batch4"]
        cols = "".join(f" {k}={v:.4g}" for k, v in row.items()
                       if k == "twin_abs" or k.startswith("x_"))
        print(f"    {layer.name:8s} {row['m']:4d} {row['n']:4d} {p:5d} "
              f"{row['fa']:3d} {err:9.2e} {abs1:8.2e} {k_ms:10.4f} "
              f"{p_ms:10.4f} {b_ms:10.4f}  {by:10s}   ({p4}, {err4:.2e}, "
              f"{abs4:.2e}){cols}")
    tot = {k: sum(r[k] for r in rows)
           for k in ("ms", "plain_ms", "bound_ms", "flops", "bytes")}
    tot["by"] = bound_of(tot["flops"], tot["bytes"])[1]
    tot["abs_err"] = max(r["abs_err"] for r in rows)
    for k in rows[0]:
        if k.startswith("x_") and k.endswith("_ms"):
            tot[k] = sum(r[k] for r in rows)
    if twin is not None:
        tot["twin_abs"] = max(r["twin_abs"] for r in rows)
    print(f"    total (one batch-1 forward): kernel {tot['ms']:.4f} ms, "
          f"plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
          f"({tot['flops'] / 1e9:.2f} GFLOP, {tot['bytes'] / 1e9:.3f} GB)"
          + "".join(f", {k} {v:.4f}" for k, v in tot.items()
                    if k.startswith("x_") or k == "twin_abs"))
    return rows, tot


def serve(params, plan, cfg, images, label, kernel_name, kernel_sum_ms):
    """Drive the main path once: every image batch through
    ``forward_spectral(backend="fused")`` with the launch counts set to 0
    just before and read just after (13 launches of ``kernel_name`` per
    forward, none of any other kernel); hold the logits to einsum.
    Returns the launches and the batch-1 p50 minus ``kernel_sum_ms``."""
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
    if launches != {k: want if k == kernel_name else 0 for k in launches}:
        fail(f"{label} launched {launches}, expected {want} launches of "
             f"{kernel_name} and none of the other kernels")
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
    host_ms = statistics.median(latency[1]) - kernel_sum_ms
    print(f"    batch-1 p50 minus the kernel sum {kernel_sum_ms:.4f} ms: "
          f"{host_ms:.2f} ms")
    print(f"    launches {launches}; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB")
    return launches[kernel_name], host_ms


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
    from repro_torch.core import spectral as spec
    from repro_torch.core.plan import build_network_plan, with_input_mode
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
              "   plain_ms   bound_ms  bound_by     (batch-4 P, rel_err, "
              "max_abs) [more]")

    def windows(lp, x_img):
        return fsc._windows_layout(x_img, lp.geo)[0]

    def halo_blocks(lp):
        return spec.halo_block_geometry(lp.geo, lp.tuning.block_p)

    def plane_bound(lp, b):
        return layer_bound(lp.dfr.shape[1], lp.layer.c_in,
                           b * lp.geo.n_tiles, lp.n_active_bins,
                           lp.layer.c_out, lp.dvr.shape[0])

    def plane_ops_bytes(lp):
        return 4 * (lp.wr.numel() + lp.wi.numel() + lp.dfr.numel()
                    + lp.dfi.numel() + lp.dvr.numel() + lp.dvi.numel()
                    + lp.bias.numel())

    def assembled(kernel_fn, lp, x_img, ops):
        """A windowed kernel's output on x_img, assembled to NCHW."""
        xt, t_cnt = fsc._windows_layout(x_img, lp.geo)
        return fsc._assemble_output(kernel_fn(xt, *ops), lp.geo,
                                    x_img.shape[0], lp.layer.c_out, t_cnt,
                                    x_img.dtype)

    # (c) plane kernel vs plain at every layer shape ----------------------
    def conv2d_ms(lp, x_img, flush_fn):
        w_sp = torch.randn((lp.layer.c_out, lp.layer.c_in, 3, 3),
                           generator=xgen, device=dev)
        return {"x_conv2d_ms": timed_ms(
            lambda: F.conv2d(x_img, w_sp, padding=1), flush_fn)}

    print("(c) " + header)
    rows, tot = check_layers(
        plan, "(c)",
        lambda lp, ops: fsc.fused_spectral_pipeline(*ops, relu=True),
        lambda lp, ops: fsc.fused_spectral_pipeline_reference(*ops,
                                                               relu=True),
        lambda lp, x_img: (windows(lp, x_img), lp.wr, lp.wi, lp.dfr, lp.dfi,
                           lp.dvr, lp.dvi, lp.bias),
        plane_bound, xgen, flush, extra=conv2d_ms)
    print(f"    dense conv2d total {tot['x_conv2d_ms']:.4f} ms")

    # (d) the main path, plane plan ---------------------------------------
    images = [torch.randn((b, 3, CONFIG.image_size, CONFIG.image_size),
                          generator=xgen, device=dev)
              for b in BATCHES]
    plane_launches, plane_host = serve(params, plan, CONFIG, images, "(d)",
                                       "fused_spectral_pipeline", tot["ms"])

    # (c3) halo plane kernel vs plain at every layer shape ----------------
    hplan = with_input_mode(plan, "halo")
    print("(c3) halo plane plan: blocks "
          f"{[(h.bth, h.btw) for h in map(halo_blocks, hplan.layers)]}")
    print("     " + header)

    def plane_windowed(lp, x_img):
        return assembled(
            lambda xt, *o: fsc.fused_spectral_pipeline(xt, *o, relu=True),
            lp, x_img, (lp.wr, lp.wi, lp.dfr, lp.dfi, lp.dvr, lp.dvi,
                        lp.bias))

    def plane_halo_extra(lp, x_img, flush_fn):
        xt = windows(lp, x_img)
        ops = (lp.wr, lp.wi, lp.dfr, lp.dfi, lp.dvr, lp.dvi, lp.bias)
        return {"x_windowed_ms": timed_ms(
            lambda: fsc.fused_spectral_pipeline(xt, *ops, relu=True),
            flush_fn), "x_idle": idle_share(lp, fsc.BLOCK_P)}

    hrows, htot = check_layers(
        hplan, "(c3)",
        lambda lp, ops: fsc.fused_spectral_pipeline_halo(
            *ops, geo=lp.geo, hg=halo_blocks(lp), relu=True),
        lambda lp, ops: fsc.fused_spectral_pipeline_halo_reference(
            *ops, geo=lp.geo, hg=halo_blocks(lp), relu=True),
        lambda lp, x_img: (x_img, lp.wr, lp.wi, lp.dfr, lp.dfi, lp.dvr,
                           lp.dvi, lp.bias),
        lambda lp, b: halo_layer_bound(lp, b, plane_ops_bytes(lp),
                                       plane_bound(lp, b)[0]),
        xgen, flush, extra=plane_halo_extra, twin=plane_windowed)

    # (d3) the main path, halo plane plan ---------------------------------
    halo_launches, halo_host = serve(params, hplan, CONFIG, images, "(d3)",
                                     "fused_spectral_pipeline_halo",
                                     htot["ms"])
    print(f"    p50 minus kernel sum, batch 1: (d3) halo {halo_host:.2f} ms,"
          f" (d) windowed {plane_host:.2f} ms")
    del plan, hplan

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
    def sched_bound(lp, b):
        return sched_layer_bound(
            lp.dfr.shape[1], lp.layer.c_in, b * lp.geo.n_tiles,
            lp.n_active_bins, lp.layer.c_out, lp.dvr.shape[0],
            entries[lp.layer.name], lp.tables.nbytes)

    print("     " + header)
    srows, stot = check_layers(
        splan, "(c2)",
        lambda lp, ops: fsc.fused_spectral_pipeline_scheduled(
            *ops, n_out=lp.layer.c_out, relu=True),
        lambda lp, ops: fsc.fused_spectral_pipeline_scheduled_reference(
            *ops, n_out=lp.layer.c_out, relu=True),
        lambda lp, x_img: (windows(lp, x_img), *lp.tables, lp.dfr, lp.dfi,
                           lp.dvr, lp.dvi, lp.bias),
        sched_bound, xgen, flush)

    # (d2) the main path, scheduled plan ----------------------------------
    sched_launches, sched_host = serve(
        params, splan, CONFIG, images, "(d2)",
        "fused_spectral_pipeline_scheduled", stot["ms"])

    # (c4) halo scheduled kernel vs plain at every layer shape ------------
    shplan = with_input_mode(splan, "halo")
    print("(c4) halo scheduled plan (the (c2) plan's tables): blocks "
          f"{[(h.bth, h.btw) for h in map(halo_blocks, shplan.layers)]}")
    print("     " + header)

    def sched_windowed(lp, x_img):
        return assembled(
            lambda xt, *o: fsc.fused_spectral_pipeline_scheduled(
                xt, *o, n_out=lp.layer.c_out, relu=True),
            lp, x_img, (*lp.tables, lp.dfr, lp.dfi, lp.dvr, lp.dvi,
                        lp.bias))

    def sched_halo_extra(lp, x_img, flush_fn):
        xt = windows(lp, x_img)
        ops = (*lp.tables, lp.dfr, lp.dfi, lp.dvr, lp.dvi, lp.bias)
        return {"x_windowed_ms": timed_ms(
            lambda: fsc.fused_spectral_pipeline_scheduled(
                xt, *ops, n_out=lp.layer.c_out, relu=True), flush_fn),
            "x_idle": idle_share(lp, fsc.SCHED_BLOCK_P)}

    def sched_ops_bytes(lp):
        return lp.tables.nbytes + 4 * (
            lp.dfr.numel() + lp.dfi.numel() + lp.dvr.numel()
            + lp.dvi.numel() + lp.bias.numel())

    shrows, shtot = check_layers(
        shplan, "(c4)",
        lambda lp, ops: fsc.fused_spectral_pipeline_scheduled_halo(
            *ops, geo=lp.geo, hg=halo_blocks(lp), n_out=lp.layer.c_out,
            relu=True),
        lambda lp, ops: fsc.fused_spectral_pipeline_scheduled_halo_reference(
            *ops, geo=lp.geo, hg=halo_blocks(lp), n_out=lp.layer.c_out,
            relu=True),
        lambda lp, x_img: (x_img, *lp.tables, lp.dfr, lp.dfi, lp.dvr,
                           lp.dvi, lp.bias),
        lambda lp, b: halo_layer_bound(lp, b, sched_ops_bytes(lp),
                                       sched_bound(lp, b)[0]),
        xgen, flush, extra=sched_halo_extra, twin=sched_windowed)
    del flush

    # (d4) the main path, halo scheduled plan -----------------------------
    shalo_launches, shalo_host = serve(
        params, shplan, CONFIG, images, "(d4)",
        "fused_spectral_pipeline_scheduled_halo", shtot["ms"])
    print(f"    p50 minus kernel sum, batch 1: (d4) halo {shalo_host:.2f} "
          f"ms, (d2) windowed {sched_host:.2f} ms")

    # every process this run started (nvcc, nvidia-smi, the table pool and
    # its resource tracker) has ended
    left = child_processes()
    if left:
        fail(f"processes still running at the end: {left}")

    # (e) kernels ---------------------------------------------------------
    csrc = "src/repro_torch/kernels/csrc/"
    ref_file = "src/repro/kernels/fused_spectral_conv.py"
    kernels = []
    for kname, src, line, launches, t in (
            ("fused_spectral_pipeline", "fused_spectral_conv.cu", 775,
             plane_launches, tot),
            ("fused_spectral_pipeline_scheduled",
             "fused_spectral_conv_scheduled.cu", 1114, sched_launches, stot),
            ("fused_spectral_pipeline_halo", "fused_spectral_conv.cu", 943,
             halo_launches, htot),
            ("fused_spectral_pipeline_scheduled_halo",
             "fused_spectral_conv_scheduled.cu", 1032, shalo_launches,
             shtot)):
        print(f"(e) {kname}: ok, launches={launches}")
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": csrc + src,
            "replaces": f"{ref_file}:{line}",
            "launches": launches,
            "max_abs_err": t["abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

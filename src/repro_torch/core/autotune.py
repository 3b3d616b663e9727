"""Alg 1 on the H100: per-layer choice of reuse flow, Hadamard mode, input
path and m-range width for the fused kernels, and the Hopper cost model
it minimizes (counterpart of ``repro.core.autotune`` and of the
reference's ``tpu_fused_flow_cost``).

The paper's Alg 1 searches the streaming parameters of each layer under
an on-chip memory cap, minimizing modelled latency.  Here the knobs are
those the CUDA kernels are built for (``kernels.fused_spectral_conv``):

  flow      output-, weight- or input-stationary: which operand a CTA
            keeps in shared memory while it walks the others;
  hadamard  kernel planes ('dense' / 'bin') or the Alg-2 tables
            ('scheduled');
  input     host-built windows or the in-kernel halo gather;
  block_m   for the weight-/input-stationary flows, the m-range width a
            CTA keeps resident (G = ceil(M / block_m) ranges, the
            reference's block_m); the CTAs' n and tile blocks are fixed
            by the build;
  residual  for a node whose shortcut add is fused into the kernel, where
            the kernel reads the shortcut: 'hbm' (from device memory at
            the flush) or 'vmem' (output-stationary only: staged in
            shared memory before the channel loop, when it fits and,
            on the plane kernel, when its launch is not split).

The cap is the 232,448 bytes of shared memory a CTA may take, and the
model is ``hopper_fused_flow_cost``.  One level up, on a D-device mesh,
``autotune_layer_sharded`` adds the partitioning strategy (replicate,
channel, spatial) and prices ``hopper_sharded_flow_cost``: one device's
kernel on its shard-local layer plus the collective's bytes over NVLink.  As in Alg 1, the grid is
enumerated, configurations over the cap are dropped and the predicted
argmin is kept; with a measurement callable (``_make_measure_fn``: the
layer's own operands on the card) the best few predictions are timed and
the fastest wins.  The model does not price the copy that makes a
windowed producer's cropped output contiguous for a halo layer, and the
measurement times each layer on a fresh contiguous activation.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import statistics
from typing import Callable, Iterable, Sequence

import torch

from repro_torch.core import dataflow as df
from repro_torch.core.spectral import halo_block_geometry, make_geometry
from repro_torch.kernels import fused_spectral_conv as fsc

# H100 SXM figures (NVIDIA data sheet; none of the reference's TPU_*).
H100_HBM_BYTES_PER_S = 3.35e12     # HBM3
H100_FP32_FLOPS = 67e12            # fp32 FMA on CUDA cores, no tensor cores
H100_SMS = 132
H100_SMEM_PER_CTA = fsc.SMEM_PER_CTA   # 232,448 B of dynamic shared memory
H100_L2_BYTES = 50e6
# NVLink 4 on the H100 SXM: 900 GB/s from a card to the others of its
# host, 450 GB/s each way (NVIDIA's published per-direction figure, not a
# measurement).  The sharded cost model charges collective bytes at it.
H100_NVLINK_BYTES_PER_S = 450e9
# Clusters of c output-stationary CTAs (one an SM) an H100 runs at once,
# by c: ``fsc.os_cluster_capacity`` (plane) and
# ``fsc.sched_cluster_capacity`` (scheduled) on an NVIDIA H100 80GB HBM3
# (chip_smoke.py (c), (c2)).  Clusters stay within a GPC, so large ones
# leave SMs idle; the model prices both kernels' launches with it.
H100_OS_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}

# Alg-2 knobs for pricing tables before they exist (paper S6.3: r = 10;
# mu, the Eq-14 PE utilization, measures 0.850-0.857 on full VGG16 at
# alpha 4, so the schedule length is T ~= nnz / mu cycles).
SCHEDULE_R = 10
SCHEDULE_MU = 0.85

# Candidates the measured pass times, best predictions first, and the
# seed of the activation it times them on.
MEASURE_TOP_K = 3
MEASURE_SEED = 0

# (WAVE_S, STEP_S) per (Hadamard kind, flow, input path): seconds per
# output rectangle a CTA finishes (IFFT, cluster reduction, store) and per
# channel step, in time = waves * (rects * WAVE_S + steps * STEP_S), waves
# the launch's CTA waves (``kernel_grid``).  Least-squares fit to the
# batch-1 device times (the wrapper's host work hidden) of the kernels it
# prices at the 13 full-width VGG16 layers: the plane kernel's weight- and
# input-stationary flows and the scheduled kernel's three flows,
# chip_smoke.py (c2), (c4)-(c6) ``x_device_ms`` on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md); the times and the fit are in
# tests/test_torch_autotune.py.  A step is latency-bound, so this term,
# not bytes or flops, is what the measured times follow.  The plane
# kernel's output-stationary launch is priced by its own launch model
# (``fsc.os_launch_geometry``, ``fsc.os_latency_s``), the one the wrapper
# launches by.
LATENCY_FIT = {
    # the weight- and input-stationary launches' own models, by which the
    # wrapper sizes them (``fsc.ws_launch_geometry``,
    # ``fsc.is_launch_geometry``)
    ("plane", "weight_stationary", "windowed"): fsc.WS_LATENCY["windowed"],
    ("plane", "weight_stationary", "halo"): fsc.WS_LATENCY["halo"],
    ("plane", "input_stationary", "windowed"): fsc.IS_LATENCY["windowed"],
    ("plane", "input_stationary", "halo"): fsc.IS_LATENCY["halo"],
    ("scheduled", "output_stationary", "windowed"): (
        2.417234150923295e-05, 2.3071455926639617e-06),
    ("scheduled", "output_stationary", "halo"): (
        2.804302569726495e-05, 2.5289022589124823e-06),
    # the scheduled flows' tensor-core kernel, on the launch its rule
    # (``fsc.sched_flow_geometry``) makes
    ("scheduled", "weight_stationary", "windowed"): (
        2.167906518364264e-05, 2.4414513672509603e-06),
    ("scheduled", "weight_stationary", "halo"): (
        3.05368631906136e-05, 1.6925894244673041e-06),
    ("scheduled", "input_stationary", "windowed"): (
        2.4828405252647998e-05, 1.6634074739346286e-06),
    ("scheduled", "input_stationary", "halo"): (
        2.5698183158294748e-05, 1.7191858308973211e-06),
}


def kernel_grid(layer: df.ConvLayer, fft_size: int, flow: str,
                hadamard: str, input_mode: str, batch: int, block_m: int,
                active_bins: int) -> dict[str, int]:
    """The CUDA launch a layer gets: CTAs, their ``waves``, channel steps
    per CTA, output rectangles per CTA (``rects``), tile blocks, m ranges
    (``ranges``), the split-K workspace's slices (``slices``; 1 for none)
    and tile slots, and the cluster ranks that share an output-stationary
    CTA's rectangle (``ranks``: its cluster over the bin chunks, or the
    scheduled kernel's channel split), from the kernels' block sizes and
    each flow's loop structure (the grid rules of
    ``csrc/fused_spectral_conv*.cu``).  The plane kernel's
    output-stationary launch is the wrapper's own,
    ``fsc.os_launch_geometry`` on ``H100_OS_CLUSTERS`` (the halo path
    takes its windowed twin's split over its own tile blocks); the
    scheduled one's cluster is ``fsc.sched_cluster`` on the same
    capacity, whose waves count its clusters; the plane weight-stationary
    launch is the wrapper's own, ``fsc.ws_launch_geometry`` on the same
    capacity (``split``: chunks of tile blocks; the halo path takes its
    windowed twin's split over its own blocks); the scheduled weight- and
    input-stationary launches are the wrapper's own,
    ``fsc.sched_flow_geometry`` on ``H100_SMS`` (``split``: ws chunks of
    tile blocks, is shares of the group walk)."""
    geo = make_geometry(layer.h_in, layer.w_in, layer.ksize, fft_size,
                        layer.pad)
    sched = hadamard == "scheduled"
    bp = fsc.SCHED_BLOCK_P if sched else fsc.BLOCK_P
    if input_mode == "halo":
        pb = batch * halo_block_geometry(geo, min(bp, geo.n_tiles)).n_blocks
    else:
        pb = -(-batch * geo.n_tiles // bp)
    m = layer.c_in
    g = 1 if flow == fsc.OS else -(-m // block_m)
    width = m if g == 1 else block_m
    ranks, waves, slices, split = 1, None, g, 1
    if sched:
        nb = -(-layer.c_out // fsc.SCHED_BLOCK_N)      # kernel groups
        halves = fsc.sched_halves(min(fsc.SCHED_BLOCK_N, layer.c_out))
        if flow == fsc.OS:
            ranks = c = fsc.sched_cluster(pb * nb * halves, m,
                                          H100_OS_CLUSTERS)
            ctas, steps, rects = pb * nb * halves * c, -(-m // c), 1
            waves = -(-pb * nb * halves // H100_OS_CLUSTERS[c])
        else:       # the wrapper's launch rule
            fg = fsc.sched_flow_geometry(flow, pb, g, width, nb * halves,
                                         H100_SMS)
            ctas, waves, steps, rects = fg.ctas, fg.waves, fg.steps, \
                fg.rects
            split = fg.split
    else:
        nb = -(-layer.c_out // fsc.BLOCK_N)
        ranks = chunks = -(-active_bins // fsc.BIN_CHUNK)
        ksteps = -(-width // fsc.BLOCK_M)
        if flow == fsc.OS:
            og = fsc.os_launch_geometry(
                -(-batch * geo.n_tiles // fsc.BLOCK_P), layer.c_out, m,
                active_bins, geo.tile ** 2, H100_OS_CLUSTERS)
            clusters = pb * nb * og.ranges * (chunks // og.cluster)
            waves = -(-clusters // H100_OS_CLUSTERS[og.cluster])
            ranks, g, slices = og.cluster, og.ranges, og.slices
            ctas, steps = clusters * og.cluster, -(-og.range_m // fsc.BLOCK_M)
            rects = 1
        elif flow == fsc.WS:        # the wrapper's launch rule
            nb = -(-layer.c_out // fsc.WS_BLOCK_N)
            wg = fsc.ws_launch_geometry(
                -(-batch * geo.n_tiles // fsc.BLOCK_P), nb, g, width,
                chunks, H100_OS_CLUSTERS[chunks])
            per = -(-pb // wg.split)
            clusters = -(-pb // per) * nb * g
            ctas, rects = clusters * chunks, per
            steps = per * ksteps + fsc.WS_SETUP_STEPS
            waves = -(-clusters // H100_OS_CLUSTERS[chunks])
            split = wg.split
        else:
            ctas, steps, rects = pb * g * chunks, ksteps * (1 + nb), nb
            ig = fsc.is_launch_geometry(
                -(-batch * geo.n_tiles // fsc.BLOCK_P), g, width,
                layer.c_out, active_bins, geo.tile ** 2, H100_OS_CLUSTERS)
            ranks, slices = ig.cluster, ig.slices
            waves = -(-pb * g * (chunks // ig.cluster)
                      // H100_OS_CLUSTERS[ig.cluster])
    if waves is None:
        waves = -(-ctas // H100_SMS)
    return {"ctas": ctas, "waves": waves, "steps": steps, "rects": rects,
            "p_blocks": pb, "n_blocks": nb, "ranges": g, "slices": slices,
            "slots": pb * bp, "ranks": ranks, "split": split}


def hopper_fused_flow_cost(layer: df.ConvLayer, fft_size: int,
                           alpha: float, flow: str, hadamard: str,
                           input_mode: str, *, batch: int = 1,
                           active_bins: int | None = None,
                           r: int = SCHEDULE_R,
                           t_cycles: int | None = None,
                           block_m: int | None = None,
                           residual: str | None = None) -> dict[str, float]:
    """Bytes, operations, shared memory and predicted seconds of ONE
    fused-kernel launch on the H100 (the counterpart of the reference's
    ``tpu_fused_flow_cost``).

    Args:
      layer, fft_size, alpha: the conv layer, tile size K and kernel
        compression (nnz = K^2 / alpha kept bins per kernel).
      flow: one of ``df.FLOWS``; hadamard: 'dense' | 'bin' |
        'scheduled'; input_mode: 'windowed' | 'halo'.
      batch: images per call; active_bins: Fa (None = K^2).
      r, t_cycles: Alg-2 replicas and table length (T = ``t_cycles``
        when the tables exist, else ceil(nnz / SCHEDULE_MU)); the tables
        have ``fsc.SCHED_BLOCK_N`` lanes per kernel group.
      block_m: the m-range width of the weight-/input-stationary flows
        (channels a CTA keeps resident); unused by output-stationary.
      residual: a fused shortcut add and where the kernel reads it
        (the reference's ``tpu_fused_flow_cost(residual=...)`` on the
        card): None for none; 'hbm' reads the output-sized shortcut once
        from device memory at the flush (output-stationary, or a flow
        with one m range) or in the finish pass, after the channel loop,
        so its read is serial; 'vmem' (output-stationary only) reads it
        once too, but prefetched into shared memory before the channel
        loop, so the read overlaps the kernel's own and the staged rows
        (``fsc.staged_rows`` of each CTA's rectangle) count against the
        shared-memory cap; on a plane output-stationary launch that
        ``kernel_grid`` splits, the finish pass reads it, so it is priced
        as 'hbm', the placement that runs (``residual`` in the result).
        The windowed path also relays the shortcut into the output's tile
        layout on the host.

    Bytes (``hbm_bytes``) follow each kernel's loops: output-stationary
    re-reads the input once per n block (plane kernel) or kernel group
    (scheduled) and the kernel operand once per tile block;
    weight-stationary reads the kernel operand once and re-reads the
    input per n block or group; input-stationary reads the input once
    and re-reads the kernel operand per tile block.  A re-read operand
    that fits the 50 MB L2 is counted once.  With more than one slice (m
    ranges; on the plane output-stationary launch, ranges x bin groups),
    and on the scheduled flows always, the split-K workspace (slices x S2
    x N x slots floats) is written and read once.  Operators, bias and
    the output are counted once.

    Time: ``predicted_s = serial_s + max(hbm_s, compute_s, latency_s)``
    with ``latency_s = waves * (rects * WAVE_S + steps * STEP_S)``
    (``LATENCY_FIT``): waves = the launch's CTA waves (``kernel_grid``:
    clusters over the card's cluster capacity where the kernel runs
    clusters, else ceil(ctas / 132)), ``rects`` = output
    rectangles a CTA finishes (1 for output-stationary, the tile blocks
    of its chunk for weight-stationary (``fsc.ws_launch_geometry``),
    every n block or group for input-stationary; the scheduled flows'
    (tile block, group half) rectangles of ``fsc.sched_flow_geometry``),
    ``steps`` = channel
    steps a CTA runs; the plane
    kernel's output-stationary launch is priced as the wrapper launches
    it, ``fsc.os_latency_s`` over its cluster waves (``kernel_grid``).
    ``serial_s`` is work in separate launches before or after the kernel
    that cannot overlap it: ``relayout_s``, the windowed path's host
    relayout (window tensor written and read back from the raw
    activation, output tiles assembled, a shortcut relaid), ``finish_s``,
    the split-K finish pass (workspace and shortcut read, output
    written), and ``shortcut_s``, an 'hbm' shortcut read at the flush,
    all at the HBM rate.
    """
    if flow not in df.FLOWS:
        raise ValueError(f"flow must be one of {df.FLOWS}, got {flow!r}")
    if residual not in (None, *fsc.SHORTCUT_PLACEMENTS) or (
            residual == "vmem" and flow != fsc.OS):
        raise ValueError(f"residual must be None, 'hbm' or (output-"
                         f"stationary only) 'vmem', got {residual!r} for "
                         f"{flow!r}")
    if hadamard not in df.HADAMARD_MODES:
        raise ValueError(f"hadamard must be one of {df.HADAMARD_MODES}, "
                         f"got {hadamard!r}")
    if input_mode not in df.INPUT_MODES:
        raise ValueError(f"input_mode must be one of {df.INPUT_MODES}, got "
                         f"{input_mode!r}")
    sched = hadamard == "scheduled"
    halo = input_mode == "halo"
    k2 = fft_size * fft_size
    fa = k2 if active_bins is None else max(1, min(int(active_bins), k2))
    if block_m is None:
        block_m = fsc.SCHED_BLOCK_M if sched else fsc.BLOCK_M
    geo = make_geometry(layer.h_in, layer.w_in, layer.ksize, fft_size,
                        layer.pad)
    s, s2 = k2, geo.tile * geo.tile
    m, n = layer.c_in, layer.c_out
    p = batch * geo.n_tiles
    grid = kernel_grid(layer, fft_size, flow, hadamard, input_mode, batch,
                       block_m, fa)
    pb, nb, g = grid["p_blocks"], grid["n_blocks"], grid["ranges"]
    slices = grid["slices"]
    plane_os = flow == fsc.OS and not sched
    if residual == "vmem" and plane_os and slices > 1:
        residual = "hbm"        # the finish pass reads it, as it runs
    nnz = max(1, int(round(k2 / alpha)))
    t_cyc = t_cycles if t_cycles is not None else math.ceil(
        nnz / SCHEDULE_MU)
    n_pe = fsc.SCHED_BLOCK_N

    h_out, w_out = (layer.h_in + 2 * layer.pad - layer.ksize + 1,
                    layer.w_in + 2 * layer.pad - layer.ksize + 1)
    raw_bytes = 4 * batch * m * layer.h_in * layer.w_in
    out_bytes = 4 * batch * n * h_out * w_out
    x_bytes = raw_bytes if halo else 4 * s * m * p
    y_bytes = out_bytes if halo else 4 * s2 * n * p
    if sched:
        w_bytes = 4 * nb * m * t_cyc * (r + 3 * n_pe)
    else:
        w_bytes = 4 * 2 * fa * n * m
    ops_bytes = 4 * (2 * fa * s + 2 * s2 * fa + n)

    def reread(nbytes: float, times: int) -> float:
        return nbytes if nbytes <= H100_L2_BYTES else nbytes * times

    if flow == fsc.OS:
        x_hbm, w_hbm = reread(x_bytes, nb), reread(w_bytes, pb)
    elif flow == fsc.WS:
        x_hbm, w_hbm = reread(x_bytes, nb), w_bytes
    else:
        x_hbm, w_hbm = x_bytes, reread(w_bytes, pb)
    # the split-K workspace: more than one slice, or a scheduled flow
    # (whose finish pass applies the epilogue to one slice too)
    split_k = slices > 1 or (sched and flow != fsc.OS)
    ws_bytes = 4 * slices * s2 * n * grid["slots"] if split_k else 0
    sc_bytes = y_bytes if residual is not None else 0   # laid out like y
    hbm = x_hbm + w_hbm + ops_bytes + y_bytes + 2 * ws_bytes + sc_bytes

    # operations: the kernels' own arithmetic (4 real FMAs per complex
    # MAC, the tile-FFT of every computed bin, the IFFT per m range)
    fft_bins = 64 if sched else fa
    refft = (grid["split"] if sched and flow == fsc.IS
             else nb * fsc.sched_halves(min(n_pe, n)) if sched
             else 1 if flow == fsc.IS else nb)
    fft_flops = 4 * fft_bins * s * m * p * refft
    if sched:
        had_flops = 8 * n * m * nnz * p
    else:
        had_flops = 8 * fa * n * m * p
    ifft_flops = 4 * s2 * fft_bins * n * p * g
    flops = fft_flops + had_flops + ifft_flops + 2 * s2 * n * p * g

    hg = (halo_block_geometry(geo, min(fsc.SCHED_BLOCK_P if sched
                                       else fsc.BLOCK_P, geo.n_tiles))
          if halo else None)
    if residual == "vmem":          # the rule by which the wrappers refuse it
        smem = fsc.staged_shortcut_bytes(
            s, s2, fa, halo=None if hg is None else (geo, hg),
            tables=(t_cyc, r, n_pe) if sched else None,
            blocks=pb * nb * fsc.sched_halves(min(n_pe, n)), m=m,
            capacity=H100_OS_CLUSTERS)
    elif sched:
        smem = fsc.sched_smem_bytes(flow, geo, block_m, t_cyc, r, n_pe, hg)
    else:
        smem = fsc.plane_smem_bytes(flow, geo, block_m, hg)
    waves = grid["waves"]
    if plane_os:
        latency_s = fsc.os_latency_s(waves, grid["steps"], halo)
    else:
        wave_s, step_s = LATENCY_FIT[("scheduled" if sched else "plane",
                                      flow, input_mode)]
        latency_s = waves * (grid["rects"] * wave_s
                             + grid["steps"] * step_s)
    relayout = 0 if halo else (raw_bytes + 2 * 4 * s * m * p
                               + 4 * s2 * n * p + out_bytes
                               + (out_bytes + sc_bytes if sc_bytes else 0))
    finish = ws_bytes + y_bytes + sc_bytes if split_k else 0
    # the shortcut read the channel loop does not hide: at the flush
    # ('hbm', one m range) or in the finish pass (counted there)
    flush_sc = sc_bytes if residual == "hbm" and not split_k else 0
    hbm_s = ((hbm - ws_bytes - (sc_bytes if residual == "hbm" else 0))
             / H100_HBM_BYTES_PER_S)                  # main kernel's share
    compute_s = flops / H100_FP32_FLOPS
    relayout_s = relayout / H100_HBM_BYTES_PER_S
    finish_s = finish / H100_HBM_BYTES_PER_S
    shortcut_s = flush_sc / H100_HBM_BYTES_PER_S
    serial_s = relayout_s + finish_s + shortcut_s
    return {
        "hbm_bytes": float(hbm),
        "kernel_hbm_bytes": float(w_hbm),
        "flops": float(flops),
        "smem_bytes": float(smem),
        "ctas": grid["ctas"],
        "waves": waves,
        "steps": grid["steps"],
        "hbm_s": hbm_s,
        "compute_s": compute_s,
        "latency_s": latency_s,
        "relayout_s": relayout_s,
        "finish_s": finish_s,
        "shortcut_s": shortcut_s,
        "serial_s": serial_s,
        "predicted_s": serial_s + max(hbm_s, compute_s, latency_s),
        "residual": residual,
    }


@dataclasses.dataclass(frozen=True)
class FusedTuning:
    """Fused-kernel configuration of one conv layer.

    ``block_n`` / ``block_p`` are the kernel's per-CTA output-channel and
    tile blocks (per image on the halo path); ``block_m`` is the
    channels per pipeline step (output-stationary) or the m-range width
    (weight-/input-stationary); ``residual`` is where a fused shortcut
    is read ('hbm' | 'vmem', None without one).  ``hbm_bytes``,
    ``smem_bytes``,
    ``predicted_s`` and ``grid_steps`` (CTAs x channel steps) come from
    the Hopper cost model; ``measured_s`` is the card's time when the
    tuning was measured, and ``measured`` every measured candidate with
    its seconds, in predicted order.
    """

    layer: str
    flow: str
    block_n: int
    block_m: int
    block_p: int
    hbm_bytes: float | None = None
    smem_bytes: float | None = None
    predicted_s: float | None = None
    measured_s: float | None = None
    hadamard: str | None = None
    input_mode: str | None = None
    grid_steps: float | None = None
    measured: tuple = ()
    residual: str | None = None


def predict_seconds(c: dict) -> float:
    """Modelled latency of one cost-model row (``predicted_s``: serial
    passes + max(bytes, operations, CTA waves x steps))."""
    return c["predicted_s"]


def _block_ms(layer: df.ConvLayer, flow: str, hadamard: str) -> list[int]:
    """The m-range widths a flow's kernel takes for this layer: the
    fixed channel step for output-stationary, else the built widths,
    one per distinct number of ranges (the narrowest)."""
    kind = "scheduled" if hadamard == "scheduled" else "plane"
    if flow == fsc.OS:
        return [fsc.SCHED_BLOCK_M if kind == "scheduled"
                else min(fsc.BLOCK_M, layer.c_in)]
    seen, out = set(), []
    for w in fsc.FLOW_BLOCK_M[(kind, flow)]:
        g = -(-layer.c_in // w)
        if g not in seen:
            seen.add(g)
            out.append(w)
    return out


def _layer_candidates(layer: df.ConvLayer, fft_size: int, batch: int,
                      flows: Sequence[str], hadamard_modes: Sequence[str],
                      input_modes: Sequence[str],
                      residual: str | None = None
                      ) -> Iterable[FusedTuning]:
    """Every configuration the kernels can launch for this layer (before
    the shared-memory cap): flows x Hadamard modes x input paths x
    m-range widths, with the kernels' n and tile blocks; a 'vmem'
    shortcut goes to the output-stationary candidates, the flows read
    theirs from device memory ('hbm')."""
    tiles = layer.tiles(fft_size)
    for flow, mode, imode in itertools.product(flows, hadamard_modes,
                                               input_modes):
        sched = mode == "scheduled"
        bn = fsc.SCHED_BLOCK_N if sched else fsc.BLOCK_N
        bp = fsc.SCHED_BLOCK_P if sched else fsc.BLOCK_P
        p = tiles * (1 if imode == "halo" else batch)
        for bm in _block_ms(layer, flow, mode):
            yield FusedTuning(layer=layer.name, flow=flow,
                              block_n=min(bn, layer.c_out), block_m=bm,
                              block_p=min(bp, p), hadamard=mode,
                              input_mode=imode,
                              residual=("hbm" if residual == "vmem"
                                        and flow != fsc.OS else residual))


def price(tn: FusedTuning, layer: df.ConvLayer, fft_size: int,
          alpha: float, *, batch: int = 1, active_bins: int | None = None,
          schedule_r: int = SCHEDULE_R,
          t_cycles: int | None = None) -> FusedTuning:
    """``tn`` with the cost model's bytes, shared memory, predicted
    seconds and CTA steps for this layer (``t_cycles``: the tables'
    length, when they exist)."""
    c = hopper_fused_flow_cost(
        layer, fft_size, alpha, tn.flow, tn.hadamard, tn.input_mode,
        batch=batch, active_bins=active_bins, r=schedule_r,
        t_cycles=t_cycles, block_m=tn.block_m, residual=tn.residual)
    return dataclasses.replace(
        tn, hbm_bytes=c["hbm_bytes"], smem_bytes=c["smem_bytes"],
        predicted_s=predict_seconds(c),
        grid_steps=float(c["ctas"] * c["steps"]), residual=c["residual"])


def autotune_layer(layer: df.ConvLayer, fft_size: int, alpha: float, *,
                   batch: int = 1,
                   flows: Sequence[str] = df.FLOWS,
                   active_bins: int | None = None,
                   hadamard_modes: Sequence[str] = ("bin",),
                   input_modes: Sequence[str] = ("windowed",),
                   schedule_r: int = SCHEDULE_R,
                   t_cycles: int | None = None,
                   residual: str | None = None,
                   measure_fn: Callable[[FusedTuning], float] | None = None
                   ) -> FusedTuning:
    """Pick (flow, hadamard, input mode, block_m) for one layer.

    Analytic pass: ``price`` every candidate (``active_bins`` = the
    plan's compacted Fa, ``t_cycles`` = the tables' length when they
    exist), drop those over ``H100_SMEM_PER_CTA`` and sort by (predicted
    seconds, CTA steps, bytes).  ``residual`` prices a fused shortcut:
    'hbm', or 'vmem', which tries the staged placement on each
    output-stationary candidate first and falls back to 'hbm' where the
    staged rows do not fit (the reference's fallback, taken per
    candidate so that such a candidate stays in the ranking) or where
    the plane kernel's launch is split (``kernel_grid``: its finish pass
    reads the shortcut); the placement is recorded in
    ``FusedTuning.residual``.  When none fits
    (tables longer than the estimate allows), the smallest footprint
    comes back, its ``smem_bytes`` over the budget for the caller to
    see; a launch of it raises.  Measured pass (with ``measure_fn``,
    seconds of one candidate on the card): time the ``MEASURE_TOP_K``
    best predictions and keep the fastest, recording every measured
    candidate in ``FusedTuning.measured``.
    """
    def priced_fit(cand: FusedTuning) -> FusedTuning:
        tn = price(cand, layer, fft_size, alpha, batch=batch,
                   active_bins=active_bins, schedule_r=schedule_r,
                   t_cycles=t_cycles)
        if tn.residual == "vmem" and tn.smem_bytes > H100_SMEM_PER_CTA:
            return priced_fit(dataclasses.replace(cand, residual="hbm"))
        return tn

    priced = [priced_fit(cand)
              for cand in _layer_candidates(layer, fft_size, batch, flows,
                                            hadamard_modes, input_modes,
                                            residual)]
    scored = [t for t in priced if t.smem_bytes <= H100_SMEM_PER_CTA]
    if not scored:
        return min(priced, key=lambda t: t.smem_bytes)
    scored.sort(key=lambda t: (t.predicted_s, t.grid_steps, t.hbm_bytes))
    if measure_fn is None:
        return scored[0]
    timed = tuple((cand, measure_fn(cand))
                  for cand in scored[:MEASURE_TOP_K])
    best, best_s = min(timed, key=lambda ct: ct[1])
    return dataclasses.replace(best, measured_s=best_s, measured=timed)


def autotune_network(layers: Sequence[df.ConvLayer] = df.VGG16_LAYERS,
                     fft_size: int = 8,
                     alpha: "float | Sequence[float]" = 4.0, *,
                     batch: int = 1,
                     active_bins: dict[str, int] | None = None,
                     hadamard_modes: Sequence[str] = ("bin",),
                     input_modes: Sequence[str] = ("windowed",),
                     measure_fns: dict[str, Callable] | None = None
                     ) -> dict[str, FusedTuning]:
    """Alg 1 over a conv stack -> {layer name: FusedTuning}; ``alpha``
    is a scalar or one per layer, ``active_bins`` and ``measure_fns``
    (``_make_measure_fn`` of each layer's plan) are keyed by layer
    name."""
    from repro_torch.core.sparse import per_layer_alphas

    layers = list(layers)
    alphas = per_layer_alphas(alpha, len(layers))
    return {layer.name: autotune_layer(
        layer, fft_size, a, batch=batch,
        active_bins=(active_bins or {}).get(layer.name),
        hadamard_modes=hadamard_modes, input_modes=input_modes,
        measure_fn=(measure_fns or {}).get(layer.name))
        for layer, a in zip(layers, alphas)}


# ---------------------------------------------------------------------------
# Two-level Alg 1: partitioning strategy x kernel configuration per layer
# ---------------------------------------------------------------------------

def hopper_sharded_flow_cost(layer: df.ConvLayer, fft_size: int,
                             alpha: float, flow: str, hadamard: str,
                             input_mode: str, *, n_shards: int,
                             strategy: str, batch: int = 1,
                             active_bins: int | None = None,
                             r: int = SCHEDULE_R,
                             t_cycles: int | None = None,
                             block_m: int | None = None,
                             residual: str | None = None
                             ) -> "dict[str, float] | None":
    """The two-level cost of one sharded layer (the counterpart of the
    reference's ``tpu_sharded_flow_cost``): ONE device's
    ``hopper_fused_flow_cost`` of the shard-local layer
    (``dataflow.shard_local_layer``), plus the collective's bytes
    (``dataflow.shard_ici_bytes``) at ``H100_NVLINK_BYTES_PER_S``.  None
    when the strategy is infeasible at ``n_shards``.

    It prices the mesh it is given: D devices joined by NVLink, also when
    the mesh repeats one card (whose bands then run one after another).
    It prices the reference's collectives only: the executor
    (``distributed.executor``) also gathers every layer's output on the
    mesh's first device and the next layer scatters it from there, link
    traffic on a mesh of distinct cards that this cost leaves out.
    Adds to the per-device dict: 'strategy', 'n_shards',
    'per_chip_hbm_bytes' (the local 'hbm_bytes'), 'ici_bytes', 'ici_s'
    and 'sharded_s' = 'predicted_s' + 'ici_s'.  ``residual`` is the
    shortcut's placement as ``hopper_fused_flow_cost`` takes it; a sharded
    layer also moves the shortcut into the shards' layout (its link
    bytes).
    """
    local = df.shard_local_layer(layer, fft_size, n_shards, strategy)
    if local is None:
        return None
    c = hopper_fused_flow_cost(local, fft_size, alpha, flow, hadamard,
                               input_mode, batch=batch,
                               active_bins=active_bins, r=r,
                               t_cycles=t_cycles, block_m=block_m,
                               residual=residual)
    ici = df.shard_ici_bytes(layer, n_shards, strategy, batch=batch,
                             residual=residual is not None)
    ici_s = ici / H100_NVLINK_BYTES_PER_S
    c.update(strategy=strategy, n_shards=n_shards,
             per_chip_hbm_bytes=c["hbm_bytes"], ici_bytes=ici, ici_s=ici_s,
             sharded_s=c["predicted_s"] + ici_s)
    return c


@dataclasses.dataclass(frozen=True)
class ShardTuning:
    """The chosen (strategy, shard-local kernel configuration) of one conv
    layer on a D-device mesh.  ``base`` is the ``FusedTuning`` of the
    shard-local layer, its ``predicted_s`` one device's kernel without the
    collective; ``sharded_s = predicted_s + ici_s`` is what the choice
    minimizes."""

    base: FusedTuning
    strategy: str                # one of dataflow.SHARD_STRATEGIES
    n_shards: int
    ici_bytes: float
    ici_s: float
    per_chip_hbm_bytes: float
    sharded_s: float


def autotune_layer_sharded(layer: df.ConvLayer, fft_size: int,
                           alpha: float, *, n_shards: int,
                           strategies: Sequence[str] | None = None,
                           batch: int = 1,
                           flows: Sequence[str] = df.FLOWS,
                           active_bins: int | None = None,
                           hadamard_modes: Sequence[str] = ("bin",),
                           input_modes: Sequence[str] = ("windowed",),
                           schedule_r: int = SCHEDULE_R,
                           t_cycles: int | None = None,
                           residual: str | None = None) -> ShardTuning:
    """Alg 1 one level up: pick (strategy, flow, Hadamard mode, input
    path, block_m) for one layer on an ``n_shards``-device mesh.

    Every feasible strategy of ``strategies`` (default: all of
    ``dataflow.SHARD_STRATEGIES``; 'replicate' is always feasible) is
    crossed with ``autotune_layer``'s candidates for the shard-local
    layer, each priced by ``hopper_sharded_flow_cost``; those over the
    shared-memory cap drop out and the rest sort by (sharded seconds, CTA
    steps, device + link bytes).  ``residual`` is the layer's shortcut
    search as ``autotune_layer`` takes it: a replicated layer runs it in
    its kernel ('vmem' falls back to 'hbm' where it does not fit), a
    sharded one adds it after the collective, read from device memory
    ('hbm').  When nothing fits, the layer is replicated with
    ``autotune_layer``'s own choice."""
    def priced(cand: FusedTuning, strategy: str) -> ShardTuning | None:
        c = hopper_sharded_flow_cost(
            layer, fft_size, alpha, cand.flow, cand.hadamard,
            cand.input_mode, n_shards=n_shards, strategy=strategy,
            batch=batch, active_bins=active_bins, r=schedule_r,
            t_cycles=t_cycles, block_m=cand.block_m, residual=cand.residual)
        if c is None:
            return None
        if cand.residual == "vmem" and c["smem_bytes"] > H100_SMEM_PER_CTA:
            return priced(dataclasses.replace(cand, residual="hbm"),
                          strategy)
        tn = dataclasses.replace(
            cand, hbm_bytes=c["hbm_bytes"], smem_bytes=c["smem_bytes"],
            predicted_s=predict_seconds(c),
            grid_steps=float(c["ctas"] * c["steps"]),
            residual=c["residual"])
        return ShardTuning(base=tn, strategy=strategy, n_shards=n_shards,
                           ici_bytes=c["ici_bytes"], ici_s=c["ici_s"],
                           per_chip_hbm_bytes=c["per_chip_hbm_bytes"],
                           sharded_s=c["sharded_s"])

    scored: list[ShardTuning] = []
    for strategy in (df.SHARD_STRATEGIES if strategies is None
                     else strategies):
        local = df.shard_local_layer(layer, fft_size, n_shards, strategy)
        if local is None:
            continue
        res = (residual if strategy == "replicate" or n_shards <= 1
               else residual and "hbm")
        for cand in _layer_candidates(local, fft_size, batch, flows,
                                      hadamard_modes, input_modes, res):
            st = priced(cand, strategy)
            if st is not None and st.base.smem_bytes <= H100_SMEM_PER_CTA:
                scored.append(st)
    if not scored:
        tn = autotune_layer(layer, fft_size, alpha, batch=batch, flows=flows,
                            active_bins=active_bins,
                            hadamard_modes=hadamard_modes,
                            input_modes=input_modes, schedule_r=schedule_r,
                            t_cycles=t_cycles, residual=residual)
        return ShardTuning(base=tn, strategy="replicate", n_shards=n_shards,
                           ici_bytes=0.0, ici_s=0.0,
                           per_chip_hbm_bytes=tn.hbm_bytes,
                           sharded_s=tn.predicted_s)
    scored.sort(key=lambda st: (st.sharded_s, st.base.grid_steps,
                                st.per_chip_hbm_bytes + st.ici_bytes))
    return scored[0]


def autotune_network_sharded(layers: Sequence[df.ConvLayer]
                             = df.VGG16_LAYERS,
                             fft_size: int = 8,
                             alpha: "float | Sequence[float]" = 4.0, *,
                             n_shards: int,
                             batch: int = 1,
                             active_bins: dict[str, int] | None = None,
                             hadamard_modes: Sequence[str] = ("bin",),
                             input_modes: Sequence[str] = ("windowed",)
                             ) -> dict[str, ShardTuning]:
    """Two-level Alg 1 over a conv stack -> {layer name: ShardTuning};
    layers are chosen independently (the sharded executor returns every
    layer's output in the global layout, so strategies mix freely)."""
    from repro_torch.core.sparse import per_layer_alphas

    layers = list(layers)
    alphas = per_layer_alphas(alpha, len(layers))
    return {layer.name: autotune_layer_sharded(
        layer, fft_size, a, n_shards=n_shards, batch=batch,
        active_bins=(active_bins or {}).get(layer.name),
        hadamard_modes=hadamard_modes, input_modes=input_modes)
        for layer, a in zip(layers, alphas)}


def device_ms(fn: Callable[[], object], flush: Callable[[], object],
              reps: int = 5) -> float:
    """Median device time of ``fn`` in ms: one warm-up call, then
    ``reps`` calls, each after ``flush()`` (an L2 flush), between CUDA
    events."""
    fn()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _make_measure_fn(lp, batch: int, tables: Callable[[], object]
                     ) -> Callable[[FusedTuning], float]:
    """Seconds of one candidate on the card: ``execute_layer_plan`` (the
    layer as the forward pass runs it, host relayout included) on the
    layer's own operands (``lp``, a ``core.plan.LayerPlan`` on a CUDA
    device) and a random activation of the plan's batch (seed
    ``MEASURE_SEED``), timed by ``device_ms`` with a 128 MiB buffer (over
    the 50 MB L2) zeroed before each launch; both live as long as the
    callable.  ``tables()`` gives the layer's Alg-2 tables (the
    caller compiles them at most once) for scheduled candidates.  A
    residual-fused layer (``lp.epilogue.residual == 'fused'``) is timed
    with a random shortcut of its output's shape, in each candidate's
    placement.  Raises when ``lp`` is not on a CUDA device: a
    measurement never falls back to the CPU."""
    dev = lp.wr.device
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            "measure=True times candidates on the card: the plan must be "
            f"on a CUDA device, got {dev}")
    flush = torch.empty(32 * 2 ** 20, device=dev)
    layer = lp.layer
    gen = torch.Generator(device=dev).manual_seed(MEASURE_SEED)
    x = torch.randn((batch, layer.c_in, layer.h_in, layer.w_in),
                    generator=gen, device=dev)
    sc = (torch.randn((batch, layer.c_out, layer.h_in + 2 * layer.pad
                       - layer.ksize + 1, layer.w_in + 2 * layer.pad
                       - layer.ksize + 1), generator=gen, device=dev)
          if lp.epilogue.residual == "fused" else None)

    def measure(tn: FusedTuning) -> float:
        tabs = tables() if tn.hadamard == "scheduled" else None
        if tabs is not None and tn.flow != fsc.OS:
            need = fsc.sched_smem_bytes(
                tn.flow, lp.geo, tn.block_m, tabs.idx.shape[2],
                tabs.idx.shape[3], tabs.sel.shape[3],
                halo_block_geometry(lp.geo, tn.block_p)
                if tn.input_mode == "halo" else None)
            if need > fsc.SMEM_PER_CTA:     # the real T outgrew the cap
                return float("inf")
        cand = dataclasses.replace(lp, tuning=tn, hadamard=tn.hadamard,
                                   input_mode=tn.input_mode, tables=tabs)
        if tn.residual == "vmem" and fsc.placement_at_batch(
                cand, batch, fsc.sched_cluster_capacity(x.device)) != "vmem":
            return float("inf")             # the staged rows do not fit
        return 1e-3 * device_ms(
            lambda: fsc.execute_layer_plan(x, cand, shortcut=sc),
            flush.zero_)

    return measure

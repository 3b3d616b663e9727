"""Fused spectral conv: ONE kernel launch per conv layer (counterpart of
``repro.kernels.fused_spectral_conv``).

Two hand-written CUDA kernels, output-stationary flow, spectra never in
device memory:

- ``fused_spectral_pipeline`` (``csrc/fused_spectral_conv.cu``):
  tile-FFT -> complex Hadamard against kernel planes summed over input
  channels -> valid-row IFFT -> bias + ReLU, all three products on the
  tensor cores in 3xTF32; where its clusters would leave SMs idle it
  takes smaller clusters over the bin chunks and splits the input
  channels over CTAs, summed by a finish pass (``os_launch_geometry``);
- ``fused_spectral_pipeline_scheduled``
  (``csrc/fused_spectral_conv_scheduled.cu``): the same pipeline whose
  Hadamard executes the Alg-2 INDEX/VALUE tables of
  ``core.scheduler.compile_layer_tables`` (gather, route, complex MAC,
  scatter per cycle).

Each has a halo-input sibling in the same source
(``fused_spectral_pipeline_halo``, ``fused_spectral_pipeline_scheduled_halo``):
it reads the raw NCHW activation in overlapping halo blocks, gathers the
windows on chip (``csrc/halo.cuh``) and writes the finished tiles
straight into the ``[B, N, H_out, W_out]`` output, so no window tensor
and no output relayout exist on the host.

Each has its plain PyTorch version beside it
(``*_reference``): the wrapper runs it for CPU tensors, and the tests
and the on-card smoke run hold the kernel to it.

Every wrapper takes the paper's three reuse flows (``flow=``, as the
reference's kernels do): 'output_stationary' sums all input channels in
the kernel; 'weight_stationary' (a CTA keeps the kernel operand of an m
range of ``block_m`` channels resident and walks a chunk of tile blocks,
``ws_launch_geometry``) and
'input_stationary' (a CTA keeps X~ of its tiles for an m range resident
and walks every output-channel block) sum each m range's partial IFFT in
a split-K workspace that a second launch reduces in ascending m-range
order before bias + ReLU.  The plain versions follow the same sum order.

Every wrapper also takes a residual shortcut (``shortcut=``, the
reference's ``_residual_kernel`` operand, B6 residual): a tensor laid out
like the wrapper's output that the kernel adds after the bias and before
the ReLU where it stores each element, bit for bit the unfused launch
(ReLU off) followed by ``+ shortcut`` and the ReLU.  The output-
stationary kernels read it from device memory at the flush
(``shortcut_placement="hbm"``) or prefetch it into shared memory before
their channel loop (``"vmem"``); the flows read it in their finish pass.

Around the windowed kernels, ``execute_layer_plan`` does the windowed
input path's host-side layout work: overlap-save window extraction into
the s-leading ``[S, M, B*T]`` layout, valid-tile assembly of the
``[t^2, N, B*T]`` output and, for a shortcut, its relayout into that
tile layout (``_shortcut_tiles``).  The halo kernels need none of them.

``execute_band_plan`` runs one shard's band of a spatially sharded layer
(B6 band): the same four kernels on an extended band whose top k-1 rows
are its halo (``spectral.make_band_geometry``), returning the uncropped
band canvas, since the 'same' crop is global and follows the join of the
bands.  The windowed kernels run unchanged on the band's windows; the halo
kernels take a band mode (``band=True``: the raw stage starts k-1 rows
lower and the store writes the uncropped canvas, ``csrc/halo.cuh``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

import repro_torch
from repro_torch.core.dataflow import FLOWS
from repro_torch.core.spectral import (HaloGeometry, SpectralGeometry,
                                       assemble_tile_canvas,
                                       assemble_valid_tiles,
                                       extract_tiles_overlapping,
                                       halo_block_geometry,
                                       halo_windows_blocked)
from repro_torch.kernels import _build

# CUDA kernel block sizes (compiled in as -DFSC_*): output channels and
# tiles per CTA, input channels per pipeline step, frequency bins per CTA
# (a cluster of ceil(Fa / BIN_CHUNK) CTAs covers the active bins).  One
# CTA per SM; its shared memory (laid out in the source) fits the 227 KB
# limit at K = 8.
BLOCK_N, BLOCK_P, BLOCK_M, BIN_CHUNK = 64, 16, 8, 8
MAX_CLUSTER = 8       # portable thread-block cluster size
# The plane kernels (tensor cores, 3xTF32; every flow): the deepest TMA /
# cp.async ring they take (-DFSC_OS_STAGES; two stages where three do not
# fit) and their threads (-DFSC_OS_THREADS: a warp per bin, 255 registers
# a thread for its accumulator fragments).
# ``os_launch_geometry`` splits M into ranges of at least OS_RANGE_MIN
# channels, and the bin chunks into smaller clusters, where that fills the
# card better; it prices a launch (``os_latency_s``, which the cost model
# of ``core.autotune`` prices it by too) by its waves, OS_STEP_S a
# BLOCK_M-channel step and OS_FIXED_S a CTA's set-up and epilogue (the
# order of the per-layer device times, waves and ranges that
# ``chip_smoke.py`` (c) prints for VGG16 on an H100; the choices it makes
# there do not move within 3-3.5 us and 20-30 us), and the split-K
# workspace written and read once at OS_HBM_BYTES_S.  The halo path
# launches its windowed twin's split, but its steps gather raw rows by
# cp.async: the cost model prices them at OS_HALO_STEP_S and
# OS_HALO_FIXED_S (least-squares fit to its VGG16 batch-1 device times,
# ``chip_smoke.py`` (c3) on an H100: 6.19 and 30.39 us).
OS_STAGES, OS_THREADS = 3, 256
OS_ALIGN = 256        # floats: the ring's alignment (1024 bytes)
OS_RANGE_MIN = 32
OS_STEP_S, OS_FIXED_S, OS_HBM_BYTES_S = 3e-6, 20e-6, 3.35e12
OS_HALO_STEP_S, OS_HALO_FIXED_S = 6.2e-6, 30e-6

# Scheduled kernel: PE lanes per kernel group (the tables' N'; the plan
# compiles them for this group size), compiled in as -DSCH_BN; tiles per
# CTA, lanes a CTA takes of a group (a half) and threads per CTA, the same
# for every flow (-DSCH_OS_THREADS), and the most active bins, fixed in
# the source.  It steps one input channel at a time, so the tables need no
# channel padding (block_m 1).
SCHED_BLOCK_N, SCHED_BLOCK_M, SCHED_MAX_BINS = 64, 1, 64
SCHED_BLOCK_P, SCHED_LANES, SCHED_OS_THREADS = 8, 32, 512
SCHED_OS_STAGES = 5   # the deepest cp.async ring the kernels take
SCHED_FLOW_STAGES_MIN = 3   # the flows' shallowest ring
# The output-stationary kernel's cluster rule (``sched_cluster``) prices a
# CTA's set-up, IFFT and reduction as this many channel steps.
SCHED_FIXED_STEPS = 24

# The reuse flows and, for the two that split the input channels into m
# ranges, the m-range widths (``block_m``) the kernels take: a multiple of
# BLOCK_M for the plane kernel (the range's planes, or its X~, stay in
# shared memory, which caps the width at K = 8: ws, whose CTA takes
# WS_BLOCK_N output channels, 32 beside a three-slot window ring and 48
# beside two (``ws_layout``), is 64), any width for the scheduled kernel
# (its ws CTA keeps the range's table rows of 32 lanes, ~9 KB a channel at
# T = 21, so 12 fit; its is CTA X~ of 8 tiles, 4 KB a channel, so 32:
# ``sched_flow_layout``).
OS, WS, IS = FLOWS
WS_BLOCK_N, WS_STAGES = 32, 4
FLOW_BLOCK_M = {("plane", WS): (8, 16, 32, 48),
                ("plane", IS): (8, 16, 32, 64),
                ("scheduled", WS): (4, 8, 12),
                ("scheduled", IS): (8, 16, 32)}
_FLOW_SUFFIX = {OS: "", WS: "_ws", IS: "_is"}


def entry_point(kernel: str, flow: str) -> str:
    """Name of the CUDA entry point (and ``LAUNCHES`` key) of a kernel
    wrapper under a flow: the wrapper's name, suffixed ``_ws`` / ``_is``
    for the weight- / input-stationary flows."""
    if flow not in FLOWS:
        raise ValueError(f"flow must be one of {FLOWS}, got {flow!r}")
    return kernel + _FLOW_SUFFIX[flow]


KERNELS = ("fused_spectral_pipeline", "fused_spectral_pipeline_scheduled",
           "fused_spectral_pipeline_halo",
           "fused_spectral_pipeline_scheduled_halo")

# The most dynamic shared memory one CTA may take on the H100 (227 KB);
# a kernel configuration over it does not launch.
SMEM_PER_CTA = 232_448
_SCHED_FMAX = 64     # scheduled kernel: bins a CTA

# Where an output-stationary kernel reads a residual shortcut: from device
# memory at the flush, or staged into shared memory before its channel
# loop (the flows' finish pass always reads it from device memory).
SHORTCUT_PLACEMENTS = ("hbm", "vmem")


def _align4(n: int) -> int:
    return (n + 3) & ~3


def staged_rows(s2: int, ranks: int) -> int:
    """Output rows of a CTA's rectangle that a staged ('vmem') shortcut
    holds: cluster rank r of C flushes rows r, r + C, ... of S2."""
    return -(-s2 // ranks)


def sched_halves(n_pe: int) -> int:
    """CTAs a kernel group of ``n_pe`` lanes takes in the scheduled
    output-stationary kernel (SCHED_LANES lanes each)."""
    return -(-n_pe // SCHED_LANES)


def sched_cluster(blocks: int, m: int, capacity: dict[int, int]) -> int:
    """C, the scheduled output-stationary kernel's cluster over input
    channels for ``blocks`` (tile block, group, lane half) clusters on a
    card that runs ``capacity[c]`` clusters of c CTAs at once
    (``sched_cluster_capacity``): among C <= min(MAX_CLUSTER, M), the
    least waves x (ceil(M / C) + SCHED_FIXED_STEPS), ties to the smaller C
    (``os_cluster`` in ``csrc/fused_spectral_conv_scheduled.cu``)."""
    best = None
    for c in range(1, min(MAX_CLUSTER, m) + 1):
        cost = (-(-blocks // capacity[c])) * (-(-m // c) + SCHED_FIXED_STEPS)
        if best is None or cost < best[0]:
            best = (cost, c)
    return best[1]


def _halo_stage(geo: SpectralGeometry, hg: HaloGeometry, bm: int,
                ws: bool = False) -> int:
    """Floats of the halo input path's ring slot (``halo.cuh::HaloPath``):
    bm channels of a block's unclamped raw rows at an odd channel pitch
    (the tile-FFT reads its windows from them by offset); ``ws``: the
    weight-stationary kernel's ``HaloWsPath``, rows staged from a 16-byte
    aligned column at a pitch of the block's columns plus 3, rounded up to
    4 floats, plus 4 where that is a multiple of 8."""
    ov = geo.ksize - 1
    rows, cols = hg.bth * geo.tile + ov, hg.btw * geo.tile + ov
    if not ws:
        return bm * ((rows * cols) | 1)
    pitch = _align4(cols + 3)
    return bm * rows * (pitch if pitch % 8 else pitch + 4)


class OsLayout(NamedTuple):
    """The output-stationary plane kernel's shared memory (``OsLayout`` of
    ``csrc/fused_spectral_conv.cu``): bytes a CTA, and its ring stages."""
    bytes: int
    stages: int


def os_layout(s: int, s2: int, x_floats: int, sc_rows: int = 0
              ) -> OsLayout:
    """Mirror of the source's ``OsLayout`` for S = K^2 window rows, S2 =
    t^2 output rows, ``x_floats`` of input a ring slot (windows S x BM x BP,
    or the halo path's raw rows) and ``sc_rows`` rows of a staged shortcut:
    the FFT's and IFFT's split A fragments, X~ (re, im; rows padded; the
    Y~ stage after the m loop), the window offsets, one mbarrier a slot,
    then (1024-byte aligned, as the TMA swizzles want; 1 KB of slack
    aligns the base) a ring of three slots (two where three would pass the
    card's limit) that the spatial partial aliases."""
    ks, mt2 = -(-s // 8), -(-s2 // 16)
    xfp = BLOCK_M * (BLOCK_P + 8) + 8
    head = (2 * ks * 128 + 2 * mt2 * 256 + 2 * BIN_CHUNK * xfp
            + _align4(s) + _align4(2 * OS_STAGES))
    ring = -(-head // OS_ALIGN) * OS_ALIGN
    slot = -(-x_floats // 128) * 128 + 2 * BIN_CHUNK * BLOCK_N * BLOCK_M
    epi = s2 * BLOCK_N * BLOCK_P
    sc = sc_rows * BLOCK_N * BLOCK_P
    for stages in range(OS_STAGES, 1, -1):
        total = 4 * (ring + max(stages * slot, epi) + sc + OS_ALIGN)
        if total <= SMEM_PER_CTA:
            break
    return OsLayout(total, stages)


def is_layout(s: int, s2: int, x_floats: int, block_m: int) -> OsLayout:
    """Mirror of the source's ``IsLayout`` (the input-stationary plane
    kernel) for S window rows, S2 output rows, ``x_floats`` of input a
    ring step and m ranges of ``block_m`` channels: the FFT's split A
    fragments, whose place the gather buffer takes once X~ is built (a
    cluster rank's n-tiles of every chunk's Y~: C x 16 rows of
    8 ceil(BLOCK_N BLOCK_P / 8 / C) + 8 floats, sized for the largest
    C), X~ of the range (re, im; a bin's rows unpadded, bins 8 floats
    apart), the IFFT's A (2 x 16 ceil(S2 / 16) rows of 68 floats), the
    window offsets, one mbarrier a slot, then (1024-byte aligned; 1 KB of
    slack aligns the base) a ring of three slots (two where three would
    pass the card's limit) of a step's windows or planes."""
    ks, mt2 = -(-s // 8), -(-s2 // 16)
    n_tiles = BLOCK_N * BLOCK_P // 8
    recv = max(c * 16 * (8 * -(-n_tiles // c) + 8)
               for c in range(1, MAX_CLUSTER + 1))
    head = (max(2 * ks * 128, recv)
            + 2 * BIN_CHUNK * (block_m * BLOCK_P + 8)
            + 2 * 16 * mt2 * (MAX_CLUSTER * BIN_CHUNK + 4) + _align4(s)
            + _align4(2 * OS_STAGES))
    ring = -(-head // OS_ALIGN) * OS_ALIGN
    slot = max(-(-x_floats // 128) * 128, 2 * BIN_CHUNK * BLOCK_N * BLOCK_M)
    for stages in range(OS_STAGES, 1, -1):
        total = 4 * (ring + stages * slot + OS_ALIGN)
        if total <= SMEM_PER_CTA:
            break
    return OsLayout(total, stages)


def ws_layout(s: int, s2: int, x_floats: int, block_m: int) -> OsLayout:
    """Mirror of the source's ``WsLayout`` (the weight-stationary plane
    kernel) for S window rows, S2 output rows, ``x_floats`` of input a
    ring slot and m ranges of ``block_m`` channels: the FFT's split A
    fragments, the IFFT's A over every bin (2 x S2 rows of 68 floats), X~
    of a step (os's padded layout) or, in its place, the gather buffer
    (C x 16 rows of 8 ceil(WS_BLOCK_N BLOCK_P / 8 / C) + 8 floats, sized
    for the largest C), the window offsets, one mbarrier a slot and one
    for the planes, then (1024-byte aligned; 1 KB of slack aligns the
    base) the range's planes (block_m / BLOCK_M blocks of 2 x BIN_CHUNK x
    WS_BLOCK_N x BLOCK_M floats) and a ring of WS_STAGES 16-byte aligned
    slots (fewer, at least two, where they would pass the card's
    limit)."""
    ks = -(-s // 8)
    nt = WS_BLOCK_N * BLOCK_P // 8
    recv = max(c * 16 * (8 * -(-nt // c) + 8)
               for c in range(1, MAX_CLUSTER + 1))
    xf = 2 * BIN_CHUNK * (BLOCK_M * (BLOCK_P + 8) + 8)
    head = (2 * ks * 128 + 2 * s2 * (MAX_CLUSTER * BIN_CHUNK + 4)
            + max(xf, recv) + _align4(s) + _align4(2 * (WS_STAGES + 1)))
    ring = (-(-head // OS_ALIGN) * OS_ALIGN
            + block_m // BLOCK_M * 2 * BIN_CHUNK * WS_BLOCK_N * BLOCK_M)
    slot = _align4(x_floats)
    for stages in range(WS_STAGES, 1, -1):
        total = 4 * (ring + stages * slot + OS_ALIGN)
        if total <= SMEM_PER_CTA:
            break
    return OsLayout(total, stages)


def _plane_layout_bytes(flow: str, s: int, s2: int, block_m: int,
                        x_floats: int, sc_rows: int) -> int:
    if flow == OS:
        return os_layout(s, s2, x_floats, sc_rows).bytes
    layout = is_layout if flow == IS else ws_layout
    return layout(s, s2, x_floats, block_m).bytes


def plane_smem_bytes(flow: str, geo: SpectralGeometry,
                     block_m: int = BLOCK_M,
                     hg: HaloGeometry | None = None,
                     sc_rows: int = 0) -> int:
    """Dynamic shared memory of one plane-kernel CTA: the ``OsLayout``
    (output-stationary), ``IsLayout`` (input-stationary) or ``WsLayout``
    (weight-stationary) of ``csrc/fused_spectral_conv.cu``, whose ring
    takes windows (``hg`` None) or the halo block's raw rows (the
    weight-stationary kernel's at a 16-byte aligned row pitch), with
    ``sc_rows`` rows of a staged shortcut (``staged_rows``)."""
    s = geo.fft_size ** 2
    x_floats = (s * BLOCK_M * BLOCK_P if hg is None
                else _halo_stage(geo, hg, BLOCK_M, flow == WS))
    return _plane_layout_bytes(flow, s, geo.tile ** 2, block_m, x_floats,
                               sc_rows)


def sched_os_layout(s: int, s2: int, t_cycles: int, r: int, x_floats: int,
                    sc_rows: int = 0) -> OsLayout:
    """Mirror of the scheduled source's ``OsLayout`` (the output-
    stationary kernel).  The channel loop: the tile-FFT's split A
    fragments (2 x 8 row tiles x 8 k steps x 128 words), X~ and the
    expanded weights of two channels (2 x 2 x 64 x SCHED_BLOCK_P and
    2 x 2 x 64 x SCHED_LANES floats), the window offsets, then a ring of
    five slots (fewer, at least two, where five would pass the card's
    limit), each a channel's input (``x_floats``) and its table rows (idx
    T x r, then sel, vr, vi T x SCHED_LANES).  After the loop the same
    bytes hold Y~ (2 x 64 rows of SCHED_LANES x SCHED_BLOCK_P + 8) and
    the IFFT's split A fragments (2 x ceil(S2 / 16) x 16 k steps x 128);
    ``sc_rows`` rows of a staged shortcut follow both."""
    fmax, bp, lanes = _SCHED_FMAX, SCHED_BLOCK_P, SCHED_LANES
    head = (2 * 8 * 8 * 128 + 2 * 2 * fmax * bp + 2 * 2 * fmax * lanes
            + _align4(s))
    slot = (_align4(x_floats) + _align4(t_cycles * r)
            + 3 * t_cycles * lanes)
    epi = (2 * fmax * (lanes * bp + 8)
           + 2 * -(-s2 // 16) * (2 * fmax // 8) * 128)
    for stages in range(SCHED_OS_STAGES, 1, -1):
        total = 4 * (max(head + stages * slot, epi)
                     + sc_rows * lanes * bp)
        if total <= SMEM_PER_CTA:
            break
    return OsLayout(total, stages)


def sched_flow_layout(flow: str, s: int, s2: int, t_cycles: int, r: int,
                      x_floats: int, block_m: int) -> OsLayout:
    """Mirror of the scheduled source's ``FlowLayout`` (the weight- and
    input-stationary kernel) for m ranges of ``block_m`` channels, in
    floats: the IFFT's A in f32 (ceil(S2 / 16) x 16 k steps x 128), then
    ws: one region for the tile-FFT's A in f32 (8192), X~ and W of two
    channels (2048 + 8192) or, after each tile block, the IFFT's round
    stage and partial ((32 + S2) rows of SCHED_LANES x SCHED_BLOCK_P + 8),
    the window offsets, the range's table rows (block_m x (idx T x r +
    sel, vr, vi T x SCHED_LANES)) and a ring of a channel's input a slot;
    is: X~ of the range (block_m x 1024), one region for the FFT's A, W,
    the round stage (32 rows) and the partial (S2 rows), the window
    offsets and a ring whose slot takes two channels' inputs or a
    channel's table rows.  Five ring slots where they fit the card's
    limit, else fewer, at least three."""
    fmax, bp, lanes = _SCHED_FMAX, SCHED_BLOCK_P, SCHED_LANES
    yp = lanes * bp + 8
    tslot = _align4(t_cycles * r) + 3 * t_cycles * lanes
    head = -(-s2 // 16) * (2 * fmax // 8) * 128
    if flow == WS:
        ring = (head + max(8192 + 2 * 2 * fmax * bp + 2 * 2 * fmax * lanes,
                           (32 + s2) * yp)
                + _align4(s) + block_m * tslot)
        slot = _align4(x_floats)
    else:
        ring = (head + block_m * 2 * fmax * bp
                + max(8192, 2 * 2 * fmax * lanes, 32 * yp, s2 * yp)
                + _align4(s))
        slot = max(2 * _align4(x_floats), tslot)
    for stages in range(SCHED_OS_STAGES, SCHED_FLOW_STAGES_MIN - 1, -1):
        total = 4 * (ring + stages * slot)
        if total <= SMEM_PER_CTA:
            break
    return OsLayout(total, stages)


def _sched_layout_bytes(flow: str, s: int, s2: int, block_m: int,
                        t_cycles: int, r: int, x_floats: int,
                        sc_rows: int) -> int:
    if flow == OS:
        return sched_os_layout(s, s2, t_cycles, r, x_floats, sc_rows).bytes
    return sched_flow_layout(flow, s, s2, t_cycles, r, x_floats,
                             block_m).bytes


def sched_smem_bytes(flow: str, geo: SpectralGeometry, block_m: int,
                     t_cycles: int, r: int, n_pe: int,
                     hg: HaloGeometry | None = None,
                     sc_rows: int = 0) -> int:
    """Dynamic shared memory of one scheduled-kernel CTA: the ``OsLayout``
    (output-stationary) or ``FlowLayout`` (the flows) of
    ``csrc/fused_spectral_conv_scheduled.cu`` for tables of ``t_cycles``
    cycles and ``r`` replicas (a CTA stages SCHED_LANES of the group's
    ``n_pe`` lanes), with ``sc_rows`` rows of a staged shortcut
    (output-stationary)."""
    s = geo.fft_size ** 2
    x_floats = (s * SCHED_BLOCK_P if hg is None
                else _halo_stage(geo, hg, 1))
    return _sched_layout_bytes(flow, s, geo.tile ** 2, block_m, t_cycles, r,
                               x_floats, sc_rows)


# Kernel launches per (kernel, flow) entry point, counted where the kernel
# is launched (a flow's split-K finish pass belongs to its launch), and of
# those the launches that fused a residual shortcut.
LAUNCHES = {entry_point(k, f): 0 for k in KERNELS for f in FLOWS}
RESIDUAL_LAUNCHES = dict.fromkeys(LAUNCHES, 0)
# and of those the launches that staged it in shared memory: a 'vmem'
# shortcut as it ran (an output-stationary plane launch that its geometry
# splits adds it in the finish pass, from device memory: 'hbm')
STAGED_LAUNCHES = dict.fromkeys(LAUNCHES, 0)
# and of those the launches on a shard's band (``execute_band_plan``)
BAND_LAUNCHES = dict.fromkeys(LAUNCHES, 0)


# ---------------------------------------------------------------------------
# DFT operators in flattened (kron) form, overlap-save + active-bin layout
# ---------------------------------------------------------------------------

def dft_matrices(fft_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag parts of the DFT matrix W = exp(-2 pi i jk / K)."""
    j, k = np.meshgrid(np.arange(fft_size), np.arange(fft_size),
                       indexing="ij")
    theta = 2.0 * np.pi * j * k / fft_size
    return (np.cos(theta).astype(np.float32),
            (-np.sin(theta)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def overlap_save_operators(fft_size: int, ksize: int,
                           active: tuple[int, ...] | None = None
                           ) -> tuple[np.ndarray, ...]:
    """(dfr, dfi, dvr, dvi) for the fused kernel.

    dfr/dfi [Fa, K^2]: forward 2-D DFT on flattened K x K windows, rows
        restricted to the active frequency bins.
    dvr/dvi [t^2, Fa]: inverse 2-D DFT restricted to the t^2
        wraparound-free output rows and the active columns.
    """
    cr, ci = dft_matrices(fft_size)
    w = cr + 1j * ci
    d = np.kron(w, w)                                   # [K^2, K^2]
    winv = (cr - 1j * ci) / fft_size                    # conj(W) / K
    dv = np.kron(winv, winv)
    valid = [u * fft_size + v
             for u in range(ksize - 1, fft_size)
             for v in range(ksize - 1, fft_size)]
    dv = dv[valid]                                      # [t^2, K^2]
    if active is not None:
        a = np.asarray(active)
        d = d[a]
        dv = dv[:, a]
    return tuple(np.ascontiguousarray(p, np.float32)
                 for p in (d.real, d.imag, dv.real, dv.imag))


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------

def _plane_spatial(xt, wr, wi, dfr, dfi, dvr, dvi) -> torch.Tensor:
    """Re(Dv . sum_m W X~) of the windows' channels, before the epilogue:
    FFT GEMM, Karatsuba complex ``bmm``, valid-row IFFT GEMM ->
    [S2, N, P]."""
    s, m, p = xt.shape
    fa, n, _ = wr.shape
    s2 = dvr.shape[0]
    x2 = xt.reshape(s, m * p)
    xfr = (dfr @ x2).reshape(fa, m, p)
    xfi = (dfi @ x2).reshape(fa, m, p)
    m1 = torch.bmm(wr, xfr)
    m2 = torch.bmm(wi, xfi)
    m3 = torch.bmm(wr + wi, xfr + xfi)
    re = (m1 - m2).reshape(fa, n * p)
    im = (m3 - m1 - m2).reshape(fa, n * p)
    return (dvr @ re - dvi @ im).reshape(s2, n, p)


def _flow_sum(partial, m: int, flow: str, block_m: int | None
              ) -> torch.Tensor:
    """A flow's sum over input channels: ``partial(m0, m1)`` of all M
    channels (output-stationary), or of each m range of ``block_m``
    channels summed in ascending order (weight-/input-stationary, the
    kernels' split-K order)."""
    if flow == OS:
        return partial(0, m)
    if flow not in FLOWS:
        raise ValueError(f"flow must be one of {FLOWS}, got {flow!r}")
    if block_m is None or block_m < 1:
        raise ValueError(f"flow {flow!r} needs block_m >= 1, got {block_m}")
    acc = partial(0, min(block_m, m))
    for m0 in range(block_m, m, block_m):
        acc = acc + partial(m0, min(m0 + block_m, m))
    return acc


def _add_shortcut(y, shortcut, relu: bool) -> torch.Tensor:
    """The epilogue after the bias: (+ shortcut) -> ReLU."""
    if shortcut is not None:
        y = y + shortcut
    return torch.relu(y) if relu else y


def _epilogue(y, bias, relu: bool, shortcut=None) -> torch.Tensor:
    """bias -> (+ shortcut) -> ReLU on [S2, N, P] tiles, the kernels' order
    (fp32 adds, no FMA)."""
    return _add_shortcut(y + bias[0][None, :, None], shortcut, relu)


def fused_spectral_pipeline_reference(xt, wr, wi, dfr, dfi, dvr, dvi,
                                      bias, *, relu: bool,
                                      flow: str = OS,
                                      block_m: int | None = None,
                                      shortcut=None) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel (same contract as
    ``fused_spectral_pipeline``): FFT GEMM, Karatsuba complex ``bmm``,
    valid-row IFFT GEMM per the flow's m ranges, summed in ascending
    order, then bias (+ shortcut) + ReLU."""
    if xt.is_cuda:
        repro_torch.strict_fp32()
    y = _flow_sum(lambda m0, m1: _plane_spatial(
        xt[:, m0:m1], wr[:, :, m0:m1], wi[:, :, m0:m1], dfr, dfi, dvr,
        dvi), xt.shape[1], flow, block_m)
    return _epilogue(y, bias, relu, shortcut)


# The kernels' sources and their -D defines (``_build.build``).
SOURCES = {
    "fused_spectral_conv": {
        "FSC_BN": BLOCK_N, "FSC_BP": BLOCK_P, "FSC_BM": BLOCK_M,
        "FSC_FC": BIN_CHUNK, "FSC_OS_STAGES": OS_STAGES,
        "FSC_OS_THREADS": OS_THREADS},
    "fused_spectral_conv_scheduled": {
        "SCH_BN": SCHED_BLOCK_N, "SCH_OS_THREADS": SCHED_OS_THREADS,
        "SCH_FIXED_STEPS": SCHED_FIXED_STEPS}}


def _libraries() -> dict[str, ctypes.CDLL]:
    """Build (at first use; one nvcc per source, started together) and
    load both kernel libraries, keyed by source name."""
    libs = _build.build(SOURCES)
    # pointers (the output, then the shortcut), then ints (the last is
    # sc_staged), then the stream
    plane, sched = libs["fused_spectral_conv"], \
        libs["fused_spectral_conv_scheduled"]
    # a flow entry point (and every plane entry point, whose output-
    # stationary kernel also splits M and the bin chunks) takes the
    # workspace pointer and block_m besides, and then its split: the plane
    # kernel's output- and input-stationary cluster size, its weight-
    # stationary tile blocks a CTA (``ws_launch_geometry``), the scheduled
    # flows' ``sched_flow_geometry``
    for lib, kernel, n_ptr, n_int in (
            (plane, "fused_spectral_pipeline", 10, 9),
            (plane, "fused_spectral_pipeline_halo", 10, 20),
            (sched, "fused_spectral_pipeline_scheduled", 12, 14),
            (sched, "fused_spectral_pipeline_scheduled_halo", 12, 24)):
        for flow in FLOWS:
            f = getattr(lib, entry_point(kernel, flow) + "_f32")
            extra = flow != OS or kernel in _SPLIT_OS
            split = kernel in _SPLIT_OS or flow != OS
            f.argtypes = ([ctypes.c_void_p] * (n_ptr + extra)
                          + [ctypes.c_int] * (n_int + extra + split)
                          + [ctypes.c_void_p])
            f.restype = ctypes.c_int
    return libs


def library() -> ctypes.CDLL:
    """The plane kernel's library (built at first use)."""
    return _libraries()["fused_spectral_conv"]


def _check_layouts(ops: dict[str, torch.Tensor],
                   int_names: tuple[str, ...] = ()) -> None:
    """Every operand on the first operand's device, float32 (int32 for
    ``int_names``) and contiguous; windows ``xt`` may instead be rows of
    P contiguous floats at one pitch."""
    lead, first = next(iter(ops.items()))
    for name, t in ops.items():
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, {lead} on "
                             f"{first.device}")
        want = torch.int32 if name in int_names else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if name != "xt" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if "xt" not in ops:
        return
    xt = ops["xt"]
    s, m, p = xt.shape
    pitch = xt.stride(1)
    if xt.stride(2) != 1 or pitch < p or xt.stride(0) != m * pitch:
        raise ValueError(f"xt must be rows of P contiguous floats at one "
                         f"pitch, got strides {xt.stride()} for shape "
                         f"{tuple(xt.shape)}")


def _check_operands(xt, wr, wi, dfr, dfi, dvr, dvi, bias) -> None:
    _check_plane_operands(dict(xt=xt, wr=wr, wi=wi, dfr=dfr, dfi=dfi,
                               dvr=dvr, dvi=dvi, bias=bias), *xt.shape)


def _check_plane_operands(ops: dict[str, torch.Tensor], s: int, m: int,
                          p: int) -> None:
    """Layouts and shapes of the plane kernels' operands (``ops`` leads
    with the windows ``xt`` or the raw input ``x``; S = K^2 window
    rows, M channels, P tiles)."""
    _check_layouts(ops)
    wr, dvr = ops["wr"], ops["dvr"]
    fa, n, m_w = wr.shape
    s2 = dvr.shape[0]
    want = dict(wr=(fa, n, m), wi=(fa, n, m), dfr=(fa, s), dfi=(fa, s),
                dvr=(s2, fa), dvi=(s2, fa), bias=(1, n))
    for name, shape in want.items():
        if tuple(ops[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(ops[name].shape)}, "
                             f"expected {shape}")
    if fa > MAX_CLUSTER * BIN_CHUNK:
        raise ValueError(f"active bins {fa} must be at most "
                         f"{MAX_CLUSTER * BIN_CHUNK}")
    if min(s, m, p, fa, n, s2) < 1:
        raise ValueError(f"empty operand: S, M, P = {s}, {m}, {p}, "
                         f"wr {tuple(wr.shape)}, dvr {tuple(dvr.shape)}")


def _flow_ranges(flow: str, block_m, m: int, kind: str) -> int:
    """G, the number of m ranges of a flow (1 for output-stationary);
    raises for a ``block_m`` the ``kind`` ('plane' | 'scheduled') kernel
    is not built for."""
    if flow not in FLOWS:
        raise ValueError(f"flow must be one of {FLOWS}, got {flow!r}")
    if flow == OS:
        return 1
    step = BLOCK_M if kind == "plane" else 1
    if block_m is None or block_m < step or block_m % step:
        raise ValueError(f"{kind} kernel, flow {flow!r}: block_m must be a "
                         f"positive multiple of {step}, got {block_m}")
    return -(-m // block_m)


def _check_shortcut(shortcut, shape: tuple, device, flow: str,
                    placement: str) -> None:
    """A shortcut is laid out exactly like the output (``shape``), f32,
    contiguous, on the output's device; 'vmem' is output-stationary's."""
    if placement not in SHORTCUT_PLACEMENTS:
        raise ValueError(f"shortcut_placement must be one of "
                         f"{SHORTCUT_PLACEMENTS}, got {placement!r}")
    if placement == "vmem" and flow != OS:
        raise ValueError(f"flow {flow!r} reads the shortcut in its finish "
                         f"pass: 'vmem' is for output-stationary only")
    if shortcut is None:
        return
    if tuple(shortcut.shape) != tuple(shape):
        raise ValueError(f"shortcut has shape {tuple(shortcut.shape)}, the "
                         f"output {tuple(shape)}")
    if shortcut.dtype != torch.float32 or not shortcut.is_contiguous():
        raise ValueError(f"shortcut must be contiguous float32, got "
                         f"{shortcut.dtype} with strides {shortcut.stride()}")
    if shortcut.device != device:
        raise ValueError(f"shortcut is on {shortcut.device}, the input on "
                         f"{device}")


def staged_shortcut_bytes(s: int, s2: int, fa: int, *, halo=None,
                          tables: tuple[int, int, int] | None = None,
                          blocks: int = 1, m: int = 1,
                          capacity: dict[int, int] | None = None) -> int:
    """Dynamic shared memory of one output-stationary CTA that stages a
    'vmem' shortcut, the rule by which the wrappers refuse that placement
    and ``placement_at_batch`` falls back from it: the plane kernel's
    layout, whose cluster splits the ``fa`` active bins, or, given the
    tables' (cycles T, replicas r, lanes N'), the scheduled kernel's,
    whose cluster over the ``m`` input channels (``sched_cluster``) is
    sized for ``blocks`` (tile block, group, lane half) clusters on a
    card of cluster ``capacity`` (``sched_cluster``).
    ``halo`` is the (geometry, halo block) pair of the halo input path,
    None for windows; S = K^2 window rows, S2 = t^2 output rows."""
    bm, bp = (BLOCK_M, BLOCK_P) if tables is None else (1, SCHED_BLOCK_P)
    x_floats = s * bm * bp if halo is None else _halo_stage(*halo, bm)
    if tables is None:
        return _plane_layout_bytes(OS, s, s2, BLOCK_M, x_floats,
                                   staged_rows(s2, -(-fa // BIN_CHUNK)))
    t_cycles, r, _ = tables
    return _sched_layout_bytes(
        OS, s, s2, 1, t_cycles, r, x_floats,
        staged_rows(s2, sched_cluster(blocks, m, capacity)))


def placement_at_batch(lp, batch: int, capacity: dict[int, int]) -> str:
    """Where ``execute_layer_plan`` has the kernel read ``lp``'s shortcut
    at ``batch`` images on a card of cluster ``capacity``
    (``sched_cluster_capacity``): the plan's placement
    ('hbm' when it chose none), except that a planned 'vmem' whose staged
    rows do not fit one CTA's shared memory at this batch
    (``staged_shortcut_bytes``) becomes 'hbm'.  The scheduled kernel's
    cluster, and with it the staged rows, follows the batch, so a plan
    built at one batch may not fit at another; both placements give the
    same bits."""
    want = lp.tuning.residual or "hbm"
    if want != "vmem":
        return want
    halo = ((lp.geo, halo_block_geometry(lp.geo, lp.tuning.block_p))
            if lp.input_mode == "halo" else None)
    tables, blocks = None, 1
    if lp.hadamard == "scheduled":
        gn, _, t_cycles, r = lp.tables.idx.shape
        tables = (t_cycles, r, lp.tables.sel.shape[-1])
        blocks = gn * sched_halves(tables[2]) * (
            batch * halo[1].n_blocks if halo is not None
            else -(-batch * lp.geo.n_tiles // SCHED_BLOCK_P))
    smem = staged_shortcut_bytes(lp.dfr.shape[1], lp.dvr.shape[0],
                                 lp.n_active_bins, halo=halo, tables=tables,
                                 blocks=blocks, m=lp.layer.c_in,
                                 capacity=capacity)
    return want if smem <= SMEM_PER_CTA else "hbm"


# The output-stationary entry points that split M over CTAs
# (``os_launch_geometry``); the scheduled ones size a cluster over M.
_SPLIT_OS = ("fused_spectral_pipeline", "fused_spectral_pipeline_halo")


class OsGeometry(NamedTuple):
    """One output-stationary plane launch: ``ctas`` (tile blocks x n
    blocks x bin chunks x ranges) in clusters of ``cluster`` CTAs, run in
    ``waves`` (of the card's cluster capacity), M summed in ``ranges``
    ranges of ``range_m`` channels; ``slices`` (ranges x bin groups) > 1
    go through the split-K workspace and its finish pass."""
    ctas: int
    cluster: int
    waves: int
    ranges: int
    range_m: int
    slices: int


def os_launch_geometry(blocks: int, n: int, m: int, fa: int, s2: int,
                       capacity: dict[int, int]) -> OsGeometry:
    """The output-stationary plane kernel's grid for ``blocks`` tile blocks
    (ceil(P / BLOCK_P) of the windowed path; the halo path takes its
    windowed twin's, so that both sum each output in the same order and
    agree bit for bit), N output and M input channels, ``fa`` active bins
    and S2 output rows, on a card that runs ``capacity[c]`` clusters of c
    CTAs at once (one CTA an SM; ``os_cluster_capacity``).  Among
    clusters whose size divides the bin chunks (a cluster covers 1 / H of
    them) and M in ranges of whole BLOCK_M steps (at least OS_RANGE_MIN
    channels), the launch of least priced time, ties to fewer slices
    (cached: the search costs about as much host time as a layer's
    kernel)."""
    return _os_geometry(blocks, n, m, fa, s2, tuple(sorted(capacity.items())))


def os_latency_s(waves: int, steps: int, halo: bool = False) -> float:
    """Priced seconds of an output-stationary plane launch's CTA waves,
    each of ``steps`` BLOCK_M-channel steps and a CTA's set-up and
    epilogue (``os_launch_geometry`` and the cost model's price; ``halo``:
    the halo path's steps)."""
    if halo:
        return waves * (steps * OS_HALO_STEP_S + OS_HALO_FIXED_S)
    return waves * (steps * OS_STEP_S + OS_FIXED_S)


# The input-stationary plane launch's latency, (WAVE_S, STEP_S) per input
# path: seconds per n block a CTA finishes (Y~ gathered, IFFT, store) and
# per window or plane step, in time = waves x (n blocks x WAVE_S + steps
# x STEP_S).  Least-squares fit to the redesigned kernel's batch-1 device
# times at the 13 full-width VGG16 layers (``chip_smoke.py`` (c5), (c6)
# ``x_device_ms`` on an NVIDIA H100 80GB HBM3, 700 W; the times and the
# fit are in tests/test_torch_autotune.py).  ``is_launch_geometry`` sizes
# the launch by it, and ``core.autotune`` prices the launch by it.
IS_LATENCY = {"windowed": (2.400677314218486e-05, 2.357374733044491e-06),
              "halo": (2.3002775118782575e-05, 2.9853373828800447e-06)}


def is_latency_s(waves: int, rects: int, steps: int,
                 halo: bool = False) -> float:
    """Priced seconds of an input-stationary plane launch's CTA waves,
    each CTA finishing ``rects`` n blocks over ``steps`` window and plane
    steps (``IS_LATENCY`` of the input path)."""
    wave_s, step_s = IS_LATENCY["halo" if halo else "windowed"]
    return waves * (rects * wave_s + steps * step_s)


class IsGeometry(NamedTuple):
    """One input-stationary plane launch: clusters of ``cluster`` CTAs
    over consecutive bin chunks (``chunks / cluster`` bin groups), run in
    ``waves`` (of the card's cluster capacity); ``slices`` (m ranges x
    bin groups) > 1 go through the split-K workspace and its finish
    pass."""
    cluster: int
    waves: int
    slices: int


def is_launch_geometry(blocks: int, ranges: int, range_m: int, n: int,
                       fa: int, s2: int,
                       capacity: dict[int, int]) -> IsGeometry:
    """The input-stationary plane kernel's clusters for ``blocks`` tile
    blocks, ``ranges`` m ranges of ``range_m`` channels, N output
    channels, ``fa`` active bins and S2 output rows on a card of cluster
    ``capacity`` (``is_cluster_capacity``): among cluster sizes dividing
    the bin chunks, the least priced launch, its waves of ``blocks x
    ranges x chunks / size`` clusters priced by ``is_latency_s`` (a CTA's
    window and BLOCK_M-channel plane steps and its n blocks' epilogues;
    the windowed path's constants, since the halo path takes its windowed
    twin's clusters) plus the split-K workspace written and read once at
    OS_HBM_BYTES_S, ties to the larger cluster (fewer slices)."""
    chunks, nb = -(-fa // BIN_CHUNK), -(-n // BLOCK_N)
    steps = -(-range_m // BLOCK_M) * (1 + nb)
    best = None
    for cl in (c for c in range(chunks, 0, -1) if chunks % c == 0):
        waves = -(-blocks * ranges * (chunks // cl) // capacity[cl])
        slices = ranges * (chunks // cl)
        cost = is_latency_s(waves, nb, steps) + (8 * slices * s2 * n * blocks * BLOCK_P
                                / OS_HBM_BYTES_S if slices > 1 else 0.0)
        if best is None or cost < best[0]:
            best = (cost, IsGeometry(cl, waves, slices))
    return best[1]


# The weight-stationary plane launch's latency, (RECT_S, STEP_S) per input
# path: seconds per output rectangle a CTA finishes (a tile block of its
# chunk: the gather of Y~, the valid-row IFFT and the store) and
# per BLOCK_M-channel step (tile-FFT and Hadamard), a CTA's set-up (its m
# range's planes landed, the operators split) priced as WS_SETUP_STEPS
# steps, in time = waves x (rects x RECT_S + steps x STEP_S).
# Least-squares fit to the kernel's batch-1 device times at the 13
# full-width VGG16 layers (``chip_smoke.py`` (c5), (c6) ``x_device_ms`` on
# an NVIDIA H100 80GB HBM3, 700 W; the times and the fit are in
# tests/test_torch_autotune.py).  ``ws_launch_geometry`` sizes the launch
# by the windowed constants, and ``core.autotune`` prices it by them (its
# ``LATENCY_FIT``).
WS_LATENCY = {"windowed": (1.064517973524086e-05, 2.7873438843063764e-06),
              "halo": (1.7883730560303338e-05, 2.742726870002715e-06)}
WS_SETUP_STEPS = 2


class WsGeometry(NamedTuple):
    """One weight-stationary plane launch: tile blocks in ``split``
    chunks of ``per`` (a CTA walks one chunk; the halo path takes
    ceil(its blocks / split) a CTA), ``ctas`` in clusters over the bin
    chunks, run in ``waves`` of the card's cluster capacity; a CTA's
    ``rects`` output rectangles (its tile blocks) and ``steps``
    BLOCK_M-channel steps (its set-up counted as WS_SETUP_STEPS more)."""
    split: int
    per: int
    ctas: int
    waves: int
    rects: int
    steps: int


@functools.lru_cache(maxsize=4096)
def ws_launch_geometry(blocks: int, nb: int, ranges: int, range_m: int,
                       chunks: int, clusters: int) -> WsGeometry:
    """The weight-stationary plane launch for ``blocks`` tile blocks of
    BLOCK_P tiles (the windowed path's; the halo path takes its windowed
    twin's split), ``nb`` n blocks of WS_BLOCK_N and ``ranges`` m ranges of
    ``range_m`` channels, on a card that runs ``clusters`` clusters of
    ``chunks`` CTAs at once (``ws_cluster_capacity``): among the splits of
    the tile blocks into chunks of ``per`` consecutive blocks, the least
    priced launch by ``WS_LATENCY`` (windowed), ties to more CTAs.  The
    split never changes a sum's order: one cluster sums each (tile block,
    n block, m range) rectangle."""
    rect_s, step_s = WS_LATENCY["windowed"]
    ksteps = -(-range_m // BLOCK_M)
    best = None
    for per in range(blocks, 0, -1):
        split = -(-blocks // per)
        if per > 1 and -(-blocks // (per - 1)) == split:
            continue        # the same split with fewer blocks a CTA
        n_clusters = split * nb * ranges
        waves = -(-n_clusters // clusters)
        steps = per * ksteps + WS_SETUP_STEPS
        cost = waves * (per * rect_s + steps * step_s)
        key = (cost, -n_clusters)
        if best is None or key < best[0]:
            best = (key, WsGeometry(split, per, n_clusters * chunks, waves,
                                    per, steps))
    return best[1]


# The price by which ``sched_flow_geometry`` sizes the scheduled weight-
# and input-stationary launch, (RECT_S, STEP_S) per flow: seconds per
# (tile block, group half) rectangle a CTA finishes (the four-round IFFT
# and the store) and per channel step (ws: tile-FFT, expansion and MACs;
# is: a build step of two channels' FFTs or a walk step of expansion and
# MACs), in time = waves x (rects x RECT_S + steps x STEP_S).  Set by hand
# (a rectangle about two of B4's channel steps); ``core.autotune``'s
# ``LATENCY_FIT`` holds the fit of the kernel's measured times, by which
# the cost model prices the launch this rule makes.
SCHED_FLOW_LATENCY = {WS: (6e-06, 2.3e-06), IS: (6e-06, 1.5e-06)}
# a CTA's set-up (the operators split, ws's table rows staged), priced by
# the launch rule as this many channel steps
SCHED_FLOW_SETUP_STEPS = 4


class FlowGeometry(NamedTuple):
    """One scheduled weight- / input-stationary launch: ``split`` (ws: the
    chunks of tile blocks; is: the shares of the (group, half) walk),
    ``ctas`` one an SM in ``waves``, and a CTA's ``rects`` (tile block,
    group half) rectangles and ``steps`` channel steps (the largest
    share's)."""
    split: int
    ctas: int
    waves: int
    rects: int
    steps: int


@functools.lru_cache(maxsize=4096)
def sched_flow_geometry(flow: str, blocks: int, ranges: int, range_m: int,
                        rects: int, sms: int) -> FlowGeometry:
    """The scheduled flows' launch rule, for ``blocks`` tile blocks of
    SCHED_BLOCK_P tiles (the halo path's blocks on its own), ``ranges`` m
    ranges of ``range_m`` channels and ``rects`` (kernel group, lane half)
    pairs, on a card of ``sms`` SMs (one CTA each): among the splits
    (ws: chunks of ceil(blocks / c) tile blocks, each walking them with
    the range's tables resident; is: shares of ceil(rects / c) group
    halves, each building X~ of the range first), the least priced launch
    by ``SCHED_FLOW_LATENCY`` and a set-up of SCHED_FLOW_SETUP_STEPS
    steps a CTA, ties to more CTAs (so the grid covers a wave where that
    costs nothing).  The split never changes a sum's order: a CTA walks
    whole (tile block, group half) rectangles of its m range."""
    rect_s, step_s = SCHED_FLOW_LATENCY[flow]
    best = None
    for c in range(1, (blocks if flow == WS else rects) + 1):
        if flow == WS:
            ctas, per = c * rects * ranges, -(-blocks // c)
            steps = per * range_m
        else:
            ctas, per = blocks * ranges * c, -(-rects // c)
            steps = -(-range_m // 2) + per * range_m
        waves = -(-ctas // sms)
        cost = waves * (per * rect_s
                        + (steps + SCHED_FLOW_SETUP_STEPS) * step_s)
        key = (cost, -ctas)
        if best is None or key < best[0]:
            best = (key, FlowGeometry(c, ctas, waves, per, steps))
    return best[1]


@functools.lru_cache(maxsize=4096)
def _os_geometry(blocks: int, n: int, m: int, fa: int, s2: int,
                 capacity: tuple[tuple[int, int], ...]) -> OsGeometry:
    capacity = dict(capacity)
    chunks, nb = -(-fa // BIN_CHUNK), -(-n // BLOCK_N)
    best = None
    for cl in (c for c in range(chunks, 0, -1) if chunks % c == 0):
        for g in range(1, max(1, -(-m // OS_RANGE_MIN)) + 1):
            range_m = m if g == 1 else BLOCK_M * -(-m // (BLOCK_M * g))
            ranges = -(-m // range_m)
            slices = ranges * (chunks // cl)
            clusters = blocks * nb * ranges * (chunks // cl)
            waves = -(-clusters // capacity[cl])
            cost = os_latency_s(waves, -(-range_m // BLOCK_M))
            if slices > 1:
                cost += (8 * slices * s2 * n * blocks * BLOCK_P
                         / OS_HBM_BYTES_S)
            key = (cost, slices)
            if best is None or key < best[0]:
                best = (key, OsGeometry(clusters * cl, cl, waves, ranges,
                                        range_m, slices))
    return best[1]


@functools.cache
def _os_capacity(index: int, kernel: str = "os"
                 ) -> tuple[tuple[int, int], ...]:
    fn = (library_scheduled().fused_spectral_pipeline_scheduled_os_max_clusters
          if kernel == "sched" else
          getattr(library(), f"fused_spectral_pipeline_{kernel}_max_clusters"))
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = []
    for cl in range(1, MAX_CLUSTER + 1):
        count = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = fn(cl, ctypes.byref(count))
        if err != 0 or count.value < 1:
            raise RuntimeError(f"cluster capacity query failed for {cl} "
                               f"CTAs: cudaError {err}")
        out.append((cl, count.value))
    return tuple(out)


def os_cluster_capacity(device) -> dict[int, int]:
    """How many clusters of 1 to MAX_CLUSTER output-stationary CTAs (one
    an SM) the card runs at once, by cluster size (queried once per
    device): clusters stay within a GPC, so a card holds fewer SMs' worth
    of large clusters."""
    return dict(_os_capacity(torch.device(device).index or 0))


def sched_cluster_capacity(device) -> dict[int, int]:
    """The same for the scheduled output-stationary kernel (its launch's
    cluster rule reads it; ``sched_cluster`` mirrors the rule)."""
    return dict(_os_capacity(torch.device(device).index or 0, "sched"))


def is_cluster_capacity(device) -> dict[int, int]:
    """The same for the plane kernel's input-stationary flow
    (``fused_is_kernel``; ``is_launch_geometry`` reads it)."""
    return dict(_os_capacity(torch.device(device).index or 0, "is"))


def ws_cluster_capacity(device) -> dict[int, int]:
    """The same for the plane kernel's weight-stationary flow
    (``fused_ws_kernel``; ``ws_launch_geometry`` reads it)."""
    return dict(_os_capacity(torch.device(device).index or 0, "ws"))


def ws_launch(blocks: int, n: int, m: int, block_m: int, fa: int,
              device) -> WsGeometry:
    """The weight-stationary plane launch on ``device`` for ``blocks``
    windowed tile blocks, N outputs, M inputs in ranges of ``block_m``
    and ``fa`` active bins (``ws_launch_geometry`` on the card's cluster
    capacity)."""
    chunks = -(-fa // BIN_CHUNK)
    return ws_launch_geometry(blocks, -(-n // WS_BLOCK_N),
                              -(-m // block_m), min(block_m, m), chunks,
                              ws_cluster_capacity(device)[chunks])


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sched_flow_launch(flow: str, blocks: int, m: int, block_m: int, n: int,
                      n_pe: int, device) -> FlowGeometry:
    """The scheduled flows' launch on ``device`` for ``blocks`` tile
    blocks, M input channels in ranges of ``block_m``, N outputs in groups
    of ``n_pe`` lanes (``sched_flow_geometry`` on the card's SM count)."""
    return sched_flow_geometry(flow, blocks, -(-m // block_m),
                               min(block_m, m),
                               -(-n // n_pe) * sched_halves(n_pe),
                               _sm_count(torch.device(device).index or 0))


def _check_staged_fits(kernel: str, smem: int) -> None:
    """Refuse a 'vmem' shortcut whose CTA would need more shared memory
    than the card gives one (the launch would fail)."""
    if smem > SMEM_PER_CTA:
        raise ValueError(f"{kernel}: staging the shortcut ('vmem') needs "
                         f"{smem} bytes of shared memory per CTA, over the "
                         f"{SMEM_PER_CTA} a CTA may take; use 'hbm'")


def _launch(lib, kernel: str, flow: str, block_m, g: int, slots: int,
            device, ptrs: tuple, ints: tuple, s2: int, n: int,
            shortcut=None, staged: bool = False, band: bool = False,
            cluster: int | None = None) -> None:
    """Call a kernel's entry point for ``flow`` on the current stream
    (the flows, and the plane kernels' output-stationary launch, get a
    split-K workspace of G * S2 * N * slots floats when G > 1 slices (the
    scheduled flows always), ``block_m`` and their ``cluster`` size or
    split), with the shortcut
    (or a null pointer) after the output and ``staged`` last; raise on a
    CUDA error, count the launch (and, with a shortcut, the residual
    launch; on a shard's ``band``, the band launch)."""
    name = entry_point(kernel, flow)
    fn = getattr(lib, name + "_f32")
    stream = torch.cuda.current_stream().cuda_stream
    sc = 0 if shortcut is None else shortcut.data_ptr()
    if flow == OS and kernel not in _SPLIT_OS:
        err = fn(*ptrs, sc, *ints, int(staged), stream)
    else:       # the scheduled flows store through it with one slice too
        ws = (torch.empty(g * s2 * n * slots, dtype=torch.float32,
                          device=device)
              if g > 1 or kernel not in _SPLIT_OS else None)
        extra = () if cluster is None else (int(cluster),)
        err = fn(*ptrs, sc, 0 if ws is None else ws.data_ptr(), *ints,
                 int(block_m), *extra, int(staged), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    if shortcut is not None:
        RESIDUAL_LAUNCHES[name] += 1
    if staged:
        STAGED_LAUNCHES[name] += 1
    if band:
        BAND_LAUNCHES[name] += 1


def fused_spectral_pipeline(xt, wr, wi, dfr, dfi, dvr, dvi, bias, *,
                            relu: bool, flow: str = OS,
                            block_m: int | None = None, shortcut=None,
                            shortcut_placement: str = "hbm",
                            band: bool = False) -> torch.Tensor:
    """FFT -> Hadamard -> IFFT (+ bias/ReLU) in one kernel launch (two
    with more than one split-K slice: a weight-stationary flow's m
    ranges, or the output-stationary split of ``os_launch_geometry`` or
    the input-stationary one of ``is_launch_geometry``, each followed by
    the split-K finish pass).

    xt:  [S, M, P] f32       overlap-save windows, s-leading (S = K^2,
                             P = B*T); contiguous, or rows of P floats
                             at a larger pitch (``_windows_layout``
                             pads it to a multiple of 4 floats so the
                             kernel copies whole 16-byte vectors)
    wr/wi: [Fa, N, M] f32    spectral kernel planes on the active bins
    dfr/dfi: [Fa, S]         forward DFT rows (active bins)
    dvr/dvi: [S2, Fa]        inverse DFT, valid rows x active columns
    bias: [1, N] f32         per-output-channel bias
    flow / block_m: the reuse flow; weight-/input-stationary take m
                             ranges of ``block_m`` channels (a value of
                             ``FLOW_BLOCK_M``)
    shortcut: [S2, N, P] f32 residual operand in the output's layout
                             (``_shortcut_tiles``), added after the bias
                             and before the ReLU; None for none
    shortcut_placement: 'hbm' (read at the flush) or 'vmem' (output-
                             stationary: staged in shared memory before
                             the channel loop; refused when it does not
                             fit beside the kernel's stages; read as
                             'hbm' by the finish pass where
                             ``os_launch_geometry`` splits the launch,
                             counted apart in ``STAGED_LAUNCHES``)
    band: the windows are a shard's band (``execute_band_plan``): the
                             launch is also counted in ``BAND_LAUNCHES``
                             (the kernel is the same)
    returns [S2, N, P] f32 finished outputs (epilogue applied).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (or raise: also when S and S2 need more shared memory per CTA than
    the card has, which the launch reports).
    """
    g = _flow_ranges(flow, block_m, xt.shape[1], "plane")
    s, m, p = xt.shape
    fa, n, _ = wr.shape
    s2 = dvr.shape[0]
    _check_shortcut(shortcut, (s2, n, p), xt.device, flow,
                    shortcut_placement)
    if xt.device.type == "cpu":
        return fused_spectral_pipeline_reference(
            xt, wr, wi, dfr, dfi, dvr, dvi, bias, relu=relu, flow=flow,
            block_m=block_m, shortcut=shortcut)
    if xt.device.type != "cuda":
        raise ValueError(f"no kernel for device {xt.device}")
    _check_operands(xt, wr, wi, dfr, dfi, dvr, dvi, bias)
    staged = shortcut is not None and shortcut_placement == "vmem"
    cluster = None
    if flow == OS:
        og = os_launch_geometry(-(-p // BLOCK_P), n, m, fa, s2,
                                os_cluster_capacity(xt.device))
        g, block_m, cluster = og.slices, og.range_m, og.cluster
        staged = staged and og.slices == 1      # else 'hbm', the same bits
    elif flow == IS:
        ig = is_launch_geometry(-(-p // BLOCK_P), g, min(block_m, m), n,
                                fa, s2, is_cluster_capacity(xt.device))
        g, cluster = ig.slices, ig.cluster
    else:                   # tile blocks a CTA
        cluster = ws_launch(-(-p // BLOCK_P), n, m, block_m, fa,
                            xt.device).per
    if staged:
        _check_staged_fits("fused_spectral_pipeline",
                           staged_shortcut_bytes(s, s2, fa))
    with torch.cuda.device(xt.device):
        y = torch.empty((s2, n, p), dtype=torch.float32, device=xt.device)
        _launch(library(), "fused_spectral_pipeline", flow, block_m, g,
                -(-p // BLOCK_P) * BLOCK_P, xt.device,
                (xt.data_ptr(), wr.data_ptr(), wi.data_ptr(),
                 dfr.data_ptr(), dfi.data_ptr(), dvr.data_ptr(),
                 dvi.data_ptr(), bias.data_ptr(), y.data_ptr()),
                (s, m, p, xt.stride(1), fa, n, s2, int(relu)), s2, n,
                shortcut, staged, band, cluster)
    return y


# ---------------------------------------------------------------------------
# The scheduled kernel (Alg-2 tables) and its plain version
# ---------------------------------------------------------------------------

def _sched_spatial(xt, idx, sel, vr, vi, dfr, dfi, dvr, dvi,
                   n_out: int) -> torch.Tensor:
    """Re(Dv . Y~) of the windows' channels through the tables (channel m
    of the windows reads table channel m), before the epilogue: per cycle
    t, vectorised over (group, channel, lane, tile), gather
    ``X~[idx[t][sel[t][n]]]``, complex-MAC with ``vr + i vi`` and
    ``index_add_`` into the ``[GN*N', Fa, P]`` psum (summing channels);
    then the valid-row IFFT -> [S2, n_out, P]."""
    s, m, p = xt.shape
    gn, _, n_cycles, _ = idx.shape
    n_pe = sel.shape[3]
    fa = dfr.shape[0]
    s2 = dvr.shape[0]
    x2 = xt.reshape(s, m * p)
    xfr = (dfr @ x2).reshape(fa * m, p)                 # row f*M + m
    xfi = (dfi @ x2).reshape(fa * m, p)
    # the bin each lane accumulates into: out_index == idx[t, sel[t, n]]
    bins = torch.gather(idx[:, :m].long(), 3, sel[:, :m].long())
    chan = torch.arange(m, device=xt.device).view(1, m, 1)
    lanes = torch.arange(gn * n_pe, device=xt.device).view(gn, 1, n_pe)
    acc_r = xt.new_zeros((gn * n_pe * fa, p))
    acc_i = xt.new_zeros((gn * n_pe * fa, p))
    for t in range(n_cycles):
        b = bins[:, :, t]                               # [GN, M, N']
        src = (b * m + chan).reshape(-1)
        dst = (lanes * fa + b).reshape(-1)
        x_r, x_i = xfr[src], xfi[src]
        w_r = vr[:, :m, t].reshape(-1, 1)
        w_i = vi[:, :m, t].reshape(-1, 1)
        acc_r.index_add_(0, dst, w_r * x_r - w_i * x_i)
        acc_i.index_add_(0, dst, w_r * x_i + w_i * x_r)
    re = acc_r.reshape(gn * n_pe, fa, p).permute(1, 0, 2).reshape(fa, -1)
    im = acc_i.reshape(gn * n_pe, fa, p).permute(1, 0, 2).reshape(fa, -1)
    return (dvr @ re - dvi @ im).reshape(s2, gn * n_pe, p)[:, :n_out]


def fused_spectral_pipeline_scheduled_reference(
        xt, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, *, n_out: int,
        relu: bool, flow: str = OS, block_m: int | None = None,
        shortcut=None) -> torch.Tensor:
    """Plain PyTorch version of the scheduled kernel (same contract as
    ``fused_spectral_pipeline_scheduled``): it executes the tables per
    the flow's m ranges (``_sched_spatial``), sums the ranges' partials
    in ascending order, then bias (+ shortcut) + ReLU."""
    if xt.is_cuda:
        repro_torch.strict_fp32()
    y = _flow_sum(lambda m0, m1: _sched_spatial(
        xt[:, m0:m1], idx[:, m0:m1], sel[:, m0:m1], vr[:, m0:m1],
        vi[:, m0:m1], dfr, dfi, dvr, dvi, n_out), xt.shape[1], flow,
        block_m)
    return _epilogue(y, bias, relu, shortcut)


def library_scheduled() -> ctypes.CDLL:
    """The scheduled kernel's library (built at first use)."""
    return _libraries()["fused_spectral_conv_scheduled"]


def _check_scheduled_operands(xt, idx, sel, vr, vi, dfr, dfi, dvr, dvi,
                              bias, n_out: int) -> None:
    _check_table_operands(dict(xt=xt, idx=idx, sel=sel, vr=vr, vi=vi,
                               dfr=dfr, dfi=dfi, dvr=dvr, dvi=dvi,
                               bias=bias), *xt.shape, n_out)


def _check_table_operands(ops: dict[str, torch.Tensor], s: int, m: int,
                          p: int, n_out: int) -> None:
    """Layouts and shapes of the scheduled kernels' operands (``ops``
    leads with the windows ``xt`` or the raw input ``x``)."""
    _check_layouts(ops, int_names=("idx", "sel"))
    idx, sel, dfr, dvr = ops["idx"], ops["sel"], ops["dfr"], ops["dvr"]
    if idx.dim() != 4:
        raise ValueError(f"idx must be [GN, Mp, T, r], got "
                         f"{tuple(idx.shape)}")
    gn, mp, n_cycles, _ = idx.shape
    n_pe = sel.shape[-1]
    fa = dfr.shape[0]
    s2 = dvr.shape[0]
    want = dict(sel=(gn, mp, n_cycles, n_pe), vr=(gn, mp, n_cycles, n_pe),
                vi=(gn, mp, n_cycles, n_pe), dfr=(fa, s), dfi=(fa, s),
                dvr=(s2, fa), dvi=(s2, fa), bias=(1, n_out))
    for name, shape in want.items():
        if tuple(ops[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(ops[name].shape)}, "
                             f"expected {shape}")
    if mp < m:
        raise ValueError(f"tables cover {mp} channels, windows {m}")
    if n_pe > SCHED_BLOCK_N:
        raise ValueError(f"{n_pe} PE lanes per group; the kernel takes at "
                         f"most {SCHED_BLOCK_N}")
    if not (gn - 1) * n_pe < n_out <= gn * n_pe:
        raise ValueError(f"n_out {n_out} does not fill {gn} groups of "
                         f"{n_pe} lanes")
    if fa > SCHED_MAX_BINS:
        raise ValueError(f"active bins {fa} must be at most "
                         f"{SCHED_MAX_BINS}")
    if min(s, m, p, fa, s2, idx.shape[3], n_cycles) < 1:
        raise ValueError(f"empty operand: S, M, P = {s}, {m}, {p}, "
                         f"idx {tuple(idx.shape)}, dvr {tuple(dvr.shape)}")


def fused_spectral_pipeline_scheduled(xt, idx, sel, vr, vi, dfr, dfi, dvr,
                                      dvi, bias, *, n_out: int,
                                      relu: bool, flow: str = OS,
                                      block_m: int | None = None,
                                      shortcut=None,
                                      shortcut_placement: str = "hbm",
                                      band: bool = False) -> torch.Tensor:
    """FFT -> SCHEDULED sparse Hadamard -> IFFT (+ bias/ReLU) in one
    kernel launch (a weight-/input-stationary flow: the tensor-core flow
    kernel, its m ranges' partials through the split-K workspace, then
    the finish pass; its launch by ``sched_flow_geometry``).

    xt:  [S, M, P] f32          overlap-save windows (as for
                                ``fused_spectral_pipeline``)
    idx: [GN, Mp, T, r] int32   replica read addresses, in the active-bin
                                coordinates of the operators (Mp >= M)
    sel: [GN, Mp, T, N'] int32  replica column feeding PE lane n
    vr/vi: [GN, Mp, T, N'] f32  lane weights (zero = idle lane)
    dfr/dfi: [Fa, S], dvr/dvi: [S2, Fa], bias: [1, n_out]
    flow / block_m: the reuse flow and, for ws/is, the m-range width
    shortcut / shortcut_placement: [S2, n_out, P] residual operand, as
                                for ``fused_spectral_pipeline``
    band: count the launch in ``BAND_LAUNCHES`` too, as for
                                ``fused_spectral_pipeline``
    returns [S2, n_out, P] f32 finished outputs; output channel
    g*N' + n is lane n of group g.

    The tables must be an exact cover (``scheduler.compile_layer_tables``
    builds them so): each (lane, bin) at most once per (group, channel).
    CPU tensors run the plain version; CUDA tensors launch the kernel
    (or raise).
    """
    g = _flow_ranges(flow, block_m, xt.shape[1], "scheduled")
    s, m, p = xt.shape
    s2 = dvr.shape[0]
    _check_shortcut(shortcut, (s2, n_out, p), xt.device, flow,
                    shortcut_placement)
    if xt.device.type == "cpu":
        return fused_spectral_pipeline_scheduled_reference(
            xt, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, n_out=n_out,
            relu=relu, flow=flow, block_m=block_m, shortcut=shortcut)
    if xt.device.type != "cuda":
        raise ValueError(f"no kernel for device {xt.device}")
    _check_scheduled_operands(xt, idx, sel, vr, vi, dfr, dfi, dvr, dvi,
                              bias, n_out)
    gn, mp, n_cycles, r = idx.shape
    n_pe = sel.shape[3]
    fa = dfr.shape[0]
    staged = shortcut is not None and shortcut_placement == "vmem"
    if staged:
        _check_staged_fits(
            "fused_spectral_pipeline_scheduled", staged_shortcut_bytes(
                s, s2, fa, tables=(n_cycles, r, n_pe),
                blocks=-(-p // SCHED_BLOCK_P) * gn * sched_halves(n_pe),
                m=m, capacity=sched_cluster_capacity(xt.device)))
    blocks = -(-p // SCHED_BLOCK_P)
    split = (None if flow == OS else sched_flow_launch(
        flow, blocks, m, block_m, n_out, n_pe, xt.device).split)
    with torch.cuda.device(xt.device):
        y = torch.empty((s2, n_out, p), dtype=torch.float32,
                        device=xt.device)
        _launch(library_scheduled(), "fused_spectral_pipeline_scheduled",
                flow, block_m, g, blocks * SCHED_BLOCK_P, xt.device,
                (xt.data_ptr(), idx.data_ptr(), sel.data_ptr(),
                 vr.data_ptr(), vi.data_ptr(), dfr.data_ptr(),
                 dfi.data_ptr(), dvr.data_ptr(), dvi.data_ptr(),
                 bias.data_ptr(), y.data_ptr()),
                (s, m, p, xt.stride(1), gn, mp, n_cycles, r, n_pe, fa,
                 n_out, s2, int(relu)), s2, n_out, shortcut, staged, band,
                split)
    return y


# ---------------------------------------------------------------------------
# The halo-input kernels and their plain versions
# ---------------------------------------------------------------------------

def _halo_windows(x: torch.Tensor, geo: SpectralGeometry,
                  hg: HaloGeometry) -> torch.Tensor:
    """Raw [B, M, H, W] -> the halo path's windows [S, M, B*nb*bt],
    s-leading: column ((b*nbh + ib)*nbw + jb)*bt + ii*btw + jj is tile
    (ii, jj) of block (ib, jb) of image b (one-hot gather, exact)."""
    b, m = x.shape[:2]
    s = geo.fft_size * geo.fft_size
    win = halo_windows_blocked(x, geo, hg)   # [B,nbh,nbw,M,bth,btw,K,K]
    return win.permute(6, 7, 3, 0, 1, 2, 4, 5).reshape(s, m, -1)


def _stage_canvas(y: torch.Tensor, geo: SpectralGeometry, hg: HaloGeometry,
                  b: int) -> torch.Tensor:
    """[t^2, N, B*nb*bt] block-major outputs -> canvas [B, N, nbh*bth*t,
    nbw*btw*t]: tile (ii, jj) of block (ib, jb) at rows (ib*bth + ii)*t
    + u, cols (jb*btw + jj)*t + v (the reference's ``_CanvasSink.stage``
    over every block)."""
    t = geo.tile
    n = y.shape[1]
    y = y.reshape(t, t, n, b, hg.nbh, hg.nbw, hg.bth, hg.btw)
    y = y.permute(3, 2, 4, 6, 0, 5, 7, 1)    # b, n, ib, ii, u, jb, jj, v
    return y.reshape(b, n, hg.nbh * hg.bth * t, hg.nbw * hg.btw * t)


def _crop_canvas(y: torch.Tensor, geo: SpectralGeometry, n: int
                 ) -> torch.Tensor:
    """[B, Np, nbh*bth*t, nbw*btw*t] halo canvas -> [B, N, H_out, W_out]:
    the channel crop and the 'same'-crop slice."""
    start = geo.ksize - 1 - geo.pad
    h_out = geo.h_in + 2 * geo.pad - geo.ksize + 1
    w_out = geo.w_in + 2 * geo.pad - geo.ksize + 1
    return y[:, :n, start:start + h_out, start:start + w_out]


def _halo_finish(y, geo: SpectralGeometry, hg: HaloGeometry, b: int,
                 n: int, shortcut, relu: bool, band: bool = False
                 ) -> torch.Tensor:
    """[t^2, N, B*nb*bt] block-major outputs (bias applied) -> contiguous
    [B, N, H_out, W_out]: canvas relayout, crop, (+ shortcut) -> ReLU.  A
    ``band`` keeps the uncropped [B, N, h_pad, w_pad] canvas (the
    channel and block-padding crop only)."""
    y = _stage_canvas(y, geo, hg, b)
    y = (y[:, :n, :geo.h_pad, :geo.w_pad] if band
         else _crop_canvas(y, geo, n))
    return _add_shortcut(y, shortcut, relu).contiguous()


def fused_spectral_pipeline_halo_reference(x, wr, wi, dfr, dfi, dvr, dvi,
                                           bias, *, geo: SpectralGeometry,
                                           hg: HaloGeometry, relu: bool,
                                           flow: str = OS,
                                           block_m: int | None = None,
                                           shortcut=None, band: bool = False
                                           ) -> torch.Tensor:
    """Plain PyTorch version of the halo plane kernel (same contract as
    ``fused_spectral_pipeline_halo``): the one-hot halo gather, block by
    block (from pre_halo_h rows lower on a band), then the plain plane
    pipeline of the flow (bias only), the canvas relayout, the crop (none
    on a band), (+ shortcut) and the ReLU.  Returns a contiguous
    [B, N, H_out, W_out] ([B, N, h_pad, w_pad] on a band)."""
    y = fused_spectral_pipeline_reference(
        _halo_windows(x, geo, hg), wr, wi, dfr, dfi, dvr, dvi, bias,
        relu=False, flow=flow, block_m=block_m)
    return _halo_finish(y, geo, hg, x.shape[0], wr.shape[1], shortcut, relu,
                        band)


def fused_spectral_pipeline_scheduled_halo_reference(
        x, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, *,
        geo: SpectralGeometry, hg: HaloGeometry, n_out: int,
        relu: bool, flow: str = OS, block_m: int | None = None,
        shortcut=None, band: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the halo scheduled kernel (same contract
    as ``fused_spectral_pipeline_scheduled_halo``): the one-hot halo
    gather, the plain table pipeline of the flow (bias only), the canvas
    relayout, the crop (none on a band), (+ shortcut) and the ReLU.
    """
    y = fused_spectral_pipeline_scheduled_reference(
        _halo_windows(x, geo, hg), idx, sel, vr, vi, dfr, dfi, dvr, dvi,
        bias, n_out=n_out, relu=False, flow=flow, block_m=block_m)
    return _halo_finish(y, geo, hg, x.shape[0], n_out, shortcut, relu, band)


def _check_halo_input(x: torch.Tensor, geo: SpectralGeometry,
                      hg: HaloGeometry, block_p: int, band: bool = False,
                      shortcut=None) -> None:
    """The halo kernels read x as a contiguous NCHW f32 image of the
    geometry's extent; they do not copy another layout silently.  An input
    that carries its top halo is a band, and a band takes no shortcut."""
    if geo.pre_halo_h and not band:
        raise ValueError(f"pre_halo_h={geo.pre_halo_h}: a band geometry "
                         f"runs in band mode (band=True)")
    if band and shortcut is not None:
        raise ValueError("a band takes no shortcut: the sharded executor "
                         "adds it after the bands are joined")
    if not 0 <= geo.pre_halo_h <= geo.ksize - 1:
        raise ValueError(f"pre_halo_h={geo.pre_halo_h} must be in "
                         f"[0, {geo.ksize - 1}]")
    if x.dim() != 4 or tuple(x.shape[2:]) != (geo.h_in, geo.w_in):
        raise ValueError(f"x must be [B, M, {geo.h_in}, {geo.w_in}], got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous NCHW float32, got "
                         f"{x.dtype} with strides {x.stride()}")
    if hg != halo_block_geometry(geo, hg.block_tiles):
        raise ValueError(f"{hg} is not a halo block of {geo}")
    if hg.block_tiles > block_p:
        raise ValueError(f"halo blocks of {hg.block_tiles} tiles exceed "
                         f"the kernel's {block_p} tile slots")


def _halo_ints(x: torch.Tensor, geo: SpectralGeometry, hg: HaloGeometry,
               band: bool) -> tuple[int, ...]:
    """The halo kernels' geometry arguments, in their order."""
    b, m, h, w = x.shape
    return (b, m, h, w, geo.fft_size, geo.ksize, geo.pad, geo.n_tiles_h,
            geo.n_tiles_w, hg.bth, hg.btw, hg.nbh, hg.nbw, geo.pre_halo_h,
            int(band))


def _halo_out_shape(x, geo: SpectralGeometry, n: int,
                    band: bool = False) -> tuple:
    if band:
        return (x.shape[0], n, geo.h_pad, geo.w_pad)
    return (x.shape[0], n, geo.h_in + 2 * geo.pad - geo.ksize + 1,
            geo.w_in + 2 * geo.pad - geo.ksize + 1)


def _halo_out(x, geo: SpectralGeometry, n: int, band: bool) -> torch.Tensor:
    return torch.empty(_halo_out_shape(x, geo, n, band), dtype=torch.float32,
                       device=x.device)


def fused_spectral_pipeline_halo(x, wr, wi, dfr, dfi, dvr, dvi, bias, *,
                                 geo: SpectralGeometry, hg: HaloGeometry,
                                 relu: bool, flow: str = OS,
                                 block_m: int | None = None, shortcut=None,
                                 shortcut_placement: str = "hbm",
                                 band: bool = False) -> torch.Tensor:
    """Halo gather -> FFT -> Hadamard -> IFFT (+ bias/ReLU) in one kernel
    launch (plus the split-K finish pass with more than one m range, as
    for ``fused_spectral_pipeline``), reading the RAW activation.

    x: [B, M, H, W] f32      raw NCHW activation, contiguous (no
                             windowing, no padding: the kernel's
                             zero-filled block copies do both)
    wr/wi/dfr/dfi/dvr/dvi/bias, flow, block_m: as
        ``fused_spectral_pipeline``.
    geo/hg: tile and halo-block geometry (``halo_block_geometry``; at
        most ``BLOCK_P`` tiles per block); one CTA per (image, block)
        and m range.
    shortcut / shortcut_placement: raw [B, N, H_out, W_out] f32 residual
        operand (contiguous; the kernel adds it where it stores each
        output, so it needs no relayout), placed as for
        ``fused_spectral_pipeline``.
    band: x is a shard's extended band (``geo`` from
        ``spectral.make_band_geometry``: its first pre_halo_h = k-1 rows
        are the top halo) and the result is the uncropped band canvas
        [B, N, h_pad, w_pad]; no shortcut.  Counted in ``BAND_LAUNCHES``.
    returns [B, N, H_out, W_out] f32, contiguous: each finished tile is
    stored at its place in the cropped output (no host relayout).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (or raise).
    """
    _check_halo_input(x, geo, hg, BLOCK_P, band, shortcut)
    g = _flow_ranges(flow, block_m, x.shape[1], "plane")
    fa, n, _ = wr.shape
    s2 = dvr.shape[0]
    _check_shortcut(shortcut, _halo_out_shape(x, geo, n), x.device, flow,
                    shortcut_placement)
    if x.device.type == "cpu":
        return fused_spectral_pipeline_halo_reference(
            x, wr, wi, dfr, dfi, dvr, dvi, bias, geo=geo, hg=hg, relu=relu,
            flow=flow, block_m=block_m, shortcut=shortcut, band=band)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_plane_operands(dict(x=x, wr=wr, wi=wi, dfr=dfr, dfi=dfi,
                               dvr=dvr, dvi=dvi, bias=bias),
                          geo.fft_size ** 2, x.shape[1], hg.block_tiles)
    staged = shortcut is not None and shortcut_placement == "vmem"
    cluster = None
    if flow == OS:          # the windowed twin's split: the same sums
        og = os_launch_geometry(-(-x.shape[0] * geo.n_tiles // BLOCK_P), n,
                                x.shape[1], fa, s2,
                                os_cluster_capacity(x.device))
        g, block_m, cluster = og.slices, og.range_m, og.cluster
        staged = staged and og.slices == 1      # else 'hbm', the same bits
    elif flow == IS:        # the windowed twin's clusters: the same sums
        ig = is_launch_geometry(-(-x.shape[0] * geo.n_tiles // BLOCK_P), g,
                                min(block_m, x.shape[1]), n, fa, s2,
                                is_cluster_capacity(x.device))
        g, cluster = ig.slices, ig.cluster
    else:                   # the windowed twin's split of the tile blocks
        wg = ws_launch(-(-x.shape[0] * geo.n_tiles // BLOCK_P), n,
                       x.shape[1], block_m, fa, x.device)
        cluster = -(-x.shape[0] * hg.n_blocks // wg.split)
    if staged:
        _check_staged_fits("fused_spectral_pipeline_halo",
                           staged_shortcut_bytes(geo.fft_size ** 2, s2, fa,
                                                 halo=(geo, hg)))
    with torch.cuda.device(x.device):
        y = _halo_out(x, geo, n, band)
        _launch(library(), "fused_spectral_pipeline_halo", flow, block_m, g,
                x.shape[0] * hg.n_blocks * BLOCK_P, x.device,
                (x.data_ptr(), wr.data_ptr(), wi.data_ptr(), dfr.data_ptr(),
                 dfi.data_ptr(), dvr.data_ptr(), dvi.data_ptr(),
                 bias.data_ptr(), y.data_ptr()),
                (*_halo_ints(x, geo, hg, band), fa, n, s2, int(relu)), s2, n,
                shortcut, staged, band, cluster)
    return y


def fused_spectral_pipeline_scheduled_halo(x, idx, sel, vr, vi, dfr, dfi,
                                           dvr, dvi, bias, *,
                                           geo: SpectralGeometry,
                                           hg: HaloGeometry, n_out: int,
                                           relu: bool, flow: str = OS,
                                           block_m: int | None = None,
                                           shortcut=None,
                                           shortcut_placement: str = "hbm",
                                           band: bool = False
                                           ) -> torch.Tensor:
    """Halo gather -> FFT -> SCHEDULED sparse Hadamard -> IFFT (+
    bias/ReLU) in one kernel launch (a weight-/input-stationary flow also
    its split-K finish pass, as ``fused_spectral_pipeline_scheduled``),
    reading the RAW activation.

    x: [B, M, H, W] f32 raw NCHW activation, contiguous; tables,
    operators, bias, flow and block_m as
    ``fused_spectral_pipeline_scheduled``; geo/hg, shortcut,
    shortcut_placement and band as ``fused_spectral_pipeline_halo`` (at
    most ``SCHED_BLOCK_P`` tiles per block).  Returns [B, n_out, H_out,
    W_out] f32, contiguous ([B, n_out, h_pad, w_pad] on a band).  CPU
    tensors run the plain version; CUDA tensors launch the kernel (or
    raise).
    """
    g = _flow_ranges(flow, block_m, x.shape[1], "scheduled")
    _check_halo_input(x, geo, hg, SCHED_BLOCK_P, band, shortcut)
    _check_shortcut(shortcut, _halo_out_shape(x, geo, n_out), x.device,
                    flow, shortcut_placement)
    if x.device.type == "cpu":
        return fused_spectral_pipeline_scheduled_halo_reference(
            x, idx, sel, vr, vi, dfr, dfi, dvr, dvi, bias, geo=geo, hg=hg,
            n_out=n_out, relu=relu, flow=flow, block_m=block_m,
            shortcut=shortcut, band=band)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_table_operands(dict(x=x, idx=idx, sel=sel, vr=vr, vi=vi,
                               dfr=dfr, dfi=dfi, dvr=dvr, dvi=dvi,
                               bias=bias),
                          geo.fft_size ** 2, x.shape[1], hg.block_tiles,
                          n_out)
    gn, mp, n_cycles, r = idx.shape
    n_pe = sel.shape[3]
    fa = dfr.shape[0]
    s2 = dvr.shape[0]
    staged = shortcut is not None and shortcut_placement == "vmem"
    if staged:
        _check_staged_fits(
            "fused_spectral_pipeline_scheduled_halo", staged_shortcut_bytes(
                geo.fft_size ** 2, s2, fa, halo=(geo, hg),
                tables=(n_cycles, r, n_pe),
                blocks=x.shape[0] * hg.n_blocks * gn * sched_halves(n_pe),
                m=x.shape[1], capacity=sched_cluster_capacity(x.device)))
    blocks = x.shape[0] * hg.n_blocks
    split = (None if flow == OS else sched_flow_launch(
        flow, blocks, x.shape[1], block_m, n_out, n_pe, x.device).split)
    with torch.cuda.device(x.device):
        y = _halo_out(x, geo, n_out, band)
        _launch(library_scheduled(), "fused_spectral_pipeline_scheduled_halo",
                flow, block_m, g, blocks * SCHED_BLOCK_P, x.device,
                (x.data_ptr(), idx.data_ptr(), sel.data_ptr(),
                 vr.data_ptr(), vi.data_ptr(), dfr.data_ptr(),
                 dfi.data_ptr(), dvr.data_ptr(), dvi.data_ptr(),
                 bias.data_ptr(), y.data_ptr()),
                (*_halo_ints(x, geo, hg, band), mp, n_cycles, r, n_pe, fa,
                 n_out, s2, int(relu)), s2, n_out, shortcut, staged, band,
                split)
    return y


# ---------------------------------------------------------------------------
# Layer execution around the kernel
# ---------------------------------------------------------------------------

def _windows_layout(x: torch.Tensor, geo: SpectralGeometry
                    ) -> tuple[torch.Tensor, int]:
    """Overlap-save windows in the kernel's s-leading layout [S, M, B*T]:
    a view whose rows lie at a pitch rounded up to 4 floats, so every
    row starts 16-byte aligned (the pad columns are never read)."""
    b, m = x.shape[:2]
    windows = extract_tiles_overlapping(x, geo)         # [B, M, T, K, K]
    t_cnt = windows.shape[2]
    s = geo.fft_size * geo.fft_size
    p = b * t_cnt
    buf = torch.empty((s, m, -(-p // 4) * 4), dtype=windows.dtype,
                      device=windows.device)
    xt = buf[:, :, :p]
    xt.view(s, m, b, t_cnt).copy_(
        windows.reshape(b, m, t_cnt, s).permute(3, 1, 0, 2))
    return xt, t_cnt


def _output_tiles(y: torch.Tensor, geo: SpectralGeometry, b: int, n: int,
                  t_cnt: int, dtype) -> torch.Tensor:
    """[t^2, N, B*T] kernel output -> [B, N, T, t, t] valid tiles."""
    s2 = geo.tile * geo.tile
    return (y.reshape(s2, n, b, t_cnt).permute(2, 1, 3, 0)
            .reshape(b, n, t_cnt, geo.tile, geo.tile).to(dtype))


def _assemble_output(y: torch.Tensor, geo: SpectralGeometry, b: int,
                     n: int, t_cnt: int, dtype) -> torch.Tensor:
    """[t^2, N, B*T] kernel output -> assembled [B, N, H, W]."""
    return assemble_valid_tiles(_output_tiles(y, geo, b, n, t_cnt, dtype),
                                geo)


def _shortcut_tiles(sc: torch.Tensor, geo: SpectralGeometry,
                    t_cnt: int) -> torch.Tensor:
    """Raw [B, N, H_out, W_out] shortcut -> the windowed kernels' output
    tile layout [t^2, N, B*T], contiguous f32 (the exact inverse of
    ``_assemble_output``): embedded at the 'same'-crop offset of the
    valid-tile canvas, zero elsewhere (those outputs are cropped), split
    into t x t tiles, u-major rows."""
    b, n, h, w = sc.shape
    t = geo.tile
    start = geo.ksize - 1 - geo.pad
    canvas = sc.new_zeros((b, n, geo.n_tiles_h * t, geo.n_tiles_w * t),
                          dtype=torch.float32)
    canvas[:, :, start:start + h, start:start + w] = sc
    tiles = (canvas.reshape(b, n, geo.n_tiles_h, t, geo.n_tiles_w, t)
             .permute(0, 1, 2, 4, 3, 5)           # b, n, ith, jtw, u, v
             .reshape(b, n, t_cnt, t * t))
    return (tiles.permute(3, 1, 0, 2).reshape(t * t, n, b * t_cnt)
            .contiguous())


def _fused_conv(x: torch.Tensor, wr, wi, dfr, dfi, dvr, dvi, bias,
                shortcut=None, *, geo: SpectralGeometry, relu: bool,
                **flow) -> torch.Tensor:
    """Window layout (and shortcut tiles) -> fused kernel -> valid-tile
    assembly (``flow``: the kernel's flow, block_m and shortcut
    placement)."""
    b = x.shape[0]
    n = wr.shape[1]
    xt, t_cnt = _windows_layout(x.to(torch.float32), geo)
    sc = None if shortcut is None else _shortcut_tiles(shortcut, geo, t_cnt)
    y = fused_spectral_pipeline(xt, wr, wi, dfr, dfi, dvr, dvi, bias,
                                relu=relu, shortcut=sc,
                                **flow)                 # [t^2, N, B*T]
    return _assemble_output(y, geo, b, n, t_cnt, x.dtype)


def _fused_conv_scheduled(x: torch.Tensor, tables, dfr, dfi, dvr, dvi,
                          bias, shortcut=None, *, geo: SpectralGeometry,
                          n_out: int, relu: bool, **flow) -> torch.Tensor:
    """Window layout (and shortcut tiles) -> scheduled fused kernel ->
    valid-tile assembly."""
    b = x.shape[0]
    xt, t_cnt = _windows_layout(x.to(torch.float32), geo)
    sc = None if shortcut is None else _shortcut_tiles(shortcut, geo, t_cnt)
    y = fused_spectral_pipeline_scheduled(
        xt, tables.idx, tables.sel, tables.vr, tables.vi, dfr, dfi, dvr,
        dvi, bias, n_out=n_out, relu=relu, shortcut=sc,
        **flow)                                         # [t^2, N, B*T]
    return _assemble_output(y, geo, b, n_out, t_cnt, x.dtype)


def _fused_conv_halo(x: torch.Tensor, wr, wi, dfr, dfi, dvr, dvi, bias,
                     shortcut=None, *, geo: SpectralGeometry, block_p: int,
                     relu: bool, **flow) -> torch.Tensor:
    """Halo plane kernel on the raw activation (and raw shortcut): no
    host window tensor, no host output relayout.  ``block_p`` (tiles per
    image block) is split into the 2-D halo block by
    ``halo_block_geometry``."""
    return fused_spectral_pipeline_halo(
        x, wr, wi, dfr, dfi, dvr, dvi, bias, geo=geo,
        hg=halo_block_geometry(geo, block_p), relu=relu, shortcut=shortcut,
        **flow)


def _fused_conv_scheduled_halo(x: torch.Tensor, tables, dfr, dfi, dvr,
                               dvi, bias, shortcut=None, *,
                               geo: SpectralGeometry, block_p: int,
                               n_out: int, relu: bool,
                               **flow) -> torch.Tensor:
    """Halo scheduled kernel on the raw activation (tables as
    ``_fused_conv_scheduled``)."""
    return fused_spectral_pipeline_scheduled_halo(
        x, tables.idx, tables.sel, tables.vr, tables.vi, dfr, dfi, dvr,
        dvi, bias, geo=geo, hg=halo_block_geometry(geo, block_p),
        n_out=n_out, relu=relu, shortcut=shortcut, **flow)


def execute_layer_plan(x: torch.Tensor, lp, shortcut=None) -> torch.Tensor:
    """Run one conv layer from a precompiled ``core.plan.LayerPlan``:
    x [B, M, H, W] -> [B, N, H_out, W_out] (bias and ReLU applied as the
    plan's epilogue says; stride and pooling stay with the caller).
    Dispatches on the plan's Hadamard mode ('dense'/'bin' run the plane
    kernel, 'scheduled' the table kernel on the precompiled tables), on
    its input mode ('windowed' lays out windows and assembles tiles on
    the host, 'halo' hands the raw activation to the halo kernel as
    contiguous NCHW f32, copying only a producer's view, such as a
    windowed layer's cropped output) and on its tuning's flow (the
    weight-/input-stationary flows take m ranges of ``block_m``
    channels); nothing is scheduled or compacted here.

    ``shortcut``: raw [B, N, H_out, W_out] residual operand of a node
    whose epilogue is residual-fused (``lp.epilogue.residual ==
    'fused'``, stride 1): the kernel adds it after the bias and before
    the ReLU, placed where the plan's tuning says ('hbm' | 'vmem'), or
    in 'hbm' where a planned 'vmem' does not fit at this batch
    (``placement_at_batch``)."""
    flow = lp.tuning.flow
    kw = dict(flow=flow, relu=lp.epilogue.relu)
    if flow != OS:
        kw["block_m"] = lp.tuning.block_m
    if shortcut is not None:
        if lp.epilogue.residual != "fused":
            raise ValueError(f"{lp.layer.name}: a shortcut goes into the "
                             f"kernel only on a residual-fused epilogue, "
                             f"not {lp.epilogue.residual!r}")
        kw["shortcut_placement"] = (
            placement_at_batch(lp, x.shape[0],
                               sched_cluster_capacity(x.device))
            if x.is_cuda
            else lp.tuning.residual or "hbm")
    halo = lp.input_mode == "halo"
    if halo:    # a windowed (or strided) producer's output is a view
        x = x.contiguous()
        if shortcut is not None:
            shortcut = shortcut.contiguous()
    bias = lp.bias if lp.epilogue.bias else torch.zeros_like(lp.bias)
    ops = (lp.dfr, lp.dfi, lp.dvr, lp.dvi, bias, shortcut)
    if lp.hadamard == "scheduled":
        n_out = lp.layer.c_out
        if halo:
            return _fused_conv_scheduled_halo(
                x, lp.tables, *ops, geo=lp.geo, block_p=lp.tuning.block_p,
                n_out=n_out, **kw)
        return _fused_conv_scheduled(x, lp.tables, *ops, geo=lp.geo,
                                     n_out=n_out, **kw)
    if halo:
        return _fused_conv_halo(x, lp.wr, lp.wi, *ops, geo=lp.geo,
                                block_p=lp.tuning.block_p, **kw)
    return _fused_conv(x, lp.wr, lp.wi, *ops, geo=lp.geo, **kw)


# ---------------------------------------------------------------------------
# A shard's band of a spatially sharded layer (B6 band)
# ---------------------------------------------------------------------------

def _band_conv(x: torch.Tensor, weights: tuple, dfr, dfi, dvr, dvi, bias, *,
               geo: SpectralGeometry, n_out: int | None, relu: bool,
               **flow) -> torch.Tensor:
    """Band windows -> the windowed plane kernel (``weights`` = (wr, wi))
    or scheduled kernel (the four tables, ``n_out``) -> the uncropped
    band canvas [B, N, h_pad, w_pad] (``assemble_tile_canvas``)."""
    b = x.shape[0]
    xt, t_cnt = _windows_layout(x.to(torch.float32), geo)
    if n_out is None:
        n = weights[0].shape[1]
        y = fused_spectral_pipeline(xt, *weights, dfr, dfi, dvr, dvi, bias,
                                    relu=relu, band=True, **flow)
    else:
        n = n_out
        y = fused_spectral_pipeline_scheduled(
            xt, *weights, dfr, dfi, dvr, dvi, bias, n_out=n_out, relu=relu,
            band=True, **flow)
    return assemble_tile_canvas(_output_tiles(y, geo, b, n, t_cnt, x.dtype),
                                geo)


def execute_band_plan(x_ext: torch.Tensor, lp) -> torch.Tensor:
    """Run one shard's band of a spatially sharded conv layer from its band
    plan (a ``core.plan.LayerPlan`` on a ``spectral.make_band_geometry``
    geometry, pre_halo_h = k-1; ``core.plan.make_sharded_layer_plan``).

    ``x_ext`` is the extended band [B, M, (k-1) + tr*t, W]: the shard's
    raw rows under the k-1 halo rows its upper neighbour sent (zeros on
    the first shard).  Returns the UNCROPPED band canvas [B, N, tr*t,
    w_pad] (bias and ReLU as the plan's epilogue says): the 'same' crop is
    global, so it runs once after the bands are joined
    (``spectral.crop_canvas_same``).  Dispatches as
    ``execute_layer_plan`` does, on the Hadamard mode, the input path (the
    windowed kernels on the band's windows, or the halo kernels in band
    mode) and the tuning's flow; every launch is also counted in
    ``BAND_LAUNCHES``.
    """
    flow = lp.tuning.flow
    kw = dict(flow=flow, relu=lp.epilogue.relu)
    if flow != OS:
        kw["block_m"] = lp.tuning.block_m
    bias = lp.bias if lp.epilogue.bias else torch.zeros_like(lp.bias)
    ops = (lp.dfr, lp.dfi, lp.dvr, lp.dvi, bias)
    sched = lp.hadamard == "scheduled"
    weights = tuple(lp.tables) if sched else (lp.wr, lp.wi)
    n_out = lp.layer.c_out if sched else None
    if lp.input_mode != "halo":
        return _band_conv(x_ext, weights, *ops, geo=lp.geo, n_out=n_out,
                          **kw)
    x_ext = x_ext.to(torch.float32).contiguous()
    hg = halo_block_geometry(lp.geo, lp.tuning.block_p)
    if sched:
        return fused_spectral_pipeline_scheduled_halo(
            x_ext, *weights, *ops, geo=lp.geo, hg=hg, n_out=n_out, band=True,
            **kw)
    return fused_spectral_pipeline_halo(x_ext, *weights, *ops, geo=lp.geo,
                                        hg=hg, band=True, **kw)

"""The standalone executor of the exact-cover schedule's INDEX/VALUE
tables (counterpart of ``repro.kernels.sparse_hadamard``).

For one group of N' sparse kernels the scheduler (``core.scheduler``)
emits per input channel m a table of T cycles (the paper's Fig 6):

  index_table[m, t, :]  r replica read addresses (frequency bins),
  sel[m, t, n]          which replica column feeds PE n,
  valid[m, t, n]        whether PE n is active,
  val_{r,i}[m, t, n]    the complex weight fed to PE n,
  out_index[m, t, n]    the frequency bin PE n accumulates into.

Each cycle gathers the r replica bins of X, routes them to the N' lanes,
does a masked complex MAC and scatters into the [N', F, P] psum, summed
over channels:

  idx int32 [M, T, r]; sel int32 [M, T, N']; valid f32 [M, T, N'];
  val_r/val_i f32 [M, T, N']; out_index int32 [M, T, N'];
  xr/xi f32 [M, F, P]  ->  yr/yi f32 [N', F, P].

The fused scheduled kernel runs the same datapath between its tile-FFT
and IFFT without the ``valid``/``out_index`` planes; this executor is
the direct Fig-6 datapath for a spectral input given from outside
(``ops.scheduled_sparse_conv_group``).  One hand-written CUDA kernel
(``csrc/sparse_hadamard.cu``), with its plain PyTorch version beside it:
the wrapper runs the plain version for CPU tensors, and the tests and
the on-card smoke run hold the kernel to it.

The kernel splits the channels into ranges over CTAs (a split-K sum,
finished in ascending range order by a second launch);
``launch_geometry`` chooses the CTA shape and the ranges per launch, and
the plain version takes the same split (``range_m``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.scheduler import ScheduleTables
from repro_torch.kernels import _build
from repro_torch.kernels.fused_spectral_conv import SMEM_PER_CTA

SOURCES = {"sparse_hadamard": {}}

# Kernel launches, counted where the kernel is launched (a split-K finish
# pass belongs to its launch).
LAUNCHES = {"scheduled_sparse_hadamard": 0}

# The kernel's CTA: ``LANES`` consumer warps, warp w one PE lane and its 32
# threads ``TILES`` tiles, plus producer warps (one CTA fits an SM); the
# grid aims at one CTA for each SM.
TILES, LANES = 32, 8


class Geometry(NamedTuple):
    """One launch of the table executor: CTAs of ``lanes`` PE lanes x
    ``tiles`` tiles in a grid of ``tile_blocks`` x ``lane_blocks`` x
    ``ranges``, range g summing channels [g * range_m, (g + 1) * range_m);
    a split-K workspace of ``workspace`` floats ([ranges, 2, N', F, P]; 0
    for one range)."""
    lanes: int
    tiles: int
    tile_blocks: int
    lane_blocks: int
    ranges: int
    range_m: int
    workspace: int


def launch_geometry(n_pe: int, m: int, f: int, p: int,
                    sms: int) -> Geometry:
    """The kernel's launch for a group of ``n_pe`` lanes, ``m`` channels,
    ``f`` bins and ``p`` tiles: CTAs of 8 lanes x 32 tiles, then as many
    channel ranges (at most M) as bring the grid to one CTA for each of
    ``sms`` SMs."""
    tile_blocks, lane_blocks = -(-p // TILES), -(-n_pe // LANES)
    g = min(m, max(1, -(-sms // (tile_blocks * lane_blocks))))
    range_m = -(-m // g)
    g = -(-m // range_m)
    return Geometry(LANES, TILES, tile_blocks, lane_blocks, g, range_m,
                    g * 2 * n_pe * f * p if g > 1 else 0)


def stack_tables(tables: list[ScheduleTables]) -> tuple[torch.Tensor, ...]:
    """Stack per-channel ``ScheduleTables`` into (idx, sel, valid, val_r,
    val_i, out_index) CPU tensors, padding every channel to the longest
    cycle count (padded cycles have valid == 0 and zero weights, and are
    inert)."""
    t_max = max(tb.n_cycles for tb in tables)

    def pad(a):
        return np.pad(a, ((0, t_max - a.shape[0]), (0, 0)))

    idx, sel, valid, vals, oidx = (
        np.stack([pad(getattr(tb, name)) for tb in tables])
        for name in ("index_table", "sel", "valid", "values", "out_index"))
    return (torch.from_numpy(idx.astype(np.int32)),
            torch.from_numpy(sel.astype(np.int32)),
            torch.from_numpy(valid.astype(np.float32)),
            torch.from_numpy(np.ascontiguousarray(vals.real, np.float32)),
            torch.from_numpy(np.ascontiguousarray(vals.imag, np.float32)),
            torch.from_numpy(oidx.astype(np.int32)))


def scheduled_sparse_hadamard_reference(idx, sel, valid, val_r, val_i,
                                        out_index, xr, xi, *,
                                        range_m: int | None = None
                                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``scheduled_sparse_hadamard``: per channel, every
    cycle at once: gather the replica bins each lane reads
    (``idx[t, sel[t, n]]``), the masked complex MAC, and one
    ``index_add_`` into the [N' * F, P] psum in (cycle, lane) order, so
    every psum sees its adds in channel, then cycle order.  With
    ``range_m`` (the kernel's split, ``launch_geometry``) the channels
    are summed in ranges of ``range_m`` and the ranges' sums added in
    ascending order; by default in one range."""
    m = idx.shape[0]
    n_pe = sel.shape[2]
    f, p = xr.shape[1], xr.shape[2]
    lanes = torch.arange(n_pe, device=xr.device) * f
    step = m if range_m is None else range_m
    y_r = y_i = None
    for lo in range(0, m, step):
        acc_r = xr.new_zeros((n_pe * f, p))
        acc_i = xr.new_zeros((n_pe * f, p))
        for c in range(lo, min(lo + step, m)):
            bins = torch.gather(idx[c].long(), 1, sel[c].long())  # [T, N']
            in_r, in_i = xr[c][bins], xi[c][bins]                 # [T, N', P]
            v = valid[c][..., None]
            w_r, w_i = val_r[c][..., None], val_i[c][..., None]
            dst = (lanes + out_index[c].long()).reshape(-1)
            pr = v * (w_r * in_r - w_i * in_i)
            pi = v * (w_r * in_i + w_i * in_r)
            acc_r.index_add_(0, dst, pr.reshape(-1, p))
            acc_i.index_add_(0, dst, pi.reshape(-1, p))
        y_r = acc_r if y_r is None else y_r + acc_r
        y_i = acc_i if y_i is None else y_i + acc_i
    return y_r.reshape(n_pe, f, p), y_i.reshape(n_pe, f, p)


@functools.cache
def library() -> ctypes.CDLL:
    """The table executor's library (built at first use)."""
    lib = _build.build(SOURCES)["sparse_hadamard"]
    fn = lib.scheduled_sparse_hadamard_f32
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.sparse_hadamard_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.sparse_hadamard_smem_bytes.restype = ctypes.c_int
    return lib


def _check(ops: dict[str, torch.Tensor]) -> None:
    """Shapes, devices, dtypes and contiguity of the operands."""
    idx, sel, xr = ops["idx"], ops["sel"], ops["xr"]
    if idx.dim() != 3 or sel.dim() != 3 or xr.dim() != 3:
        raise ValueError(f"idx must be [M, T, r], sel [M, T, N'] and xr "
                         f"[M, F, P], got {tuple(idx.shape)}, "
                         f"{tuple(sel.shape)}, {tuple(xr.shape)}")
    m, t, _ = idx.shape
    lanes = (m, t, sel.shape[2])
    want = dict(sel=lanes, valid=lanes, val_r=lanes, val_i=lanes,
                out_index=lanes, xi=tuple(xr.shape))
    for name, a in ops.items():
        if name in want and tuple(a.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{want[name]}")
        dtype = (torch.int32 if name in ("idx", "sel", "out_index")
                 else torch.float32)
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if a.device != xr.device:
            raise ValueError(f"{name} is on {a.device}, xr on {xr.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xr.shape[0] != m:
        raise ValueError(f"tables cover {m} channels, xr {xr.shape[0]}")


def scheduled_sparse_hadamard(idx, sel, valid, val_r, val_i, out_index, xr,
                              xi) -> tuple[torch.Tensor, torch.Tensor]:
    """Execute one PE group's stacked tables (``stack_tables``) on the
    spectral input xr/xi [M, F, P]: returns (yr, yi) [N', F, P] f32,
    summed over channels and cycles.  Every index must lie in range
    (``idx``, ``out_index`` in [0, F), ``sel`` in [0, r)), as the
    scheduler builds them.

    CPU tensors run the plain version; CUDA tensors launch the kernel (a
    group the kernel takes: F, r and T small enough for its accumulators
    and table ring to fit a CTA's shared memory, as the library's
    ``sparse_hadamard_smem_bytes`` reckons it; the geometry of
    ``launch_geometry``, plus the split-K finish pass with more than one
    channel range) or raise.
    """
    _check(dict(idx=idx, sel=sel, valid=valid, val_r=val_r, val_i=val_i,
                out_index=out_index, xr=xr, xi=xi))
    if xr.device.type == "cpu":
        return scheduled_sparse_hadamard_reference(
            idx, sel, valid, val_r, val_i, out_index, xr, xi)
    if xr.device.type != "cuda":
        raise ValueError(f"no kernel for device {xr.device}")
    m, t, r = idx.shape
    n_pe = sel.shape[2]
    f, p = xr.shape[1], xr.shape[2]
    with torch.cuda.device(xr.device):
        yr = torch.empty((n_pe, f, p), dtype=torch.float32, device=xr.device)
        yi = torch.empty_like(yr)
        if min(m, t, r, n_pe, f, p) == 0:
            return yr.zero_(), yi.zero_()
        lib = library()
        geo = launch_geometry(n_pe, m, f, p, _build.sm_count(xr.device))
        if any(a.data_ptr() % 16 for a in (idx, xr, xi)):
            raise ValueError("idx, xr and xi must be 16-byte aligned (the "
                             "kernel stages them in 16-byte copies)")
        need = lib.sparse_hadamard_smem_bytes(f, r, t)
        if need > SMEM_PER_CTA:
            raise ValueError(f"{f} bins x {r} replicas need {need} bytes of "
                             f"shared memory, over the {SMEM_PER_CTA} of a "
                             f"CTA")
        ws = (torch.empty(geo.workspace, dtype=torch.float32,
                          device=xr.device) if geo.workspace else None)
        err = lib.scheduled_sparse_hadamard_f32(
            idx.data_ptr(), sel.data_ptr(), valid.data_ptr(),
            val_r.data_ptr(), val_i.data_ptr(), out_index.data_ptr(),
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            0 if ws is None else ws.data_ptr(), m, t, r, n_pe, f, p,
            geo.range_m, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"scheduled_sparse_hadamard launch failed: "
                               f"cudaError {err}")
        LAUNCHES["scheduled_sparse_hadamard"] += 1
    return yr, yi

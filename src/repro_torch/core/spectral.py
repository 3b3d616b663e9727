"""Spectral (FFT-domain) convolution with overlap-save tiling
(counterpart of ``repro.core.spectral``).

Spatial convolution is replaced by: take overlapping K x K input
windows with stride t = K - k + 1, FFT them, Hadamard-multiply with the
K x K spectral kernels summed over input channels, inverse-FFT, and
keep each window's t x t wraparound-free outputs.  Those outputs are
complete full-conv results, so assembly is a pure relayout and a bias +
ReLU epilogue can follow directly.

The paper's own decomposition, overlap-and-add (§3, Eqs 3-4), is here
too (``extract_tiles``, ``fft_tiles``, ``overlap_add``): disjoint t x t
tiles zero-padded to K x K, whose K x K full-conv outputs overlap by k-1
pixels and are summed.  For kernels that are not pruned both equal
``spatial_conv2d``.  These helpers, ``spectral_conv2d`` and the band
oracle run ``torch.fft`` on the tensor's device: none of them is a
kernel of the port.

Conventions: activations are NCHW ``x[b, c, h, w]``, kernels
``w[n, m, k, k]``; CNN convolution is cross-correlation, so the spatial
kernel is flipped before its FFT.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

import repro_torch


class SpectralGeometry(NamedTuple):
    """Static geometry of a tiled spectral convolution."""

    fft_size: int        # K
    tile: int            # t = K - k + 1
    ksize: int           # spatial kernel size k
    pad: int             # spatial 'same' padding
    h_in: int            # input spatial height (pre-padding)
    w_in: int
    n_tiles_h: int       # tiles along H
    n_tiles_w: int
    h_pad: int           # n_tiles_h * tile
    w_pad: int
    # Rows of top halo already in the input (a shard's band,
    # ``make_band_geometry``): the first pre_halo_h input rows are the
    # upper neighbour's last rows (zeros on the first shard), so the
    # windows pad only the remaining k-1-pre_halo_h rows on top and every
    # H-axis window and gather coordinate shifts down by pre_halo_h.  0 is
    # the single-device geometry.
    pre_halo_h: int = 0

    @property
    def n_tiles(self) -> int:
        return self.n_tiles_h * self.n_tiles_w


def make_geometry(h_in: int, w_in: int, ksize: int, fft_size: int,
                  pad: int | None = None) -> SpectralGeometry:
    tile = fft_size - ksize + 1
    if tile <= 0:
        raise ValueError(f"fft_size {fft_size} too small for kernel {ksize}")
    if ksize - 1 > tile:
        raise ValueError("overlap-save tiling requires k - 1 <= tile size")
    if pad is None:
        pad = (ksize - 1) // 2
    # pad the tiled canvas by at least `pad` on the bottom/right so the
    # 'same' crop never reads past it
    n_th = -(-(h_in + pad) // tile)
    n_tw = -(-(w_in + pad) // tile)
    return SpectralGeometry(fft_size, tile, ksize, pad, h_in, w_in,
                            n_th, n_tw, n_th * tile, n_tw * tile)


def spectral_kernel(w: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Spatial kernel [N, M, k, k] -> complex64 spectral kernel
    [N, M, K, K]: flipped (correlation), zero-padded to K x K, FFT'd."""
    k = w.shape[-1]
    w = torch.flip(w.to(torch.float32), dims=(-2, -1))
    w = F.pad(w, (0, fft_size - k, 0, fft_size - k))
    return torch.fft.fft2(w)


def extract_tiles(x: torch.Tensor, geo: SpectralGeometry) -> torch.Tensor:
    """[B, M, H, W] -> [B, M, T, t, t] disjoint tiles (row-major T) of
    the input zero-padded at the bottom/right to the tiled canvas."""
    b, m = x.shape[:2]
    x = F.pad(x, (0, geo.w_pad - geo.w_in, 0, geo.h_pad - geo.h_in))
    x = x.reshape(b, m, geo.n_tiles_h, geo.tile, geo.n_tiles_w, geo.tile)
    return (x.permute(0, 1, 2, 4, 3, 5)
            .reshape(b, m, geo.n_tiles, geo.tile, geo.tile))


def extract_tiles_overlapping(x: torch.Tensor, geo: SpectralGeometry
                              ) -> torch.Tensor:
    """[B, M, H, W] -> [B, M, T, K, K] overlap-save input windows: K x K
    windows with stride t starting at offset -(k-1) (at row offset
    pre_halo_h - (k-1) when the input carries its top halo)."""
    b, m = x.shape[:2]
    ov = geo.ksize - 1
    pre = geo.pre_halo_h
    x = F.pad(x, (ov, geo.w_pad - geo.w_in, ov - pre,
                  geo.h_pad + pre - geo.h_in))
    k, t = geo.fft_size, geo.tile
    win = x.unfold(2, k, t).unfold(3, k, t)       # [B, M, n_th, n_tw, K, K]
    return win.reshape(b, m, geo.n_tiles, k, k)


class HaloGeometry(NamedTuple):
    """Static geometry of the in-kernel halo gather.

    The fused kernel's halo input mode reads the RAW NCHW activation
    directly: each block covers ``bth x btw`` tiles *plus* the
    k-1-pixel halo the overlap-save windows share — ``rh = bth*t + (K -
    t)`` rows by ``rw = btw*t + (K - t)`` cols, clamped to the image
    (small images fit in one block) — and gathers its stride-t, size-K
    windows on chip (``halo_gather_matrices`` describes the gather).
    No ``[B, M, T, K, K]`` windowed tensor is ever materialized in
    device memory.
    """

    bth: int             # tiles per block along H
    btw: int             # tiles per block along W
    nbh: int             # blocks along H  (ceil(n_tiles_h / bth))
    nbw: int             # blocks along W
    rh: int              # raw rows per block: min(bth*t + k - 1, h_in)
    rw: int              # raw cols per block

    @property
    def block_tiles(self) -> int:
        """Tiles per block — the halo path's effective block_p."""
        return self.bth * self.btw

    @property
    def n_blocks(self) -> int:
        return self.nbh * self.nbw


def halo_block_geometry(geo: SpectralGeometry, block_p: int) -> HaloGeometry:
    """Split a tile-count budget ``block_p`` into a 2-D halo block.

    Favors full tile rows (btw first) so the per-axis halo fraction
    (K - t)/(b*t) is paid on as few axes as possible; the resulting
    ``block_tiles = bth*btw <= block_p`` is what the kernel's tile slots
    are sized by.  Deterministic: the kernel and the plan derive the
    same blocks from (geo, block_p).
    """
    block_p = max(1, block_p)
    btw = max(1, min(geo.n_tiles_w, block_p))
    bth = max(1, min(geo.n_tiles_h, block_p // btw))
    ov = geo.ksize - 1
    return HaloGeometry(
        bth=bth, btw=btw,
        nbh=-(-geo.n_tiles_h // bth), nbw=-(-geo.n_tiles_w // btw),
        rh=min(bth * geo.tile + ov, geo.h_in),
        rw=min(btw * geo.tile + ov, geo.w_in))


def halo_block_starts(geo: SpectralGeometry, hg: HaloGeometry
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Clamped raw-image start offsets of every halo block, per axis.

    Block ib's windows span raw rows ``[ib*bth*t - (k-1), ...+rh)``;
    the start is clamped to ``[0, h_in - rh]`` so the block never reads
    out of bounds — the gather matrices re-align the windows against
    the clamped block and encode the 'same'-padding (and bottom/right
    tile padding) as all-zero one-hot rows.  (The CUDA kernels read at
    the unclamped starts with zero fill instead; the windows are the
    same.)
    """
    ov = geo.ksize - 1
    sh = np.arange(hg.nbh) * hg.bth * geo.tile - ov + geo.pre_halo_h
    sw = np.arange(hg.nbw) * hg.btw * geo.tile - ov
    return (np.clip(sh, 0, geo.h_in - hg.rh),
            np.clip(sw, 0, geo.w_in - hg.rw))


def halo_gather_matrices(geo: SpectralGeometry, hg: HaloGeometry
                         ) -> tuple[np.ndarray, np.ndarray]:
    """One-hot window selectors for the halo gather.

    gr [nbh, bth*K, rh] / gc [nbw, btw*K, rw] f32: row ``ii*K + kh`` of
    block ib selects raw image row ``(ib*bth + ii)*t - (k-1) + kh``
    relative to the block's clamped start.  Rows whose raw coordinate
    falls outside the image ('same' zero-padding, bottom/right tile
    padding past n_tiles) or whose tile index exceeds the tile grid are
    left all-zero, so the gathered window values are exact zeros — the
    one-hot matmul IS the zero-padding.  Being 0/1 operands, the gather
    is numerically exact: halo windows equal
    ``extract_tiles_overlapping`` bit for bit.
    """
    k = geo.fft_size
    ov = geo.ksize - 1
    sh, sw = halo_block_starts(geo, hg)

    def axis(nb, bt, n_tiles, start, size, extent, pre=0):
        g = np.zeros((nb, bt * k, size), np.float32)
        for ib in range(nb):
            for ii in range(bt):
                tile_idx = ib * bt + ii
                if tile_idx >= n_tiles:
                    continue                      # block padding tile
                for kh in range(k):
                    raw = tile_idx * geo.tile - ov + kh + pre
                    if 0 <= raw < extent:
                        g[ib, ii * k + kh, raw - start[ib]] = 1.0
        return g

    return (axis(hg.nbh, hg.bth, geo.n_tiles_h, sh, hg.rh, geo.h_in,
                 geo.pre_halo_h),
            axis(hg.nbw, hg.btw, geo.n_tiles_w, sw, hg.rw, geo.w_in))


def halo_windows_blocked(x: torch.Tensor, geo: SpectralGeometry,
                         hg: HaloGeometry) -> torch.Tensor:
    """The halo gather as the kernels do it, in plain PyTorch: clamped
    raw blocks, one-hot row/column selection (exact in f32).

    x [B, M, H, W] -> windows [B, nbh, nbw, M, bth, btw, K, K], blocks
    in (image, block-row, block-col) order, tiles bth-major inside a
    block; slots past the tile grid hold zeros.
    """
    if x.is_cuda:
        repro_torch.strict_fp32()    # a TF32 product would round x
    b, m = x.shape[:2]
    k = geo.fft_size
    gr, gc = (torch.from_numpy(a).to(x.device)
              for a in halo_gather_matrices(geo, hg))
    sh, sw = halo_block_starts(geo, hg)
    rows = torch.as_tensor(sh[:, None] + np.arange(hg.rh)[None, :],
                           device=x.device)             # [nbh, rh]
    cols = torch.as_tensor(sw[:, None] + np.arange(hg.rw)[None, :],
                           device=x.device)             # [nbw, rw]
    blk = x.to(torch.float32)[:, :, rows][:, :, :, :, cols]
    # blk [B, M, nbh, rh, nbw, rw]; select rows, then columns
    win = torch.einsum("irh,bmihjw->bijmrw", gr, blk)
    win = torch.einsum("bijmrw,jcw->bijmrc", win, gc)
    win = win.reshape(b, hg.nbh, hg.nbw, m, hg.bth, k, hg.btw, k)
    return win.permute(0, 1, 2, 3, 4, 6, 5, 7)


def halo_window_reference(x: torch.Tensor, geo: SpectralGeometry,
                          hg: HaloGeometry) -> torch.Tensor:
    """Host-side emulation of the kernels' halo gather (tests/docs):
    ``halo_windows_blocked`` reordered back to row-major tiles with the
    block padding cropped.  Equals ``extract_tiles_overlapping(x, geo)``
    for every (H, W, k, t, block_p) the plan can emit."""
    b, m = x.shape[:2]
    k = geo.fft_size
    win = halo_windows_blocked(x, geo, hg)   # [B,nbh,nbw,M,bth,btw,K,K]
    win = win.permute(0, 3, 1, 4, 2, 5, 6, 7).reshape(
        b, m, hg.nbh * hg.bth, hg.nbw * hg.btw, k, k)
    win = win[:, :, :geo.n_tiles_h, :geo.n_tiles_w]
    return win.reshape(b, m, geo.n_tiles, k, k).to(x.dtype)


def assemble_tile_canvas(y_tiles: torch.Tensor, geo: SpectralGeometry
                         ) -> torch.Tensor:
    """[B, N, T, t, t] valid tiles -> uncropped [B, N, h_pad, w_pad]
    full-conv canvas (pure relayout)."""
    b, n, t_cnt, tl, _ = y_tiles.shape
    if t_cnt != geo.n_tiles or tl != geo.tile:
        raise ValueError(f"tiles {tuple(y_tiles.shape)} do not match "
                         f"geometry {geo}")
    yt = y_tiles.reshape(b, n, geo.n_tiles_h, geo.n_tiles_w, tl, tl)
    return (yt.permute(0, 1, 2, 4, 3, 5)
            .reshape(b, n, geo.h_pad, geo.w_pad))


def crop_canvas_same(canvas: torch.Tensor, geo: SpectralGeometry
                     ) -> torch.Tensor:
    """'same' crop of a full-conv canvas -> [B, N, H_out, W_out]."""
    start = geo.ksize - 1 - geo.pad
    h_out = geo.h_in + 2 * geo.pad - geo.ksize + 1
    w_out = geo.w_in + 2 * geo.pad - geo.ksize + 1
    return canvas[:, :, start:start + h_out, start:start + w_out]


def assemble_valid_tiles(y_tiles: torch.Tensor, geo: SpectralGeometry
                         ) -> torch.Tensor:
    """[B, N, T, t, t] valid tiles -> [B, N, H_out, W_out]."""
    return crop_canvas_same(assemble_tile_canvas(y_tiles, geo), geo)


# ---------------------------------------------------------------------------
# Spatial sharding: tile-row bands and the cross-shard halo
# ---------------------------------------------------------------------------
#
# Spatial sharding splits the image into horizontal bands of whole tile
# rows (pruned-kernel overlap-save results depend on where the tiles lie,
# so shard boundaries fall on tile boundaries).  Shard d owns tile rows
# [d*tr, (d+1)*tr) = raw rows [d*tr*t, (d+1)*tr*t) and needs exactly
# k-1 rows of top halo from shard d-1 (zeros on shard 0: the global
# 'same' padding) and no bottom halo.  The extended band [B, C,
# (k-1) + tr*t, W] is described by ``make_band_geometry``.

def shard_band_rows(geo: SpectralGeometry, n_shards: int) -> int:
    """Tile rows per shard band: ceil(n_tiles_h / n_shards)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return -(-geo.n_tiles_h // n_shards)


def make_band_geometry(geo: SpectralGeometry,
                       tile_rows: int) -> SpectralGeometry:
    """Per-shard geometry of a ``tile_rows``-tall band of ``geo``: the
    input is the extended band (h_in counts the k-1 halo rows, which
    pre_halo_h marks), the canvas is tile_rows*t rows; the W axis is
    inherited (bands span the full width)."""
    ov = geo.ksize - 1
    return SpectralGeometry(
        geo.fft_size, geo.tile, geo.ksize, geo.pad,
        h_in=ov + tile_rows * geo.tile, w_in=geo.w_in,
        n_tiles_h=tile_rows, n_tiles_w=geo.n_tiles_w,
        h_pad=tile_rows * geo.tile, w_pad=geo.w_pad, pre_halo_h=ov)


def halo_exchange_reference(x: torch.Tensor, geo: SpectralGeometry,
                            n_shards: int) -> list[torch.Tensor]:
    """The cross-shard halo exchange, in plain PyTorch (tests, and the
    sharded executor's own split): the ``n_shards`` extended bands
    [B, C, (k-1) + tr*t, W] of x zero-padded at the bottom to
    n_shards * tr * t rows, shard d's band prefixed by the last k-1 rows
    of shard d-1's (zeros for shard 0)."""
    ov = geo.ksize - 1
    hb = shard_band_rows(geo, n_shards) * geo.tile
    b, c, h, w = x.shape
    xp = F.pad(x, (0, 0, 0, n_shards * hb - h))
    return [torch.cat([x.new_zeros((b, c, ov, w)) if d == 0
                       else xp[:, :, d * hb - ov:d * hb],
                       xp[:, :, d * hb:(d + 1) * hb]], dim=2)
            for d in range(n_shards)]


def spectral_band_conv2d_pretransformed(x_ext: torch.Tensor, w_f,
                                        geo: SpectralGeometry
                                        ) -> torch.Tensor:
    """The band einsum oracle: one shard's extended band -> its UNCROPPED
    band canvas [B, N, tile_rows*t, w_pad].

    ``geo`` is a ``make_band_geometry`` result and ``x_ext`` the
    extended band (top halo included).  The band canvases joined along H
    are ``assemble_tile_canvas`` of the unsharded image, to the
    accumulation order of the Hadamard contraction; ``crop_canvas_same``
    with the global geometry then gives the 'same' output."""
    if x_ext.is_cuda:
        repro_torch.strict_fp32()
    windows = extract_tiles_overlapping(x_ext, geo)     # [B,M,T,K,K]
    x_f = torch.fft.fft2(windows.to(torch.float32))
    y_f = _hadamard_maybe_sparse(x_f, w_f, geo)
    y_sp = torch.fft.ifft2(y_f).real
    ov = geo.ksize - 1
    y_valid = y_sp[..., ov:, ov:]
    return assemble_tile_canvas(y_valid.to(x_ext.dtype), geo)


def fft_tiles(tiles: torch.Tensor, geo: SpectralGeometry) -> torch.Tensor:
    """[..., t, t] -> [..., K, K] complex spectral tiles (zero-padded at
    the bottom/right to K x K)."""
    pad = geo.fft_size - geo.tile
    return torch.fft.fft2(F.pad(tiles.to(torch.float32), (0, pad, 0, pad)))


def _shift(a: torch.Tensor, dim: int) -> torch.Tensor:
    """a'[..., i, ...] = a[..., i-1, ...] along ``dim``, a'[..., 0, ...] =
    0."""
    return torch.cat([torch.zeros_like(a.narrow(dim, 0, 1)),
                      a.narrow(dim, 0, a.shape[dim] - 1)], dim=dim)


def overlap_add(y_tiles: torch.Tensor, geo: SpectralGeometry
                ) -> torch.Tensor:
    """The overlap-and-add merge (Eq 4): [B, N, T, K, K] spatial-domain
    full-conv output tiles -> the 'same' output [B, N, H_out, W_out].

    Tile (i, j)'s K x K output sits at canvas offset (i*t, j*t) and
    overlaps its neighbours by ov = k-1 pixels (ov <= t, checked by
    ``make_geometry``), so canvas block (i, j) sums four parts, in this
    order: its own tile's [:t, :t], the left tile's [:t, t:] on its
    first ov columns, the upper tile's [t:, :t] on its first ov rows and
    the upper-left tile's [t:, t:] on its ov x ov corner.  The canvas
    spill past h_pad / w_pad is dropped: ``make_geometry`` padded the
    canvas past every row the 'same' crop reads."""
    b, n, t_cnt, kk, _ = y_tiles.shape
    if t_cnt != geo.n_tiles or kk != geo.fft_size:
        raise ValueError(f"tiles {tuple(y_tiles.shape)} do not match "
                         f"geometry {geo}")
    ov = geo.ksize - 1
    tl = geo.tile
    yt = y_tiles.reshape(b, n, geo.n_tiles_h, geo.n_tiles_w, kk, kk)
    spill = tl - ov         # the part of a block no neighbour reaches
    blk = yt[..., :tl, :tl]
    blk = blk + F.pad(_shift(yt[..., :tl, tl:], 3), (0, spill))
    blk = blk + F.pad(_shift(yt[..., tl:, :tl], 2), (0, 0, 0, spill))
    blk = blk + F.pad(_shift(_shift(yt[..., tl:, tl:], 2), 3),
                      (0, spill, 0, spill))
    out = (blk.permute(0, 1, 2, 4, 3, 5)
           .reshape(b, n, geo.h_pad, geo.w_pad))
    return crop_canvas_same(out, geo)


def hadamard_accumulate(x_f: torch.Tensor, w_f: torch.Tensor
                        ) -> torch.Tensor:
    """Y~[b,n,t,u,v] = sum_m X~[b,m,t,u,v] * W~[n,m,u,v]."""
    return torch.einsum("bmtuv,nmuv->bntuv", x_f, w_f)


def spectral_conv2d(x: torch.Tensor, w: torch.Tensor, *,
                    fft_size: int = 8, pad: int | None = None
                    ) -> torch.Tensor:
    """Spectral convolution of NCHW ``x`` with the spatial kernel ``w``
    [N, M, k, k] on x's device: 'same' cross-correlation to fp error,
    through the kernel's FFT and ``spectral_conv2d_pretransformed``."""
    geo = make_geometry(x.shape[2], x.shape[3], w.shape[-1], fft_size, pad)
    w_f = spectral_kernel(w.to(x.device), fft_size)
    return spectral_conv2d_pretransformed(x, w_f, geo)


def spectral_conv2d_pretransformed(x: torch.Tensor, w_f,
                                   geo: SpectralGeometry) -> torch.Tensor:
    """The einsum oracle: spectral conv with an already-transformed
    (possibly pruned) kernel.

    ``w_f`` is a dense complex [N, M, K, K] tensor or a
    ``sparse.SparseSpectralKernels`` (anything with ``.values`` and
    ``.active_bins`` that is not a tensor); for
    pruned kernels the Hadamard product is restricted to the frequency
    bins that are non-zero in some kernel.  Defines the pruned-conv
    semantics the fused kernel is held to.
    """
    if x.is_cuda:
        repro_torch.strict_fp32()
    windows = extract_tiles_overlapping(x, geo)         # [B,M,T,K,K]
    x_f = torch.fft.fft2(windows.to(torch.float32))
    y_f = _hadamard_maybe_sparse(x_f, w_f, geo)         # [B,N,T,K,K]
    y_sp = torch.fft.ifft2(y_f).real
    ov = geo.ksize - 1
    y_valid = y_sp[..., ov:, ov:]                       # [B,N,T,t,t]
    return assemble_valid_tiles(y_valid.to(x.dtype), geo)


def _hadamard_maybe_sparse(x_f: torch.Tensor, w_f,
                           geo: SpectralGeometry) -> torch.Tensor:
    if isinstance(w_f, torch.Tensor):                   # dense kernel
        return hadamard_accumulate(x_f, w_f)
    values = w_f.values
    kk = geo.fft_size
    f = kk * kk
    active = w_f.active_bins
    if active is None:
        active = np.flatnonzero(
            w_f.mask.any(dim=1).any(dim=0).reshape(f).cpu().numpy())
    if len(active) >= f:                                # nothing prunable
        return hadamard_accumulate(x_f, values)
    b, m, t = x_f.shape[:3]
    n = values.shape[0]
    idx = torch.as_tensor(np.asarray(active), dtype=torch.long,
                          device=x_f.device)
    xa = x_f.reshape(b, m, t, f)[..., idx]
    wa = values.reshape(n, m, f)[..., idx]
    ya = torch.einsum("bmtf,nmf->bntf", xa, wa)
    y = torch.zeros((b, n, t, f), dtype=ya.dtype, device=ya.device)
    y[..., idx] = ya
    return y.reshape(b, n, t, kk, kk)


def spatial_conv2d(x: torch.Tensor, w: torch.Tensor, *,
                   pad: int | None = None, stride: int = 1
                   ) -> torch.Tensor:
    """Spatial-domain oracle: 'same' cross-correlation (cuDNN with TF32
    off on the card)."""
    if x.is_cuda:
        repro_torch.strict_fp32()
    k = w.shape[-1]
    if pad is None:
        pad = (k - 1) // 2
    return F.conv2d(x.to(torch.float32), w.to(torch.float32),
                    stride=stride, padding=pad).to(x.dtype)

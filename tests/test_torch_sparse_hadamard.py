"""The standalone Alg-2 table executor of repro_torch == repro's.

``ops.scheduled_sparse_conv_group`` (schedule, Fig-6 tables, executor)
and ``sparse_hadamard.scheduled_sparse_hadamard`` run their plain PyTorch
versions here (CPU tensors) and are held to the reference's
``ops.scheduled_sparse_conv_group`` and Pallas table kernel in interpret
mode on the same numpy inputs: schedule stats equal, outputs within
max|port - jax| <= 1e-5 * max|jax|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scheduler as jsch
from repro.core import sparse as jsp
from repro.core import spectral as jspec
from repro.kernels import ops as jops
from repro.kernels import sparse_hadamard as jsh
from repro_torch.core import scheduler as sch
from repro_torch.core import sparse as sp
from repro_torch.core import spectral as spec
from repro_torch.kernels import ops
from repro_torch.kernels import sparse_hadamard as sh

REL_TOL = 1e-5


def assert_rel(port, ref, tol=REL_TOL):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _spectra(rng, b, m, t):
    """Complex [B, M, T, 8, 8] tile spectra (the FFT of random windows)."""
    return np.fft.fft2(rng.standard_normal((b, m, t, 8, 8))).astype(
        np.complex64)


@pytest.mark.parametrize("alpha,r", [(4, 4), (4, 10), (8, 6)])
def test_group_matches_reference(alpha, r):
    """One group of 16 kernels over 4 channels, pruned alike by both
    packages: equal schedule stats, equal outputs, and both equal the
    masked dense Hadamard."""
    rng = np.random.default_rng(alpha * 10 + r)
    w = rng.standard_normal((16, 4, 3, 3)).astype(np.float32)
    x_f = _spectra(rng, 1, 4, 9)
    jsk = jsp.prune_magnitude(jspec.spectral_kernel(jnp.asarray(w), 8),
                              float(alpha))
    sk = sp.prune_magnitude(spec.spectral_kernel(torch.from_numpy(w), 8),
                            float(alpha))
    assert np.array_equal(sk.indices.numpy(), np.asarray(jsk.indices))
    jy, jstats = jops.scheduled_sparse_conv_group(
        np.asarray(jsk.values), np.asarray(jsk.indices), jnp.asarray(x_f),
        r=r)
    y, stats = ops.scheduled_sparse_conv_group(
        sk.values, sk.indices, torch.from_numpy(x_f), r=r)
    assert stats == jstats
    assert y.shape == (16, 9, 8, 8) and y.dtype == torch.complex64
    assert_rel(y.real, np.real(jy))
    assert_rel(y.imag, np.imag(jy))
    dense = np.einsum("bmtuv,nmuv->bntuv", x_f, sk.values.numpy())[0]
    assert_rel(y.real, dense.real)
    assert_rel(y.imag, dense.imag)


def _padded_tables(mod):
    """Two channels of one group of 8 kernels with different cycle
    counts (4 and 2 non-zeros a kernel), built by ``mod``'s scheduler."""
    rng = np.random.default_rng(3)
    k2, n_pe = 16, 8
    tables = []
    for m in range(2):
        nnz = 4 if m == 0 else 2
        idx = np.stack([np.sort(rng.choice(k2, nnz, replace=False))
                        for _ in range(n_pe)])
        vals = np.zeros((n_pe, k2), np.complex64)
        for i in range(n_pe):
            vals[i, idx[i]] = rng.standard_normal(nnz)
        s = mod.schedule_exact_cover(idx, k2, r=4)
        tables.append(mod.build_tables(s, vals, idx))
    return tables


def test_stack_tables_padding_inert():
    """Channels with fewer cycles are padded to the longest; the padded
    cycles are inert: the stacked tables equal the reference's, the
    short channel's padded valid rows are zero, and executing the stack
    equals the per-channel sum of the unpadded tables."""
    tables = _padded_tables(sch)
    packed = sh.stack_tables(tables)
    jpacked = jsh.stack_tables(_padded_tables(jsch))
    for a, b in zip(packed, jpacked):
        assert a.numpy().dtype == np.asarray(b).dtype
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert packed[0].shape[:2] == (2, max(t.n_cycles for t in tables))
    t_short = min(t.n_cycles for t in tables)
    short = int(np.argmin([t.n_cycles for t in tables]))
    assert float(packed[2][short, t_short:].sum()) == 0.0
    x = np.fft.fft2(np.random.default_rng(4).standard_normal((2, 4, 4, 5)),
                    axes=(1, 2)).reshape(2, 16, 5).astype(np.complex64)
    xr, xi = (torch.from_numpy(np.ascontiguousarray(a, np.float32))
              for a in (x.real, x.imag))
    yr, yi = sh.scheduled_sparse_hadamard(*packed, xr, xi)
    want = sum(np.stack([sch.execute_tables(tb, x[c, :, p])
                         for p in range(5)], -1)
               for c, tb in enumerate(tables))
    assert_rel(yr, want.real)
    assert_rel(yi, want.imag)


@pytest.mark.parametrize("p", [5, 9])
def test_executor_plain_matches_reference_kernel(p):
    """The plain executor against the reference's Pallas table kernel on
    the same stacked tables of a full 64-lane group at alpha 4, r = 10,
    for a ragged tile count."""
    rng = np.random.default_rng(p)
    w = rng.standard_normal((64, 5, 3, 3)).astype(np.float32)
    sk = sp.prune_magnitude(spec.spectral_kernel(torch.from_numpy(w), 8), 4.)
    packed, _ = ops.group_tables(sk.values, sk.indices, r=10)
    x = rng.standard_normal((2, 5, 64, p)).astype(np.float32)
    jr, ji = jsh.scheduled_sparse_hadamard(
        *(jnp.asarray(a.numpy()) for a in packed), jnp.asarray(x[0]),
        jnp.asarray(x[1]))
    yr, yi = sh.scheduled_sparse_hadamard(*packed, torch.from_numpy(x[0]),
                                          torch.from_numpy(x[1]))
    assert yr.shape == (64, 64, p)
    assert_rel(yr, jr)
    assert_rel(yi, ji)


def test_executor_arguments_checked():
    packed, _ = ops.group_tables(
        np.ones((4, 2, 8, 8), np.complex64),
        np.tile(np.arange(64), (4, 2, 1)).astype(np.int32), r=4)
    x = torch.zeros(2, 64, 3)
    with pytest.raises(ValueError, match="channels"):
        sh.scheduled_sparse_hadamard(*packed, x[:1], x[:1])
    with pytest.raises(TypeError, match="int32"):
        sh.scheduled_sparse_hadamard(packed[0].long(), *packed[1:], x, x)
    with pytest.raises(ValueError, match="xi has shape"):
        sh.scheduled_sparse_hadamard(*packed, x, x[..., :2])
    with pytest.raises(ValueError, match="batch 1"):
        ops.scheduled_sparse_conv_group(
            np.ones((4, 2, 8, 8), np.complex64),
            np.tile(np.arange(64), (4, 2, 1)).astype(np.int32),
            torch.zeros(2, 2, 3, 8, 8, dtype=torch.complex64))


# --- the kernel's channel split (split-K over CTAs) --------------------------

@pytest.mark.parametrize("ranges", [1, 2, 3, "M"])
def test_range_split_plain_matches_reference_kernel(ranges):
    """The plain version summed as the kernel sums it (``range_m``: each
    range in (channel, cycle) order, then the ranges in ascending order)
    against the reference's Pallas table kernel on one 64-lane group's
    tables at alpha 4, r = 10, for 1, 2, 3 and M ranges."""
    rng = np.random.default_rng(11)
    m, p = 5, 9
    w = rng.standard_normal((64, m, 3, 3)).astype(np.float32)
    sk = sp.prune_magnitude(spec.spectral_kernel(torch.from_numpy(w), 8), 4.)
    packed, _ = ops.group_tables(sk.values, sk.indices, r=10)
    x = rng.standard_normal((2, m, 64, p)).astype(np.float32)
    jr, ji = jsh.scheduled_sparse_hadamard(
        *(jnp.asarray(a.numpy()) for a in packed), jnp.asarray(x[0]),
        jnp.asarray(x[1]))
    g = m if ranges == "M" else ranges
    yr, yi = sh.scheduled_sparse_hadamard_reference(
        *packed, torch.from_numpy(x[0]), torch.from_numpy(x[1]),
        range_m=-(-m // g))
    assert_rel(yr, jr)
    assert_rel(yi, ji)
    if g == 1:      # one range is the default order, bit for bit
        dr, di = sh.scheduled_sparse_hadamard_reference(
            *packed, torch.from_numpy(x[0]), torch.from_numpy(x[1]))
        assert torch.equal(dr, yr) and torch.equal(di, yi)


@pytest.mark.parametrize("n_pe,m,p,sms", [
    (64, 512, 9, 132), (64, 512, 25, 132), (64, 256, 100, 132),
    (64, 64, 1444, 132), (64, 3, 1444, 132), (20, 3, 4, 132),
    (64, 1, 1, 132), (64, 7, 37, 132), (13, 100, 70, 8)])
def test_launch_geometry_covers_every_channel_once(n_pe, m, p, sms):
    """``launch_geometry``: the channel ranges cover [0, M) exactly once in
    ascending order, there are at most M of them, the tile and lane
    blocks cover P and N', the grid reaches an SM count where there are
    channels enough, and the workspace is [ranges, 2, N', F, P] (none for
    one range), the size the wrapper allocates."""
    f = 64
    geo = sh.launch_geometry(n_pe, m, f, p, sms)
    bounds = [(lo, min(lo + geo.range_m, m))
              for lo in range(0, m, geo.range_m)]
    assert len(bounds) == geo.ranges <= m
    assert [c for lo, hi in bounds for c in range(lo, hi)] == list(range(m))
    assert all(hi > lo for lo, hi in bounds)
    assert geo.tile_blocks * geo.tiles >= p > (geo.tile_blocks - 1) * \
        geo.tiles
    assert geo.lane_blocks * geo.lanes >= n_pe
    ctas = geo.tile_blocks * geo.lane_blocks * geo.ranges
    assert ctas >= min(sms, geo.tile_blocks * geo.lane_blocks * m)
    want = geo.ranges * 2 * n_pe * f * p if geo.ranges > 1 else 0
    assert geo.workspace == want

"""repro_torch's overlap-add path, band einsum oracle, random pruning and
plain oracles == the reference's (``repro.core.spectral``,
``repro.core.sparse``, ``repro.kernels.ref``).

Same numpy inputs through both packages.  Relayouts, pruning masks and
indices exactly (``prune_random``'s masks bit for bit: both draw from
``np.random.default_rng(seed)``); FFT-based results (``fft_tiles``,
``overlap_add`` of FFT'd tiles, ``spectral_conv2d``, the band oracle,
the Hadamard oracles) within 1e-5 absolute and 1e-6 of max|reference|
(fp32 FFTs of two libraries agree to a few ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as jsp
from repro.core import spectral as jspec
from repro.kernels import ref as jref
from repro_torch.core import sparse as sp
from repro_torch.core import spectral as spec
from repro_torch.kernels import ref

ABS_TOL, REL_TOL = 1e-5, 1e-6
# (H, W, k, K, pad): divisible and ragged canvases, k = 5, K = 16, one tile
GEOMETRIES = [(12, 12, 3, 8, None), (14, 14, 3, 8, 1), (11, 13, 3, 8, None),
              (16, 16, 5, 8, None), (24, 24, 3, 16, None), (6, 6, 3, 8, 0)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after): the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_close(port, ref_, abs_tol=ABS_TOL, rel_tol=REL_TOL):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    ref_ = np.asarray(ref_)
    assert port.shape == ref_.shape
    err = np.abs(port - ref_).max()
    assert err <= abs_tol, err
    assert err <= rel_tol * max(np.abs(ref_).max(), 1.0), err


def geos(h, w, k, K, pad):
    return spec.make_geometry(h, w, k, K, pad), jspec.make_geometry(
        h, w, k, K, pad)


@pytest.mark.parametrize("h,w,k,K,pad", GEOMETRIES)
def test_extract_tiles_exact(h, w, k, K, pad):
    geo, jgeo = geos(h, w, k, K, pad)
    x = rand((2, 3, h, w))
    port = spec.extract_tiles(torch.from_numpy(x), geo)
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(jspec.extract_tiles(jnp.asarray(x), jgeo)))


@pytest.mark.parametrize("h,w,k,K,pad", GEOMETRIES)
def test_fft_tiles_and_overlap_add(h, w, k, K, pad):
    """fft_tiles of the disjoint tiles, and overlap_add of random
    full-conv output tiles (elementwise adds in the reference's order:
    bit for bit)."""
    geo, jgeo = geos(h, w, k, K, pad)
    tiles = rand((2, 3, geo.n_tiles, geo.tile, geo.tile), seed=1)
    port = spec.fft_tiles(torch.from_numpy(tiles), geo)
    jf = jspec.fft_tiles(jnp.asarray(tiles), jgeo)
    assert port.dtype == torch.complex64
    assert_close(port.real, np.real(jf))
    assert_close(port.imag, np.imag(jf))
    y = rand((2, 4, geo.n_tiles, K, K), seed=2)
    np.testing.assert_array_equal(
        spec.overlap_add(torch.from_numpy(y), geo).numpy(),
        np.asarray(jspec.overlap_add(jnp.asarray(y), jgeo)))


def test_overlap_add_refuses_other_geometry():
    geo = spec.make_geometry(12, 12, 3, 8)
    with pytest.raises(ValueError):
        spec.overlap_add(torch.zeros((1, 1, geo.n_tiles + 1, 8, 8)), geo)


@pytest.mark.parametrize("h,w,k,K,pad", GEOMETRIES)
def test_paper_oaa_equals_spatial(h, w, k, K, pad):
    """The paper's OaA decomposition (Eqs 3-4) end to end on the port:
    disjoint tiles -> FFT -> Hadamard -> IFFT -> overlap_add equals the
    'same' cross-correlation."""
    geo, _ = geos(h, w, k, K, pad)
    x, wk = rand((1, 3, h, w), 3), rand((4, 3, k, k), 4)
    xt = torch.from_numpy(x)
    x_f = spec.fft_tiles(spec.extract_tiles(xt, geo), geo)
    w_f = spec.spectral_kernel(torch.from_numpy(wk), K)
    y_tiles = torch.fft.ifft2(spec.hadamard_accumulate(x_f, w_f)).real
    y = spec.overlap_add(y_tiles, geo)
    want = spec.spatial_conv2d(xt, torch.from_numpy(wk), pad=geo.pad)
    assert_close(y, want.numpy(), abs_tol=1e-4, rel_tol=1e-5)


@pytest.mark.parametrize("h,w,k,K,pad", GEOMETRIES)
def test_spectral_conv2d_equals_reference(h, w, k, K, pad):
    x, wk = rand((2, 3, h, w), 5), rand((5, 3, k, k), 6)
    port = spec.spectral_conv2d(torch.from_numpy(x), torch.from_numpy(wk),
                                fft_size=K, pad=pad)
    jy = jspec.spectral_conv2d(jnp.asarray(x), jnp.asarray(wk), fft_size=K,
                               pad=pad)
    assert_close(port, jy)
    assert_close(port, spec.spatial_conv2d(
        torch.from_numpy(x), torch.from_numpy(wk), pad=pad).numpy(),
        abs_tol=1e-4, rel_tol=1e-5)


# (H, W, k, K, D): the band cases of ``test_torch_band.py``'s kind
BAND_CASES = [(56, 56, 3, 8, 4), (28, 28, 3, 8, 4), (14, 14, 3, 8, 3),
              (13, 12, 5, 8, 2), (18, 17, 3, 16, 2), (20, 9, 3, 8, 4)]


@pytest.mark.parametrize("alpha", [1.0, 4.0])
@pytest.mark.parametrize("case", BAND_CASES)
def test_band_oracle_equals_reference(case, alpha):
    """Each shard's uncropped band canvas against the reference's on the
    same extended band (dense and pruned kernels), and the joined
    canvases cropped against the port's unsharded einsum oracle."""
    h, w, k, K, d = case
    geo, jgeo = geos(h, w, k, K, None)
    x, wk = rand((1, 3, h, w), 7), rand((4, 3, k, k), 8)
    w_f = spec.spectral_kernel(torch.from_numpy(wk), K)
    jw_f = jspec.spectral_kernel(jnp.asarray(wk), K)
    if alpha > 1:
        w_f, jw_f = sp.prune_magnitude(w_f, alpha), jsp.prune_magnitude(
            jw_f, alpha)
    tr = spec.shard_band_rows(geo, d)
    bgeo = spec.make_band_geometry(geo, tr)
    jbgeo = jspec.make_band_geometry(jgeo, tr)
    bands = spec.halo_exchange_reference(torch.from_numpy(x), geo, d)
    jbands = jspec.halo_exchange_reference(jnp.asarray(x), jgeo, d)
    parts = []
    for band, jband in zip(bands, jbands, strict=True):
        part = spec.spectral_band_conv2d_pretransformed(band, w_f, bgeo)
        assert_close(part, jspec.spectral_band_conv2d_pretransformed(
            jband, jw_f, jbgeo))
        parts.append(part)
    joined = torch.cat(parts, dim=2)[:, :, :geo.h_pad]
    assert_close(spec.crop_canvas_same(joined, geo),
                 spec.spectral_conv2d_pretransformed(
                     torch.from_numpy(x), w_f, geo).numpy())


def assert_same_masks(sk, jsk):
    np.testing.assert_array_equal(sk.mask.numpy(), np.asarray(jsk.mask))
    np.testing.assert_array_equal(sk.indices.numpy(),
                                  np.asarray(jsk.indices))
    np.testing.assert_array_equal(sk.active_bins, jsk.active_bins)
    assert sk.alpha == jsk.alpha and sk.nnz == jsk.nnz
    np.testing.assert_array_equal(sk.values.numpy() == 0,
                                  np.asarray(jsk.values) == 0)


@pytest.mark.parametrize("shape,alpha,seed", [
    ((6, 3, 3, 3), 4.0, 0), ((6, 3, 3, 3), 2.0, 1), ((16, 8, 3, 3), 4.0, 7),
    ((5, 4, 5, 5), 3.0, 0), ((4, 2, 3, 3), 64.0, 3), ((8, 8, 3, 3), 1.0, 2),
    ((64, 64, 3, 3), 4.0, 0)])
def test_prune_random_masks_bit_equal(shape, alpha, seed):
    K = 8 if shape[-1] == 3 else 16
    w = rand(shape, seed=11)
    sk = sp.prune_random(spec.spectral_kernel(torch.from_numpy(w), K),
                         alpha, seed=seed)
    jsk = jsp.prune_random(jspec.spectral_kernel(jnp.asarray(w), K), alpha,
                           seed=seed)
    assert_same_masks(sk, jsk)
    assert_close(sk.values.real, np.real(jsk.values))
    assert_close(sk.values.imag, np.imag(jsk.values))
    # the random pattern is not the magnitude one
    mag = sp.prune_magnitude(spec.spectral_kernel(torch.from_numpy(w), K),
                             alpha)
    if alpha > 1:
        assert not torch.equal(mag.mask, sk.mask)


def test_prune_random_default_seed_is_zero():
    wf = spec.spectral_kernel(torch.from_numpy(rand((4, 3, 3, 3))), 8)
    assert torch.equal(sp.prune_random(wf, 4.0).mask,
                       sp.prune_random(wf, 4.0, seed=0).mask)
    assert not torch.equal(sp.prune_random(wf, 4.0).mask,
                           sp.prune_random(wf, 4.0, seed=1).mask)


@pytest.mark.parametrize("pruner", ["prune_magnitude", "prune_random"])
def test_sparse_hadamard_reference_and_index_matrix(pruner):
    w, xf = rand((6, 3, 3, 3), 12), rand((2, 3, 4, 8, 8), 13)
    xfi = rand((2, 3, 4, 8, 8), 14)
    wf = spec.spectral_kernel(torch.from_numpy(w), 8)
    jwf = jspec.spectral_kernel(jnp.asarray(w), 8)
    sk = getattr(sp, pruner)(wf, 4.0)
    jsk = getattr(jsp, pruner)(jwf, 4.0)
    x_f = torch.complex(torch.from_numpy(xf), torch.from_numpy(xfi))
    jx_f = jnp.asarray(xf) + 1j * jnp.asarray(xfi)
    y = sp.sparse_hadamard_reference(x_f, sk)
    jy = jsp.sparse_hadamard_reference(jx_f, jsk)
    assert_close(y.real, np.real(jy))
    assert_close(y.imag, np.imag(jy))
    for m, group in ((0, slice(0, 4)), (2, slice(2, 6)), (1, slice(None))):
        idx = sp.kernel_index_matrix(sk, m, group)
        assert isinstance(idx, np.ndarray)
        np.testing.assert_array_equal(idx, jsp.kernel_index_matrix(
            jsk, m, group))


def test_ref_oracles_equal_reference():
    f, n, m, p = 16, 5, 3, 7
    wr, wi, xr, xi = (rand(s, seed=20 + i) for i, s in enumerate(
        [(f, n, m), (f, n, m), (f, m, p), (f, m, p)]))
    t = lambda a: torch.from_numpy(a)
    yr, yi = ref.spectral_hadamard_ref(t(wr), t(wi), t(xr), t(xi))
    jyr, jyi = jref.spectral_hadamard_ref(*(jnp.asarray(a)
                                            for a in (wr, wi, xr, xi)))
    assert_close(yr, jyr)
    assert_close(yi, jyi)

    vals = rand((n, f), 30) + 1j * rand((n, f), 31)
    mask = rand((n, f), 32) > 0
    xr2, xi2 = rand((f, p), 33), rand((f, p), 34)
    yr, yi = ref.sparse_hadamard_ref(torch.from_numpy(vals.astype(
        np.complex64)), t(mask), t(xr2), t(xi2))
    jyr, jyi = jref.sparse_hadamard_ref(jnp.asarray(vals.astype(
        np.complex64)), jnp.asarray(mask), jnp.asarray(xr2),
        jnp.asarray(xi2))
    assert_close(yr, jyr)
    assert_close(yi, jyi)

    tiles = rand((2, 3, 6, 6), 40)
    fr, fi = ref.fft2_tiles_ref(t(tiles), 8)
    jfr, jfi = jref.fft2_tiles_ref(jnp.asarray(tiles), 8)
    assert fr.shape == (2, 3, 8, 8) and fr.dtype == torch.float32
    assert_close(fr, jfr)
    assert_close(fi, jfi)
    back = ref.ifft2_tiles_ref(fr, fi)
    assert_close(back, jref.ifft2_tiles_ref(jfr, jfi))
    assert_close(back[..., :6, :6], tiles)

"""repro_torch spectral substrate == repro.core.spectral / sparse.

Same numpy inputs through both packages.  Relayouts and the numpy
operators must match exactly; transforms and the einsum oracle to
max|port - jax| <= 1e-6 * max|jax| (fp32 FFTs of different libraries
agree to a few ulp); pruning masks, indices and active bins exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vgg16_spectral import SMOKE as JAX_SMOKE
from repro.core import sparse as jsp
from repro.core import spectral as jspec
from repro.kernels import fft8 as jfft8
from repro.kernels import fused_spectral_conv as jfsc
from repro.models import cnn as jcnn
from repro_torch.core import sparse as sp
from repro_torch.core import spectral as spec
from repro_torch.kernels import fused_spectral_conv as fsc

REL_TOL = 1e-6
GEOMETRIES = [(12, 12, 3, 8, None), (14, 14, 3, 8, 1), (11, 13, 3, 8, None),
              (16, 16, 5, 8, None), (24, 24, 3, 16, None), (6, 6, 3, 8, 0)]


def assert_rel(port, ref, tol=REL_TOL):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("h,w,k,K,pad", GEOMETRIES)
def test_geometry_matches(h, w, k, K, pad):
    geo = spec.make_geometry(h, w, k, K, pad)
    ref = jspec.make_geometry(h, w, k, K, pad)
    assert geo._asdict() == {f: getattr(ref, f) for f in geo._fields}
    assert geo.n_tiles == ref.n_tiles


@pytest.mark.parametrize("h,w,k,K,pad", GEOMETRIES)
def test_extract_tiles_overlapping_exact(h, w, k, K, pad):
    x = rand((2, 3, h, w))
    geo = spec.make_geometry(h, w, k, K, pad)
    port = spec.extract_tiles_overlapping(torch.from_numpy(x), geo)
    ref = jspec.extract_tiles_overlapping(jnp.asarray(x),
                                          jspec.make_geometry(h, w, k, K, pad))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("h,w,k,K,pad", GEOMETRIES)
def test_assemble_valid_tiles_exact(h, w, k, K, pad):
    geo = spec.make_geometry(h, w, k, K, pad)
    y = rand((2, 4, geo.n_tiles, geo.tile, geo.tile), seed=1)
    port = spec.assemble_valid_tiles(torch.from_numpy(y), geo)
    jgeo = jspec.make_geometry(h, w, k, K, pad)
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(jspec.assemble_valid_tiles(jnp.asarray(y),
                                                            jgeo)))
    np.testing.assert_array_equal(
        spec.assemble_tile_canvas(torch.from_numpy(y), geo).numpy(),
        np.asarray(jspec.assemble_tile_canvas(jnp.asarray(y), jgeo)))


@pytest.mark.parametrize("K", [8, 16])
def test_spectral_kernel(K):
    w = rand((5, 3, 3, 3), seed=2)
    port = spec.spectral_kernel(torch.from_numpy(w), K)
    ref = jspec.spectral_kernel(jnp.asarray(w), K)
    assert port.dtype == torch.complex64
    assert_rel(port.real, np.asarray(ref).real)
    assert_rel(port.imag, np.asarray(ref).imag)


@pytest.mark.parametrize("K,k,active", [
    (8, 3, None), (8, 3, (0, 1, 2, 9, 17, 33, 40, 63)), (8, 5, None),
    (16, 3, tuple(range(0, 256, 8)))])
def test_operators_exact(K, k, active):
    for port, ref in zip(fsc.overlap_save_operators(K, k, active),
                         jfsc.overlap_save_operators(K, k, active)):
        np.testing.assert_array_equal(port, ref)
    for port, ref in zip(fsc.dft_matrices(K), jfft8.dft_matrices(K)):
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("alpha", [1.0, 4.0, 16.0])
@pytest.mark.parametrize("h,w,k,K,pad", GEOMETRIES[:4])
def test_einsum_oracle(h, w, k, K, pad, alpha):
    x = rand((2, 3, h, w), seed=3)
    wk = rand((4, 3, k, k), seed=4)
    geo = spec.make_geometry(h, w, k, K, pad)
    jgeo = jspec.make_geometry(h, w, k, K, pad)
    sk = sp.prune_magnitude(spec.spectral_kernel(torch.from_numpy(wk), K),
                            alpha)
    jsk = jsp.prune_magnitude(jspec.spectral_kernel(jnp.asarray(wk), K),
                              alpha)
    port = spec.spectral_conv2d_pretransformed(torch.from_numpy(x), sk, geo)
    ref = jspec.spectral_conv2d_pretransformed(jnp.asarray(x), jsk, jgeo)
    assert_rel(port, ref)


@pytest.mark.parametrize("stride", [1, 2])
def test_spatial_conv2d(stride):
    x = rand((2, 3, 13, 12), seed=5)
    wk = rand((4, 3, 3, 3), seed=6)
    port = spec.spatial_conv2d(torch.from_numpy(x), torch.from_numpy(wk),
                               stride=stride)
    ref = jspec.spatial_conv2d(jnp.asarray(x), jnp.asarray(wk),
                               stride=stride)
    assert_rel(port, ref)


def _assert_same_pruning(w, K, alpha):
    sk = sp.prune_magnitude(spec.spectral_kernel(torch.from_numpy(w), K),
                            alpha)
    jsk = jsp.prune_magnitude(jspec.spectral_kernel(jnp.asarray(w), K),
                              alpha)
    np.testing.assert_array_equal(sk.mask.numpy(), np.asarray(jsk.mask))
    np.testing.assert_array_equal(sk.indices.numpy(),
                                  np.asarray(jsk.indices))
    np.testing.assert_array_equal(sk.active_bins, jsk.active_bins)
    assert sk.alpha == jsk.alpha and sk.nnz == jsk.nnz
    active = sp.compacted_active_bins(sk)
    jactive = jsp.compacted_active_bins(jsk)
    assert (active is None) == (jactive is None)
    if active is not None:
        np.testing.assert_array_equal(active, jactive)
    return sk, jsk, active


@pytest.fixture(scope="module")
def smoke_convs():
    params = jcnn.init(jax.random.PRNGKey(0), JAX_SMOKE)
    return [np.array(c["w"]) for c in params["convs"]]


@pytest.mark.parametrize("index", range(len(JAX_SMOKE.layers)))
def test_prune_magnitude_smoke_layers_exact(smoke_convs, index):
    sk, jsk, active = _assert_same_pruning(smoke_convs[index], 8, 4.0)
    wr, wi = sp.compact_planes(sk, active)
    jwr, jwi = jsp.compact_planes(jsk, active)
    assert_rel(wr, jwr)
    assert_rel(wi, jwi)


def test_prune_magnitude_full_width_conv5_1_exact():
    """conv5_1 at full width (512 x 512 He-initialised 3x3 kernels):
    conjugate-symmetric bins tie in exact arithmetic, so this checks the
    two FFTs never flip which bin survives."""
    w = rand((512, 512, 3, 3), seed=7) * np.float32((2.0 / (512 * 9)) ** 0.5)
    _assert_same_pruning(w, 8, 4.0)


@pytest.mark.parametrize("active", [None, np.array([0, 5, 9, 12, 20, 33,
                                                     47, 63])])
def test_compact_planes_layout(active):
    w = rand((6, 3, 3, 3), seed=8)
    sk = sp.prune_magnitude(spec.spectral_kernel(torch.from_numpy(w), 8),
                            2.0)
    wr, wi = sp.compact_planes(sk, active)
    fa = 64 if active is None else len(active)
    assert wr.shape == wi.shape == (fa, 6, 3)
    assert wr.is_contiguous() and wr.dtype == torch.float32


def test_per_layer_alphas():
    assert sp.per_layer_alphas(4, 3) == jsp.per_layer_alphas(4, 3)
    assert sp.per_layer_alphas([1, 2.5], 2) == (1.0, 2.5)
    with pytest.raises(ValueError):
        sp.per_layer_alphas([2.0], 2)
    with pytest.raises(ValueError):
        sp.per_layer_alphas(0.5, 1)

"""repro_torch band geometry and band kernels' plain versions == repro's.

Spatial sharding splits every layer into bands of whole tile rows; each
shard's band carries its k-1 rows of top halo in the buffer
(``pre_halo_h``).  Held EQUAL to the reference's numpy/integer helpers:
``shard_band_rows``, ``make_band_geometry``, ``halo_exchange_reference``,
``dataflow.shard_local_layer`` / ``shard_ici_bytes``, the band windows
(``extract_tiles_overlapping``) and the halo gather's block starts and
selectors on band geometries, over the VGG16 and ResNet-18 layers at D in
{2, 3, 4, 8}.  The band plain versions (what ``execute_band_plan`` runs on
CPU tensors) are held to the reference's ``execute_band_plan`` in
interpret mode on each band (<= 1e-5 abs; reference plans windowed: the
reference halo path does not run on this tree's jax), and the halo band to
the windowed band (plane bit for bit, scheduled <= 1e-5).  The CUDA
kernels run only on a card: ``test_torch_gpu.py`` holds them to these
plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet18_spectral import CONFIG as JAX_RESNET
from repro.core import dataflow as jdf
from repro.core import plan as jpl
from repro.core import spectral as jspec
from repro.kernels import fused_spectral_conv as jfsc
from repro_torch.configs.resnet18_spectral import CONFIG as RESNET
from repro_torch.core import dataflow as df
from repro_torch.core import plan as pl
from repro_torch.core import spectral as spec
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import fused_spectral_conv as fsc

ABS_TOL = 1e-5
SHARDS = (2, 3, 4, 8)
MODELS = {"vgg16": (df.VGG16_LAYERS, jdf.VGG16_LAYERS),
          "resnet18": (RESNET.layers, JAX_RESNET.layers)}


def _jlayer(layer):
    return jdf.ConvLayer(layer.name, layer.c_in, layer.c_out, layer.h_in,
                         layer.w_in, layer.ksize, layer.pad, layer.stride)


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_shard_helpers_equal_reference(model, d):
    """shard_band_rows, make_band_geometry, shard_local_layer and
    shard_ici_bytes (batch 1 and 4, with and without a shortcut) at every
    layer and strategy: exactly the reference's."""
    layers, jlayers = MODELS[model]
    for layer, jlayer in zip(layers, jlayers, strict=True):
        assert _jlayer(layer) == jlayer
        geo = spec.make_geometry(layer.h_in, layer.w_in, layer.ksize, 8)
        jgeo = jspec.make_geometry(layer.h_in, layer.w_in, layer.ksize, 8)
        assert tuple(geo) == tuple(jgeo)
        tr = spec.shard_band_rows(geo, d)
        assert tr == jspec.shard_band_rows(jgeo, d)
        assert tuple(spec.make_band_geometry(geo, tr)) == tuple(
            jspec.make_band_geometry(jgeo, tr))
        for strategy in df.SHARD_STRATEGIES:
            local = df.shard_local_layer(layer, 8, d, strategy)
            jlocal = jdf.shard_local_layer(jlayer, 8, d, strategy)
            assert (local is None) == (jlocal is None)
            if local is not None:
                assert _jlayer(local) == jlocal
            for batch in (1, 4):
                for residual in (False, True):
                    assert df.shard_ici_bytes(
                        layer, d, strategy, batch=batch,
                        residual=residual) == jdf.shard_ici_bytes(
                            jlayer, d, strategy, batch=batch,
                            residual=residual)


def test_shard_helpers_refuse_what_the_reference_refuses():
    layer = df.VGG16_LAYERS[0]
    with pytest.raises(ValueError):
        spec.shard_band_rows(spec.make_geometry(8, 8, 3, 8), 0)
    with pytest.raises(ValueError):
        df.shard_local_layer(layer, 8, 2, "diagonal")
    with pytest.raises(ValueError):
        df.shard_ici_bytes(layer, 2, "diagonal")


# (H, W, k, K, D): VGG16 extents, an all-padding last band (conv4 at D = 4:
# 5 tile rows in bands of 2), k = 5, K = 16, and one tile row per shard
BAND_CASES = [(224, 224, 3, 8, 4), (112, 112, 3, 8, 3), (56, 56, 3, 8, 8),
              (28, 28, 3, 8, 4), (14, 14, 3, 8, 3), (13, 12, 5, 8, 2),
              (18, 17, 3, 16, 2), (20, 9, 3, 8, 4)]


def _band_case(h, w, k, K, d, b=1, m=2, seed=0):
    geo = spec.make_geometry(h, w, k, K)
    jgeo = jspec.make_geometry(h, w, k, K)
    x = np.random.default_rng(seed).standard_normal((b, m, h, w)).astype(
        np.float32)
    bands = spec.halo_exchange_reference(torch.from_numpy(x), geo, d)
    jbands = jspec.halo_exchange_reference(jnp.asarray(x), jgeo, d)
    tr = spec.shard_band_rows(geo, d)
    return (geo, spec.make_band_geometry(geo, tr),
            jspec.make_band_geometry(jgeo, tr), x, bands, jbands)


@pytest.mark.parametrize("case", BAND_CASES)
def test_halo_exchange_and_band_windows_equal_reference(case):
    """The exchanged bands, their overlap-save windows, and (stitched) the
    unsharded windows: bit for bit the reference's, including bands that
    hold only padding rows."""
    geo, bgeo, jbgeo, x, bands, jbands = _band_case(*case)
    d, ov = case[4], case[2] - 1
    assert len(bands) == d
    wins = []
    for band, jband in zip(bands, jbands, strict=True):
        assert band.shape[2] == ov + bgeo.h_pad
        assert np.array_equal(band.numpy(), np.asarray(jband))
        win = spec.extract_tiles_overlapping(band, bgeo)
        assert np.array_equal(win.numpy(), np.asarray(
            jspec.extract_tiles_overlapping(jband, jbgeo)))
        wins.append(win.reshape(*win.shape[:2], bgeo.n_tiles_h,
                                bgeo.n_tiles_w, *win.shape[3:]))
    full = spec.extract_tiles_overlapping(torch.from_numpy(x), geo)
    cat = torch.cat(wins, dim=2)[:, :, :geo.n_tiles_h]
    assert torch.equal(cat.reshape(full.shape), full)


@pytest.mark.parametrize("block_p", [16, 4, 1])
@pytest.mark.parametrize("case", BAND_CASES)
def test_band_halo_gather_equals_reference(case, block_p):
    """On a band geometry (pre_halo_h = k-1): halo blocks, block starts
    and one-hot selectors equal the reference's, and the gathered windows
    equal the band's overlap-save windows bit for bit."""
    geo, bgeo, jbgeo, x, bands, _ = _band_case(*case)
    hg = spec.halo_block_geometry(bgeo, block_p)
    jhg = jspec.halo_block_geometry(jbgeo, block_p)
    assert tuple(hg) == tuple(jhg)
    for a, c in zip(spec.halo_block_starts(bgeo, hg),
                    jspec.halo_block_starts(jbgeo, jhg), strict=True):
        assert np.array_equal(a, c)
    for a, c in zip(spec.halo_gather_matrices(bgeo, hg),
                    jspec.halo_gather_matrices(jbgeo, jhg), strict=True):
        assert a.dtype == c.dtype and np.array_equal(a, c)
    for band in bands:
        assert torch.equal(spec.halo_window_reference(band, bgeo, hg),
                           spec.extract_tiles_overlapping(band, bgeo))


class BandCfg:
    """Two convs small enough for interpret-mode reference kernels, with
    a tile grid of 4 rows (22 x 22, K = 8): D = 3 leaves an all-padding
    band (bands of 2 rows)."""
    name = "band"
    fft_size = 8
    alpha = 4.0
    layers = (jdf.ConvLayer("c1", 4, 8, 22, 22, 3, 1),
              jdf.ConvLayer("c2", 8, 12, 22, 22, 3, 1))
    pool_after = frozenset()
    graph = None


class PortBandCfg(BandCfg):
    layers = tuple(df.ConvLayer(l.name, l.c_in, l.c_out, l.h_in, l.w_in)
                   for l in BandCfg.layers)


def _band_params(seed=0):
    rng = np.random.default_rng(seed)
    convs = [{"w": (0.2 * rng.standard_normal(
                  (l.c_out, l.c_in, 3, 3))).astype(np.float32),
              "b": (0.1 * rng.standard_normal(l.c_out)).astype(np.float32)}
             for l in BandCfg.layers]
    return {"convs": convs}


@pytest.fixture(scope="module")
def band_plans():
    """Reference and port sharded plans of BandCfg (spatial, D = 3) for
    each Hadamard mode: the reference's windowed, the port's windowed and
    halo."""
    params = _band_params()
    jparams = {"convs": [{k: jnp.asarray(v) for k, v in c.items()}
                         for c in params["convs"]]}
    tparams = params_from_numpy(params, "cpu")
    out = {}
    for hadamard in ("bin", "scheduled"):
        jsplan = jpl.build_sharded_network_plan(
            jparams, BandCfg, n_shards=3, batch=2, strategies=("spatial",),
            hadamard=hadamard, input_mode="windowed")
        ports = {imode: pl.build_sharded_network_plan(
            tparams, PortBandCfg, n_shards=3, batch=2,
            strategies=("spatial",), hadamard=hadamard, input_mode=imode,
            device="cpu") for imode in ("windowed", "halo")}
        out[hadamard] = (jsplan, ports)
    return out


def _bands(layer, d=3, b=2, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (b, layer.c_in, layer.h_in, layer.w_in)).astype(np.float32)
    geo = spec.make_geometry(layer.h_in, layer.w_in, 3, 8)
    return (spec.halo_exchange_reference(torch.from_numpy(x), geo, d),
            jspec.halo_exchange_reference(
                jnp.asarray(x), jspec.make_geometry(layer.h_in, layer.w_in,
                                                    3, 8), d))


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
def test_band_plain_versions_match_reference(band_plans, hadamard, layer):
    """The windowed band's plain version (plane or scheduled) against the
    reference's execute_band_plan on each band: the uncropped canvas
    [B, N, tr*t, w_pad] within 1e-5 abs."""
    jsplan, ports = band_plans[hadamard]
    jband = jsplan.layers[layer].shards[0]
    band = ports["windowed"].layers[layer].shards[0]
    # a plane layer whose kernels leave no bin empty is 'dense' on either
    # side (the port pads active bins to whole chunks, the reference not)
    sched = hadamard == "scheduled"
    assert ((band.hadamard == "scheduled") == (jband.hadamard == "scheduled")
            == sched)
    assert tuple(band.geo) == tuple(jband.geo)
    bands, jbands = _bands(ports["windowed"].layers[layer].base.layer)
    for xb, jxb in zip(bands, jbands, strict=True):
        y = fsc.execute_band_plan(xb, band)
        ref = np.asarray(jfsc.execute_band_plan(jxb, jband, interpret=True))
        assert y.shape == ref.shape == (2, band.layer.c_out, band.geo.h_pad,
                                        band.geo.w_pad)
        assert float(np.abs(y.numpy() - ref).max()) <= ABS_TOL


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
def test_halo_band_matches_windowed_band(band_plans, hadamard, layer):
    """The halo band's plain version (the gather from k-1 rows lower, the
    uncropped canvas) against the windowed band's: plane bit for bit,
    scheduled within 1e-5 abs; and the kernels' launch counters untouched
    on the CPU."""
    _, ports = band_plans[hadamard]
    win = ports["windowed"].layers[layer].shards[0]
    halo = ports["halo"].layers[layer].shards[0]
    assert halo.input_mode == "halo" and win.input_mode == "windowed"
    before = (dict(fsc.LAUNCHES), dict(fsc.BAND_LAUNCHES))
    for xb in _bands(ports["windowed"].layers[layer].base.layer)[0]:
        yw = fsc.execute_band_plan(xb, win)
        yh = fsc.execute_band_plan(xb, halo)
        if hadamard == "bin":
            assert torch.equal(yh, yw)
        else:
            assert float((yh - yw).abs().max()) <= ABS_TOL
    assert (fsc.LAUNCHES, fsc.BAND_LAUNCHES) == before


def test_band_mode_guards():
    """A band geometry runs only in band mode, a band takes no shortcut,
    and a band's output is the uncropped canvas."""
    geo = spec.make_band_geometry(spec.make_geometry(22, 22, 3, 8), 2)
    hg = spec.halo_block_geometry(geo, fsc.BLOCK_P)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (1, 2, geo.h_in, geo.w_in)).astype(np.float32))
    dfr, dfi, dvr, dvi = (torch.from_numpy(a)
                          for a in fsc.overlap_save_operators(8, 3))
    wr = torch.from_numpy(rng.standard_normal((64, 3, 2)).astype(np.float32))
    ops = (wr, wr, dfr, dfi, dvr, dvi, torch.zeros(1, 3))
    with pytest.raises(ValueError, match="band mode"):
        fsc.fused_spectral_pipeline_halo(x, *ops, geo=geo, hg=hg, relu=True)
    with pytest.raises(ValueError, match="no shortcut"):
        fsc.fused_spectral_pipeline_halo(
            x, *ops, geo=geo, hg=hg, relu=True, band=True,
            shortcut=torch.zeros(1, 3, geo.h_pad, geo.w_pad))
    y = fsc.fused_spectral_pipeline_halo(x, *ops, geo=geo, hg=hg, relu=True,
                                         band=True)
    assert y.shape == (1, 3, geo.h_pad, geo.w_pad)

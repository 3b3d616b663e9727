"""repro_torch halo input path == repro's, on the same numpy inputs.

The port's halo geometry (``HaloGeometry``, ``halo_block_starts``,
``halo_gather_matrices``) and its window gather are held EQUAL to the
reference's numpy helpers and to the windowed extraction.  The halo
pipelines' plain versions (what the wrappers run on CPU tensors) are
held to the reference's fused convs run on the windowed path in
interpret mode (<= 1e-5 * max|ref|) — the reference's own halo kernel
does not run on this tree's jax (``pl.Unblocked`` is gone) — and to the
port's windowed plain path (<= 1e-6; on the CPU the two are in fact
equal bit for bit, which the tests assert too: the gather is exact and
every output column goes through the same GEMMs).  VGG16 SMOKE logits
through halo plans are held to the reference's einsum oracle at alpha
4 and to the spatial oracle at alpha 1.  The CUDA kernels themselves
run only on a card: ``test_torch_gpu.py`` holds them to these plain
versions there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.vgg16_spectral import SMOKE as JAX_SMOKE
from repro.core import dataflow as jdf
from repro.core import plan as jpl
from repro.core import sparse as jsp
from repro.core import spectral as jspec
from repro.kernels import fused_spectral_conv as jfsc
from repro.models import cnn as jcnn
from repro_torch.configs.vgg16_spectral import SMOKE
from repro_torch.core import plan as pl
from repro_torch.core import scheduler as sch
from repro_torch.core import sparse as sp
from repro_torch.core import spectral as spec
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import fused_spectral_conv as fsc
from repro_torch.models import cnn

REL_TOL = 1e-5
HALO_VS_WINDOWED_TOL = 1e-6


def assert_rel(port, ref, tol=REL_TOL):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def both_geometries(h, w, k, K, block_p):
    geo, jgeo = spec.make_geometry(h, w, k, K), jspec.make_geometry(h, w, k,
                                                                    K)
    return (geo, spec.halo_block_geometry(geo, block_p), jgeo,
            jspec.halo_block_geometry(jgeo, block_p))


def assert_geometry_equal(h, w, k, K, block_p):
    geo, hg, jgeo, jhg = both_geometries(h, w, k, K, block_p)
    assert tuple(hg) == tuple(jhg)
    assert (hg.block_tiles, hg.n_blocks) == (jhg.block_tiles, jhg.n_blocks)
    for a, b in zip(spec.halo_block_starts(geo, hg),
                    jspec.halo_block_starts(jgeo, jhg), strict=True):
        assert np.array_equal(a, b)
    for a, b in zip(spec.halo_gather_matrices(geo, hg),
                    jspec.halo_gather_matrices(jgeo, jhg), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def assert_gather_equal(h, w, k, K, block_p, b=2, m=3, seed=0):
    geo, hg, jgeo, jhg = both_geometries(h, w, k, K, block_p)
    x = np.random.default_rng(seed).standard_normal((b, m, h, w)).astype(
        np.float32)
    got = spec.halo_window_reference(torch.from_numpy(x), geo, hg)
    assert torch.equal(got, spec.extract_tiles_overlapping(
        torch.from_numpy(x), geo))
    ref = np.asarray(jspec.halo_window_reference(jnp.asarray(x), jgeo, jhg))
    assert np.array_equal(got.numpy(), ref)


VGG16_HW = [(l.h_in, l.w_in) for l in jdf.VGG16_LAYERS]
AWKWARD = [(13, 12, 3, 8, 5), (7, 5, 5, 8, 3), (13, 12, 3, 8, 16),
           (11, 7, 5, 8, 3), (2, 2, 3, 8, 16), (18, 17, 3, 16, 7)]


@pytest.mark.parametrize("block_p", [16, 4])
@pytest.mark.parametrize("hw", VGG16_HW,
                         ids=[l.name for l in jdf.VGG16_LAYERS])
def test_halo_geometry_equals_reference_vgg16(hw, block_p):
    assert_geometry_equal(*hw, 3, 8, block_p)


@pytest.mark.parametrize("case", AWKWARD)
def test_halo_geometry_equals_reference_awkward(case):
    assert_geometry_equal(*case)


@settings(max_examples=40, deadline=None)
@given(h=st.integers(2, 34), w=st.integers(2, 34),
       k=st.sampled_from([3, 5]), K=st.sampled_from([8, 16]),
       block_p=st.integers(1, 64))
def test_halo_geometry_and_gather_property(h, w, k, K, block_p):
    assert_geometry_equal(h, w, k, K, block_p)
    assert_gather_equal(h, w, k, K, block_p, b=1, m=2, seed=h * 100 + w)


@pytest.mark.parametrize("case", [(224, 224, 3, 8, 16), (14, 14, 3, 8, 16),
                                  (14, 14, 3, 8, 4), (56, 56, 3, 8, 4),
                                  *AWKWARD])
def test_window_gather_equals_reference_and_windowed(case):
    b, m = (1, 2) if case[0] > 100 else (2, 3)
    assert_gather_equal(*case, b=b, m=m)


# ---------------------------------------------------------------------------
# Plain halo pipelines vs the reference's fused convs (windowed path)
# ---------------------------------------------------------------------------

def conv_case(h, w, cin, cout, k, batch=2, seed=3, alpha=4.0):
    """Raw input, spatial weights, bias, both packages' pruned spectral
    kernels and geometries."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cin, h, w)).astype(np.float32)
    wk = rng.standard_normal((cout, cin, k, k)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    jsk = jsp.prune_magnitude(jspec.spectral_kernel(jnp.asarray(wk), 8),
                              alpha)
    sk = sp.prune_magnitude(spec.spectral_kernel(torch.from_numpy(wk), 8),
                            alpha)
    return (x, b, sk, jsk, spec.make_geometry(h, w, k, 8),
            jspec.make_geometry(h, w, k, 8))


def port_operators(sk, geo):
    active = sp.compacted_active_bins(sk, pad_to=fsc.BIN_CHUNK)
    key = None if active is None else tuple(int(a) for a in active)
    ops = [torch.from_numpy(a) for a in
           fsc.overlap_save_operators(geo.fft_size, geo.ksize, key)]
    return active, ops


CONV_CASES = [
    (13, 12, 4, 6, 3, 5),     # ragged edges, 1 x 3 blocks
    (13, 12, 4, 6, 3, 16),    # a 3 x 3 block in 16 slots
    (14, 14, 5, 7, 3, 4),     # VGG16 conv5 extent, block_p 4
    (19, 13, 3, 5, 5, 7),     # k = 5 (t = 4)
]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("h,w,cin,cout,k,block_p", CONV_CASES)
def test_fused_conv_halo_matches_reference(h, w, cin, cout, k, block_p,
                                           relu):
    x, b, sk, jsk, geo, jgeo = conv_case(h, w, cin, cout, k)
    active, (dfr, dfi, dvr, dvi) = port_operators(sk, geo)
    wr, wi = sp.compact_planes(sk, active)
    bias = torch.from_numpy(b).reshape(1, -1)
    xt = torch.from_numpy(x)
    port = fsc._fused_conv_halo(xt, wr, wi, dfr, dfi, dvr, dvi, bias,
                                geo=geo, block_p=block_p, relu=relu)
    assert port.shape == (2, cout, h, w) and port.is_contiguous()
    ref = jfsc.fused_spectral_conv2d(
        jnp.asarray(x), jsk, jgeo, block_n=4, block_m=2, block_p=block_p,
        bias=jnp.asarray(b), relu=relu, input_mode="windowed",
        interpret=True)
    assert_rel(port, ref)
    windowed = fsc._fused_conv(xt, wr, wi, dfr, dfi, dvr, dvi, bias,
                               geo=geo, relu=relu)
    assert_rel(port, windowed, HALO_VS_WINDOWED_TOL)
    assert torch.equal(port, windowed)          # exact on the CPU


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("h,w,cin,cout,k,block_p", CONV_CASES)
def test_fused_conv_scheduled_halo_matches_reference(h, w, cin, cout, k,
                                                     block_p, relu):
    x, b, sk, jsk, geo, jgeo = conv_case(h, w, cin, cout, k, seed=5)
    block_p = min(block_p, fsc.SCHED_BLOCK_P)
    active, (dfr, dfi, dvr, dvi) = port_operators(sk, geo)
    k2 = 64
    lt = sch.compile_layer_tables(
        sk.indices.numpy(), sk.values.reshape(cout, cin, k2).numpy(), k2,
        6, 4, active=active, m_pad_to=1)
    tables = pl.PlanTables(*(torch.from_numpy(a) for a in
                             (lt.idx, lt.sel, lt.vr, lt.vi)))
    bias = torch.from_numpy(b).reshape(1, -1)
    xt = torch.from_numpy(x)
    port = fsc._fused_conv_scheduled_halo(
        xt, tables, dfr, dfi, dvr, dvi, bias, geo=geo, block_p=block_p,
        n_out=cout, relu=relu)
    assert port.shape == (2, cout, h, w) and port.is_contiguous()
    ref = jfsc.fused_spectral_conv2d_scheduled(
        jnp.asarray(x), jsk, jgeo, r=6, n_par=4, block_m=1, block_p=8,
        bias=jnp.asarray(b), relu=relu, input_mode="windowed",
        interpret=True)
    assert_rel(port, ref)
    windowed = fsc._fused_conv_scheduled(xt, tables, dfr, dfi, dvr, dvi,
                                         bias, geo=geo, n_out=cout,
                                         relu=relu)
    assert_rel(port, windowed, HALO_VS_WINDOWED_TOL)
    assert torch.equal(port, windowed)          # exact on the CPU


def test_cpu_tensor_takes_plain_version():
    x, b, sk, _, geo, _ = conv_case(13, 12, 4, 6, 3)
    active, ops = port_operators(sk, geo)
    wr, wi = sp.compact_planes(sk, active)
    args = (torch.from_numpy(x), wr, wi, *ops,
            torch.from_numpy(b).reshape(1, -1))
    hg = spec.halo_block_geometry(geo, 9)
    before = dict(fsc.LAUNCHES)
    y = fsc.fused_spectral_pipeline_halo(*args, geo=geo, hg=hg, relu=True)
    assert fsc.LAUNCHES == before
    assert torch.equal(y, fsc.fused_spectral_pipeline_halo_reference(
        *args, geo=geo, hg=hg, relu=True))


@pytest.mark.parametrize("case", ["contiguous", "dtype", "extent",
                                  "blocks", "slots"])
def test_halo_input_checks(case):
    """The halo wrappers take a contiguous NCHW f32 image of the plan's
    extent and its own halo blocks; they copy nothing silently."""
    x, b, sk, _, geo, _ = conv_case(13, 12, 4, 6, 3)
    active, ops = port_operators(sk, geo)
    wr, wi = sp.compact_planes(sk, active)
    xt = torch.from_numpy(x)
    hg = spec.halo_block_geometry(geo, 16)
    block_p = fsc.BLOCK_P
    if case == "contiguous":
        xt = xt.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "dtype":
        xt = xt.double()
    elif case == "extent":
        xt = xt[:, :, :12].contiguous()
    elif case == "blocks":
        hg = hg._replace(nbh=hg.nbh + 1)
    else:
        block_p = fsc.SCHED_BLOCK_P
    fsc._check_halo_input(torch.from_numpy(x), geo,
                          spec.halo_block_geometry(geo, 16), fsc.BLOCK_P)
    with pytest.raises(ValueError):
        fsc._check_halo_input(xt, geo, hg, block_p)
    if case == "contiguous":
        with pytest.raises(ValueError, match="contiguous"):
            fsc.fused_spectral_pipeline_halo(
                xt, wr, wi, *ops, torch.from_numpy(b).reshape(1, -1),
                geo=geo, hg=hg, relu=True)


# ---------------------------------------------------------------------------
# Halo plans: SMOKE layers and logits, plan errors, the derived plan
# ---------------------------------------------------------------------------

def jax_params(seed, jcfg):
    jparams = jcnn.init(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.array, jparams), "cpu")


@pytest.fixture(scope="module")
def halo_plans():
    jparams, params = jax_params(0, JAX_SMOKE)
    jplans = {h: jpl.build_network_plan(jparams, JAX_SMOKE, batch=2,
                                        input_mode="windowed", hadamard=h)
              for h in ("bin", "scheduled")}
    plans = {h: pl.build_network_plan(params, SMOKE, batch=2, hadamard=h,
                                      input_mode="halo", device="cpu")
             for h in ("bin", "scheduled")}
    return dict(jparams=jparams, params=params, jplans=jplans, plans=plans)


@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
@pytest.mark.parametrize("index", range(len(SMOKE.layers)))
def test_execute_layer_plan_smoke_layers(halo_plans, index, hadamard):
    lp = halo_plans["plans"][hadamard].layers[index]
    jlp = halo_plans["jplans"][hadamard].layers[index]
    assert lp.input_mode == lp.tuning.input_mode == "halo"
    assert lp.hadamard == jlp.hadamard
    tiles = lp.geo.n_tiles
    p_blk = fsc.SCHED_BLOCK_P if hadamard == "scheduled" else fsc.BLOCK_P
    assert lp.tuning.block_p == min(p_blk, tiles)      # per image
    layer = lp.layer
    x = np.random.default_rng(index).standard_normal(
        (2, layer.c_in, layer.h_in, layer.w_in)).astype(np.float32)
    port = fsc.execute_layer_plan(torch.from_numpy(x), lp)
    ref = jfsc.execute_layer_plan(jnp.asarray(x), jlp, interpret=True)
    assert_rel(port, ref)


@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
def test_smoke_logits_match_reference_einsum(halo_plans, hadamard):
    d = halo_plans
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    out = cnn.forward_spectral(d["params"], d["plans"][hadamard],
                               torch.from_numpy(x), backend="fused")
    ref = jcnn.forward_spectral(d["jparams"], d["jplans"][hadamard],
                                jnp.asarray(x), backend="einsum")
    assert out.shape == (2, SMOKE.n_classes)
    assert_rel(out, ref)


@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
def test_alpha1_halo_logits_match_forward_spatial(hadamard):
    jcfg = dataclasses.replace(JAX_SMOKE, alpha=1.0)
    cfg = dataclasses.replace(SMOKE, alpha=1.0)
    jparams, params = jax_params(2, jcfg)
    plan = pl.build_network_plan(params, cfg, batch=2, hadamard=hadamard,
                                 input_mode="halo", device="cpu")
    assert all(lp.input_mode == "halo" and lp.n_active_bins == 64
               for lp in plan.layers)
    x = np.random.default_rng(2).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    out = cnn.forward_spectral(params, plan, torch.from_numpy(x),
                               backend="fused")
    assert_rel(out, jcnn.forward_spatial(jparams, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
def test_input_mode_auto_raises_naming_a5(hadamard):
    """input_mode='auto' is ported with the Hopper cost model (A5): each
    layer gets the path the model ranks first, under the forced Hadamard
    mode; measuring the ranking raises without a card."""
    params = cnn.init(SMOKE, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    plan = pl.build_network_plan(params, SMOKE, device="cpu",
                                 hadamard=hadamard, input_mode="auto")
    for lp in plan.layers:
        assert lp.input_mode == lp.tuning.input_mode in ("windowed", "halo")
        assert lp.hadamard in (hadamard, "dense")
    with pytest.raises(RuntimeError, match="card"):
        pl.build_network_plan(params, SMOKE, device="cpu", measure=True,
                              hadamard=hadamard, input_mode="auto")


@pytest.mark.parametrize("bad", ["strided", "HALO", ""])
def test_bad_input_mode_raises(bad):
    with pytest.raises(ValueError, match="input_mode"):
        pl.build_network_plan({"convs": []}, SMOKE, device="cpu",
                              input_mode=bad)
    with pytest.raises(ValueError, match="input_mode"):
        pl.with_input_mode(pl.NetworkPlan("x", 8, 1, (), ()), bad)


def assert_plans_equal(a: pl.NetworkPlan, b: pl.NetworkPlan):
    assert (a.name, a.fft_size, a.batch, a.graph) == \
        (b.name, b.fft_size, b.batch, b.graph)
    for la, lb in zip(a.layers, b.layers, strict=True):
        for f in dataclasses.fields(pl.LayerPlan):
            va, vb = getattr(la, f.name), getattr(lb, f.name)
            if isinstance(va, torch.Tensor):
                assert torch.equal(va, vb), f.name
            elif isinstance(va, tuple) and va and \
                    isinstance(va[0], torch.Tensor):     # tables, kernels
                assert all(torch.equal(x, y) if isinstance(x, torch.Tensor)
                           else np.array_equal(x, y)
                           for x, y in zip(va, vb, strict=True)), f.name
            elif isinstance(va, np.ndarray) or va is None:
                assert np.array_equal(va, vb) if va is not None \
                    else vb is None, f.name
            else:
                assert va == vb, f.name


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
def test_derived_halo_plan_equals_built(hadamard, batch):
    """``with_input_mode`` (what chip_smoke.py uses to reuse the scheduled
    plan's tables) gives the plan ``build_network_plan`` builds for the
    halo path, and back."""
    _, params = jax_params(3, JAX_SMOKE)
    kw = dict(batch=batch, hadamard=hadamard, device="cpu")
    windowed = pl.build_network_plan(params, SMOKE, **kw)
    halo = pl.build_network_plan(params, SMOKE, input_mode="halo", **kw)
    assert_plans_equal(pl.with_input_mode(windowed, "halo"), halo)
    assert_plans_equal(pl.with_input_mode(halo, "windowed"), windowed)

"""repro_torch's residual shortcut (B6 residual) == repro's.

The same numpy operands and shortcut go through the port's kernel
wrappers with ``shortcut=`` (their plain PyTorch versions on CPU tensors:
bias -> + shortcut -> ReLU after the flow's sum) and the reference's
``fused_spectral_pipeline`` / ``fused_spectral_pipeline_scheduled`` with
``shortcut=_shortcut_tiles(...)`` in interpret mode, at the ResNet-18
SMOKE residual shapes (8 channels at 16 x 16, 16 at 8 x 8, batch 2);
tolerance max|port - jax| <= 1e-5 * max|jax|.  The halo plain versions
with a shortcut equal the port's windowed plain path bit for bit (the
reference's halo kernel does not run on this jax).  Also here: the
shortcut's tile relayout, the wrappers' argument checks, the Hopper cost
model's shortcut pricing and the plan's residual modes.  The CUDA
kernels run only on a card (``test_torch_gpu.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet18_spectral import SMOKE as JAX_SMOKE
from repro.core import plan as jpl
from repro.core import scheduler as jsch
from repro.core import spectral as jspec
from repro.core.dataflow import ConvLayer as JConvLayer
from repro.core.dataflow import NodeSpec as JNodeSpec
from repro.kernels import fused_spectral_conv as jfsc
from repro.models import cnn as jcnn
from repro_torch.configs.resnet18_spectral import SMOKE
from repro_torch.core import autotune as at
from repro_torch.core import plan as pl
from repro_torch.core import spectral as spec
from repro_torch.core.dataflow import ConvLayer, NodeSpec
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import fused_spectral_conv as fsc
from repro_torch.models import cnn

REL_TOL = 1e-5
OS, WS, IS = fsc.FLOWS

# the SMOKE residual nodes' shapes: (channels, image side), batch 2
SMOKE_SHAPES = [(8, 16), (16, 8)]


def assert_rel(port, ref, tol=REL_TOL):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def residual_inputs(c, h, b=2, seed=0, k=3):
    """Geometry, windows [S, M, P] (contiguous), raw input and a raw
    [B, N, H, W] shortcut (M = N = c), numpy f32."""
    geo = spec.make_geometry(h, h, k, 8)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, h, h)).astype(np.float32)
    xt, t_cnt = fsc._windows_layout(torch.from_numpy(x), geo)
    sc = rng.standard_normal((b, c, h, h)).astype(np.float32)
    return geo, x, xt.contiguous().numpy(), t_cnt, sc


def plane_operands(c, s2, fa=64, seed=0):
    rng = np.random.default_rng(seed + 100)
    shapes = [(fa, c, c), (fa, c, c), (fa, 64), (fa, 64), (s2, fa),
              (s2, fa), (1, c)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def table_operands(c, s2, *, m_pad_to, fa=64, n_par=4, r=6, seed=0):
    """Reference Alg-2 tables of random kernels (channels padded to
    ``m_pad_to``), operators and bias."""
    rng = np.random.default_rng(seed + 200)
    s = 64
    active = np.sort(rng.choice(s, fa, replace=False))
    nnz = max(1, fa // 4)
    ind = np.sort(np.stack([[rng.choice(active, nnz, replace=False)
                             for _ in range(c)] for _ in range(c)]),
                  axis=-1).astype(np.int32)
    vals = np.zeros((c, c, s), np.complex64)
    np.put_along_axis(vals, ind.astype(np.int64),
                      (rng.standard_normal((c, c, nnz)) + 1j
                       * rng.standard_normal((c, c, nnz))).astype(
                          np.complex64), axis=-1)
    lt = jsch.compile_layer_tables(ind, vals, s, r, n_par,
                                   active=active if fa < s else None,
                                   m_pad_to=m_pad_to)
    f32 = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return [lt.idx, lt.sel, lt.vr, lt.vi, f32(fa, s), f32(fa, s),
            f32(s2, fa), f32(s2, fa), f32(1, c)]


# ---------------------------------------------------------------------------
# The shortcut's tile relayout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("h,w,k", [(16, 16, 3), (8, 8, 3), (13, 12, 3),
                                   (19, 13, 5)])
def test_shortcut_tiles_match_reference_and_invert_assembly(h, w, k, b):
    """``_shortcut_tiles`` equals the reference's relayout, contiguous
    (as the kernels take it), and ``_assemble_output`` of it returns the
    shortcut exactly."""
    geo = spec.make_geometry(h, w, k, 8)
    rng = np.random.default_rng(h + w)
    sc = rng.standard_normal((b, 5, h, w)).astype(np.float32)
    t_cnt = geo.n_tiles
    tiles = fsc._shortcut_tiles(torch.from_numpy(sc), geo, t_cnt)
    assert tiles.shape == (geo.tile ** 2, 5, b * t_cnt)
    assert tiles.is_contiguous()
    ref = jfsc._shortcut_tiles(jnp.asarray(sc),
                               jspec.make_geometry(h, w, k, 8), t_cnt)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(ref))
    back = fsc._assemble_output(tiles, geo, b, 5, t_cnt, torch.float32)
    assert torch.equal(back, torch.from_numpy(sc))


# ---------------------------------------------------------------------------
# Plain versions with a shortcut against the reference's pallas_calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flow,block_m", [(OS, 8), (WS, 8), (IS, 8)])
@pytest.mark.parametrize("c,h", SMOKE_SHAPES)
def test_plane_plain_with_shortcut_matches_jax_kernel(c, h, flow, block_m):
    geo, _, xt, t_cnt, sc = residual_inputs(c, h, seed=c)
    ops = [xt] + plane_operands(c, geo.tile ** 2, seed=c)
    sct = fsc._shortcut_tiles(torch.from_numpy(sc), geo, t_cnt)
    kw = {} if flow == OS else dict(block_m=block_m)
    for relu in (False, True):
        port = fsc.fused_spectral_pipeline(
            *map(torch.from_numpy, ops), relu=relu, flow=flow, shortcut=sct,
            **kw)
        ref = jfsc.fused_spectral_pipeline(
            *map(jnp.asarray, ops), flow=flow, block_n=8, block_m=block_m,
            block_p=8, relu=relu, interpret=True,
            shortcut=jnp.asarray(sct.numpy()))
        assert_rel(port, ref)


@pytest.mark.parametrize("flow,block_m", [(OS, 1), (WS, 1), (WS, 3),
                                          (IS, 2), (IS, 4)])
@pytest.mark.parametrize("c,h", SMOKE_SHAPES)
def test_scheduled_plain_with_shortcut_matches_jax_kernel(c, h, flow,
                                                          block_m):
    """Tables at ``m_pad_to=block_m``, as the reference's flows need."""
    geo, _, xt, t_cnt, sc = residual_inputs(c, h, seed=c + 1)
    ops = [xt] + table_operands(c, geo.tile ** 2, m_pad_to=block_m,
                                seed=c + block_m)
    sct = fsc._shortcut_tiles(torch.from_numpy(sc), geo, t_cnt)
    kw = {} if flow == OS else dict(block_m=block_m)
    for relu in (False, True):
        port = fsc.fused_spectral_pipeline_scheduled(
            *map(torch.from_numpy, ops), n_out=c, relu=relu, flow=flow,
            shortcut=sct, **kw)
        ref = jfsc.fused_spectral_pipeline_scheduled(
            *map(jnp.asarray, ops), n_out=c, flow=flow, block_m=block_m,
            block_p=8, relu=relu, interpret=True,
            shortcut=jnp.asarray(sct.numpy()))
        assert_rel(port, ref)


@pytest.mark.parametrize("flow,block_m", [(OS, None), (WS, 8), (IS, 8)])
@pytest.mark.parametrize("c,h", SMOKE_SHAPES)
def test_halo_plain_with_shortcut_equals_windowed(c, h, flow, block_m):
    """Both halo plain versions with a raw shortcut equal the windowed
    plain path with its tile relayout bit for bit, and the reference's
    windowed pallas_calls to 1e-5."""
    geo, x, xt, t_cnt, sc = residual_inputs(c, h, seed=c + 2)
    b = x.shape[0]
    xw, x, sc_t = (torch.from_numpy(a) for a in (xt, x, sc))
    sct = fsc._shortcut_tiles(sc_t, geo, t_cnt)
    kw = {} if flow == OS else dict(block_m=block_m)
    jsct = jnp.asarray(sct.numpy())

    plane = [torch.from_numpy(a) for a in plane_operands(c, geo.tile ** 2)]
    y = fsc.fused_spectral_pipeline_halo(
        x, *plane, geo=geo, hg=spec.halo_block_geometry(geo, 16), relu=True,
        flow=flow, shortcut=sc_t, **kw)
    yw = fsc._assemble_output(fsc.fused_spectral_pipeline(
        xw, *plane, relu=True, flow=flow, shortcut=sct, **kw), geo, b, c,
        t_cnt, x.dtype)
    assert torch.equal(y, yw)
    ref = jfsc.fused_spectral_pipeline(
        jnp.asarray(xt), *(jnp.asarray(a.numpy()) for a in plane),
        flow=flow, block_n=8, block_m=block_m or 8, block_p=8, relu=True,
        interpret=True, shortcut=jsct)
    assert_rel(y, jfsc._assemble_output(ref, jspec.make_geometry(
        h, h, 3, 8), b, c, t_cnt, jnp.float32))

    sb = {OS: 1, WS: 3, IS: 4}[flow]
    tabs = [torch.from_numpy(a) for a in table_operands(
        c, geo.tile ** 2, m_pad_to=sb, seed=c)]
    kw = {} if flow == OS else dict(block_m=sb)
    y = fsc.fused_spectral_pipeline_scheduled_halo(
        x, *tabs, geo=geo, hg=spec.halo_block_geometry(geo, 4), n_out=c,
        relu=True, flow=flow, shortcut=sc_t, **kw)
    yw = fsc._assemble_output(fsc.fused_spectral_pipeline_scheduled(
        xw, *tabs, n_out=c, relu=True, flow=flow, shortcut=sct, **kw), geo,
        b, c, t_cnt, x.dtype)
    assert torch.equal(y, yw)
    ref = jfsc.fused_spectral_pipeline_scheduled(
        jnp.asarray(xt), *(jnp.asarray(a.numpy()) for a in tabs), n_out=c,
        flow=flow, block_m=sb, block_p=8, relu=True, interpret=True,
        shortcut=jsct)
    assert_rel(y, jfsc._assemble_output(ref, jspec.make_geometry(
        h, h, 3, 8), b, c, t_cnt, jnp.float32))


@pytest.mark.parametrize("case", ["shape", "placement", "vmem_flow",
                                  "dtype"])
def test_shortcut_arguments_checked(case):
    """A shortcut not laid out like the output, an unknown placement, or
    'vmem' on a flow with a finish pass is refused before anything
    runs."""
    geo, _, xt, t_cnt, sc = residual_inputs(8, 16)
    ops = [torch.from_numpy(a) for a in [xt] + plane_operands(8, 36)]
    sct = fsc._shortcut_tiles(torch.from_numpy(sc), geo, t_cnt)
    kw = {"shape": dict(shortcut=sct[:, :, :-1]),
          "placement": dict(shortcut=sct, shortcut_placement="smem"),
          "vmem_flow": dict(shortcut=sct, shortcut_placement="vmem",
                            flow=WS, block_m=8),
          "dtype": dict(shortcut=sct.double())}[case]
    with pytest.raises(ValueError):
        fsc.fused_spectral_pipeline(*ops, relu=True, **kw)


def test_residual_launch_keys():
    assert set(fsc.RESIDUAL_LAUNCHES) == set(fsc.LAUNCHES)


# ---------------------------------------------------------------------------
# The Hopper cost model's shortcut pricing
# ---------------------------------------------------------------------------

LAYER = ConvLayer("s3b1b", 256, 256, 28, 28)


@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
@pytest.mark.parametrize("input_mode", ["windowed", "halo"])
def test_cost_model_prices_the_shortcut_bytes(hadamard, input_mode):
    """'hbm' and 'vmem' both read the output-sized shortcut once; 'hbm'
    reads it after the channel loop (serial), 'vmem' beside it, with its
    staged rows in shared memory.  The plane kernel is priced at batch 4,
    where its output-stationary launch is one slice; at batch 1 it is
    split (``kernel_grid``), its finish pass reads the shortcut, and
    'vmem' is priced as the 'hbm' that runs."""
    batch = 1 if hadamard == "scheduled" else 4
    cost = lambda r, flow=OS, bm=None, b=batch: at.hopper_fused_flow_cost(
        LAYER, 8, 4.0, flow, hadamard, input_mode, batch=b, active_bins=64,
        residual=r, block_m=bm)
    base, hbm, vmem = cost(None), cost("hbm"), cost("vmem")
    geo = spec.make_geometry(28, 28, 3, 8)
    y_bytes = (4 * 256 * 28 * 28 if input_mode == "halo"
               else 4 * 36 * 256 * geo.n_tiles)
    if hadamard == "bin":
        split = {r: cost(r, b=1) for r in (None, "hbm", "vmem")}
        assert at.kernel_grid(LAYER, 8, OS, hadamard, input_mode, 1, 8,
                              64)["slices"] > 1
        assert vmem["residual"] == "vmem" and split["vmem"]["residual"] \
            == "hbm"
        assert split["vmem"]["predicted_s"] == split["hbm"]["predicted_s"]
        assert split["vmem"]["smem_bytes"] == split[None]["smem_bytes"]
        assert split["hbm"]["shortcut_s"] == 0
        assert split["hbm"]["finish_s"] == pytest.approx(
            split[None]["finish_s"] + y_bytes / 3.35e12)
        y_bytes *= batch
    assert hbm["hbm_bytes"] == vmem["hbm_bytes"] == base["hbm_bytes"] \
        + y_bytes
    assert hbm["shortcut_s"] == pytest.approx(y_bytes / 3.35e12)
    assert vmem["shortcut_s"] == base["shortcut_s"] == 0
    assert hbm["smem_bytes"] == base["smem_bytes"]
    ranks = at.kernel_grid(LAYER, 8, OS, hadamard, input_mode, batch,
                           1 if hadamard == "scheduled" else 8, 64)["ranks"]
    rows = fsc.staged_rows(36, ranks)
    if hadamard == "scheduled":
        assert vmem["smem_bytes"] == base["smem_bytes"] + 4 * 64 * 4 * rows
    else:
        # the plane kernel's output-stationary ring gives up its third
        # stage where the staged rows would not fit beside it
        hg = (spec.halo_block_geometry(geo, fsc.BLOCK_P)
              if input_mode == "halo" else None)
        x_floats = (64 * 8 * 16 if hg is None else
                    8 * (((hg.bth * 6 + 2) * (hg.btw * 6 + 2)) | 1))
        assert base["smem_bytes"] == fsc.os_layout(64, 36, x_floats).bytes
        assert vmem["smem_bytes"] == fsc.os_layout(64, 36, x_floats,
                                                   rows).bytes
    assert vmem["predicted_s"] <= hbm["predicted_s"]
    ws = cost("hbm", WS, 1 if hadamard == "scheduled" else 8)
    assert ws["finish_s"] > cost(None, WS, 1 if hadamard == "scheduled"
                                 else 8)["finish_s"]
    with pytest.raises(ValueError, match="vmem"):
        cost("vmem", WS, 8)


def test_autotune_places_the_shortcut():
    """A staged shortcut is tried first on output-stationary candidates
    and falls back to 'hbm' where its rows do not fit (one bin chunk:
    all 36 rows) or where the plane kernel's launch is split (batch 1:
    its finish pass reads the shortcut); ws/is read it globally."""
    fits = at.autotune_layer(LAYER, 8, 4.0, flows=(OS,), batch=4,
                             active_bins=64, residual="vmem")
    assert fits.residual == "vmem"
    assert fits.smem_bytes <= at.H100_SMEM_PER_CTA
    split = at.autotune_layer(LAYER, 8, 4.0, flows=(OS,), active_bins=64,
                              residual="vmem")
    assert split.residual == "hbm"
    one_chunk = at.autotune_layer(LAYER, 8, 4.0, flows=(OS,),
                                  active_bins=8, residual="vmem")
    assert one_chunk.residual == "hbm"
    assert fsc.plane_smem_bytes(OS, spec.make_geometry(28, 28, 3, 8),
                                sc_rows=36) > at.H100_SMEM_PER_CTA
    for flow in (WS, IS):
        tn = at.autotune_layer(LAYER, 8, 4.0, flows=(flow,), active_bins=64,
                               residual="vmem")
        assert tn.residual == "hbm"
    assert at.autotune_layer(LAYER, 8, 4.0, active_bins=64).residual is None


# ---------------------------------------------------------------------------
# The plan's residual modes against the reference's plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jparams = jcnn.init(jax.random.PRNGKey(0), JAX_SMOKE)
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.array, jparams), "cpu")


def residual_modes(plan):
    return {n.id: (plan.layers[n.layer_index].epilogue.residual,
                   plan.layers[n.layer_index].epilogue.relu,
                   n.residual_from, n.relu)
            for n in plan.graph if n.kind == "conv"}


@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
def test_smoke_plan_fuses_every_block_shortcut(weights, hadamard):
    """Every b node is residual-fused, as in the reference's plan; its
    placement is the tuning's and ``shortcut_on_chip`` says so."""
    jparams, params = weights
    plan = pl.build_network_plan(params, SMOKE, batch=2, hadamard=hadamard,
                                 device="cpu")
    jplan = jpl.build_network_plan(jparams, JAX_SMOKE, batch=2,
                                   hadamard=hadamard, input_mode="windowed")
    modes = residual_modes(plan)
    assert modes == residual_modes(jplan)
    fused = [k for k, v in modes.items() if v[0] == "fused"]
    assert fused == ["s1b1b", "s1b2b", "s2b1b", "s2b2b"]
    for node in plan.graph:
        if node.kind != "conv":
            continue
        tn = plan.layers[node.layer_index].tuning
        assert tn.residual == ("vmem" if node.id in fused else None)
        assert node.shortcut_on_chip == (tn.residual == "vmem")
    moved = pl.with_flow(plan, WS)
    assert residual_modes(moved) == modes
    assert all(not n.shortcut_on_chip for n in moved.graph)
    assert all(moved.layers[n.layer_index].tuning.residual == "hbm"
               for n in moved.graph if n.id in fused)
    halo = pl.with_input_mode(plan, "halo")
    assert residual_modes(halo) == modes
    assert [n.shortcut_on_chip for n in halo.graph] == \
        [n.shortcut_on_chip for n in plan.graph]


def strided_graph(conv_layer, node_spec, cfg):
    """A stem, then a stride-2 conv whose shortcut is a pool of the
    stem: the residual node is strided."""
    layers = (conv_layer("stem", 3, 8, 16, 16),
              conv_layer("down", 8, 8, 16, 16, stride=2))
    nodes = (node_spec(id="stem"),
             node_spec(id="stem:pool", kind="pool", inputs=("stem",)),
             node_spec(id="down", inputs=("stem",),
                       residual_from="stem:pool"),
             node_spec(id="head:pool", kind="pool", pool="avg",
                       inputs=("down",)))
    return dataclasses.replace(cfg, name="strided", layers=layers,
                               graph=nodes, image_size=16)


def test_strided_residual_node_adds_on_the_host(weights):
    """A strided residual node takes the 'add' rung with the kernel's
    ReLU off, as the reference decides; its logits agree with the
    reference's fused backend."""
    cfg = strided_graph(ConvLayer, NodeSpec, SMOKE)
    jcfg = strided_graph(JConvLayer, JNodeSpec, JAX_SMOKE)
    jparams = jcnn.init(jax.random.PRNGKey(1), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                               "cpu")
    plan = pl.build_network_plan(params, cfg, batch=2, device="cpu")
    jplan = jpl.build_network_plan(jparams, jcfg, batch=2,
                                   input_mode="windowed")
    assert residual_modes(plan) == residual_modes(jplan) == {
        "stem": (None, True, None, True),
        "down": ("add", False, "stem:pool", True)}
    assert plan.layers[1].tuning.residual is None
    x = np.random.default_rng(2).standard_normal((2, 3, 16, 16)).astype(
        np.float32)
    out = cnn.forward_spectral(params, plan, torch.from_numpy(x),
                               backend="fused")
    ref = jcnn.forward_spectral(jparams, jplan, jnp.asarray(x),
                                backend="pallas_fused", interpret=True)
    assert_rel(out, ref)


def test_shortcut_only_on_a_fused_epilogue(weights):
    """``execute_layer_plan`` takes a shortcut only where the plan fused
    it."""
    _, params = weights
    plan = pl.build_network_plan(params, SMOKE, batch=2, device="cpu")
    lp = plan.layers[1]                       # s1b1a: no shortcut
    x = torch.zeros(2, 8, 16, 16)
    with pytest.raises(ValueError, match="residual-fused"):
        fsc.execute_layer_plan(x, lp, shortcut=torch.zeros(2, 8, 16, 16))

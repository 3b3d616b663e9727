"""repro_torch's one-call fused layers (``fused_spectral_conv2d``,
``fused_spectral_conv2d_scheduled``) == the reference's.

On the CPU the wrappers run the kernels' plain versions.  Windowed, they
are held to the reference's wrappers (interpret mode) on the same numpy
inputs and weights, every flow, dense and pruned kernels, at max|port -
jax| <= 1e-5 (absolute; outputs are O(1)-O(10)).  The reference's halo
path does not run on this tree's jax, so the port's halo wrappers are
held to the port's windowed ones (1e-5), to the reference's windowed
wrappers and to its einsum oracle ``spectral_conv2d_pretransformed``.
On SMOKE VGG16 plans built from the reference's weights, each wrapper
equals ``execute_layer_plan`` on the same layer bit for bit (the same
operands and tables).  The group-size rule of the scheduled kernel is
checked without a card; ``test_torch_gpu.py`` checks it on one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vgg16_spectral import SMOKE as JAX_SMOKE
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

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after): the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_abs(port, ref, tol=TOL):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol, err


def case(h, w, cin, cout, alpha, *, k=3, K=8, batch=2, seed=3):
    """Numpy inputs, and both packages' kernels (pruned at alpha > 1),
    geometries and bias."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cin, h, w)).astype(np.float32)
    wk = rng.standard_normal((cout, cin, k, k)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    wf = spec.spectral_kernel(torch.from_numpy(wk), K)
    jwf = jspec.spectral_kernel(jnp.asarray(wk), K)
    if alpha > 1:
        wf, jwf = sp.prune_magnitude(wf, alpha), jsp.prune_magnitude(
            jwf, alpha)
    return dict(x=x, wf=wf, jwf=jwf, b=b,
                geo=spec.make_geometry(h, w, k, K),
                jgeo=jspec.make_geometry(h, w, k, K))


def oracle(c, relu):
    """The reference's einsum oracle with the epilogue."""
    y = jspec.spectral_conv2d_pretransformed(jnp.asarray(c["x"]), c["jwf"],
                                             c["jgeo"])
    y = y + jnp.asarray(c["b"])[None, :, None, None]
    return jax.nn.relu(y) if relu else y


# (H, W, M, N, alpha, blocks (block_m, block_p)): test_fused_spectral.py's
# pruned case and a ragged dense one
PLANE_CASES = [(13, 12, 4, 6, 4.0, (4, 16)), (11, 13, 3, 5, 1.0, (8, 8))]


@pytest.mark.parametrize("flow", fsc.FLOWS)
@pytest.mark.parametrize("shape", PLANE_CASES)
def test_plane_wrapper_matches_reference(shape, flow):
    h, w, cin, cout, alpha, (bm, bp) = shape
    c = case(h, w, cin, cout, alpha)
    x, b = torch.from_numpy(c["x"]), torch.from_numpy(c["b"])
    kw = dict(flow=flow, block_m=bm, block_p=bp, bias=b, relu=True)
    y = fsc.fused_spectral_conv2d(x, c["wf"], c["geo"], **kw)
    jy = jfsc.fused_spectral_conv2d(
        jnp.asarray(c["x"]), c["jwf"], c["jgeo"], flow=flow, block_n=4,
        block_m=bm, block_p=bp, bias=jnp.asarray(c["b"]), relu=True)
    assert_abs(y, jy)
    halo = fsc.fused_spectral_conv2d(x, c["wf"], c["geo"],
                                     input_mode="halo", **kw)
    assert_abs(halo, y.numpy())
    assert_abs(halo, jy)
    assert_abs(halo, oracle(c, relu=True))


@pytest.mark.parametrize("flow", fsc.FLOWS)
@pytest.mark.parametrize("alpha", [2.0, 4.0])
def test_scheduled_wrapper_matches_reference(alpha, flow):
    """test_scheduled_fused.py's case: n_par 4, r 6 (the plain version
    takes any group size)."""
    c = case(13, 12, 4, 6, alpha)
    x, b = torch.from_numpy(c["x"]), torch.from_numpy(c["b"])
    kw = dict(n_par=4, r=6, flow=flow, block_m=2, block_p=8, bias=b,
              relu=True)
    y = fsc.fused_spectral_conv2d_scheduled(x, c["wf"], c["geo"], **kw)
    jy = jfsc.fused_spectral_conv2d_scheduled(
        jnp.asarray(c["x"]), c["jwf"], c["jgeo"], n_par=4, r=6, flow=flow,
        block_m=2, block_p=8, bias=jnp.asarray(c["b"]), relu=True)
    assert_abs(y, jy)
    halo = fsc.fused_spectral_conv2d_scheduled(x, c["wf"], c["geo"],
                                               input_mode="halo", **kw)
    assert_abs(halo, y.numpy())
    assert_abs(halo, oracle(c, relu=True))


def test_scheduled_group_remainder_and_oversized_blocks():
    """c_out not a multiple of n_par; blocks larger than the layer."""
    c = case(13, 12, 4, 7, 4.0, seed=9)
    x, b = torch.from_numpy(c["x"]), torch.from_numpy(c["b"])
    y = fsc.fused_spectral_conv2d_scheduled(
        x, c["wf"], c["geo"], n_par=3, r=6, block_m=512, block_p=512,
        bias=b)
    jy = jfsc.fused_spectral_conv2d_scheduled(
        jnp.asarray(c["x"]), c["jwf"], c["jgeo"], n_par=3, r=6,
        block_m=512, block_p=512, bias=jnp.asarray(c["b"]))
    assert_abs(y, jy)
    assert_abs(y, oracle(c, relu=False))


def test_tables_argument_and_method():
    """Precompiled tables (any channel padding) give the wrapper's own
    result bit for bit; another scheduler gives the same function."""
    c = case(12, 12, 5, 6, 4.0, seed=4)
    x = torch.from_numpy(c["x"])
    sk, geo = c["wf"], c["geo"]
    y = fsc.fused_spectral_conv2d_scheduled(x, sk, geo, n_par=6, r=6)
    active = sp.compacted_active_bins(sk, pad_to=fsc.BIN_CHUNK)
    lt = sch.compile_layer_tables(
        sk.indices.numpy(), sk.values.reshape(6, 5, 64).numpy(), 64, 6, 6,
        active=active, m_pad_to=4)
    assert lt.m_pad == 8
    assert torch.equal(fsc.fused_spectral_conv2d_scheduled(
        x, sk, geo, tables=lt), y)
    for method in ("lowest_index", "random"):
        assert_abs(fsc.fused_spectral_conv2d_scheduled(
            x, sk, geo, n_par=6, r=6, method=method), y.numpy())


def test_block_n_has_no_effect_and_block_m_snaps():
    c = case(12, 12, 3, 5, 4.0, seed=6)
    x = torch.from_numpy(c["x"])
    ys = [fsc.fused_spectral_conv2d(x, c["wf"], c["geo"], block_n=bn,
                                    flow=fsc.IS)
          for bn in (1, 4, 512)]
    assert all(torch.equal(y, ys[0]) for y in ys[1:])
    assert fsc.one_call_flow_block_m("plane", fsc.OS, 64) is None
    assert fsc.one_call_flow_block_m("plane", fsc.WS, 64) == 48
    assert fsc.one_call_flow_block_m("plane", fsc.IS, 64) == 64
    assert fsc.one_call_flow_block_m("plane", fsc.IS, 2) == 8
    assert fsc.one_call_flow_block_m("scheduled", fsc.WS, 64) == 12
    assert fsc.one_call_flow_block_m("scheduled", fsc.IS, 20) == 16
    with pytest.raises(ValueError):
        fsc.one_call_flow_block_m("plane", "diagonal", 8)


def test_argument_errors():
    c = case(12, 12, 3, 5, 4.0)
    x = torch.from_numpy(c["x"])
    with pytest.raises(ValueError, match="input_mode"):
        fsc.fused_spectral_conv2d(x, c["wf"], c["geo"], input_mode="tiles")
    with pytest.raises(ValueError, match="input_mode"):
        fsc.fused_spectral_conv2d_scheduled(x, c["wf"], c["geo"],
                                            input_mode="tiles")
    with pytest.raises(ValueError, match="K = 8"):
        fsc.fused_spectral_conv2d(x, c["wf"],
                                  spec.make_geometry(12, 12, 3, 16))


def test_cuda_group_size_rule():
    """On a CUDA device the scheduled kernel's group is min(64, N) lanes:
    any other n_par (or tables of another group) raises naming 64, before
    anything is compiled or moved; the plain version's device takes
    any."""
    c = case(6, 6, 2, 70, 4.0, batch=1)
    sk, geo = c["wf"], c["geo"]
    cuda = torch.device("cuda", 0)
    for n_par in (16, 70, 128):
        with pytest.raises(ValueError, match="64"):
            fsc.one_call_scheduled_operands(sk, geo, n_par=n_par,
                                            device=cuda)
    small = case(6, 6, 2, 6, 4.0, batch=1)["wf"]
    with pytest.raises(ValueError, match="64"):
        fsc.one_call_scheduled_operands(small, geo, n_par=4, device=cuda)
    lt = sch.compile_layer_tables(
        sk.indices.numpy(), sk.values.reshape(70, 2, 64).numpy(), 64, 10, 35)
    with pytest.raises(ValueError, match="64"):
        fsc.one_call_scheduled_operands(sk, geo, tables=lt, device=cuda)
    tabs = fsc.one_call_scheduled_operands(sk, geo, n_par=35, device="cpu")[0]
    assert tabs.sel.shape[3] == 35 and tabs.idx.shape[0] == 2


# ---------------------------------------------------------------------------
# SMOKE VGG16: the wrappers against execute_layer_plan and the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """Port plans (bin and scheduled, windowed and halo) on the
    reference's SMOKE weights, and those weights."""
    jparams = jcnn.init(jax.random.PRNGKey(0), JAX_SMOKE)
    params = params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                               "cpu")
    plans = {}
    for hadamard in ("bin", "scheduled"):
        plan = pl.build_network_plan(params, SMOKE, batch=1,
                                     hadamard=hadamard, device="cpu")
        plans[(hadamard, "windowed")] = plan
        plans[(hadamard, "halo")] = pl.with_input_mode(plan, "halo")
    return dict(plans=plans, jparams=jparams)


@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
@pytest.mark.parametrize("input_mode", ["windowed", "halo"])
def test_smoke_layers_equal_plan_path(smoke, hadamard, input_mode):
    """Every SMOKE layer: the wrapper on the plan's pruned kernels, bias
    and epilogue is ``execute_layer_plan`` bit for bit."""
    plan = smoke["plans"][(hadamard, input_mode)]
    rng = np.random.default_rng(1)
    for lp in plan.layers:
        layer = lp.layer
        x = torch.from_numpy(rng.standard_normal(
            (1, layer.c_in, layer.h_in, layer.w_in)).astype(np.float32))
        kw = dict(bias=lp.bias, relu=lp.epilogue.relu, input_mode=input_mode)
        if hadamard == "scheduled":
            y = fsc.fused_spectral_conv2d_scheduled(x, lp.kernels, lp.geo,
                                                    **kw)
        else:
            y = fsc.fused_spectral_conv2d(x, lp.kernels, lp.geo, **kw)
        assert torch.equal(y, fsc.execute_layer_plan(x, lp)), layer.name


@pytest.mark.parametrize("index", [1, 2, 7])
def test_smoke_layers_match_reference_wrappers(smoke, index):
    """SMOKE conv1_2 / conv2_1 / conv4_1 at batch 2 with the reference's
    weights and pruning: both port wrappers (windowed and halo) against
    the reference's windowed wrappers."""
    layer = JAX_SMOKE.layers[index]
    jw = jspec.spectral_kernel(smoke["jparams"]["convs"][index]["w"], 8)
    jsk = jsp.prune_magnitude(jw, 4.0)
    sk = sp.prune_magnitude(spec.spectral_kernel(torch.from_numpy(
        np.array(smoke["jparams"]["convs"][index]["w"])), 8), 4.0)
    geo = spec.make_geometry(layer.h_in, layer.w_in, 3, 8)
    jgeo = jspec.make_geometry(layer.h_in, layer.w_in, 3, 8)
    x = np.random.default_rng(index).standard_normal(
        (2, layer.c_in, layer.h_in, layer.w_in)).astype(np.float32)
    jy = jfsc.fused_spectral_conv2d(jnp.asarray(x), jsk, jgeo, relu=True)
    jys = jfsc.fused_spectral_conv2d_scheduled(jnp.asarray(x), jsk, jgeo,
                                               relu=True)
    for mode in ("windowed", "halo"):
        assert_abs(fsc.fused_spectral_conv2d(
            torch.from_numpy(x), sk, geo, relu=True, input_mode=mode), jy)
        assert_abs(fsc.fused_spectral_conv2d_scheduled(
            torch.from_numpy(x), sk, geo, relu=True, input_mode=mode), jys)

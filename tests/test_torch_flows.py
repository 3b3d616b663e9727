"""repro_torch weight- and input-stationary flows == repro's flow kernels.

The same numpy operands go through the port's kernel wrappers with
``flow=`` (their plain PyTorch versions on CPU tensors: each m range's
partial IFFT, summed over ranges in ascending order, then the epilogue)
and the reference's ``fused_spectral_pipeline(flow=...)`` /
``fused_spectral_pipeline_scheduled(flow=...)`` in interpret mode at the
same m-range width; SMOKE logits through plans moved to a flow
(``with_flow``) and through ``hadamard="auto", input_mode="auto"`` plans
are held to the reference's einsum oracle (alpha 4) and
``forward_spatial`` (alpha 1).  Tolerance: max|port - jax| <= 1e-5 *
max|jax|.  The CUDA kernels run only on a card (``test_torch_gpu.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vgg16_spectral import SMOKE as JAX_SMOKE
from repro.core import plan as jpl
from repro.core import scheduler as jsch
from repro.kernels import fused_spectral_conv as jfsc
from repro.models import cnn as jcnn
from repro_torch.configs.vgg16_spectral import SMOKE
from repro_torch.core import plan as pl
from repro_torch.core import spectral as spec
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import fused_spectral_conv as fsc
from repro_torch.models import cnn

REL_TOL = 1e-5
WS, IS = "weight_stationary", "input_stationary"


def assert_rel(port, ref, tol=REL_TOL):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def plane_operands(s, m, p, fa, n, s2, seed):
    rng = np.random.default_rng(seed)
    shapes = [(s, m, p), (fa, n, m), (fa, n, m), (fa, s), (fa, s),
              (s2, fa), (s2, fa), (1, n)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


@pytest.mark.parametrize("flow", [WS, IS])
@pytest.mark.parametrize("s,m,p,fa,n,s2,block_m", [
    (64, 5, 21, 64, 6, 36, 8),       # one m range
    (64, 20, 13, 24, 9, 36, 8),      # three ranges, the last ragged
    (64, 33, 9, 16, 5, 16, 16),      # three ranges of 16, k = 5
])
def test_plane_flow_plain_matches_jax_kernel(s, m, p, fa, n, s2, block_m,
                                             flow):
    ops = plane_operands(s, m, p, fa, n, s2, seed=m + p)
    for relu in (False, True):
        port = fsc.fused_spectral_pipeline(
            *map(torch.from_numpy, ops), relu=relu, flow=flow,
            block_m=block_m)
        ref = jfsc.fused_spectral_pipeline(
            *map(jnp.asarray, ops), flow=flow, block_n=8, block_m=block_m,
            block_p=8, relu=relu, interpret=True)
        assert_rel(port, ref)


def table_operands(s, m, p, n, fa, s2, n_par, *, m_pad_to, seed, r=6):
    """Windows, reference Alg-2 tables of random kernels on ``fa`` active
    bins (channels padded to ``m_pad_to``), operators and bias."""
    rng = np.random.default_rng(seed)
    active = np.sort(rng.choice(s, fa, replace=False))
    nnz = max(1, fa // 4)
    ind = np.sort(np.stack([[rng.choice(active, nnz, replace=False)
                             for _ in range(m)] for _ in range(n)]),
                  axis=-1).astype(np.int32)
    vals = np.zeros((n, m, s), np.complex64)
    np.put_along_axis(vals, ind.astype(np.int64),
                      (rng.standard_normal((n, m, nnz)) + 1j
                       * rng.standard_normal((n, m, nnz))).astype(
                          np.complex64), axis=-1)
    lt = jsch.compile_layer_tables(ind, vals, s, r, n_par,
                                   active=active if fa < s else None,
                                   m_pad_to=m_pad_to)
    f32 = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return [f32(s, m, p), lt.idx, lt.sel, lt.vr, lt.vi, f32(fa, s),
            f32(fa, s), f32(s2, fa), f32(s2, fa), f32(1, n)]


@pytest.mark.parametrize("flow,block_m", [(WS, 1), (WS, 3), (IS, 2),
                                          (IS, 4)])
@pytest.mark.parametrize("s,m,p,n,fa,s2,n_par", [
    (64, 6, 13, 9, 64, 36, 4),       # group remainder
    (64, 7, 9, 8, 24, 16, 8),        # Fa < K^2, k = 5
])
def test_scheduled_flow_plain_matches_jax_kernel(s, m, p, n, fa, s2, n_par,
                                                 flow, block_m):
    ops = table_operands(s, m, p, n, fa, s2, n_par, m_pad_to=block_m,
                         seed=m + n + block_m)
    for relu in (False, True):
        port = fsc.fused_spectral_pipeline_scheduled(
            *map(torch.from_numpy, ops), n_out=n, relu=relu, flow=flow,
            block_m=block_m)
        ref = jfsc.fused_spectral_pipeline_scheduled(
            *map(jnp.asarray, ops), n_out=n, flow=flow, block_m=block_m,
            block_p=8, relu=relu, interpret=True)
        assert_rel(port, ref)


@pytest.mark.parametrize("flow", ["output_stationary", WS, IS])
def test_one_range_flow_equals_output_stationary(flow):
    """With one m range a flow's sum order is output-stationary's."""
    ops = [torch.from_numpy(a) for a in
           plane_operands(64, 7, 11, 64, 5, 36, seed=3)]
    y = fsc.fused_spectral_pipeline(*ops, relu=True, flow=flow, block_m=8)
    assert torch.equal(y, fsc.fused_spectral_pipeline(*ops, relu=True))


@pytest.mark.parametrize("flow,block_m", [(WS, 16), (IS, 8)])
@pytest.mark.parametrize("h,w,b,m,block_p", [(13, 12, 2, 19, 16),
                                             (20, 17, 1, 9, 5)])
def test_halo_flow_plain_equals_windowed(h, w, b, m, block_p, flow,
                                         block_m):
    """The halo plain versions equal the windowed ones of the same flow
    bit for bit (the gather is exact; the reference's own halo kernel
    does not run on this jax)."""
    geo = spec.make_geometry(h, w, 3, 8)
    hg = spec.halo_block_geometry(geo, block_p)
    rng = np.random.default_rng(h + m)
    x = torch.from_numpy(rng.standard_normal((b, m, h, w)).astype(
        np.float32))
    n, fa = 6, 24
    ops = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
           for sh in [(fa, n, m), (fa, n, m), (fa, 64), (fa, 64), (36, fa),
                      (36, fa), (1, n)]]
    y = fsc.fused_spectral_pipeline_halo(x, *ops, geo=geo, hg=hg, relu=True,
                                         flow=flow, block_m=block_m)
    xt, t_cnt = fsc._windows_layout(x, geo)
    yw = fsc._assemble_output(fsc.fused_spectral_pipeline(
        xt, *ops, relu=True, flow=flow, block_m=block_m), geo, b, n, t_cnt,
        x.dtype)
    assert torch.equal(y, yw)

    tabs = table_operands(64, m, 1, n, fa, 36, 4, m_pad_to=1, seed=m)[1:5]
    sops = [torch.from_numpy(a) for a in tabs] + ops[2:]
    sb = 3 if flow == WS else 4
    y = fsc.fused_spectral_pipeline_scheduled_halo(
        x, *sops, geo=geo, hg=spec.halo_block_geometry(geo, 4), n_out=n,
        relu=True, flow=flow, block_m=sb)
    yw = fsc._assemble_output(fsc.fused_spectral_pipeline_scheduled(
        xt, *sops, n_out=n, relu=True, flow=flow, block_m=sb), geo, b, n,
        t_cnt, x.dtype)
    assert torch.equal(y, yw)


@pytest.mark.parametrize("case", ["flow", "plane_width", "sched_width",
                                  "missing_width"])
def test_flow_arguments_checked(case):
    ops = [torch.from_numpy(a) for a in
           plane_operands(64, 7, 11, 64, 5, 36, seed=4)]
    kw = {"flow": {"flow": "row_stationary", "block_m": 8},
          "plane_width": {"flow": WS, "block_m": 12},
          "missing_width": {"flow": IS}}.get(case)
    before = dict(fsc.LAUNCHES)
    with pytest.raises(ValueError):
        if case == "sched_width":
            t = table_operands(64, 7, 11, 5, 64, 36, 4, m_pad_to=1,
                               seed=4)
            fsc.fused_spectral_pipeline_scheduled(
                *map(torch.from_numpy, t), n_out=5, relu=True, flow=WS,
                block_m=0)
        else:
            fsc.fused_spectral_pipeline(*ops, relu=True, **kw)
    assert fsc.LAUNCHES == before


def test_entry_points_and_launch_keys():
    """Twelve (kernel, flow) entry points, each counted on its own."""
    names = {fsc.entry_point(k, f) for k in fsc.KERNELS for f in fsc.FLOWS}
    assert len(names) == 12 and set(fsc.LAUNCHES) == names
    assert fsc.entry_point("fused_spectral_pipeline_halo", IS) == \
        "fused_spectral_pipeline_halo_is"


# ---------------------------------------------------------------------------
# SMOKE network: forced-flow and autotuned plans against the oracles
# ---------------------------------------------------------------------------

def jax_params(seed, cfg):
    jparams = jcnn.init(jax.random.PRNGKey(seed), cfg)
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.array, jparams), "cpu")


@pytest.fixture(scope="module")
def smoke():
    jparams, params = jax_params(3, JAX_SMOKE)
    jplan = jpl.build_network_plan(jparams, JAX_SMOKE, batch=2,
                                   input_mode="windowed", hadamard="bin")
    x = np.random.default_rng(5).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    ref = jcnn.forward_spectral(jparams, jplan, jnp.asarray(x),
                                backend="einsum")
    return dict(params=params, x=torch.from_numpy(x), ref=np.asarray(ref))


@pytest.mark.parametrize("flow", [WS, IS])
@pytest.mark.parametrize("hadamard,input_mode", [
    ("bin", "windowed"), ("scheduled", "windowed"), ("bin", "halo"),
    ("scheduled", "halo")])
def test_with_flow_smoke_logits_match_reference_einsum(smoke, hadamard,
                                                       input_mode, flow):
    plan = pl.build_network_plan(smoke["params"], SMOKE, batch=2,
                                 hadamard=hadamard, input_mode=input_mode,
                                 device="cpu")
    moved = pl.with_flow(plan, flow)
    for a, b in zip(plan.layers, moved.layers):      # nothing rebuilt
        assert b.tuning.flow == flow and b.hadamard == a.hadamard
        assert b.input_mode == a.input_mode == input_mode
        assert a.wr is b.wr and a.tables is b.tables
    out = cnn.forward_spectral(smoke["params"], moved, smoke["x"],
                               backend="fused")
    assert_rel(out, smoke["ref"])


def test_auto_plan_smoke_logits_match_reference_einsum(smoke):
    plan = pl.build_network_plan(smoke["params"], SMOKE, batch=2,
                                 hadamard="auto", input_mode="auto",
                                 device="cpu")
    for lp in plan.layers:
        assert lp.tuning.hadamard == lp.hadamard in ("dense", "bin",
                                                     "scheduled")
        assert lp.tuning.input_mode == lp.input_mode in ("windowed", "halo")
        assert (lp.tables is not None) == (lp.hadamard == "scheduled")
        assert lp.tuning.predicted_s > 0
    out = cnn.forward_spectral(smoke["params"], plan, smoke["x"],
                               backend="fused")
    assert_rel(out, smoke["ref"])


@pytest.mark.parametrize("flow", ["auto", WS, IS])
def test_alpha1_flow_logits_match_forward_spatial(flow):
    """alpha 1 (dense, no tables): the auto plan (which mixes input
    paths) and the plan moved to each split-K flow."""
    jcfg = dataclasses.replace(JAX_SMOKE, alpha=1.0)
    cfg = dataclasses.replace(SMOKE, alpha=1.0)
    jparams, params = jax_params(4, jcfg)
    plan = pl.build_network_plan(params, cfg, batch=2, hadamard="auto",
                                 input_mode="auto", device="cpu")
    if flow != "auto":
        plan = pl.with_flow(plan, flow)
        assert all(lp.tuning.flow == flow for lp in plan.layers)
    assert all(lp.hadamard == "dense" for lp in plan.layers)
    x = np.random.default_rng(6).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    out = cnn.forward_spectral(params, plan, torch.from_numpy(x),
                               backend="fused")
    assert_rel(out, jcnn.forward_spatial(jparams, jcfg, jnp.asarray(x)))

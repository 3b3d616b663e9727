"""repro_torch scheduled fused conv == repro's scheduled Pallas kernel.

The same Alg-2 tables and numpy operands go through the port's
``fused_spectral_pipeline_scheduled`` (its plain PyTorch version on CPU
tensors) and the reference's kernel (interpret mode); every SMOKE layer
runs through both ``execute_layer_plan``s on ``hadamard='scheduled'``
plans built from the same weights, and the SMOKE logits are held to the
reference's ``pallas_fused`` and ``einsum`` backends.  Tolerance:
max|port - jax| <= 1e-5 * max|jax|.  The CUDA kernel itself runs only
on a card: ``test_torch_gpu.py`` holds it to the plain version there.
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
from repro_torch.core import scheduler as sch
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import fused_spectral_conv as fsc
from repro_torch.models import cnn

REL_TOL = 1e-5


def assert_rel(port, ref, tol=REL_TOL):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def scheduled_operands(s, m, p, n, fa, s2, n_par, *, r=6, m_pad_to=1,
                       alpha=4.0, seed=0, pad_cycles=1):
    """Windows, Alg-2 tables (compiled by the reference scheduler on
    random kernels supported on ``fa`` active bins, then padded with
    ``pad_cycles`` all-zero cycles), operators, bias."""
    rng = np.random.default_rng(seed)
    active = np.sort(rng.choice(s, fa, replace=False))
    nnz = max(1, int(round(fa / alpha)))
    ind = np.sort(np.stack([[rng.choice(active, nnz, replace=False)
                             for _ in range(m)] for _ in range(n)]),
                  axis=-1).astype(np.int32)
    vals = np.zeros((n, m, s), np.complex64)
    np.put_along_axis(vals, ind.astype(np.int64),
                      (rng.standard_normal((n, m, nnz)) + 1j
                       * rng.standard_normal((n, m, nnz))).astype(
                          np.complex64), axis=-1)
    lt = jsch.compile_layer_tables(
        ind, vals, s, r, n_par, active=active if fa < s else None,
        m_pad_to=m_pad_to)
    pad = lambda a: np.pad(a, ((0, 0), (0, 0), (0, pad_cycles), (0, 0)))
    f32 = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return dict(xt=f32(s, m, p), idx=pad(lt.idx), sel=pad(lt.sel),
                vr=pad(lt.vr), vi=pad(lt.vi), dfr=f32(fa, s), dfi=f32(fa, s),
                dvr=f32(s2, fa), dvi=f32(s2, fa), bias=f32(1, n))


ORDER = ("xt", "idx", "sel", "vr", "vi", "dfr", "dfi", "dvr", "dvi",
         "bias")


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("s,m,p,n,fa,s2,n_par,m_pad_to", [
    (64, 5, 37, 16, 64, 36, 8, 1),     # dense bins, two full groups
    (64, 4, 20, 7, 64, 36, 3, 2),      # group remainder, padded channels
    (64, 3, 12, 9, 24, 36, 4, 1),      # Fa < K^2 (compacted coordinates)
    (64, 6, 9, 5, 60, 16, 5, 4),       # Fa not a multiple of 8; t = 4
])
def test_reference_matches_jax_kernel(s, m, p, n, fa, s2, n_par, m_pad_to,
                                      relu):
    ops = scheduled_operands(s, m, p, n, fa, s2, n_par, m_pad_to=m_pad_to,
                             seed=s + m + p + n)
    port = fsc.fused_spectral_pipeline_scheduled(
        *(torch.from_numpy(ops[k]) for k in ORDER), n_out=n, relu=relu)
    ref = jfsc.fused_spectral_pipeline_scheduled(
        *(jnp.asarray(ops[k]) for k in ORDER), n_out=n,
        flow="output_stationary", block_m=m_pad_to, block_p=8, relu=relu,
        interpret=True)
    assert_rel(port, ref)


def test_cpu_tensor_takes_plain_version():
    ops = scheduled_operands(64, 3, 9, 6, 64, 36, 4, seed=1)
    args = [torch.from_numpy(ops[k]) for k in ORDER]
    before = dict(fsc.LAUNCHES)
    y = fsc.fused_spectral_pipeline_scheduled(*args, n_out=6, relu=True)
    assert fsc.LAUNCHES == before
    torch.testing.assert_close(
        y, fsc.fused_spectral_pipeline_scheduled_reference(
            *args, n_out=6, relu=True), rtol=0, atol=0)


@pytest.mark.parametrize("case", ["dtype", "shape", "lanes", "n_out",
                                  "channels", "bins", "contiguous"])
def test_scheduled_operand_checks(case):
    ops = {k: torch.from_numpy(v) for k, v in
           scheduled_operands(64, 3, 9, 6, 64, 36, 4, seed=2).items()}
    fsc._check_scheduled_operands(*(ops[k] for k in ORDER), 6)
    n_out = 6
    if case == "dtype":
        ops["sel"] = ops["sel"].long()
    elif case == "shape":
        ops["vi"] = ops["vi"][..., :3].contiguous()
    elif case == "lanes":              # more lanes than the kernel's block
        for k in ("sel", "vr", "vi"):
            ops[k] = torch.zeros(ops[k].shape[:3] + (65,),
                                 dtype=ops[k].dtype)
    elif case == "n_out":              # leaves a whole group empty
        n_out = 4
        ops["bias"] = ops["bias"][:, :4]
    elif case == "channels":           # tables for fewer channels
        for k in ("idx", "sel", "vr", "vi"):
            ops[k] = ops[k][:, :2].contiguous()
    elif case == "bins":               # more bins than one cluster
        ops["dfr"] = ops["dfi"] = torch.zeros(72, 64)
        ops["dvr"] = ops["dvi"] = torch.zeros(36, 72)
    else:
        ops["vr"] = ops["vr"].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        fsc._check_scheduled_operands(*(ops[k] for k in ORDER), n_out)


def jax_params(seed=0, cfg=JAX_SMOKE):
    jparams = jcnn.init(jax.random.PRNGKey(seed), cfg)
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.array, jparams), "cpu")


@pytest.fixture(scope="module")
def scheduled_plans():
    jparams, params = jax_params(1)
    jplan = jpl.build_network_plan(jparams, JAX_SMOKE, batch=2,
                                   input_mode="windowed",
                                   hadamard="scheduled")
    plan = pl.build_network_plan(params, SMOKE, batch=2,
                                 hadamard="scheduled", device="cpu")
    return dict(jparams=jparams, params=params, jplan=jplan, plan=plan)


@pytest.mark.parametrize("index", range(len(SMOKE.layers)))
def test_execute_layer_plan_smoke_layers(scheduled_plans, index):
    lp = scheduled_plans["plan"].layers[index]
    jlp = scheduled_plans["jplan"].layers[index]
    assert lp.hadamard == jlp.hadamard == "scheduled"
    assert lp.tuning.flow == "output_stationary"
    assert lp.tables is not None and lp.schedule_cycles > 0
    assert 0.0 < lp.pe_utilization <= 1.0
    layer = lp.layer
    x = np.random.default_rng(index).standard_normal(
        (2, layer.c_in, layer.h_in, layer.w_in)).astype(np.float32)
    port = fsc.execute_layer_plan(torch.from_numpy(x), lp)
    ref = jfsc.execute_layer_plan(jnp.asarray(x), jlp, interpret=True)
    assert_rel(port, ref)


def test_smoke_logits_match_reference(scheduled_plans):
    sp_ = scheduled_plans
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    out = cnn.forward_spectral(sp_["params"], sp_["plan"],
                               torch.from_numpy(x), backend="fused")
    for backend in ("pallas_fused", "einsum"):
        ref = jcnn.forward_spectral(sp_["jparams"], sp_["jplan"],
                                    jnp.asarray(x), backend=backend)
        assert_rel(out, ref)


def used_entries(idx, sel, live):
    """[..., T, r] mask of the INDEX entries some live lane reads."""
    r = idx.shape[-1]
    onehot = sel[..., None] == np.arange(r)             # [..., T, N', r]
    return (onehot & live[..., None]).any(axis=-2)


@pytest.mark.parametrize("alpha", [4.0, 32.0])
def test_plan_tables_equal_reference_compile(alpha):
    """The plan's tables are the reference scheduler's, called with the
    port's group size, channel padding and active bins; and, in absolute
    bin coordinates, those of a compile without compaction (alpha 32
    compacts the first three SMOKE layers)."""
    cfg = dataclasses.replace(SMOKE, alpha=alpha)
    _, params = jax_params(2)
    plan = pl.build_network_plan(params, cfg, hadamard="scheduled",
                                 device="cpu")
    assert (alpha == 32.0) == any(lp.active is not None
                                  for lp in plan.layers)
    for lp in plan.layers:
        layer, k2 = lp.layer, 64
        assert lp.tuning.block_n == min(fsc.SCHED_BLOCK_N, layer.c_out)
        assert lp.tuning.block_m == fsc.SCHED_BLOCK_M
        args = (lp.kernels.indices.numpy(),
                lp.kernels.values.reshape(layer.c_out, layer.c_in,
                                          k2).numpy(),
                k2, 10, lp.tuning.block_n)
        ref = jsch.compile_layer_tables(*args, active=lp.active,
                                        m_pad_to=lp.tuning.block_m)
        tb = {k: getattr(lp.tables, k).numpy() for k in ORDER[1:5]}
        for name in ("idx", "sel", "vr", "vi"):
            assert np.array_equal(tb[name], getattr(ref, name)), name
        assert lp.schedule_cycles == ref.total_cycles
        assert lp.pe_utilization == ref.pe_utilization
        absolute = jsch.compile_layer_tables(*args,
                                             m_pad_to=lp.tuning.block_m)
        live = (tb["vr"] != 0) | (tb["vi"] != 0)
        used = used_entries(tb["idx"], tb["sel"], live)
        port_abs = (tb["idx"] if lp.active is None
                    else np.asarray(lp.active)[tb["idx"]])
        assert np.array_equal(port_abs[used], absolute.idx[used])
        assert np.array_equal(used, used_entries(absolute.idx, absolute.sel,
                                                 live))


def test_per_layer_alpha_falls_back_to_planes():
    """alpha 1 layers cannot be scheduled: they take the plane kernel
    (dense, no tables) and the rest the scheduled one, as in the
    reference; logits agree with both packages' einsum oracles."""
    alphas = (1.0, 2.0) + (4.0,) * 11
    jcfg = dataclasses.replace(JAX_SMOKE, alpha=alphas)
    cfg = dataclasses.replace(SMOKE, alpha=alphas)
    jparams, params = jax_params(3, jcfg)
    plan = pl.build_network_plan(params, cfg, batch=1, hadamard="scheduled",
                                 device="cpu")
    assert plan.layers[0].hadamard == "dense"
    assert plan.layers[0].tables is None
    assert plan.layers[0].schedule_cycles is None
    assert all(lp.hadamard == "scheduled" and lp.tables is not None
               for lp in plan.layers[1:])
    jplan = jpl.build_network_plan(jparams, jcfg, batch=1,
                                   input_mode="windowed",
                                   hadamard="scheduled")
    assert [lp.hadamard for lp in jplan.layers] == \
        [lp.hadamard for lp in plan.layers]
    x = np.random.default_rng(1).standard_normal((1, 3, 32, 32)).astype(
        np.float32)
    out = cnn.forward_spectral(params, plan, torch.from_numpy(x),
                               backend="fused")
    assert_rel(out, cnn.forward_spectral(params, plan, torch.from_numpy(x),
                                         backend="einsum"))
    assert_rel(out, jcnn.forward_spectral(jparams, jplan, jnp.asarray(x),
                                          backend="einsum"))


@pytest.mark.parametrize("kwargs", [dict(schedule=False),
                                    dict(schedule=True)])
def test_schedule_flag_and_sampled_stats(kwargs):
    """schedule=False turns the scheduled request into the plane path
    with no stats; schedule=True gives plane plans sampled stats equal to
    the reference's."""
    _, params = jax_params(4)
    plan = pl.build_network_plan(params, SMOKE, hadamard="scheduled"
                                 if not kwargs["schedule"] else "bin",
                                 device="cpu", **kwargs)
    jparams = jcnn.init(jax.random.PRNGKey(4), JAX_SMOKE)
    jplan = jpl.build_network_plan(jparams, JAX_SMOKE, input_mode="windowed",
                                   hadamard="bin", **kwargs)
    for lp, jlp in zip(plan.layers, jplan.layers):
        assert lp.hadamard in ("dense", "bin") and lp.tables is None
        assert lp.schedule_cycles == jlp.schedule_cycles
        assert lp.pe_utilization == jlp.pe_utilization


def test_no_scheduling_inside_a_forward(scheduled_plans, monkeypatch):
    """Compile once: a forward on a scheduled plan runs no scheduler."""
    def boom(*a, **k):
        raise AssertionError("scheduler ran inside a forward")
    for name in ("schedule_exact_cover", "build_tables",
                 "compile_layer_tables", "_schedule_block"):
        monkeypatch.setattr(sch, name, boom)
    monkeypatch.setitem(sch.SCHEDULERS, "exact_cover", boom)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    out = cnn.forward_spectral(scheduled_plans["params"],
                               scheduled_plans["plan"], x, backend="fused")
    assert out.shape == (2, SMOKE.n_classes) and torch.isfinite(out).all()

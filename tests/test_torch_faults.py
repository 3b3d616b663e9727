"""repro_torch's degradation ladder under injected faults, held to the
reference's (``tests/test_faults.py``, the resilience cases of
``tests/test_dag_plan.py`` and ``tests/test_sharded_plan.py``).

Under any single injected fault the port's forward either returns logits
within 1e-5 of the reference's einsum oracle (the reference's own TOL)
through a demoted plan, or raises a structured ``ResilienceError``
naming the layer and the site.  Both packages harden plans built from the
same weights under the same fault and must take the same rungs.  The
reference may build halo plans but never executes one here (its halo
kernel does not run on this tree's jax): its probes stop at the injected
fault before any halo launch, and the guard tests run on windowed plans.
The port runs its plain versions on the CPU; the sharded ladder runs on a
``(cpu,) * D`` mesh.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import resnet18_spectral as jresnet
from repro.core import dataflow as jdf
from repro.core import plan as jpl
from repro.core import resilience as jres
from repro.models import cnn as jcnn
from repro.testing import faults as jfaults
from repro_torch.configs import resnet18_spectral as resnet
from repro_torch.core import dataflow as df
from repro_torch.core import plan as pl
from repro_torch.core import resilience as res
from repro_torch.distributed import executor as ex
from repro_torch.interop import params_from_numpy
from repro_torch.launch.mesh import make_spectral_mesh
from repro_torch.models import cnn
from repro_torch.testing import faults

TOL = 1e-5
JLAYERS = (jdf.ConvLayer("c1", 3, 8, 32, 32), jdf.ConvLayer("c2", 8, 8, 16, 16),
           jdf.ConvLayer("c3", 8, 8, 8, 8), jdf.ConvLayer("c4", 8, 8, 4, 4),
           jdf.ConvLayer("c5", 8, 8, 2, 2))
POOLS = frozenset({"c1", "c2", "c3", "c4", "c5"})
JCFG = jcnn.SpectralCNNConfig(name="mini-faults", layers=JLAYERS, alpha=4.0,
                              n_classes=4, image_size=32, fc_dim=8,
                              pool_after=POOLS)
CFG = cnn.SpectralCNNConfig(
    name="mini-faults", layers=tuple(df.ConvLayer(l.name, l.c_in, l.c_out,
                                                  l.h_in, l.w_in)
                                     for l in JLAYERS),
    alpha=4.0, n_classes=4, image_size=32, fc_dim=8, pool_after=POOLS)
RESIDUAL_IDS = ("s1b1b", "s1b2b", "s2b1b", "s2b2b")


def port_params(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                             "cpu")


@pytest.fixture(scope="module")
def mini():
    """Both packages' scheduled + halo plans (the most aggressive
    variant) from the reference's weights, the input, and the
    reference's einsum logits (which read the pruned kernels only)."""
    jparams = jcnn.init(jax.random.PRNGKey(0), JCFG)
    params = port_params(jparams)
    kw = dict(batch=1, hadamard="scheduled", input_mode="halo")
    jplan = jcnn.build_plan(jparams, JCFG, **kw)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 3, 32, 32),
                                     jnp.float32))
    return dict(jparams=jparams, params=params, jplan=jplan,
                plan=cnn.build_plan(params, CFG, device="cpu", **kw),
                x=x, tx=torch.from_numpy(x),
                ref=np.asarray(jcnn.forward_spectral(
                    jparams, jplan, jnp.asarray(x), backend="einsum")))


def err(out, ref) -> float:
    return float(np.abs(out.detach().numpy() - np.asarray(ref)).max())


def modes(plan):
    return [(lp.input_mode, lp.hadamard, lp.backend) for lp in plan.layers]


def rungs(plan):
    """Each layer's provenance, the rungs only (the raw error text that
    follows differs between the packages)."""
    return [[p.split(" (")[0] for p in lp.provenance] for lp in plan.layers]


def harden_both(mini, site, **match):
    with faults.inject(site, **match) as fault:
        hard = res.harden_network_plan(mini["plan"])
    with jfaults.inject(site, **match) as jfault:
        jhard = jres.harden_network_plan(mini["jplan"])
    assert fault.fires > 0 and jfault.fires > 0
    assert modes(hard) == modes(jhard)
    assert rungs(hard) == rungs(jhard)
    out = cnn.forward_spectral(mini["params"], hard, mini["tx"],
                               backend="fused")
    assert err(out, mini["ref"]) <= TOL
    return hard


def test_no_fault_leaks_between_tests():
    with faults.inject("lowering") as f:
        assert res._FAULTS
    assert f not in res._FAULTS and not res._FAULTS
    with pytest.raises(ValueError):
        with faults.inject("telepathy"):
            pass


def test_rung1_halo_demotes_to_windowed(mini):
    hard = harden_both(mini, "lowering", input_mode="halo")
    for lp in hard.layers:
        assert (lp.input_mode, lp.backend) == ("windowed", "fused")
        assert lp.provenance[0].startswith("input_mode halo->windowed")
        assert lp.tuning.input_mode == "windowed"


def test_rung2_scheduled_demotes_to_plane(mini):
    hard = harden_both(mini, "lowering", hadamard="scheduled")
    for lp in hard.layers:
        assert lp.hadamard in ("dense", "bin") and lp.tables is None
        assert lp.backend == "fused"
        assert any(p.startswith("hadamard scheduled->")
                   for p in lp.provenance)


def test_rung3_fused_demotes_to_staged(mini):
    hard = harden_both(mini, "lowering", backend="fused")
    for lp in hard.layers:
        assert lp.backend == "staged"
        assert lp.provenance[-1].startswith("backend fused->staged")


def test_rung4_terminal_einsum_always_executes(mini):
    """An unmatched lowering fault fails every variant: every layer lands
    on einsum, one recorded rung per applicable rung (no residual here),
    and the forward is the port's own einsum forward exactly."""
    hard = harden_both(mini, "lowering")
    applicable = [r for r in res.DEMOTION_LADDER if r[0] != "epilogue"]
    for lp in hard.layers:
        assert lp.backend == "einsum"
        assert len(lp.provenance) == len(applicable)
    out = cnn.forward_spectral(mini["params"], hard, mini["tx"],
                               backend="fused")
    own = cnn.forward_spectral(mini["params"], mini["plan"], mini["tx"],
                               backend="einsum")
    assert torch.equal(out, own)
    hr = hard.health_report()
    assert hr["healthy"] is False
    assert hr["demoted_layers"] == [lp.layer.name for lp in hard.layers]


def test_vmem_overflow_walks_ladder(mini):
    """A launch refused for its shared memory at the fused dispatch walks
    the fused rungs and settles on staged; the provenance carries the
    card's refusal."""
    hard = harden_both(mini, "vmem_overflow")
    for lp in hard.layers:
        assert lp.backend == "staged"
        assert any("shared memory" in p for p in lp.provenance)


def test_sticky_cuda_error_is_not_demoted(mini):
    """A probe that dies of an illegal memory access leaves the context
    unusable: harden raises KernelLoweringError for the first layer at
    once, the error as its cause, and demotes nothing."""
    cause = RuntimeError("CUDA error: an illegal memory access was "
                         "encountered")
    with faults.inject("lowering", exc=lambda: cause) as fault:
        with pytest.raises(res.KernelLoweringError) as ei:
            res.harden_network_plan(mini["plan"])
    assert fault.fires == 1
    assert ei.value.layer == "c1" and ei.value.site == "harden"
    assert ei.value.__cause__ is cause
    assert res.is_sticky_cuda_error(RuntimeError(
        "fused_spectral_pipeline launch failed: cudaError 716"))
    assert not res.is_sticky_cuda_error(RuntimeError(
        "fused_spectral_pipeline launch failed: cudaError 1"))


def test_oob_index_rejected_at_build(mini):
    """A corrupted INDEX table from schedule compilation (the site runs in
    the building process, once per layer) is refused by build-time
    validation, with the reference's diagnostics."""
    with pytest.raises(res.PlanValidationError) as ei:
        with faults.inject("oob_index") as fault:
            cnn.build_plan(mini["params"], CFG, batch=1,
                           hadamard="scheduled", device="cpu")
    assert fault.fires == len(CFG.layers)
    with pytest.raises(jres.PlanValidationError) as jei:
        with jfaults.inject("oob_index"):
            jcnn.build_plan(mini["jparams"], JCFG, batch=1,
                            hadamard="scheduled")
    got = {(d.layer, d.check) for d in ei.value.diagnostics}
    assert got == {(d.layer, d.check) for d in jei.value.diagnostics}
    assert ("c1", "tables/idx-bounds") in got


@pytest.fixture(scope="module")
def windowed(mini):
    """Windowed scheduled plans of both packages (the reference's guard
    tests execute their plan)."""
    kw = dict(batch=1, hadamard="scheduled", input_mode="windowed")
    return dict(plan=cnn.build_plan(mini["params"], CFG, device="cpu", **kw),
                jplan=jcnn.build_plan(mini["jparams"], JCFG, **kw), kw=kw)


def test_corrupt_value_caught_by_parity_guard(mini, windowed):
    """A finite but wrong VALUE plane sails through validation; the
    sampled parity guard catches it on the same layers as the
    reference's, and under 'demote' the answer stays within TOL."""
    with faults.inject("corrupt_value") as fault:
        bad = cnn.build_plan(mini["params"], CFG, device="cpu",
                             **windowed["kw"])
    assert fault.fires == len(CFG.layers)
    with jfaults.inject("corrupt_value"):
        jbad = jcnn.build_plan(mini["jparams"], JCFG, **windowed["kw"])
    guards = res.NumericGuards(parity=True, policy="demote")
    out = cnn.forward_spectral(mini["params"], bad, mini["tx"],
                               backend="fused", guards=guards)
    jguards = jres.NumericGuards(parity=True, policy="demote")
    jcnn.forward_spectral(mini["jparams"], jbad, jnp.asarray(mini["x"]),
                          backend="pallas_fused", guards=jguards)
    assert guards.events and guards.events[0]["check"] == "parity"
    assert [(e["layer"], e["check"]) for e in guards.events] == \
        [(e["layer"], e["check"]) for e in jguards.events]
    assert err(out, mini["ref"]) <= TOL
    raw = cnn.forward_spectral(mini["params"], bad, mini["tx"],
                               backend="fused")
    assert err(raw, mini["ref"]) > TOL


def test_nan_activations_guard_policies(mini, windowed):
    """The NaN scan names the poisoned layer as the reference's does;
    'demote' recomputes it through the oracle, 'warn' keeps it."""
    g = res.NumericGuards(policy="raise")
    with faults.inject("nan_activations", layer="c2"):
        with pytest.raises(res.NumericGuardError) as ei:
            cnn.forward_spectral(mini["params"], windowed["plan"],
                                 mini["tx"], backend="fused", guards=g)
    jg = jres.NumericGuards(policy="raise")
    with jfaults.inject("nan_activations", layer="c2"):
        with pytest.raises(jres.NumericGuardError) as jei:
            jcnn.forward_spectral(mini["jparams"], windowed["jplan"],
                                  jnp.asarray(mini["x"]),
                                  backend="pallas_fused", guards=jg)
    assert (ei.value.layer, ei.value.site) == (jei.value.layer,
                                               jei.value.site) == (
        "c2", "nan_scan")
    assert [e["layer"] for e in g.events] == ["c2"]

    g2 = res.NumericGuards(policy="demote")
    with faults.inject("nan_activations", layer="c2"):
        out = cnn.forward_spectral(mini["params"], windowed["plan"],
                                   mini["tx"], backend="fused", guards=g2)
    assert [e["layer"] for e in g2.events] == ["c2"]
    assert bool(torch.isfinite(out).all()) and err(out, mini["ref"]) <= TOL

    g3 = res.NumericGuards(policy="warn")
    with faults.inject("nan_activations", layer="c2"):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out3 = cnn.forward_spectral(mini["params"], windowed["plan"],
                                        mini["tx"], backend="fused",
                                        guards=g3)
    assert any("numeric-guard" in str(wi.message) for wi in w)
    assert g3.events and not bool(torch.isfinite(out3).all())


def test_guards_on_the_staged_backend(mini):
    """Guards run on the staged backend too, and a clean forward records
    no event under either guard."""
    g = res.NumericGuards(nan_scan=True, parity=True)
    for backend in ("staged", "fused"):
        out = cnn.forward_spectral(mini["params"], mini["plan"], mini["tx"],
                                   backend=backend, guards=g)
        assert err(out, mini["ref"]) <= TOL
    assert g.events == []


def test_unhardened_fused_failure_is_structured(mini):
    """Without harden_network_plan a failing layer is never demoted: the
    forward raises KernelLoweringError naming it, as the reference's."""
    with faults.inject("lowering", backend="fused"):
        with pytest.raises(res.KernelLoweringError) as ei:
            cnn.forward_spectral(mini["params"], mini["plan"], mini["tx"],
                                 backend="fused")
    assert (ei.value.layer, ei.value.site) == ("c1", "forward")
    for word in ("backend=", "flow=", "hadamard=", "input_mode="):
        assert word in str(ei.value)
    assert isinstance(ei.value.__cause__, RuntimeError)


def test_demotion_repriced_costs_stay_honest(mini):
    """Each fused rung re-prices the tuning through the cost model (the
    numbers change with the variant); the staged and einsum rungs carry
    no fused numbers; nothing lies below einsum."""
    lp = mini["plan"].layers[0]
    demoted = res.demote_layer(lp, reason="test")
    assert demoted.input_mode == demoted.tuning.input_mode == "windowed"
    assert demoted.tuning.hbm_bytes != lp.tuning.hbm_bytes
    assert demoted.provenance[-1] == jres.demote_layer(
        mini["jplan"].layers[0], reason="test").provenance[-1]
    lp_e = demoted
    while (nxt := res.demote_layer(lp_e, reason="test")) is not None:
        lp_e = nxt
        if lp_e.backend == "fused":
            assert lp_e.tuning.predicted_s is not None
        else:
            assert lp_e.tuning.predicted_s is None
    assert lp_e.backend == "einsum"
    assert len(lp_e.provenance) == 4


# ---------------------------------------------------------------------------
# The residual DAG (ResNet-18 SMOKE at alpha 1, against the spatial oracle)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    jcfg = dataclasses.replace(jresnet.SMOKE, alpha=1.0)
    jparams = jcnn.init(jax.random.PRNGKey(0), jcfg)
    x = jax.random.normal(jax.random.PRNGKey(0), (1, 3, 32, 32), jnp.float32)
    params = port_params(jparams)
    return dict(params=params, x=torch.from_numpy(np.asarray(x)),
                plan=pl.build_network_plan(
                    params, dataclasses.replace(resnet.SMOKE, alpha=1.0),
                    batch=1, device="cpu"),
                jplan=jpl.build_network_plan(jparams, jcfg, batch=1,
                                             input_mode="windowed"),
                ref=np.asarray(jcnn.forward_spatial(jparams, jcfg, x)))


def test_residual_demotion_rung_and_parity(dense):
    """A lowering fault on every residual-fused variant moves each
    residual node to the residual-add rung (the reference's rung), and
    the hardened plan answers like the spatial oracle; the health report
    names the nodes."""
    with faults.inject("lowering", residual="fused") as fault:
        hard = res.harden_network_plan(dense["plan"])
    assert fault.fires == len(RESIDUAL_IDS)
    jlp = next(lp for lp in dense["jplan"].layers
               if lp.epilogue.residual == "fused")
    want = jres.demote_layer(jlp, reason="x").provenance[0].split(" (")[0]
    for node in (n for n in hard.graph if n.kind == "conv"):
        lp = hard.layers[node.layer_index]
        if node.residual_from is None:
            assert not lp.provenance
            continue
        assert lp.epilogue.residual == "add" and lp.epilogue.relu is False
        assert [p.split(" (")[0] for p in lp.provenance] == [want]
        assert lp.tuning.residual is None
    out = cnn.forward_spectral(dense["params"], hard, dense["x"],
                               backend="fused")
    assert err(out, dense["ref"]) <= TOL
    hr = hard.health_report()
    assert set(hr["demotions_by_node"]) == set(RESIDUAL_IDS)
    assert [r["node"] for r in hr["layers"]] == [n.id for n in hard.graph]


def test_backend_ladder_flips_residual(dense):
    """Leaving the fused backend moves a residual-fused layer to the 'add'
    rung in the same step, with the reference's provenance."""
    lp = next(lp for lp in dense["plan"].layers
              if lp.epilogue.residual == "fused")
    jlp = next(lp for lp in dense["jplan"].layers
               if lp.epilogue.residual == "fused")
    demoted = res.demote_layer_backend(lp, reason="load test")
    jdemoted = jres.demote_layer_backend(jlp, reason="load test")
    assert demoted.backend == "staged" and demoted.epilogue.residual == "add"
    assert demoted.provenance == jdemoted.provenance
    staged = res.plan_at_backend_rung(dense["plan"], "staged")
    out = cnn.forward_spectral(dense["params"], staged, dense["x"],
                               backend="fused")
    assert err(out, dense["ref"]) <= TOL


# ---------------------------------------------------------------------------
# Sharded plans: shard-scoped faults on a (cpu,) * D mesh
# ---------------------------------------------------------------------------

class JTinyCfg:
    name = "tiny-shard"
    fft_size = 8
    alpha = 4.0
    layers = (jdf.ConvLayer("c1", 4, 8, 16, 16, 3, 1),
              jdf.ConvLayer("c2", 8, 8, 16, 16, 3, 1))
    pool_after = frozenset({"c2"})
    graph = None


class TinyCfg(JTinyCfg):
    layers = tuple(df.ConvLayer(l.name, l.c_in, l.c_out, l.h_in, l.w_in)
                   for l in JTinyCfg.layers)


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
    f32 = lambda *sh, s=0.1: (s * rng.standard_normal(sh)).astype(np.float32)
    npar = {"convs": [{"w": f32(l.c_out, l.c_in, 3, 3), "b": f32(l.c_out)}
                      for l in JTinyCfg.layers],
            "fc1": f32(512, 16, s=0.05), "fc2": f32(16, 16, s=0.05),
            "fc3": f32(16, 4, s=0.05)}
    jparams = jax.tree_util.tree_map(jnp.asarray, npar)
    params = params_from_numpy(npar, "cpu")
    x = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    jbase = jpl.build_network_plan(jparams, JTinyCfg, batch=2,
                                   hadamard="bin", input_mode="windowed")
    build = lambda **kw: pl.build_sharded_network_plan(
        params, TinyCfg, n_shards=2, batch=2, strategies=("channel",),
        device="cpu", **kw)
    return dict(params=params, jparams=jparams, x=torch.from_numpy(x),
                splan=build(), ssplan=build(hadamard="scheduled"),
                mesh=make_spectral_mesh(2, devices=["cpu"] * 2),
                ref=np.asarray(jcnn.forward_spectral(
                    jparams, jbase, jnp.asarray(x), backend="einsum")))


def test_healthy_sharded_plan_hardens_to_itself(tiny):
    out = res.harden_sharded_plan(tiny["splan"])
    assert out is tiny["splan"]
    assert all(not s.provenance for s in out.layers)
    assert not [d for d in res.validate_sharded_plan(tiny["splan"])
                if d.severity == "error"]


def test_injected_shard_fault_demotes_structurally(tiny):
    """A fault on one shard of one layer demotes that layer's base plan
    one rung (the shards rebuilt from it, the shard ladder in the
    provenance); the other layer keeps its strategy; the sharded forward
    stays within TOL of the reference's oracle."""
    splan = tiny["splan"]
    name = splan.layers[0].base.layer.name
    with faults.inject("shard_tables", layer=name, shard=1) as fault:
        out = res.harden_sharded_plan(splan)
    assert fault.fires == 1
    demoted = out.layers[0]
    assert demoted.provenance[0].startswith("shard ladder: RuntimeError")
    assert demoted.base.backend == "staged" and demoted.strategy == \
        "replicate"
    assert demoted.base.provenance[0].startswith("backend fused->staged")
    assert out.base.layers[0] is demoted.base
    assert out.layers[1] is splan.layers[1]
    y = ex.forward_spectral_sharded(tiny["params"], out, tiny["x"],
                                    mesh=tiny["mesh"])
    assert err(y, tiny["ref"]) <= TOL


def test_persistent_shard_fault_collapses_to_replicate(tiny):
    """A fault on every shard of a scheduled layer walks it down the
    fused rungs until it leaves the fused backend: 'replicate', the rung
    that runs no shard."""
    splan = tiny["ssplan"]
    name = splan.layers[0].base.layer.name
    with faults.inject("shard_tables", layer=name) as fault:
        out = res.harden_sharded_plan(splan)
    assert fault.fires == 2
    demoted = out.layers[0]
    assert demoted.strategy == "replicate" and not demoted.shards
    assert demoted.base.backend != "fused"
    assert len(demoted.provenance) == 2
    y = ex.forward_spectral_sharded(tiny["params"], out, tiny["x"],
                                    mesh=tiny["mesh"])
    assert err(y, tiny["ref"]) <= TOL


def test_corrupt_shard_tables_caught_by_validation(tiny):
    """One rotten shard is caught by per-shard validation, with the
    reference's diagnostics on the reference's plan built alike; its
    siblings, and the unmodified plan, stay healthy."""
    splan = tiny["ssplan"]
    bad = faults.corrupt_shard_tables(splan, shard=1, kind="oob_index")
    with pytest.raises(res.PlanValidationError):
        res.validate_sharded_plan(bad)
    diags = res.validate_sharded_plan(bad, raise_on_error=False)
    errors = {(d.layer, d.check) for d in diags if d.severity == "error"}
    jsplan = jpl.build_sharded_network_plan(
        tiny["jparams"], JTinyCfg, n_shards=2, batch=2,
        strategies=("channel",), hadamard="scheduled")
    jbad = jfaults.corrupt_shard_tables(jsplan, shard=1, kind="oob_index")
    assert errors == {(d.layer, d.check) for d in jres.validate_sharded_plan(
        jbad, raise_on_error=False) if d.severity == "error"}
    assert errors == {("c1", "tables/idx-bounds")}
    res.validate_sharded_plan(splan)
    with pytest.raises(res.PlanValidationError):
        pl.validate_sharded_plan(bad)
    hard = res.harden_sharded_plan(bad)
    assert "tables/idx-bounds" in hard.layers[0].provenance[0]


def test_executor_stages_shard_tables_through_the_fault_site(tiny):
    """The sharded forward passes each shard's tables through the
    'shard_tables' site on the host: a raise there surfaces before the
    shards run, a corruption changes that shard's tables only."""
    splan, name = tiny["ssplan"], "c1"
    with faults.inject("shard_tables", layer=name, shard=1):
        with pytest.raises(RuntimeError, match="injected fault"):
            ex.forward_spectral_sharded(tiny["params"], splan, tiny["x"],
                                        mesh=tiny["mesh"])
    clean = ex.forward_spectral_sharded(tiny["params"], splan, tiny["x"],
                                        mesh=tiny["mesh"])
    assert err(clean, tiny["ref"]) <= TOL
    bump = lambda tb: tb._replace(vr=faults._corrupt_value(tb.vr))
    with faults.inject("shard_tables", corrupt=bump, layer=name,
                       shard=1) as fault:
        bad = ex.forward_spectral_sharded(tiny["params"], splan, tiny["x"],
                                          mesh=tiny["mesh"])
    assert fault.fires == 1
    assert err(bad, tiny["ref"]) > TOL

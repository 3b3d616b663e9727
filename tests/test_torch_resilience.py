"""repro_torch's resilience layer, the static half: the error taxonomy,
plan validation, the health report, the backend rungs and the circuit
breaker, each held to the reference's ``repro.core.resilience``.

Both packages build their plans from the same weights (the reference's
``cnn.init``, carried across by ``interop.params_from_numpy``).  Their
diagnostics are compared as (layer, check, severity) sets on every check
both packages have (the TPU's ``vmem-budget`` and ``dma/*`` checks are
the port's ``smem-budget`` and launch-geometry checks, compared on their
own), on healthy and corrupted plans and on the DAG error cases.  The
reference builds halo plans here but never executes one (its halo
kernel does not run on this tree's jax).
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import resnet18_spectral as jresnet
from repro.core import dataflow as jdf
from repro.core import plan as jpl
from repro.core import resilience as jres
from repro.core import sparse as jsp
from repro.models import cnn as jcnn
from repro.testing import faults as jfaults
from repro_torch.configs import resnet18_spectral as resnet
from repro_torch.core import autotune as at
from repro_torch.core import dataflow as df
from repro_torch.core import plan as pl
from repro_torch.core import resilience as res
from repro_torch.core import scheduler as sch
from repro_torch.core.spectral import make_geometry
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import fused_spectral_conv as fsc
from repro_torch.models import cnn
from repro_torch.testing import faults

JMINI = jcnn.SpectralCNNConfig(
    name="mini-res", layers=(jdf.ConvLayer("c1", 3, 8, 32, 32),
                             jdf.ConvLayer("c2", 8, 8, 16, 16),
                             jdf.ConvLayer("c3", 8, 8, 8, 8)),
    alpha=4.0, n_classes=4, image_size=32, fc_dim=8,
    pool_after=frozenset({"c1", "c2", "c3"}))
MINI = cnn.SpectralCNNConfig(
    name="mini-res", layers=tuple(df.ConvLayer(l.name, l.c_in, l.c_out,
                                               l.h_in, l.w_in)
                                  for l in JMINI.layers),
    alpha=4.0, n_classes=4, image_size=32, fc_dim=8,
    pool_after=JMINI.pool_after)
JDENSE = dataclasses.replace(jresnet.SMOKE, alpha=1.0)
DENSE = dataclasses.replace(resnet.SMOKE, alpha=1.0)

# checks both packages have (the rest are the port's Hopper checks)
SHARED = ("modes/", "operators/", "epilogue/", "tables/", "halo/", "graph/",
          "schedule/")


def shared(diags):
    return {(d.layer, d.check, d.severity) for d in diags
            if d.check.startswith(SHARED)}


def port_params(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                             "cpu")


@pytest.fixture(scope="module")
def mini():
    jparams = jcnn.init(jax.random.PRNGKey(0), JMINI)
    params = port_params(jparams)
    kw = dict(batch=1, hadamard="scheduled", input_mode="halo")
    return dict(jparams=jparams, params=params,
                jplan=jcnn.build_plan(jparams, JMINI, **kw),
                plan=cnn.build_plan(params, MINI, device="cpu", **kw))


@pytest.fixture(scope="module")
def dense():
    jparams = jcnn.init(jax.random.PRNGKey(0), JDENSE)
    return dict(jplan=jpl.build_network_plan(jparams, JDENSE, batch=1),
                plan=pl.build_network_plan(port_params(jparams), DENSE,
                                           batch=1, device="cpu"))


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

def _family(mod):
    return {name: tuple(b.__name__ for b in getattr(mod, name).__mro__[1:])
            for name in ("ResilienceError", "PlanValidationError",
                         "KernelLoweringError", "NumericGuardError")}


def test_taxonomy_matches_reference():
    """The same classes with the same bases (validation and guard errors
    are ValueErrors, lowering errors NotImplementedErrors), and the
    scheduler's error is resilience's."""
    assert _family(res) == _family(jres)
    assert issubclass(res.PlanValidationError, ValueError)
    assert issubclass(res.KernelLoweringError, NotImplementedError)
    assert sch.PlanValidationError is res.PlanValidationError
    assert res.FAULT_SITES == jres.FAULT_SITES
    assert faults.FAULT_SITES == jfaults.FAULT_SITES
    assert (faults.OOB_INDEX, faults.VALUE_DELTA, faults.SLOW_EXTRA_S) == (
        jfaults.OOB_INDEX, jfaults.VALUE_DELTA, jfaults.SLOW_EXTRA_S)
    assert df.EXEC_BACKENDS == jdf.EXEC_BACKENDS == res.BACKEND_RUNGS


def test_error_carries_structure():
    diags = [res.Diagnostic("c1", "tables/idx-bounds", "boom"),
             res.Diagnostic("c2", "smem-budget", "big", "warn")]
    err = res.PlanValidationError("plan failed", layer="c1",
                                  site="validate_plan", diagnostics=diags)
    jerr = jres.PlanValidationError(
        "plan failed", layer="c1", site="validate_plan",
        diagnostics=[jres.Diagnostic(**dataclasses.asdict(d))
                     for d in diags])
    assert (err.layer, err.site, len(err.diagnostics)) == ("c1",
                                                          "validate_plan", 2)
    assert str(err) == str(jerr)
    assert "[c2] smem-budget (warn)" in str(err)


def test_guard_policy_validated():
    with pytest.raises(ValueError):
        res.NumericGuards(policy="explode")
    assert res.GUARD_POLICIES == jres.GUARD_POLICIES


# ---------------------------------------------------------------------------
# Plan validation
# ---------------------------------------------------------------------------

def test_validate_plan_healthy_matches_reference(mini):
    """A freshly built scheduled + halo plan (the most aggressive
    variant) carries no error in either package."""
    diags = res.validate_plan(mini["plan"])
    assert not [d for d in diags if d.severity == "error"]
    assert shared(diags) == shared(jres.validate_plan(mini["jplan"]))


def test_build_plan_validates_by_default(mini):
    plan = cnn.build_plan(mini["params"], MINI, batch=1, validate=False,
                          device="cpu")
    assert res.validate_plan(plan, raise_on_error=False) is not None


@pytest.mark.parametrize("kind", ["oob_index", "corrupt_value"])
def test_corrupted_tables_match_reference(mini, kind):
    """An out-of-range INDEX table is refused by static validation, before
    any launch, naming the layer and the check; a finite but wrong VALUE
    plane passes it (the parity guard's job).  The reference agrees."""
    bad = faults.corrupt_plan_tables(mini["plan"], kind=kind)
    jbad = jfaults.corrupt_plan_tables(mini["jplan"], kind=kind)
    diags = res.validate_plan(bad, raise_on_error=False)
    assert shared(diags) == shared(jres.validate_plan(jbad,
                                                      raise_on_error=False))
    assert bad.layers[0].tables.idx.device == mini["plan"].layers[0].tables \
        .idx.device
    if kind == "corrupt_value":
        assert not [d for d in diags if d.severity == "error"]
        return
    with pytest.raises(res.PlanValidationError) as ei:
        res.validate_plan(bad)
    err = ei.value
    assert err.site == "validate_plan" and err.layer == "c1"
    assert "tables/idx-bounds" in {d.check for d in err.diagnostics}
    assert str(faults.OOB_INDEX) in str(err)


BAD_LAYERS = {
    "input_mode": lambda lp: dict(input_mode="telepathy"),
    "backend": lambda lp: dict(backend="quantum"),
    "flow": lambda lp: dict(tuning=dataclasses.replace(lp.tuning,
                                                       flow="sideways")),
    "bias": lambda lp: dict(bias=lp.bias * float("nan")),
    "utilization": lambda lp: dict(pe_utilization=1.5),
}


@pytest.mark.parametrize("what", sorted(BAD_LAYERS))
def test_validate_layer_plan_flags_match_reference(mini, what):
    """Bad modes, a non-finite bias, an impossible utilization: the same
    (layer, check, severity) in both packages."""
    lp, jlp = mini["plan"].layers[0], mini["jplan"].layers[0]
    kw = BAD_LAYERS[what](lp)
    jkw = BAD_LAYERS[what](jlp)
    if what == "bias":
        jkw = dict(bias=jlp.bias * np.float32("nan"))
    diags = shared(res.validate_layer_plan(dataclasses.replace(lp, **kw)))
    assert diags and diags == shared(jres.validate_layer_plan(
        dataclasses.replace(jlp, **jkw)))


def test_smem_budget_is_warn_severity(mini):
    """A layout over the budget is advisory at build (a warning on every
    layer), as the reference's vmem-budget is."""
    diags = res.validate_plan(mini["plan"], smem_budget=1)
    smem = [d for d in diags if d.check == "smem-budget"]
    assert {d.layer for d in smem} == {"c1", "c2", "c3"}
    assert all(d.severity == "warn" for d in smem)
    jv = [d for d in jres.validate_plan(mini["jplan"], vmem_budget=1)
          if d.check == "vmem-budget"]
    assert {d.layer for d in jv} == {d.layer for d in smem}


def test_smem_check_reads_the_kernels_layouts(mini):
    """``layer_smem_bytes`` is the kernel's layout at the layer's flow and
    block_m (``fsc.sched_smem_bytes`` with the halo block), and the
    cost model's figure for the same configuration."""
    for lp in mini["plan"].layers:
        _, _, t_cycles, r = lp.tables.idx.shape
        hg = fsc.halo_block_geometry(lp.geo, lp.tuning.block_p)
        want = fsc.sched_smem_bytes(lp.tuning.flow, lp.geo, lp.tuning.block_m,
                                    t_cycles, r, lp.tables.sel.shape[-1], hg)
        assert res.layer_smem_bytes(lp) == want == lp.tuning.smem_bytes


FULL_WIDTH = [(l, f) for l in df.VGG16_LAYERS[::4] for f in df.FLOWS]


@pytest.mark.parametrize("layer,flow", FULL_WIDTH,
                         ids=[f"{l.name}-{f[:6]}" for l, f in FULL_WIDTH])
def test_launch_geometry_clean_on_full_width_tunings(layer, flow):
    """The launch-geometry and shared-memory checks pass every tuning the
    autotuner gives a full-width VGG16 layer (shapes only: a stand-in
    plan with the operators' shapes and no weights)."""
    geo = make_geometry(layer.h_in, layer.w_in, layer.ksize, 8, layer.pad)
    for mode, imode in (("bin", "windowed"), ("bin", "halo")):
        tn = at.autotune_layer(layer, 8, 4.0, flows=(flow,),
                               active_bins=64, hadamard_modes=(mode,),
                               input_modes=(imode,))
        lp = types.SimpleNamespace(
            layer=layer, geo=geo, tuning=tn, hadamard=mode, input_mode=imode,
            backend="fused", active=None, n_active_bins=64, tables=None,
            dfr=torch.empty(64, 64), dvr=torch.empty(36, 64),
            wr=torch.empty(64, layer.c_out, layer.c_in),
            bias=torch.zeros(1, layer.c_out), pe_utilization=None,
            epilogue=pl.EpilogueSpec())
        diags = res.validate_layer_plan(lp)
        assert not diags, [str(d) for d in diags]
        assert res.layer_smem_bytes(lp) == tn.smem_bytes


def test_launch_geometry_checks_flag_bad_blocks(mini):
    """The reference's dma/* checks on the port's launch rules: a healthy
    plan carries none, a non-positive block is ``dma/tile-bounds`` (as in
    the reference), an m-range width the plane kernel cannot step is
    ``dma/revisit-order``."""
    for lp in mini["plan"].layers:
        assert not [d for d in res.validate_layer_plan(lp)
                    if d.check.startswith("dma/")]
    lp, jlp = mini["plan"].layers[0], mini["jplan"].layers[0]
    bad = dataclasses.replace(lp, tuning=dataclasses.replace(lp.tuning,
                                                             block_n=0))
    jbad = dataclasses.replace(jlp, tuning=dataclasses.replace(jlp.tuning,
                                                               block_n=0))
    checks = {(d.check, d.severity) for d in res.validate_layer_plan(bad)}
    assert ("dma/tile-bounds", "error") in checks
    assert ("dma/tile-bounds", "error") in {
        (d.check, d.severity) for d in jres.validate_layer_plan(jbad)}
    plane = dataclasses.replace(
        lp, hadamard="bin" if lp.active is not None else "dense",
        tables=None, input_mode="windowed",
        tuning=dataclasses.replace(lp.tuning, flow=fsc.IS, block_m=12))
    assert "dma/revisit-order" in {d.check for d in
                                   res.validate_layer_plan(plane)}


# ---------------------------------------------------------------------------
# Property: the port's Alg-2 compiler's output always validates
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(
    n_kernels=st.sampled_from([4, 8, 16]),
    m_ch=st.sampled_from([3, 4, 8]),
    alpha=st.sampled_from([2.0, 4.0]),
    block_m=st.sampled_from([4, 8, 16]),
    seed=st.integers(0, 2**31 - 1),
)
def test_compiled_tables_always_validate(n_kernels, m_ch, alpha, block_m,
                                         seed):
    """For any random sparsity pattern (the reference's ``prune_random``),
    the port's ``compile_layer_tables`` emits tables both packages'
    ``validate_tables`` pass clean."""
    k = 8
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_kernels, m_ch, k, k))
         + 1j * rng.standard_normal((n_kernels, m_ch, k, k))
         ).astype(np.complex64)
    sk = jsp.prune_random(w, alpha, seed=seed)
    active = jsp.compacted_active_bins(sk)
    n_bins = len(active) if active is not None else k * k
    bm = min(block_m, m_ch)
    tables = sch.compile_layer_tables(
        np.asarray(sk.indices),
        np.asarray(sk.values).reshape(n_kernels, m_ch, k * k), k * k,
        at.SCHEDULE_R, n_par=min(8, n_kernels), active=active, m_pad_to=bm)
    diags = res.validate_tables(tables, n_bins=n_bins, r=at.SCHEDULE_R,
                                c_out=n_kernels, c_in=m_ch, layer="prop")
    assert not diags, [str(d) for d in diags]
    assert not jres.validate_tables(
        tables, n_bins=n_bins, r=at.SCHEDULE_R, c_out=n_kernels, c_in=m_ch,
        block_m=block_m, layer="prop")


def _mutations(tb):
    idx = np.array(tb.idx, copy=True)
    idx.flat[0] = -3
    sel = np.array(tb.sel, copy=True)
    sel.flat[0] = 10 ** 6
    vr = np.array(tb.vr, copy=True)
    vr.flat[0] = np.inf
    return {"pristine": {}, "idx-bounds": dict(idx=idx),
            "sel-bounds": dict(sel=sel), "value-finite": dict(vr=vr),
            "idx-dtype": dict(idx=np.asarray(tb.idx, np.int64))}


@pytest.mark.parametrize("what", ["pristine", "idx-bounds", "sel-bounds",
                                  "value-finite", "idx-dtype"])
def test_validate_tables_catches_all_corruptions(mini, what):
    """Each corruption class maps to its named check, in both packages, on
    the same (reference) tables; on the port's own device tables too."""
    jlp = mini["jplan"].layers[0]
    lp = mini["plan"].layers[0]
    tb = types.SimpleNamespace(**{f: np.asarray(getattr(jlp.tables, f))
                                  for f in ("idx", "sel", "vr", "vi")})
    mut = types.SimpleNamespace(**{**vars(tb), **_mutations(tb)[what]})
    kw = dict(n_bins=jlp.n_active_bins, r=at.SCHEDULE_R,
              c_out=jlp.layer.c_out, c_in=jlp.layer.c_in, layer="c1")
    got = {d.check for d in res.validate_tables(mut, **kw)}
    want = {d.check for d in jres.validate_tables(
        mut, block_m=jlp.tuning.block_m, **kw)}
    assert got == want
    assert (not got) == (what == "pristine")
    if what != "pristine":
        assert f"tables/{what}" in got
    ptb = lp.tables
    pmut = {"idx-dtype": dict(idx=ptb.idx.long())}.get(what, {
        k: torch.from_numpy(np.asarray(v)) for k, v in
        _mutations(types.SimpleNamespace(
            **{f: ptb.__getattribute__(f).numpy()
               for f in ("idx", "sel", "vr", "vi")}))[what].items()})
    pgot = {d.check for d in res.validate_tables(
        ptb._replace(**pmut), n_bins=lp.n_active_bins, r=at.SCHEDULE_R,
        c_out=lp.layer.c_out, c_in=lp.layer.c_in, layer="c1")}
    assert pgot == got


def test_tables_m_pad_and_groups(mini):
    """The port's padding rules: Mp may exceed c_in (any padding) but not
    fall short; the lane groups must fill c_out the way the kernel
    needs."""
    lp = mini["plan"].layers[1]
    tb = lp.tables
    kw = dict(n_bins=lp.n_active_bins, r=at.SCHEDULE_R, c_out=8, c_in=8)
    padded = pl.PlanTables(*(torch.cat([t, torch.zeros_like(t[:, :3])], 1)
                             for t in tb))
    assert not res.validate_tables(padded, **kw)
    short = pl.PlanTables(*(t[:, :5] for t in tb))
    assert {d.check for d in res.validate_tables(short, **kw)} == {
        "tables/m-pad"}
    assert {d.check for d in res.validate_tables(
        tb, **{**kw, "c_out": 200})} == {"tables/groups"}


# ---------------------------------------------------------------------------
# The DAG: one test per PlanValidationError site, against the reference
# ---------------------------------------------------------------------------

GRAPHS = {
    "duplicate-id": ("topo", [dict(id="a"), dict(id="a", inputs=("a",))]),
    "reserved-id": ("topo", [dict(id="input")]),
    "unknown-reference": ("topo", [dict(id="a", inputs=("ghost",))]),
    "unknown-residual": ("topo", [dict(id="a", residual_from="ghost")]),
    "cycle": ("topo", [dict(id="a", inputs=("b",)),
                       dict(id="b", inputs=("a",))]),
    "input-shape": ("shapes", [("c1", 3, 4), ("c2", 8, 4)],
                    [dict(id="c1"), dict(id="c2", inputs=("c1",))]),
    "residual-shape": ("shapes", [("c1", 3, 4), ("c2", 4, 8)],
                       [dict(id="c1"), dict(id="c2", inputs=("c1",),
                                            residual_from="c1")]),
    "stride-residual": ("shapes", [("c1", 3, 4), ("c2", 4, 4, 2)],
                        [dict(id="c1"), dict(id="c2", inputs=("c1",),
                                             residual_from="c1")]),
    "pool-input": ("shapes", [], [dict(id="p", kind="pool")]),
    "conv-without-layer": ("shapes", [], [dict(id="ghost")]),
}


def _raise(pkg, case):
    dfm, plm = (df, pl) if pkg == "port" else (jdf, jpl)
    err_t = res.PlanValidationError if pkg == "port" else \
        jres.PlanValidationError
    kind, *args = GRAPHS[case]
    specs = [dfm.NodeSpec(**s) for s in args[-1]]
    with pytest.raises(err_t) as ei:
        if kind == "topo":
            plm._topo_order_specs(specs)
        else:
            layers = [dfm.ConvLayer(name, ci, co, 16, 16, stride=s)
                      for name, ci, co, *rest in args[0]
                      for s in (rest[0] if rest else 1,)]
            plm.node_output_shapes(layers, specs)
    return ei.value


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_graph_error_sites_match_reference(case):
    """Each DAG check raises ``PlanValidationError`` with the reference's
    ``layer`` and ``site``."""
    err, jerr = _raise("port", case), _raise("jax", case)
    assert isinstance(err, ValueError)
    assert (err.layer, err.site) == (jerr.layer, jerr.site)
    assert err.site in ("graph", "graph/input-shape", "graph/residual-shape")


def test_graph_conv_nodes_must_cover_layers():
    cfg = cnn.SpectralCNNConfig(
        name="bad-cover", alpha=1.0, n_classes=4, image_size=16, fc_dim=16,
        layers=(df.ConvLayer("c1", 3, 4, 16, 16),
                df.ConvLayer("c2", 4, 4, 16, 16)),
        pool_after=frozenset(), graph=(df.NodeSpec(id="c1"),))
    params = cnn.init(dataclasses.replace(cfg, graph=None), device="cpu")
    with pytest.raises(res.PlanValidationError) as ei:
        pl.build_network_plan(params, cfg, batch=1, device="cpu")
    assert ei.value.site == "graph"


def _rot(plan, how):
    graph = plan.graph if hasattr(plan, "schedule_seconds") else \
        plan.execution_graph
    if how == "duplicate":
        return dataclasses.replace(plan, graph=graph + (graph[0],))
    if how == "reversed":
        return dataclasses.replace(plan, graph=graph[::-1])
    if how == "layer-index":
        conv = next(i for i, n in enumerate(graph) if n.kind == "conv")
        g = list(graph)
        g[conv] = dataclasses.replace(g[conv], layer_index=999)
        return dataclasses.replace(plan, graph=tuple(g))
    idx = next(i for i, lp in enumerate(plan.layers)
               if lp.epilogue.residual == "fused")
    layers = list(plan.layers)
    layers[idx] = dataclasses.replace(layers[idx], backend="staged")
    return dataclasses.replace(plan, layers=tuple(layers))


@pytest.mark.parametrize("how", ["duplicate", "reversed", "layer-index",
                                 "residual-off-fused"])
def test_validate_graph_on_a_rotten_plan_matches_reference(dense, how):
    """A built ResNet-18 plan whose graph rots (a duplicated id, a
    reversed order, a bad layer index) or whose residual-fused layer
    leaves the fused backend: the same graph diagnostics as the
    reference's, and ``validate_plan`` raises."""
    bad, jbad = _rot(dense["plan"], how), _rot(dense["jplan"], how)
    diags = shared(res.validate_plan(bad, raise_on_error=False))
    assert diags and diags == shared(
        jres.validate_plan(jbad, raise_on_error=False))
    with pytest.raises(res.PlanValidationError) as ei:
        res.validate_plan(bad)
    assert ei.value.site == "validate_plan"


# ---------------------------------------------------------------------------
# Health report, stats, harden on a healthy plan
# ---------------------------------------------------------------------------

def test_health_report_healthy(mini):
    hr = mini["plan"].health_report()
    jhr = mini["jplan"].health_report()
    assert hr["healthy"] is True and hr["demoted_layers"] == []
    assert hr["issues"]["error"] == 0
    assert [r["node"] for r in hr["layers"]] == [r["node"]
                                                 for r in jhr["layers"]]
    conv = [r for r in hr["layers"] if r["kind"] == "conv"]
    jconv = [r for r in jhr["layers"] if r["kind"] == "conv"]
    keys = ("node", "layer", "backend", "hadamard", "input_mode",
            "residual", "demotions")
    assert [{k: r[k] for k in keys} for r in conv] == \
        [{k: r[k] for k in keys} for r in jconv]
    assert set(hr) == set(jhr)


def test_health_report_keyed_by_node_ids(dense):
    hr = dense["plan"].health_report()
    ids = [r["node"] for r in hr["layers"]]
    assert ids == [n.id for n in dense["plan"].graph]
    assert ids == [r["node"] for r in dense["jplan"].health_report()["layers"]]
    assert "stem:pool" in ids and "head:pool" in ids
    assert {r["pool"] for r in hr["layers"] if r["kind"] == "pool"} == {
        "max", "avg"}


def test_harden_is_noop_on_healthy_plan(mini):
    """No fault: every layer keeps its variant (the same objects), no
    provenance; the probes ran the plain versions on the CPU."""
    hard = res.harden_network_plan(mini["plan"])
    assert hard is mini["plan"]
    assert all(a is b for a, b in zip(hard.layers, mini["plan"].layers))
    assert all(not lp.provenance for lp in hard.layers)


def test_stats_surface_backend_and_demotions(mini):
    s = mini["plan"].layers[0].stats()
    js = mini["jplan"].layers[0].stats()
    assert set(js) - {"hbm_bytes"} <= set(s)
    assert s["backend"] == "fused" and s["demotions"] == 0
    assert s["smem_bytes"] == mini["plan"].layers[0].tuning.smem_bytes
    assert [r["layer"] for r in mini["plan"].summary()] == ["c1", "c2", "c3"]
    node = mini["plan"].graph[0]
    assert mini["plan"].node_plan(node) is mini["plan"].layers[0]
    with pytest.raises(ValueError):
        mini["plan"].node_plan(mini["plan"].graph[1])


def test_layer_plan_is_frozen_by_identity(mini):
    """``dataclasses.replace`` keeps LayerPlan frozen with identity
    equality, so a demoted layer is a new key of identity caches."""
    lp = mini["plan"].layers[0]
    again = dataclasses.replace(lp)
    assert again is not lp and again != lp
    with pytest.raises(dataclasses.FrozenInstanceError):
        again.backend = "einsum"


# ---------------------------------------------------------------------------
# Backend-axis rungs
# ---------------------------------------------------------------------------

def test_demote_layer_backend_walks_rungs(mini):
    lp, jlp = mini["plan"].layers[0], mini["jplan"].layers[0]
    staged = res.demote_layer_backend(lp, reason="test")
    jstaged = jres.demote_layer_backend(jlp, reason="test")
    assert staged.backend == jstaged.backend == "staged"
    assert staged.provenance == jstaged.provenance
    einsum = res.demote_layer_backend(staged, reason="test")
    assert einsum.backend == "einsum"
    assert einsum.provenance == jres.demote_layer_backend(
        jstaged, reason="test").provenance
    assert res.demote_layer_backend(einsum) is None
    assert (einsum.hadamard, einsum.input_mode) == (lp.hadamard,
                                                    lp.input_mode)
    # no cost model off the fused backend: no stale fused numbers
    for tn in (staged.tuning, einsum.tuning):
        assert (tn.hbm_bytes, tn.smem_bytes, tn.predicted_s) == (None,) * 3


def test_plan_at_backend_rung(mini):
    plan = mini["plan"]
    assert res.plan_at_backend_rung(plan, "fused") is plan
    down = res.plan_at_backend_rung(plan, "einsum", reason="load ladder")
    jdown = jres.plan_at_backend_rung(mini["jplan"], "einsum",
                                      reason="load ladder")
    assert all(lp.backend == "einsum" for lp in down.layers)
    assert [lp.provenance for lp in down.layers] == \
        [lp.provenance for lp in jdown.layers]
    assert res.plan_at_backend_rung(down, "staged") is down
    with pytest.raises(ValueError):
        res.plan_at_backend_rung(plan, "nonsense")


# ---------------------------------------------------------------------------
# Circuit breaker (the reference's scenarios, both packages in step)
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _pair(**kw):
    clock = _Clock()
    return clock, res.CircuitBreaker(clock=clock, **kw), \
        jres.CircuitBreaker(clock=clock, **kw)


def _same(*breakers):
    snaps = [b.snapshot() for b in breakers]
    assert snaps[0] == snaps[1]
    return breakers[0]


def test_breaker_opens_after_consecutive_failures():
    clock, brk, jbrk = _pair(name="fused", failure_threshold=3,
                             cooldown_s=1.0)
    assert brk.state == "closed" and brk.allow() and jbrk.allow()
    for b in (brk, jbrk):
        b.record_failure("boom")
        b.record_failure("boom")
    assert _same(brk, jbrk).state == "closed"
    for b in (brk, jbrk):
        b.record_failure("boom")
    assert _same(brk, jbrk).state == "open" and brk.n_opens == 1
    assert not brk.allow() and not jbrk.allow()


def test_breaker_success_resets_failure_streak():
    _, brk, jbrk = _pair(name="fused", failure_threshold=2)
    for b in (brk, jbrk):
        b.record_failure("a")
        b.record_success()
        b.record_failure("b")
    assert _same(brk, jbrk).state == "closed"
    for b in (brk, jbrk):
        b.record_failure("c")
    assert _same(brk, jbrk).state == "open"


def test_breaker_half_open_to_closed_recovery():
    clock, brk, jbrk = _pair(name="staged", failure_threshold=1,
                             cooldown_s=2.0, recovery_successes=1)
    for b in (brk, jbrk):
        b.record_failure("boom")
    assert brk.state == "open" and not brk.allow() and not jbrk.allow()
    clock.t = 5.0
    assert brk.allow() and jbrk.allow() and brk.state == "half_open"
    for b in (brk, jbrk):
        b.record_success()
    assert _same(brk, jbrk).state == "closed" and brk.failures == 0
    assert [t["to"] for t in brk.transitions] == ["open", "half_open",
                                                  "closed"]


def test_breaker_half_open_failure_reopens():
    clock, brk, jbrk = _pair(name="staged", failure_threshold=1,
                             cooldown_s=1.0)
    for b in (brk, jbrk):
        b.record_failure("boom")
    clock.t = 2.0
    assert brk.allow() and jbrk.allow() and brk.state == "half_open"
    for b in (brk, jbrk):
        b.record_failure("still broken")
    assert _same(brk, jbrk).state == "open" and brk.n_opens == 2
    assert not brk.allow()
    clock.t = 4.0
    assert brk.allow() and jbrk.allow() and _same(brk, jbrk).state == \
        "half_open"

"""repro_torch's FPGA complexity model (``core.dataflow``, Eqs 6-13) and
Alg 1 (``core.optimizer``) == the reference's.

Pure integer and float arithmetic on both sides, so every value is held
EXACTLY equal (==, no tolerance): the BRAM counts, transfer words,
bandwidths and latency budgets over all 13 VGG16 layers on a grid of
architecture and streaming parameters, and ``optimize()`` field by field.
Then the reference's own assertions (``tests/test_dataflow.py``,
``tests/test_system.py``'s Alg-1 test) run again on the port, as cases
of parametrised tests.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core import dataflow as jdf
from repro.core import optimizer as jopt
from repro_torch.core import dataflow as df
from repro_torch.core import optimizer as opt
from repro_torch.core import scheduler as sch

P_PAR, N_PAR, R, K, ALPHA = 9, 64, 10, 8, 4.0
LAYERS = range(len(df.VGG16_LAYERS))
GRID = list(itertools.product((1, 9), (16, 64), (6, 10), (2.0, 4.0)))
STREAMING = [(1, 16), (9, 64), (27, 128), (1444, 512), (196, 32)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after): the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(i):
    return df.VGG16_LAYERS[i], jdf.VGG16_LAYERS[i]


def test_layer_tables_and_constants_equal():
    assert (df.BRAM_DEPTH, df.WORD_BYTES) == (jdf.BRAM_DEPTH,
                                              jdf.WORD_BYTES)
    assert [dataclasses.astuple(l) for l in df.VGG16_LAYERS] == \
        [dataclasses.astuple(l) for l in jdf.VGG16_LAYERS]
    assert [l.name for l in df.VGG16_OPT_LAYERS] == \
        [l.name for l in jdf.VGG16_OPT_LAYERS]
    for i in LAYERS:
        l, jl = pair(i)
        for K_ in (8, 16):
            assert l.tile_size(K_) == jl.tile_size(K_)
            assert l.tiles(K_) == jl.tiles(K_)
            for a in (1.0, 4.0, 3.0):
                assert l.spectral_macs(K_, a) == jl.spectral_macs(K_, a)
        assert l.spatial_macs() == jl.spatial_macs()


@pytest.mark.parametrize("i", LAYERS)
def test_bram_and_transfers_equal_reference(i):
    l, jl = pair(i)
    for p, n, r, a in GRID:
        for fn in ("bram_flow1", "bram_flow2", "bram_flow3"):
            assert getattr(df, fn)(l, K, a, p, n, r) == \
                getattr(jdf, fn)(jl, K, a, p, n, r), (fn, p, n, r, a)
            assert getattr(df, fn)(l, K, a, p, n, r, m_par=2) == \
                getattr(jdf, fn)(jl, K, a, p, n, r, m_par=2)
        for ps, ns in STREAMING:
            assert df.bram_flexible(l, K, a, p, n, r, ns, ps) == \
                jdf.bram_flexible(jl, K, a, p, n, r, ns, ps)
            assert df.transfers_flexible(l, K, a, ns, ps) == \
                jdf.transfers_flexible(jl, K, a, ns, ps)
        assert df.transfers_flow1(l, K, a, n) == \
            jdf.transfers_flow1(jl, K, a, n)
        assert df.transfers_flow2(l, K, a, p) == \
            jdf.transfers_flow2(jl, K, a, p)
        assert df.transfers_flow3(l, K, a) == jdf.transfers_flow3(jl, K, a)
        assert df.transfers_flow3(l, K, a, m_par=4, complex_words=1) == \
            jdf.transfers_flow3(jl, K, a, m_par=4, complex_words=1)
        words = df.transfers_flow1(l, K, a, n)
        for tau in (20e-3, 1.37e-3):
            assert df.bandwidth_gbps(words, tau) == \
                jdf.bandwidth_gbps(words, tau)


@pytest.mark.parametrize("alpha", [2.0, 4.0])
@pytest.mark.parametrize("tau", [20e-3, 5e-3])
def test_latency_budget_equal_reference(alpha, tau):
    for layers, jlayers in ((df.VGG16_OPT_LAYERS, jdf.VGG16_OPT_LAYERS),
                            (df.VGG16_LAYERS, jdf.VGG16_LAYERS)):
        assert df.layer_latency_budget(layers, K, alpha, tau) == \
            jdf.layer_latency_budget(jlayers, K, alpha, tau)


def same_plan(port, ref):
    """Every field of two DataflowPlans equal (the layer plans too)."""
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    assert port.total_transfers_words == ref.total_transfers_words


@pytest.fixture(scope="module")
def alg1():
    """The port's and the reference's Alg 1 at (9, 64) and at the
    defaults."""
    return {"9x64": (opt.optimize(arch_candidates=[(9, 64)]),
                     jopt.optimize(arch_candidates=[(9, 64)])),
            "default": (opt.optimize(), jopt.optimize())}


@pytest.mark.parametrize("setting", ["9x64", "default"])
def test_optimize_equals_reference(alg1, setting):
    port, ref = alg1[setting]
    same_plan(port, ref)


def test_optimize_known_answers(alg1):
    """The reference's answers: P'=1, N'=16 at the defaults, 12.2156 GB/s
    max layer bandwidth; 58,212,602 words at (9, 64)."""
    d, _ = alg1["default"]
    assert (d.p_par, d.n_par) == (1, 16)
    assert round(d.bw_max_gbps, 4) == 12.2156
    p, _ = alg1["9x64"]
    assert round(p.bw_max_gbps, 4) == 12.2156
    assert p.total_transfers_words == 58_212_602


@pytest.mark.parametrize("kw", [
    dict(arch_candidates=[(4, 32), (9, 64), (16, 64)]),
    dict(alpha=2.0, r=6, arch_candidates=[(1, 16), (9, 64)]),
    dict(total_tau_s=5e-3, n_bram_cap=1500, arch_candidates=[(4, 16)]),
])
def test_optimize_other_settings_equal_reference(kw):
    same_plan(opt.optimize(**kw), jopt.optimize(**kw))


def test_layer_and_pure_flow_helpers_equal_reference():
    l, jl = pair(5)
    assert list(opt._streaming_candidates(l, K, 9, 64)) == \
        list(jopt._streaming_candidates(jl, K, 9, 64))
    assert dataclasses.astuple(opt.optimize_layer(
        l, K, ALPHA, 9, 64, R, 1e-3, 2160)) == dataclasses.astuple(
        jopt.optimize_layer(jl, K, ALPHA, 9, 64, R, 1e-3, 2160))
    assert opt.optimize_layer(l, K, ALPHA, 9, 64, R, 1e-3, 10) is None
    assert jopt.optimize_layer(jl, K, ALPHA, 9, 64, R, 1e-3, 10) is None
    assert opt.pure_flow_transfers(df.VGG16_OPT_LAYERS, K, ALPHA, 9, 64) \
        == jopt.pure_flow_transfers(jdf.VGG16_OPT_LAYERS, K, ALPHA, 9, 64)


# ---------------------------------------------------------------------------
# tests/test_dataflow.py's and test_system.py's assertions, on the port
# ---------------------------------------------------------------------------

def check_vgg16_layer_table():
    names = [l.name for l in df.VGG16_LAYERS]
    assert names[0] == "conv1_1" and names[-1] == "conv5_3"
    assert len(df.VGG16_LAYERS) == 13
    l = df.VGG16_LAYERS[1]
    assert (l.c_in, l.c_out, l.h_in) == (64, 64, 224)
    assert l.tiles(8) == 38 * 38      # t = 6, canvas 228 -> 38 x 38


def check_flow1_bram_explodes_on_early_layers():
    """Fig 2: streaming input tiles (Flow #1) needs huge #BRAMs early."""
    b_early = df.bram_flow1(df.VGG16_LAYERS[1], K, ALPHA, P_PAR, N_PAR, R)
    b_late = df.bram_flow1(df.VGG16_LAYERS[10], K, ALPHA, P_PAR, N_PAR, R)
    assert b_early > 2160 and b_late < 2160
    assert b_early > 4 * b_late


def check_flow2_fewer_brams_more_traffic():
    for layer in df.VGG16_OPT_LAYERS[:3]:
        assert df.bram_flow2(layer, K, ALPHA, P_PAR, N_PAR, R) <= \
            df.bram_flow1(layer, K, ALPHA, P_PAR, N_PAR, R)
        assert df.transfers_flow2(layer, K, ALPHA, P_PAR) > \
            df.transfers_flow1(layer, K, ALPHA, N_PAR)
    conv1_2 = df.VGG16_OPT_LAYERS[0]
    assert df.bram_flow2(conv1_2, K, ALPHA, P_PAR, N_PAR, R) \
        < df.bram_flow1(conv1_2, K, ALPHA, P_PAR, N_PAR, R)


def check_flow3_never_advantageous():
    for layer in df.VGG16_OPT_LAYERS:
        assert df.transfers_flow3(layer, K, ALPHA) > min(
            df.transfers_flow1(layer, K, ALPHA, N_PAR),
            df.transfers_flow2(layer, K, ALPHA, P_PAR))


def check_flexible_interpolates_pure_flows():
    """Eq 13 ~ Eq 9 at (Ns=N', Ps=T) and ~ Eq 10 at (Ns=N, Ps=P')."""
    layer = df.VGG16_LAYERS[4]
    f1 = df.transfers_flow1(layer, K, ALPHA, N_PAR)
    flex1 = df.transfers_flexible(layer, K, ALPHA, ns=N_PAR,
                                  ps=layer.tiles(K))
    assert abs(f1 - flex1) / f1 < 0.05
    f2 = df.transfers_flow2(layer, K, ALPHA, P_PAR)
    flex2 = df.transfers_flexible(layer, K, ALPHA, ns=layer.c_out, ps=P_PAR)
    assert abs(f2 - flex2) / f2 < 0.05


def check_latency_budget_partitions_tau():
    taus = df.layer_latency_budget(df.VGG16_OPT_LAYERS, K, ALPHA, 20e-3)
    assert len(taus) == 12
    np.testing.assert_allclose(sum(taus.values()), 20e-3, rtol=1e-9)
    assert max(taus, key=taus.get) in {"conv3_2", "conv3_3", "conv4_2",
                                       "conv4_3"}
    assert taus["conv1_2"] > taus["conv5_1"]


def check_optimize_searches_arch_space():
    plan = opt.optimize(arch_candidates=[(4, 32), (9, 64), (16, 64)])
    assert (plan.p_par, plan.n_par) in {(4, 32), (9, 64), (16, 64)}


def check_infeasible_cap_raises():
    with pytest.raises(ValueError):
        opt.optimize(arch_candidates=[(9, 64)], n_bram_cap=10)


MODEL_CHECKS = {f.__name__[len("check_"):]: f for f in (
    check_vgg16_layer_table, check_flow1_bram_explodes_on_early_layers,
    check_flow2_fewer_brams_more_traffic, check_flow3_never_advantageous,
    check_flexible_interpolates_pure_flows,
    check_latency_budget_partitions_tau,
    check_optimize_searches_arch_space, check_infeasible_cap_raises)}


@pytest.mark.parametrize("name", list(MODEL_CHECKS))
def test_reference_dataflow_assertions_on_port(name):
    MODEL_CHECKS[name]()


def alg1_all_layers_planned(plan):
    assert [l.layer for l in plan.layers] == \
        [l.name for l in df.VGG16_OPT_LAYERS]
    assert plan.p_par == 9 and plan.n_par == 64


def alg1_bram_cap_respected(plan):
    assert all(l.n_bram < 2160 for l in plan.layers)


def alg1_beats_pure_flows(plan):
    """Flow opt moves fewer words than pure Flow #2, by more than a
    quarter (the paper reports 42 %)."""
    pure = opt.pure_flow_transfers(df.VGG16_OPT_LAYERS, K, ALPHA,
                                   plan.p_par, plan.n_par)
    total_flow2 = sum(v["flow2"] for v in pure.values())
    assert plan.total_transfers_words < total_flow2
    assert 1 - plan.total_transfers_words / total_flow2 > 0.25


def alg1_streaming_params_monotone(plan):
    ns = {l.layer: l.ns for l in plan.layers}
    assert ns["conv5_1"] >= ns["conv1_2"]


def alg1_bandwidth_under_ddr(plan):
    assert plan.bw_max_gbps < 19.0


def alg1_plus_alg2_consistency(plan):
    """test_system.py: the Alg-1 plan's N' feeds Alg 2 (the port's
    scheduler); utilization and bandwidth within the paper's envelope."""
    rng = np.random.default_rng(0)
    idx = np.stack([np.sort(rng.choice(64, 16, replace=False))
                    for _ in range(plan.n_par)])
    s = sch.schedule_exact_cover(idx, 64, r=10)
    sch.verify_schedule(s, idx, 64)
    assert s.pe_utilization > 0.8


ALG1_CHECKS = {f.__name__: f for f in (
    alg1_all_layers_planned, alg1_bram_cap_respected, alg1_beats_pure_flows,
    alg1_streaming_params_monotone, alg1_bandwidth_under_ddr,
    alg1_plus_alg2_consistency)}


@pytest.mark.parametrize("name", list(ALG1_CHECKS))
def test_reference_alg1_assertions_on_port(alg1, name):
    ALG1_CHECKS[name](alg1["9x64"][0])

"""repro_torch's spectral serving front end (``launch.spectral_serve``),
its plan cache (``core.plan.plan_cache_key`` / ``PlanCache``) and
``testing.faults.chaos_soak``, held to the reference's.

Three groups, all on the CPU (the kernel wrappers run their plain
versions):

- the reference's serving tests (``tests/test_spectral_serve.py``) on the
  port's server, at their tolerances (1e-5 abs of the einsum oracle, the
  einsum rung bit for bit under plan corruption), with scheduled
  windowed plans (the reference's halo path does not run on this tree's
  jax, so nothing here asks either package for ``input_mode="auto"``);
- the port's server against the reference's, run side by side on the
  same weights and requests through the same scenario: equal response
  codes and rungs, ladder transitions and counters, logits within 1e-5
  of max|reference|.  The requests carry no deadline, so the ladder is a
  function of the queue's fill alone (the service EMA is wall time);
- the cache key against the reference's tuple, and the port-only rules:
  no CPU fallback, the sticky-error rule.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import resnet18_spectral as jresnet
from repro.configs import vgg16_spectral as jvgg
from repro.core import dataflow as jdf
from repro.core import plan as jpl
from repro.launch import spectral_serve as jss
from repro.testing import faults as jfaults
from repro_torch.configs import resnet18_spectral, vgg16_spectral
from repro_torch.core import dataflow as df
from repro_torch.core import plan as pl
from repro_torch.interop import params_from_numpy
from repro_torch.launch import spectral_serve as ss
from repro_torch.models import cnn
from repro_torch.testing import faults

CFG = vgg16_spectral.SMOKE
BUCKETS = (1, 2)
# scheduled, so 'serve_plan_cache' has tables to corrupt; windowed, the
# input path both packages run here
PLAN_KW = {"hadamard": "scheduled", "input_mode": "windowed"}
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after).
    SMOKE's ops are small, and when test processes share the cores a
    thread pool per op stalls on the others (~15x slower with six busy
    processes on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shared_cache():
    """One PlanCache for the port's servers of this module: they all
    draw their weights from seed 0 and build with the same kwargs."""
    return pl.PlanCache()


def make_server(shared_cache, **kw):
    clock = ss.ManualClock()
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("queue_limit", 4)
    kw.setdefault("plan_kwargs", dict(PLAN_KW))
    srv = ss.SpectralServer(CFG, clock=clock, plan_cache=shared_cache,
                            device="cpu", **kw)
    return srv, clock


def oracle(srv, images):
    """The port's einsum logits for a stack of [C, H, W] images, padded
    to their bucket."""
    b = len(images)
    bucket = srv._bucket_for(b)
    plan = srv.plans.get(srv.params, CFG, bucket, **srv.plan_kwargs)
    x = np.zeros((bucket,) + srv.image_shape, np.float32)
    for i, img in enumerate(images):
        x[i] = img
    y = cnn.forward_spectral(srv.params, plan, torch.from_numpy(x),
                             backend="einsum")
    return y.numpy()[:b]


# ---------------------------------------------------------------------------
# The reference's serving tests on the port's server
# ---------------------------------------------------------------------------

def test_admission_control_and_shedding(shared_cache):
    """The queue is bounded: excess requests are shed at once with a
    structured 'overloaded' response, a malformed image fails
    structurally, nothing queues without bound."""
    srv, _ = make_server(shared_cache, queue_limit=2)
    reqs = ss.synthetic_requests(5, CFG, seed=0)
    bad = ss.InferenceRequest(rid=99, image=np.zeros((1, 4, 4),
                                                     np.float32))
    for r in reqs:
        srv.submit(r)
    srv.submit(bad)
    assert [r.code for r in reqs] == [None, None, "overloaded",
                                      "overloaded", "overloaded"]
    assert all("queue full" in r.error for r in reqs[2:])
    assert bad.code == "failed" and "bad_request" in bad.error
    assert len(srv.queue) == 2
    stats = srv.run_until_drained()
    assert all(r.terminal for r in reqs)
    assert stats["counters"]["ok"] == 2
    assert stats["counters"]["overloaded"] == 3
    assert stats["loop_deaths"] == 0


def test_deadline_expiry_before_execution(shared_cache):
    """A queued request past its deadline retires 'deadline_exceeded'
    and never reaches a kernel; a request with slack runs."""
    srv, clock = make_server(shared_cache)
    tight = ss.synthetic_requests(2, CFG, seed=1, deadline_s=1.0)
    loose = ss.synthetic_requests(1, CFG, seed=7, rid0=10)[0]
    for r in tight:
        srv.submit(r)
    srv.submit(loose)
    clock.advance(2.0)          # past the tight deadlines, before a tick
    srv.run_until_drained()
    assert [r.code for r in tight] == ["deadline_exceeded"] * 2
    assert all(r.logits is None for r in tight)
    assert loose.code == "ok"
    ref = oracle(srv, [loose.image])
    assert float(np.abs(ref[0] - loose.logits).max()) <= TOL


def test_bucketing_parity_and_warm_cache(shared_cache):
    """Requests are padded into the smallest bucket that fits and match
    the einsum oracle; serving builds no plan (the cache was warmed)."""
    srv, _ = make_server(shared_cache, queue_limit=8)
    builds_before = srv.plans.builds
    reqs = ss.synthetic_requests(3, CFG, seed=2)
    for r in reqs:
        srv.submit(r)
    stats = srv.run_until_drained()
    assert stats["counters"]["ok"] == 3
    # 3 requests over buckets (1, 2): one batch of 2, one of 1
    assert stats["batches"] == 2
    assert all(r.rung == "fused" for r in reqs)
    ref = oracle(srv, [r.image for r in reqs[:2]])
    for r, y in zip(reqs[:2], ref):
        assert float(np.abs(y - r.logits).max()) <= TOL
    ref = oracle(srv, [reqs[2].image])
    assert float(np.abs(ref[0] - reqs[2].logits).max()) <= TOL
    assert srv.plans.builds == builds_before   # no request-path build
    # the service EMA the ladder reads, per rung that served
    assert set(stats["service_ema_ms"]) == {"fused"}
    assert stats["service_ema_ms"]["fused"] > 0.0


def test_load_ladder_demotes_and_promotes(shared_cache):
    """Queue pressure >= demote_pressure demotes one rung; pressure
    clearing promotes back; every transition, with its pressure, is in
    health_report()."""
    srv, _ = make_server(shared_cache, queue_limit=4,
                         demote_patience=1, promote_patience=1)
    reqs = ss.synthetic_requests(4, CFG, seed=3)
    for r in reqs:
        srv.submit(r)
    stats = srv.run_until_drained()
    health = srv.health_report()
    assert stats["demotions"] >= 1 and stats["promotions"] >= 1
    dirs = [t["direction"] for t in health["transitions"]]
    assert "demote" in dirs and "promote" in dirs
    assert all({"tick", "t", "from", "to", "reason", "pressure"}
               <= set(t) for t in health["transitions"])
    first = health["transitions"][0]
    assert (first["direction"], first["from"], first["to"]) == \
        ("demote", "fused", "staged")
    assert first["pressure"] >= srv.demote_pressure
    assert health["rung"] == "fused"
    assert all(r.code == "ok" for r in reqs)


def test_serve_kernel_fault_retries_down_and_breaker_recovers(
        shared_cache):
    """A kernel fault mid-request moves the batch to the next rung in the
    same tick, opens that backend's breaker, and the breaker walks open
    -> half_open -> closed once the fault is gone and the cooldown has
    passed."""
    srv, clock = make_server(shared_cache, breaker_failures=1,
                             breaker_cooldown_s=1.0)
    r1 = ss.synthetic_requests(1, CFG, seed=4)[0]
    with faults.inject("serve_kernel", backend="fused") as fault:
        srv.submit(r1)
        srv.run_until_drained(cooldown_ticks=0)
    assert fault.fires == 1
    assert r1.code == "ok" and r1.rung == "staged"
    ref = oracle(srv, [r1.image])
    assert float(np.abs(ref[0] - r1.logits).max()) <= TOL
    brk = srv.breakers["fused"]
    assert brk.state == "open" and brk.n_opens == 1

    # inside the cooldown: fused is skipped without an attempt
    r2 = ss.synthetic_requests(1, CFG, seed=5, rid0=1)[0]
    srv.submit(r2)
    srv.run_until_drained(cooldown_ticks=0)
    assert r2.code == "ok" and r2.rung == "staged"
    assert brk.state == "open"

    # the cooldown over: the half-open probe succeeds and closes it
    clock.advance(2.0)
    r3 = ss.synthetic_requests(1, CFG, seed=6, rid0=2)[0]
    srv.submit(r3)
    srv.run_until_drained(cooldown_ticks=0)
    assert r3.code == "ok" and r3.rung == "fused"
    assert brk.state == "closed"
    assert [t["to"] for t in brk.transitions] == ["open", "half_open",
                                                  "closed"]


def test_all_rungs_failing_is_a_structured_failure(shared_cache):
    """When every rung faults, einsum included, the request gets a
    terminal 'failed' response and the loop lives on."""
    srv, _ = make_server(shared_cache)
    req = ss.synthetic_requests(1, CFG, seed=8)[0]
    with faults.inject("serve_kernel"):        # no match: every backend
        srv.submit(req)
        stats = srv.run_until_drained(cooldown_ticks=0)
    assert req.code == "failed"
    assert "einsum" in req.error
    assert stats["loop_deaths"] == 0
    ok = ss.synthetic_requests(1, CFG, seed=9, rid0=1)[0]
    srv.submit(ok)
    srv.run_until_drained(cooldown_ticks=0)
    assert ok.code == "ok"


def test_plan_cache_corruption_served_by_einsum(shared_cache):
    """A corrupted plan out of the cache is caught by validate_plan on
    fetch and the batch runs on the einsum rung (which never reads the
    tables): the oracle's answer bit for bit, no silent run of a bad
    plan; the next fetch validates the pristine plan and recovers."""
    srv, _ = make_server(shared_cache)
    req = ss.synthetic_requests(1, CFG, seed=10)[0]
    with faults.inject("serve_plan_cache") as fault:
        srv.submit(req)
        srv.run_until_drained(cooldown_ticks=0)
        assert 1 in srv.health_report()["plan_cache"]["corrupt_buckets"]
    assert fault.fires >= 1
    assert req.code == "ok" and req.rung == "einsum"
    ref = oracle(srv, [req.image])
    assert float(np.abs(ref[0] - req.logits).max()) == 0.0
    assert srv.counters["plan_cache_corruptions"] >= 1
    ok = ss.synthetic_requests(1, CFG, seed=11, rid0=1)[0]
    srv.submit(ok)
    srv.run_until_drained(cooldown_ticks=0)
    assert ok.code == "ok" and ok.rung == "fused"
    assert srv.health_report()["plan_cache"]["corrupt_buckets"] == []


def test_slow_injection_advances_clock_and_counts(shared_cache):
    """serve_slow adds service seconds on the virtual clock and is
    counted."""
    srv, clock = make_server(shared_cache)
    req = ss.synthetic_requests(1, CFG, seed=12)[0]
    t0 = clock()
    with faults.inject("serve_slow"):
        srv.submit(req)
        srv.run_until_drained(cooldown_ticks=0)
    assert req.code == "ok"
    assert clock() - t0 == pytest.approx(faults.SLOW_EXTRA_S)
    assert srv.counters["slow_injections"] == 1
    assert req.latency_s >= faults.SLOW_EXTRA_S


def test_loop_death_is_contained(shared_cache, monkeypatch):
    """A tick-level exception is a counted loop death that fails at most
    the queue head; the drain goes on for the rest."""
    srv, _ = make_server(shared_cache, queue_limit=8)
    reqs = ss.synthetic_requests(4, CFG, seed=13)
    for r in reqs:
        srv.submit(r)
    real = srv._take_batch
    calls = {"n": 0}

    def explode_once(now):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected tick explosion")
        return real(now)

    monkeypatch.setattr(srv, "_take_batch", explode_once)
    stats = srv.run_until_drained()
    assert stats["loop_deaths"] == 1
    assert all(r.terminal for r in reqs)
    assert sum(r.code == "failed" for r in reqs) == 1
    assert sum(r.code == "ok" for r in reqs) == 3


def test_chaos_soak_drains_with_all_gates():
    """The deterministic 4x-capacity fault-injected burst drains with no
    loop death, every request terminal, the excess shed, a demotion and
    a promotion, every fault site exercised and every answer within
    1e-5 of the einsum oracle."""
    rep = faults.chaos_soak(queue_limit=8, seed=0, device="cpu")
    assert rep["failed_gates"] == [], rep["gates"]
    assert all(rep["gates"].values()) and len(rep["gates"]) == 10
    assert rep["requests"] >= 4 * rep["queue_limit"]
    assert rep["stats"]["loop_deaths"] == 0
    assert rep["oracle_max_abs_err"] <= 1e-5
    dirs = [t["direction"] for t in rep["health"]["transitions"]]
    assert "demote" in dirs and "promote" in dirs


def test_chaos_soak_relative_oracle_tolerance():
    """With ``oracle_rel_tol`` the oracle gate is that fraction of
    max|einsum logits| of the soak's own oracle pass: every gate holds at
    1e-4 of SMOKE's logits, and a negative fraction fails exactly that
    gate."""
    rep = faults.chaos_soak(queue_limit=8, seed=0, device="cpu",
                            oracle_rel_tol=1e-4)
    assert rep["failed_gates"] == [], rep["gates"]
    # SMOKE's logits are ~7e-4: the tolerance is far under 1e-5 absolute
    assert 0.0 < rep["oracle_tol"] < 1e-6
    assert rep["oracle_max_abs_err"] <= rep["oracle_tol"]
    bad = faults.chaos_soak(queue_limit=8, seed=0, device="cpu",
                            oracle_rel_tol=-1.0)
    assert bad["failed_gates"] == ["no_silent_wrong_answers"]
    assert bad["oracle_tol"] == pytest.approx(-1e4 * rep["oracle_tol"])


def test_synthetic_requests_deterministic():
    a = ss.synthetic_requests(3, CFG, seed=42)
    b = ss.synthetic_requests(3, CFG, seed=42)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.image, rb.image)
    c = ss.synthetic_requests(1, CFG, seed=43)
    assert float(np.abs(a[0].image - c[0].image).max()) > 0


# ---------------------------------------------------------------------------
# The port's server against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_caches():
    """A plan cache per package for the parity servers (their weights
    are the reference's, not seed 0's of ``shared_cache``)."""
    return jpl.PlanCache(), pl.PlanCache()


def scenario_burst(mod, fmod, srv, clock):
    """A 2x-capacity burst: half shed, the ladder demotes and promotes."""
    reqs = mod.synthetic_requests(2 * srv.queue_limit, srv.cfg, seed=20)
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return reqs


def scenario_serve_kernel(mod, fmod, srv, clock):
    """'serve_kernel' on fused: a retry on staged, the fused breaker open,
    then half-open and closed after the cooldown."""
    reqs = [mod.synthetic_requests(1, srv.cfg, seed=21 + i, rid0=i)[0]
            for i in range(3)]
    with fmod.inject("serve_kernel", backend="fused"):
        srv.submit(reqs[0])
        srv.run_until_drained(cooldown_ticks=0)
    srv.submit(reqs[1])
    srv.run_until_drained(cooldown_ticks=0)
    clock.advance(2.0)
    srv.submit(reqs[2])
    srv.run_until_drained(cooldown_ticks=0)
    return reqs


def scenario_plan_cache(mod, fmod, srv, clock):
    """'serve_plan_cache': the batch on einsum, the next on fused."""
    reqs = [mod.synthetic_requests(1, srv.cfg, seed=24 + i, rid0=i)[0]
            for i in range(2)]
    with fmod.inject("serve_plan_cache"):
        srv.submit(reqs[0])
        srv.run_until_drained(cooldown_ticks=0)
    srv.submit(reqs[1])
    srv.run_until_drained(cooldown_ticks=0)
    return reqs


# scenario: (driver, server kwargs, the rungs of the 'ok' requests)
SCENARIOS = {
    "burst": (scenario_burst, {}, ["staged"] * 4),
    "serve_kernel": (scenario_serve_kernel,
                     {"breaker_failures": 1, "breaker_cooldown_s": 1.0},
                     ["staged", "staged", "fused"]),
    "serve_plan_cache": (scenario_plan_cache, {}, ["einsum", "fused"]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_server_matches_reference_server(both_caches, name):
    run, kw, rungs = SCENARIOS[name]
    jcache, cache = both_caches
    common = dict(buckets=BUCKETS, queue_limit=4, plan_kwargs=dict(PLAN_KW),
                  **kw)
    jclock = jss.ManualClock()
    jsrv = jss.SpectralServer(jvgg.SMOKE, clock=jclock, plan_cache=jcache,
                              **common)
    clock = ss.ManualClock()
    srv = ss.SpectralServer(
        CFG, clock=clock, plan_cache=cache, device="cpu",
        params=params_from_numpy(jax.tree_util.tree_map(np.array,
                                                        jsrv.params),
                                 "cpu"),
        **common)
    jreqs = run(jss, jfaults, jsrv, jclock)
    reqs = run(ss, faults, srv, clock)

    assert [(r.code, r.rung) for r in reqs] == \
        [(r.code, r.rung) for r in jreqs]
    assert all(r.terminal for r in reqs)
    assert [r.rung for r in reqs if r.ok] == rungs

    def moves(s):
        return [(t["tick"], t["direction"], t["from"], t["to"])
                for t in s.transitions]

    assert moves(srv) == moves(jsrv)
    if name == "burst":
        assert [m[1] for m in moves(srv)] == ["demote", "promote"]
        assert srv.counters["overloaded"] == srv.queue_limit
    st, jst = srv.stats(), jsrv.stats()
    for k in ("counters", "served_by_rung", "batches", "ticks",
              "demotions", "promotions", "loop_deaths"):
        assert st[k] == jst[k], k
    assert {n: [t["to"] for t in b.transitions]
            for n, b in srv.breakers.items()} == \
        {n: [t["to"] for t in b.transitions]
         for n, b in jsrv.breakers.items()}
    served = [(r, j) for r, j in zip(reqs, jreqs) if j.ok]
    assert served
    for r, j in served:
        ref = np.asarray(j.logits)
        assert float(np.abs(r.logits - ref).max()) <= \
            TOL * float(np.abs(ref).max())


def test_synthetic_requests_match_reference():
    """The same seed gives the reference's images, ids and deadlines."""
    mine = ss.synthetic_requests(4, CFG, seed=5, deadline_s=0.5, rid0=3)
    ref = jss.synthetic_requests(4, jvgg.SMOKE, seed=5, deadline_s=0.5,
                                 rid0=3)
    for a, b in zip(mine, ref):
        assert (a.rid, a.deadline_s) == (b.rid, b.deadline_s)
        np.testing.assert_array_equal(a.image, b.image)


# ---------------------------------------------------------------------------
# The plan cache
# ---------------------------------------------------------------------------

class _GoldCfg:
    name = "golden"
    fft_size = 8
    alpha = 4.0
    layers = (df.ConvLayer("c1", 4, 8, 16, 16),)
    pool_after = frozenset()
    graph = (df.NodeSpec(id="c1"),)


class _JGoldCfg:
    name = "golden"
    fft_size = 8
    alpha = 4.0
    layers = (jdf.ConvLayer("c1", 4, 8, 16, 16),)
    pool_after = frozenset()
    graph = (jdf.NodeSpec(id="c1"),)


def test_plan_cache_key_golden_snapshot():
    """The key's tuple is the reference's golden snapshot
    (``tests/test_dag_plan.py``), and its live key for the same config."""
    key = pl.plan_cache_key(_GoldCfg, 2, mesh_shape=(2,),
                            hadamard="scheduled")
    assert key == (
        "golden", 8, (4.0,), 2,
        ("mesh", (2,)),
        ("graph", (("c1", "conv", ("input",), "max", None, True),)),
        (("hadamard", "'scheduled'"),),
    )
    assert key == jpl.plan_cache_key(_JGoldCfg, 2, mesh_shape=(2,),
                                     hadamard="scheduled")


@pytest.mark.parametrize("preset", ["vgg16", "resnet18"])
def test_plan_cache_key_equals_reference_on_presets(preset):
    """Both SMOKE presets (ResNet-18's residual DAG included) key alike
    in both packages, over batch, mesh and build kwargs."""
    cfg, jcfg = {"vgg16": (CFG, jvgg.SMOKE),
                 "resnet18": (resnet18_spectral.SMOKE, jresnet.SMOKE)}[preset]
    for batch, mesh, kw in ((1, None, {}), (4, (2,), PLAN_KW),
                            (8, (2, 2), {"hadamard": "bin"})):
        assert pl.plan_cache_key(cfg, batch, mesh_shape=mesh, **kw) == \
            jpl.plan_cache_key(jcfg, batch, mesh_shape=mesh, **kw)


def test_plan_cache_key_axes_distinct():
    """Every axis gives a distinct key: batch, mesh, build kwargs, the
    DAG fields, and the device a plan lives on."""
    base = pl.plan_cache_key(_GoldCfg, 1)

    class NoGraph(_GoldCfg):
        graph = None

    class Rewired(_GoldCfg):
        graph = (df.NodeSpec(id="c1", residual_from="input"),)

    class NoRelu(_GoldCfg):
        graph = (df.NodeSpec(id="c1", relu=False),)

    keys = [base,
            pl.plan_cache_key(_GoldCfg, 2),
            pl.plan_cache_key(_GoldCfg, 1, mesh_shape=(2,)),
            pl.plan_cache_key(_GoldCfg, 1, mesh_shape=(1,)),
            pl.plan_cache_key(_GoldCfg, 1, hadamard="dense"),
            pl.plan_cache_key(_GoldCfg, 1, input_mode="halo"),
            pl.plan_cache_key(NoGraph, 1),
            pl.plan_cache_key(Rewired, 1),
            pl.plan_cache_key(NoRelu, 1),
            pl.plan_cache_key(_GoldCfg, 1, device=torch.device("cpu")),
            pl.plan_cache_key(_GoldCfg, 1,
                              device=torch.device("cuda", 0)),
            pl.plan_cache_key(_GoldCfg, 1,
                              device=torch.device("cuda", 1))]
    assert len(set(keys)) == len(keys)


def test_server_keys_its_plans_by_device_and_mesh():
    """A server passes its device (a CUDA device with its index) and
    its mesh into every key: a cache shared with a server elsewhere never
    hands it that server's plan."""
    built = []

    def builder(params, cfg, *, batch, **kw):
        built.append((batch, kw["device"]))
        return types.SimpleNamespace(batch=batch)

    cache = pl.PlanCache(builder=builder)
    srv = ss.SpectralServer(CFG, buckets=(1, 2), device="cpu",
                            plan_cache=cache, mesh_shape=(2,))
    assert srv.device == torch.device("cpu")
    assert built == [(1, torch.device("cpu")), (2, torch.device("cpu"))]
    for key in cache._plans:
        assert ("mesh", (2,)) in key
        assert ("device", repr(torch.device("cpu"))) in key[-1]
    card = pl.plan_cache_key(CFG, 1, mesh_shape=(2,), **{
        **srv.plan_kwargs, "device": torch.device("cuda", 0)})
    assert card not in cache._plans


def test_plan_cache_warm_get_invalidate():
    built = []

    def builder(params, cfg, *, batch, **kw):
        built.append((batch, tuple(sorted(kw))))
        return types.SimpleNamespace(batch=batch)

    cache = pl.PlanCache(builder=builder)
    keys = cache.warm({}, CFG, (1, 2))
    assert set(keys) == {1, 2} and len(cache) == 2
    assert cache.builds == 2 and cache.build_s >= 0.0
    # hits never call the builder
    p1 = cache.get({}, CFG, 1)
    assert p1.batch == 1 and cache.hits == 1 and cache.builds == 2
    # other build kwargs: another entry, never a collision
    cache.get({}, CFG, 1, hadamard="scheduled")
    assert cache.builds == 3 and len(cache) == 3
    # an invalidation forces exactly one rebuild
    assert cache.invalidate(keys[1])
    assert not cache.invalidate(keys[1])        # already gone
    cache.get({}, CFG, 1)
    assert cache.builds == 4 and cache.invalidations == 1
    st = cache.stats()
    assert st["entries"] == 3 and st["builds"] == 4
    assert st["misses"] == 4 and st["hits"] == 1
    # scalar and per-layer alpha key alike
    seq = dataclasses.replace(CFG, alpha=(4.0,) * len(CFG.layers))
    assert pl.plan_cache_key(CFG, 1) == pl.plan_cache_key(seq, 1)


def test_plan_cache_default_builder_is_build_network_plan():
    """With no builder the cache builds the port's plan, on the device
    the build kwargs name."""
    cache = pl.PlanCache()
    params = cnn.init(CFG, device="cpu")
    plan = cache.get(params, CFG, 2, device="cpu")
    assert isinstance(plan, pl.NetworkPlan) and plan.batch == 2
    assert cache.get(params, CFG, 2, device="cpu") is plan
    assert cache.stats()["builds"] == 1 and cache.build_s > 0


def test_key_folds_mesh_shape():
    k_none = pl.plan_cache_key(_GoldCfg, 1)
    k1 = pl.plan_cache_key(_GoldCfg, 1, mesh_shape=(1,))
    k4 = pl.plan_cache_key(_GoldCfg, 1, mesh_shape=(4,))
    k8 = pl.plan_cache_key(_GoldCfg, 1, mesh_shape=(8,))
    k24 = pl.plan_cache_key(_GoldCfg, 1, mesh_shape=(2, 4))
    assert len({k_none, k1, k4, k8, k24}) == 5
    assert k4 == pl.plan_cache_key(_GoldCfg, 1, mesh_shape=[4])


def test_plan_cache_separates_meshes():
    built = []

    def builder(params, cfg, *, batch, **kw):
        built.append(batch)
        return ("plan", len(built))

    cache = pl.PlanCache(builder=builder)
    a = cache.get({}, _GoldCfg, 1)
    b = cache.get({}, _GoldCfg, 1, mesh_shape=(8,))
    c = cache.get({}, _GoldCfg, 1, mesh_shape=(4,))
    assert len(built) == 3                # one build per mesh
    assert a != b and b != c
    assert cache.get({}, _GoldCfg, 1, mesh_shape=(8,)) == b
    assert cache.get({}, _GoldCfg, 1) == a
    assert len(built) == 3
    assert cache.stats()["hits"] == 2


def test_server_threads_mesh_shape():
    import inspect
    sig = inspect.signature(ss.SpectralServer.__init__)
    assert "mesh_shape" in sig.parameters


# ---------------------------------------------------------------------------
# Port-only rules
# ---------------------------------------------------------------------------

def test_server_without_cuda_raises():
    """With no device the server and the soak ask for the card, and with
    no card they raise; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ss.SpectralServer(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        faults.chaos_soak(queue_limit=4)


def test_sticky_cuda_error_fails_the_batch_at_once(shared_cache):
    """A fault that reads as a sticky CUDA error fails the batch with a
    structured response naming it, counted in kernel_faults and the
    breaker, the lower rungs never tried; the loop lives on."""
    srv, _ = make_server(shared_cache)
    req = ss.synthetic_requests(1, CFG, seed=30)[0]
    sticky = "CUDA error: an illegal memory access was encountered"
    with faults.inject("serve_kernel", backend="fused",
                       exc=lambda: RuntimeError(sticky)) as fused, \
            faults.inject("serve_kernel", backend="staged") as staged, \
            faults.inject("serve_kernel", backend="einsum") as einsum:
        srv.submit(req)
        stats = srv.run_until_drained(cooldown_ticks=0)
    assert (fused.fires, staged.fires, einsum.fires) == (1, 0, 0)
    assert req.code == "failed"
    assert "illegal memory access" in req.error and "sticky" in req.error
    assert stats["counters"]["kernel_faults"] == 1
    assert stats["served_by_rung"] == {"fused": 0, "staged": 0,
                                       "einsum": 0}
    assert srv.breakers["fused"].failures == 1
    assert stats["loop_deaths"] == 0
    ok = ss.synthetic_requests(1, CFG, seed=31, rid0=1)[0]
    srv.submit(ok)
    srv.run_until_drained(cooldown_ticks=0)
    assert ok.code == "ok" and ok.rung == "fused"

"""Deterministic fault injection for the resilience layer (counterpart of
``repro.testing.faults``).

The degradation ladder (``core.resilience``) exists for failures that
are hard to reproduce on purpose: an nvcc build that fails, a launch the
card refuses for its shared memory, corrupted Alg-2 tables.
``inject(site, ...)`` installs a fault at one of the named sites the
port consults (``resilience.fault_check`` / ``fault_corrupt``), so tests
drive every edge of the ladder, on the CPU through the plain versions
and on the card through the kernels.

Sites (``FAULT_SITES``):

  'lowering'        raise at kernel dispatch (``execute_layer_plan``,
                    ``execute_band_plan``, the staged rung): a kernel
                    variant that fails to build or launch.  Match kwargs
                    (``input_mode='halo'``, ``hadamard='scheduled'``,
                    ``residual='fused'``, ``backend='fused'``, ``layer=``)
                    pick which variants fail, so which rung moves.
  'vmem_overflow'   raise at the fused dispatch with the error the card
                    gives a launch that asks for more shared memory than
                    a CTA may take (the site keeps the reference's name).
  'oob_index'       push one Alg-2 INDEX entry far out of the active-bin
                    range where ``scheduler.compile_layer_tables`` stacks
                    the tables: plan validation refuses it at build.
  'corrupt_value'   perturb one VALUE entry (finite but wrong) there:
                    invisible to validation, caught by the parity guard.
  'nan_activations' put a NaN into a fused layer's output: caught by the
                    NaN scan.
  'shard_tables'    a fault in one shard of a sharded plan (match on
                    ``shard=``, ``layer=``, ``strategy=``): a raise by
                    default, or with ``corrupt=`` a transform of that
                    shard's tables; consulted on the host, where the
                    executor stages shard tables and where
                    ``resilience.harden_sharded_plan`` probes.

Serving sites (consulted by ``launch.spectral_serve``):

  'serve_kernel'     raise at batch dispatch in the serving loop (match on
                     ``backend='fused'|'staged'|'einsum'``, the rung being
                     tried, and/or ``bucket=``): drives the rung's breaker
                     and the retry a rung down.
  'serve_plan_cache' corrupt the plan fetched from the serving cache (one
                     scheduled layer's INDEX table pushed out of range by
                     ``corrupt_plan_tables``: the plan must have a
                     scheduled layer).  ``validate_plan`` catches it on
                     fetch and the batch runs on the einsum rung.
  'serve_slow'       add ``SLOW_EXTRA_S`` seconds to a batch's service time
                     (advancing the server's clock where it can be).

``chaos_soak`` drives a 4x-capacity burst through all three.

Usage::

    from repro_torch.testing import faults

    with faults.inject("lowering", input_mode="halo") as fault:
        plan = resilience.harden_network_plan(plan)   # halo -> windowed
    assert fault.fires > 0

Faults match on the call site's context and are removed when the
``with`` block exits; nested faults compose.  Nothing here is random.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core import resilience as res

FAULT_SITES = res.FAULT_SITES

# An index far outside any active-bin range (K^2 <= 64 here).
OOB_INDEX = 1_000_000
# Extra service seconds of 'serve_slow'.
SLOW_EXTRA_S = 0.25
# The finite perturbation of one VALUE entry: large enough that the
# sampled parity guard (tol 1e-4) trips on channel 0, small enough to
# stay finite through the network.
VALUE_DELTA = 32.0


def _default_exc(site: str, match: dict) -> Callable[[], Exception]:
    """Raw errors, worded like the failures they stand for; the
    resilience layer must turn them into structured ones.  None of them
    reads as a sticky CUDA error (``resilience.is_sticky_cuda_error``)."""
    if site == "vmem_overflow":
        return lambda: RuntimeError(
            "kernel launch failed: cudaError 1: too much dynamic shared "
            "memory requested for one CTA (injected fault, "
            f"match={match})")
    if site == "serve_kernel":
        return lambda: RuntimeError(
            f"kernel fault mid-request (injected fault, match={match})")
    return lambda: RuntimeError(
        f"kernel build or launch failed (injected fault at {site!r}, "
        f"match={match})")


def _copy(a):
    return a.clone() if isinstance(a, torch.Tensor) else np.array(a,
                                                                  copy=True)


def _corrupt_oob_index(idx):
    out = _copy(idx)
    out.reshape(-1)[0] = OOB_INDEX
    return out


def _corrupt_value(vr):
    out = _copy(vr)
    out.reshape(-1)[0] += VALUE_DELTA
    return out


def _corrupt_nan(y: torch.Tensor) -> torch.Tensor:
    out = y.clone()
    out[(0,) * out.dim()] = float("nan")
    return out


def _corrupt_served_plan(plan):
    return corrupt_plan_tables(plan, kind="oob_index")


def _corrupt_slow(dt):
    return float(dt) + SLOW_EXTRA_S


_DEFAULT_CORRUPT = {
    "oob_index": _corrupt_oob_index,
    "corrupt_value": _corrupt_value,
    "nan_activations": _corrupt_nan,
    "serve_plan_cache": _corrupt_served_plan,
    "serve_slow": _corrupt_slow,
}


@contextlib.contextmanager
def inject(site: str, *, exc: Callable[[], Exception] | None = None,
           corrupt: Callable | None = None,
           **match) -> Iterator[res.InjectedFault]:
    """Install one deterministic fault at ``site`` for the ``with`` block.

    ``match`` kwargs restrict it to call sites whose context carries
    every key with an equal value; ``exc`` replaces the raised
    exception's factory at a raise site, ``corrupt`` the transform at a
    corruption site.  Yields the ``InjectedFault`` (``fires`` counts its
    activations)."""
    if site in ("lowering", "vmem_overflow", "serve_kernel") or (
            site == "shard_tables" and corrupt is None):
        fault = res.InjectedFault(site=site, match=dict(match),
                                  exc=exc or _default_exc(site, match))
    elif site == "shard_tables" or site in _DEFAULT_CORRUPT:
        fault = res.InjectedFault(site=site, match=dict(match),
                                  corrupt=corrupt or _DEFAULT_CORRUPT[site])
    else:
        raise ValueError(f"unknown fault site {site!r}; must be one of "
                         f"{FAULT_SITES}")
    res.install_fault(fault)
    try:
        yield fault
    finally:
        res.remove_fault(fault)


def _corrupted(tables, kind: str):
    """``tables`` (``core.plan.PlanTables``) with idx ('oob_index') or vr
    ('corrupt_value') mutated, on the tables' own device."""
    mutate = _DEFAULT_CORRUPT[kind]
    if kind == "oob_index":
        return tables._replace(idx=mutate(tables.idx))
    return tables._replace(vr=mutate(tables.vr))


def corrupt_plan_tables(plan, *, layer: str | None = None,
                        kind: str = "oob_index"):
    """A copy of ``plan`` with the first scheduled layer's (or ``layer``'s)
    Alg-2 tables mutated (``kind``: 'oob_index' | 'corrupt_value'), for
    tests that a corrupted built plan is refused by ``validate_plan``."""
    new_layers, done = [], False
    for lp in plan.layers:
        if (not done and lp.tables is not None
                and (layer is None or lp.layer.name == layer)):
            lp = dataclasses.replace(lp, tables=_corrupted(lp.tables, kind))
            done = True
        new_layers.append(lp)
    if not done:
        raise ValueError(f"no scheduled layer matching {layer!r} in plan")
    return dataclasses.replace(plan, layers=tuple(new_layers))


def chaos_soak(*, cfg=None, queue_limit: int = 16, seed: int = 0,
               oracle_tol: float = 1e-5, oracle_rel_tol: float | None = None,
               log=None, device=None) -> dict:
    """Deterministic fault-injected soak of ``launch.spectral_serve`` on
    ``device`` (the CUDA device unless ``device="cpu"``).

    Submits >= 4x ``queue_limit`` requests in bursts while walking the
    server through every serving fault site on a virtual clock:

      wave 1  a 2x-capacity burst (the excess must be shed) with
              'serve_kernel' faults on the staged rung: the ladder demotes
              under queue pressure, the staged breaker opens, batches
              retry a rung down;
      wave 2  a 1x burst through a 'serve_plan_cache' corruption window:
              corrupt plans caught on fetch, served by the einsum rung;
      wave 3  tight-deadline requests behind a 'serve_slow' window: they
              must retire ``deadline_exceeded``, never run late;
      wave 4  a clean burst after the cooldown: the ladder promotes back
              to fused and serves on it.

    Gates (``failed_gates`` must be empty): all_terminal,
    zero_loop_deaths, shed_nonzero, deadline_exceeded_nonzero,
    demotion_and_promotion, kernel_faults_exercised,
    plan_cache_corruption_exercised, slow_injection_exercised,
    recovered_to_fused, and no_silent_wrong_answers: every 'ok' logits
    row within ``oracle_tol`` (absolute) of the einsum forward of the
    pristine plan on the soak's device.  With ``oracle_rel_tol`` the
    tolerance is instead ``oracle_rel_tol`` x max|einsum logits| of that
    oracle pass (the report's ``oracle_tol`` is then that product).

    Returns the report (gates, stats, health_report).
    """
    from repro_torch.launch import spectral_serve as ss
    from repro_torch.models import cnn

    if cfg is None:
        from repro_torch.configs import vgg16_spectral
        cfg = vgg16_spectral.SMOKE
    say = log or (lambda *_: None)
    clock = ss.ManualClock()
    srv = ss.SpectralServer(
        cfg, queue_limit=queue_limit, clock=clock, seed=seed,
        plan_kwargs={"hadamard": "scheduled"},
        demote_pressure=0.75, promote_pressure=0.25,
        demote_patience=1, promote_patience=2,
        breaker_failures=2, breaker_cooldown_s=0.5, device=device)

    reqs: list = []

    def burst(n: int, deadline_s: float | None = None) -> None:
        wave = ss.synthetic_requests(n, cfg, seed=seed + len(reqs),
                                     deadline_s=deadline_s,
                                     rid0=len(reqs))
        for r in wave:
            srv.submit(r)
        reqs.extend(wave)

    def drive(n: int, dt: float = 0.05) -> None:
        for _ in range(n):
            try:
                srv.tick()
            except Exception as e:        # noqa: BLE001 — soak must live
                srv.loop_deaths += 1
                say(f"loop death: {type(e).__name__}: {e}")
            clock.advance(dt)

    say(f"wave 1: 2x burst ({2 * queue_limit}) + staged kernel faults")
    burst(2 * queue_limit)
    with inject("serve_kernel", backend="staged"):
        drive(2)
    drive(4)  # faults cleared; idle ticks let the ladder promote

    say(f"wave 2: 1x burst ({queue_limit}) + plan-cache corruption")
    burst(queue_limit)
    with inject("serve_plan_cache"):
        drive(1)

    say("wave 3: tight deadlines behind a slow-service window")
    burst(queue_limit // 2, deadline_s=0.01)
    burst(queue_limit // 2)        # clean requests behind the tight ones
    clock.advance(0.05)            # tight deadlines expire while queued
    with inject("serve_slow"):
        drive(1)

    clock.advance(1.0)  # past the breaker cooldown
    srv.run_until_drained(max_ticks=20 * queue_limit)
    for _ in range(8 * srv.promote_patience):
        if srv._load_rung == 0 and not srv.queue:
            break
        drive(1, dt=0.1)

    say(f"wave 4: clean recovery burst ({queue_limit // 2}) on "
        f"rung {ss.SERVE_RUNGS[srv._load_rung]}")
    burst(queue_limit // 2)
    srv.run_until_drained(max_ticks=4 * queue_limit)

    stats = srv.stats()
    health = srv.health_report()

    # every completed answer against the einsum forward of the pristine
    # plan, on the soak's device
    ok_reqs = [r for r in reqs if r.ok]
    bucket = srv.buckets[-1]
    plan = srv.plans.get(srv.params, cfg, bucket, **srv.plan_kwargs)
    worst = scale = 0.0
    for i in range(0, len(ok_reqs), bucket):
        chunk = ok_reqs[i:i + bucket]
        x = np.zeros((bucket,) + srv.image_shape, np.float32)
        for j, r in enumerate(chunk):
            x[j] = r.image
        ref = cnn.forward_spectral(
            srv.params, plan, torch.from_numpy(x).to(srv.device),
            backend="einsum").cpu().numpy()
        scale = max(scale, float(np.abs(ref[:len(chunk)]).max()))
        for j, r in enumerate(chunk):
            worst = max(worst, float(np.max(np.abs(ref[j] - r.logits))))
    if oracle_rel_tol is not None:
        oracle_tol = oracle_rel_tol * scale

    c = stats["counters"]
    gates = {
        "all_terminal": all(r.terminal for r in reqs),
        "zero_loop_deaths": stats["loop_deaths"] == 0,
        "shed_nonzero": c["overloaded"] > 0,
        "deadline_exceeded_nonzero": c["deadline_exceeded"] > 0,
        "demotion_and_promotion": (stats["demotions"] >= 1
                                   and stats["promotions"] >= 1),
        "kernel_faults_exercised": c["kernel_faults"] > 0,
        "plan_cache_corruption_exercised":
            c["plan_cache_corruptions"] > 0,
        "slow_injection_exercised": c["slow_injections"] > 0,
        "recovered_to_fused": health["rung"] == "fused",
        "no_silent_wrong_answers": worst <= oracle_tol,
    }
    failed = sorted(k for k, v in gates.items() if not v)
    say(f"{len(reqs)} requests: {c['ok']} ok / {c['overloaded']} shed "
        f"/ {c['deadline_exceeded']} deadline / {c['failed']} failed; "
        f"max |err| {worst:.2e}; failed gates: {failed or 'none'}")
    return {
        "requests": len(reqs),
        "queue_limit": queue_limit,
        "gates": gates,
        "failed_gates": failed,
        "oracle_max_abs_err": worst,
        "oracle_tol": oracle_tol,
        "stats": stats,
        "health": health,
    }


def corrupt_shard_tables(splan, *, layer: str | None = None,
                         shard: int = 0, kind: str = "oob_index"):
    """A copy of a ``ShardedNetworkPlan`` with one shard's Alg-2 tables
    mutated (``kind`` as ``corrupt_plan_tables``), for tests that
    per-shard validation (``resilience.validate_sharded_plan``) catches a
    single rotten shard while its siblings stay healthy."""
    new_layers, done = [], False
    for slp in splan.layers:
        if (not done and len(slp.shards) > shard
                and slp.shards[shard].tables is not None
                and (layer is None or slp.base.layer.name == layer)):
            shards = list(slp.shards)
            shards[shard] = dataclasses.replace(
                shards[shard], tables=_corrupted(shards[shard].tables, kind))
            slp = dataclasses.replace(slp, shards=tuple(shards))
            done = True
        new_layers.append(slp)
    if not done:
        raise ValueError(
            f"no sharded layer matching layer={layer!r} with tables on "
            f"shard {shard} (build with hadamard='scheduled' and a "
            f"channel or spatial strategy)")
    return dataclasses.replace(splan, layers=tuple(new_layers))

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

The serving sites ('serve_kernel', 'serve_plan_cache', 'serve_slow')
are registered, with their defaults, for the serving front end, which
the port does not have yet; nothing consults them.

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

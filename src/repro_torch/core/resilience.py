"""Resilient execution: validated plans, tiered degradation, numeric
guards and the fault registry (counterpart of ``repro.core.resilience``).

  1. **Plan validation** (build time).  ``validate_plan`` runs structured
     invariant checks over a ``core.plan.NetworkPlan`` (each layer's
     shared memory against the CTA budget, the Alg-2 INDEX/VALUE tables'
     bounds and dtypes, halo block starts within the raw image, the
     CUDA launch geometry, the DAG) and raises ``PlanValidationError``
     with per-layer ``Diagnostic`` records instead of a bare ValueError,
     a launch-time refusal or an out-of-range read on the card.

  2. **Tiered graceful degradation** (plan hardening, opt-in).
     ``harden_network_plan`` validates each layer, then probes its kernel
     variant (one forward on zeros, synchronized) and, on failure,
     demotes it one rung at a time along ``DEMOTION_LADDER``

         input_mode  halo -> windowed
         hadamard    scheduled -> bin | dense (the plane kernel)
         epilogue    residual-fused -> residual-add
         backend     fused -> staged -> einsum

     re-pricing the tuning through ``core.autotune`` on the fused rungs.
     Every demotion is recorded in ``LayerPlan.provenance`` and shown by
     ``NetworkPlan.health_report()``.  Each rung computes the same
     function (windowed == halo bit for bit, plane == scheduled to float
     tolerance, staged and einsum are the standing oracles).  Nothing
     demotes unless the caller asks: ``forward_spectral`` on an
     unhardened plan raises ``KernelLoweringError`` where a layer fails.
     The backend axis alone (``BACKEND_RUNGS``, ``demote_layer_backend``,
     ``plan_at_backend_rung``) and a per-backend ``CircuitBreaker`` are
     the rungs a serving front end trades under load.

  3. **Runtime numeric guards** (opt-in).  ``NumericGuards`` adds a
     per-layer NaN/Inf scan and a sampled-channel parity check against
     the einsum oracle to ``models.cnn.forward_spectral``; each costs one
     host synchronization per layer on the card.

  4. **Fault injection** (testing).  The registry (``install_fault``,
     ``fault_check``, ``fault_corrupt``) that ``repro_torch.testing.faults``
     drives, so every edge of the ladder can be exercised on the CPU and
     on the card.  The hooks are one truthiness check when no fault is
     installed, and they run in Python on the host, outside any CUDA
     graph a caller could capture.

What differs on Hopper from the reference's TPU checks:

  * the VMEM budget is the CTA's shared-memory budget
    (``fsc.SMEM_PER_CTA``): check ``smem-budget`` reads the layer's
    layout (``fsc.plane_smem_bytes`` / ``fsc.sched_smem_bytes`` at its
    flow and ``block_m``; for a 'vmem' shortcut the staged layout of
    ``fsc.staged_shortcut_bytes``, the test ``_check_staged_fits``
    applies at launch);
  * the manual-DMA accumulator checks (``dma/*``) become checks of the
    port's launch rules (``fsc.os_launch_geometry``,
    ``is_launch_geometry``, ``ws_launch_geometry``,
    ``sched_flow_geometry``, ``sched_cluster``): tile blocks, n blocks and
    m ranges must cover the output and the input channels, and a
    scheduled flow's ring must hold ``fsc.SCHED_FLOW_STAGES_MIN``
    stages.  ``hw_safe`` has no Hopper meaning and is gone;
  * ``tables/m-pad`` asks for ``Mp >= c_in`` (the port's kernels take any
    channel padding) and ``n_bins`` is the padded active-bin count;
  * the tables live on the device: their checks reduce there and read
    back a few scalars, once per layer and validation, never per forward;
  * the staged and einsum rungs have no cost model, so their tunings
    carry ``None`` bytes and seconds;
  * a probe that dies of a sticky CUDA error (an illegal or misaligned
    address, a device-side assert) is not demoted: the context is lost
    and every lower rung would fail too, so ``harden_*`` raises
    ``KernelLoweringError`` at once, the error as its ``__cause__``.

Import discipline: this module imports only the leaf ``core`` modules
(``dataflow``, ``sparse``, ``spectral``); ``core.plan``, ``core.autotune``
and the kernels import it, and the functions that need them import them
lazily.
"""

from __future__ import annotations

import dataclasses
import re
import time
import warnings
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core import dataflow as df
from repro_torch.core import sparse as sp
from repro_torch.core import spectral as spec


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

class ResilienceError(Exception):
    """Base of the structured failure taxonomy: the failing ``layer``
    (None for network-level failures), the ``site`` that detected it and
    the per-layer ``Diagnostic`` records."""

    def __init__(self, message: str, *, layer: str | None = None,
                 site: str | None = None,
                 diagnostics: Sequence["Diagnostic"] = ()):
        self.layer = layer
        self.site = site
        self.diagnostics = tuple(diagnostics)
        if self.diagnostics:
            message = "\n".join([message] + [f"  - {d}"
                                             for d in self.diagnostics])
        super().__init__(message)


class PlanValidationError(ResilienceError, ValueError):
    """A NetworkPlan / LayerPlan / schedule invariant is violated (build
    or validate time).  A ValueError, so callers that caught the bare
    error keep working."""


class KernelLoweringError(ResilienceError, NotImplementedError):
    """The chosen kernel variant cannot build, launch or run (an nvcc
    failure, a launch refused for its shared memory, a fault on the
    card)."""


class NumericGuardError(ResilienceError, ValueError):
    """A runtime numeric guard tripped: non-finite activations, or the
    sampled parity check against the einsum oracle out of tolerance."""


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One failed (or advisory) invariant check of one layer."""

    layer: str
    check: str               # e.g. 'tables/idx-bounds', 'smem-budget'
    message: str
    severity: str = "error"  # 'error' | 'warn'

    def __str__(self) -> str:
        return f"[{self.layer}] {self.check} ({self.severity}): " \
               f"{self.message}"


# ---------------------------------------------------------------------------
# Fault-injection registry (driven by repro_torch.testing.faults)
# ---------------------------------------------------------------------------

# Named sites production code consults (``testing.faults`` documents
# each).  ``shard_tables`` is shard-scoped (its context carries the shard
# index), consulted on the host where a sharded layer's tables are staged
# and probed.  The ``serve_*`` sites are consulted by the serving front
# end (``launch.spectral_serve``).
FAULT_SITES = ("lowering", "vmem_overflow", "oob_index", "corrupt_value",
               "nan_activations", "shard_tables", "serve_kernel",
               "serve_plan_cache", "serve_slow")


@dataclasses.dataclass
class InjectedFault:
    """A deterministic fault installed at a named site.

    ``match`` restricts it to call sites whose context carries every
    listed key with an equal value (``{"input_mode": "halo"}`` fails only
    halo variants, so one rung of the ladder moves); ``exc`` is an
    exception factory for raise sites, ``corrupt`` a value transform for
    corruption sites; ``fires`` counts activations."""

    site: str
    match: dict = dataclasses.field(default_factory=dict)
    exc: Callable[[], Exception] | None = None
    corrupt: Callable[[Any], Any] | None = None
    fires: int = 0

    def matches(self, ctx: dict) -> bool:
        return all(ctx.get(k) == v for k, v in self.match.items())


_FAULTS: list[InjectedFault] = []


def install_fault(fault: InjectedFault) -> None:
    if fault.site not in FAULT_SITES:
        raise ValueError(f"unknown fault site {fault.site!r}; "
                         f"must be one of {FAULT_SITES}")
    _FAULTS.append(fault)


def remove_fault(fault: InjectedFault) -> None:
    if fault in _FAULTS:
        _FAULTS.remove(fault)


def fault_check(site: str, **ctx) -> None:
    """Raise the injected exception of a matching fault, if one is
    installed (a no-op, one truthiness check, otherwise)."""
    if not _FAULTS:
        return
    for f in _FAULTS:
        if f.site == site and f.exc is not None and f.matches(ctx):
            f.fires += 1
            raise f.exc()


def fault_corrupt(site: str, value, **ctx):
    """``value`` passed through every matching corruption fault."""
    if not _FAULTS:
        return value
    for f in _FAULTS:
        if f.site == site and f.corrupt is not None and f.matches(ctx):
            f.fires += 1
            value = f.corrupt(value)
    return value


# ---------------------------------------------------------------------------
# (1) Plan validation
# ---------------------------------------------------------------------------

def _default_budget(smem_budget: int | None) -> int:
    if smem_budget is not None:
        return smem_budget
    from repro_torch.kernels import fused_spectral_conv as fsc
    return fsc.SMEM_PER_CTA


def validate_tables(tables, *, n_bins: int, r: int, c_out: int,
                    c_in: int, layer: str = "?") -> list[Diagnostic]:
    """Bounds, dtype and shape invariants of one layer's Alg-2 tables.

    ``tables`` duck-types ``core.plan.PlanTables`` /
    ``scheduler.LayerTables`` (``idx`` / ``sel`` / ``vr`` / ``vi``, torch
    tensors on any device or numpy arrays).  Checks: idx/sel int32, vr/vi
    float32; idx entries in [0, n_bins) (the padded active bins the kernel
    gathers from); sel entries in [0, r); sel/vr/vi of one shape and idx
    aligned on [GN, Mp, T]; GN groups of N' lanes cover c_out the way the
    kernel needs (``(GN - 1) N' < c_out <= GN N'``, N' at most
    ``fsc.SCHED_BLOCK_N``); Mp >= c_in (the port's kernels take any
    channel padding); vr/vi finite.  The reductions run where the tables
    live and read back one small vector.
    """
    from repro_torch.kernels import fused_spectral_conv as fsc
    out: list[Diagnostic] = []
    d = lambda check, msg: out.append(Diagnostic(layer, check, msg))
    idx, sel, vr, vi = (
        a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        for a in (tables.idx, tables.sel, tables.vr, tables.vi))
    for name, arr, want in (("idx", idx, torch.int32),
                            ("sel", sel, torch.int32),
                            ("vr", vr, torch.float32),
                            ("vi", vi, torch.float32)):
        if arr.dtype != want:
            d(f"tables/{name}-dtype", f"{name} dtype {arr.dtype} != {want}")
    if sel.shape != vr.shape or sel.shape != vi.shape:
        d("tables/shape", f"sel {tuple(sel.shape)} / vr {tuple(vr.shape)} / "
                          f"vi {tuple(vi.shape)} shapes disagree")
    if idx.dim() != 4 or sel.dim() != 4 or idx.shape[:3] != sel.shape[:3]:
        d("tables/shape", f"idx {tuple(idx.shape)} does not align with sel "
                          f"{tuple(sel.shape)} on [GN, Mp, T]")
        return out                       # the checks below read [GN, Mp, T]
    gn, mp, _, r_tab = idx.shape
    n_pe = sel.shape[3]
    if r_tab > r:
        d("tables/replicas", f"idx carries {r_tab} replica slots, the "
                             f"schedule allows r={r}")
    if not (gn - 1) * n_pe < c_out <= gn * n_pe or n_pe > fsc.SCHED_BLOCK_N:
        d("tables/groups", f"GN*N' = {gn}*{n_pe} lanes do not fill the "
                           f"layer's {c_out} kernels the way the kernel "
                           f"needs (N' <= {fsc.SCHED_BLOCK_N})")
    if mp < c_in:
        d("tables/m-pad", f"tables cover Mp={mp} channels, the layer has "
                          f"c_in={c_in}; the kernel would read past them")
    if not idx.numel() or not sel.numel():
        return out
    stats = torch.stack([
        idx.min().to(torch.float64), idx.max().to(torch.float64),
        sel.min().to(torch.float64), sel.max().to(torch.float64),
        (torch.isfinite(vr).all() & torch.isfinite(vi).all())
        .to(torch.float64)]).cpu().tolist()
    i_min, i_max, s_min, s_max, finite = (int(v) for v in stats)
    if i_min < 0 or i_max >= n_bins:
        d("tables/idx-bounds",
          f"INDEX entries outside [0, {n_bins}): min={i_min} max={i_max}; "
          f"the kernel's gather at these addresses reads unrelated spectra "
          f"or past the tile")
    if s_min < 0 or s_max >= max(1, r_tab):
        d("tables/sel-bounds", f"sel entries outside [0, {r_tab}): "
                               f"min={s_min} max={s_max}")
    if not finite:
        d("tables/value-finite", "non-finite entries in VALUE planes")
    return out


def layer_smem_bytes(lp, batch: int = 1) -> int:
    """Dynamic shared memory one CTA of the layer's fused launch takes:
    its kernel's layout at the tuning's flow and ``block_m``
    (``fsc.plane_smem_bytes`` / ``fsc.sched_smem_bytes``; the halo path's
    ring holds the block's raw rows), or the staged layout where a
    residual-fused layer reads a 'vmem' shortcut
    (``fsc.staged_bytes_at_batch``, as ``fsc.placement_at_batch`` tests
    it, on the cost model's cluster capacity)."""
    from repro_torch.core import autotune as at
    from repro_torch.kernels import fused_spectral_conv as fsc
    tn = lp.tuning
    hg = (spec.halo_block_geometry(lp.geo, tn.block_p)
          if lp.input_mode == "halo" else None)
    if lp.hadamard == "scheduled":
        _, _, t_cycles, r = lp.tables.idx.shape
        smem = fsc.sched_smem_bytes(tn.flow, lp.geo, tn.block_m, t_cycles, r,
                                    lp.tables.sel.shape[-1], hg)
    else:
        smem = fsc.plane_smem_bytes(tn.flow, lp.geo, tn.block_m, hg)
    if (lp.epilogue.residual == "fused" and tn.residual == "vmem"
            and tn.flow == fsc.OS):
        smem = max(smem, fsc.staged_bytes_at_batch(lp, batch,
                                                   at.H100_OS_CLUSTERS))
    return smem


def _geometry_diagnostics(lp, batch: int, d) -> None:
    """The reference's manual-DMA accumulator checks, as checks of the
    port's launch rules: tile blocks, n blocks and m ranges must cover
    the output and the input channels (``dma/tile-bounds``,
    ``dma/revisit-order``: every output sums each of its m ranges once
    and the last flushes the epilogue), a scheduled flow's ring must hold
    ``fsc.SCHED_FLOW_STAGES_MIN`` stages (``dma/slot-count``; the
    reference's DMA_SLOTS has no other Hopper meaning)."""
    from repro_torch.core import autotune as at
    from repro_torch.kernels import fused_spectral_conv as fsc
    tn, geo, layer = lp.tuning, lp.geo, lp.layer
    if min(tn.block_n, tn.block_m, tn.block_p) < 1:
        d("dma/tile-bounds",
          f"non-positive block sizes (n={tn.block_n}, m={tn.block_m}, "
          f"p={tn.block_p}) cannot address output tiles")
        return
    n, m = layer.c_out, layer.c_in
    fa, s2 = lp.n_active_bins, geo.tile ** 2
    chunks = -(-fa // fsc.BIN_CHUNK)
    sched = lp.hadamard == "scheduled"
    if lp.input_mode == "halo":
        try:
            hg = spec.halo_block_geometry(geo, tn.block_p)
        except Exception:
            hg = None           # diagnosed under halo/geometry
        if hg is not None and (hg.nbh * hg.bth < geo.n_tiles_h
                               or hg.nbw * hg.btw < geo.n_tiles_w):
            d("dma/tile-bounds",
              f"halo block grid {hg.nbh}x{hg.nbw} of {hg.bth}x{hg.btw} "
              f"tiles does not cover the {geo.n_tiles_h}x{geo.n_tiles_w} "
              f"tile canvas")
    # the halo launches take their windowed twin's split: one rule
    blocks = -(-batch * geo.n_tiles // (fsc.SCHED_BLOCK_P if sched
                                        else fsc.BLOCK_P))

    def cover(what, ranges, width, total, check="dma/revisit-order"):
        if ranges < 1 or ranges * width < total or (ranges - 1) * width >= total:
            d(check, f"{ranges} {what} of {width} do not cover the layer's "
                     f"{total} once each")

    if tn.flow == fsc.OS:
        if sched:
            rects = -(-n // fsc.SCHED_BLOCK_N) * fsc.sched_halves(
                min(fsc.SCHED_BLOCK_N, n))
            c = fsc.sched_cluster(blocks * rects, m, at.H100_OS_CLUSTERS)
            cover("channel shares of the cluster", c, -(-m // c), m)
        else:
            og = fsc.os_launch_geometry(blocks, n, m, fa, s2,
                                        at.H100_OS_CLUSTERS)
            if chunks % og.cluster:
                d("dma/tile-bounds", f"cluster of {og.cluster} CTAs does not "
                                     f"tile the {chunks} bin chunks")
            cover("m ranges", og.ranges, og.range_m, m)
        return
    step = 1 if sched else fsc.BLOCK_M
    if tn.block_m % step:
        d("dma/revisit-order", f"{tn.flow} m ranges of {tn.block_m} channels; "
                               f"the {'scheduled' if sched else 'plane'} "
                               f"kernel steps {step} at a time")
        return
    ranges, range_m = -(-m // tn.block_m), min(tn.block_m, m)
    cover("m ranges", ranges, range_m, m)
    if sched:
        rects = -(-n // fsc.SCHED_BLOCK_N) * fsc.sched_halves(
            min(fsc.SCHED_BLOCK_N, n))
        fg = fsc.sched_flow_geometry(tn.flow, blocks, ranges, range_m, rects,
                                     at.H100_SMS)
        if tn.flow == fsc.WS:
            cover("tile-block chunks", fg.split, -(-blocks // fg.split),
                  blocks, "dma/tile-bounds")
        else:
            cover("shares of the group walk", fg.split, -(-rects // fg.split),
                  rects, "dma/tile-bounds")
        if lp.tables is not None:
            _, _, t_cycles, r = lp.tables.idx.shape
            hg = (spec.halo_block_geometry(geo, tn.block_p)
                  if lp.input_mode == "halo" else None)
            x_floats = (geo.fft_size ** 2 * fsc.SCHED_BLOCK_P if hg is None
                        else fsc._halo_stage(geo, hg, 1))
            stages = fsc.sched_flow_layout(tn.flow, geo.fft_size ** 2, s2,
                                           t_cycles, r, x_floats,
                                           range_m).stages
            if stages < fsc.SCHED_FLOW_STAGES_MIN:
                d("dma/slot-count", f"the flow's ring holds {stages} stages, "
                                    f"fewer than {fsc.SCHED_FLOW_STAGES_MIN}")
    elif tn.flow == fsc.IS:
        ig = fsc.is_launch_geometry(blocks, ranges, range_m, n, fa, s2,
                                    at.H100_OS_CLUSTERS)
        if chunks % ig.cluster:
            d("dma/tile-bounds", f"cluster of {ig.cluster} CTAs does not tile "
                                 f"the {chunks} bin chunks")
    else:
        wg = fsc.ws_launch_geometry(blocks, -(-n // fsc.WS_BLOCK_N), ranges,
                                    range_m, chunks,
                                    at.H100_OS_CLUSTERS[chunks])
        cover("tile-block chunks", wg.split, wg.per, blocks,
              "dma/tile-bounds")


def validate_layer_plan(lp, *, batch: int = 1,
                        smem_budget: int | None = None) -> list[Diagnostic]:
    """Structured invariant checks of one ``core.plan.LayerPlan``
    (empty = healthy).  'error' marks an invariant whose violation makes
    the kernel wrong or unlaunchable; 'warn' an advisory finding: a
    layout over ``smem_budget`` (default ``fsc.SMEM_PER_CTA``; the
    autotuner's smallest-footprint fallback when nothing fits) is refused
    at launch, so ``harden_network_plan`` demotes it."""
    out: list[Diagnostic] = []
    name = lp.layer.name
    d = lambda check, msg, sev="error": out.append(
        Diagnostic(name, check, msg, sev))
    budget = _default_budget(smem_budget)

    if lp.backend not in df.EXEC_BACKENDS:
        d("modes/backend", f"backend {lp.backend!r} not in "
                           f"{df.EXEC_BACKENDS}")
        return out
    if lp.backend != "fused":
        return out          # staged / einsum read only kernels and geo
    tn = lp.tuning
    for check, value, allowed in (("modes/flow", tn.flow, df.FLOWS),
                                  ("modes/hadamard", lp.hadamard,
                                   df.HADAMARD_MODES),
                                  ("modes/input", lp.input_mode,
                                   df.INPUT_MODES)):
        if value not in allowed:
            d(check, f"{check.split('/')[1]} {value!r} not in {allowed}")
            return out

    k2 = lp.geo.fft_size ** 2
    s2 = lp.geo.tile ** 2
    fa = lp.n_active_bins
    if tuple(lp.dfr.shape) != (fa, k2) or tuple(lp.dvr.shape) != (s2, fa):
        d("operators/shape",
          f"DFT operators dfr {tuple(lp.dfr.shape)} / dvr "
          f"{tuple(lp.dvr.shape)} do not match (Fa={fa}, S={k2}, S2={s2})")
    if lp.hadamard != "scheduled" and tuple(lp.wr.shape) != (
            fa, lp.layer.c_out, lp.layer.c_in):
        d("operators/planes",
          f"kernel planes {tuple(lp.wr.shape)} != "
          f"({fa}, {lp.layer.c_out}, {lp.layer.c_in})")
    if tuple(lp.bias.shape) != (1, lp.layer.c_out):
        d("epilogue/bias-shape",
          f"bias {tuple(lp.bias.shape)} != (1, {lp.layer.c_out})")
    elif not bool(torch.isfinite(lp.bias).all()):
        d("epilogue/bias-finite", "non-finite bias entries")

    # --- Alg-2 tables -------------------------------------------------
    tables_ok = True
    if lp.hadamard == "scheduled":
        if lp.tables is None:
            d("tables/missing", "hadamard='scheduled' but no tables "
                                "compiled into the plan")
            tables_ok = False
        else:
            from repro_torch.core import autotune as at
            diags = validate_tables(lp.tables, n_bins=fa, r=at.SCHEDULE_R,
                                    c_out=lp.layer.c_out,
                                    c_in=lp.layer.c_in, layer=name)
            tables_ok = not any(x.check in ("tables/shape",)
                                for x in diags)
            out.extend(diags)

    # --- shared memory vs the CTA budget -------------------------------
    if tables_ok:
        try:
            smem = layer_smem_bytes(lp, batch)
            if smem > budget:
                d("smem-budget",
                  f"a CTA needs {smem} bytes of shared memory, over the "
                  f"{budget} budget, at flow {tn.flow} block_m {tn.block_m}"
                  + (" with a staged ('vmem') shortcut"
                     if tn.residual == "vmem" else "")
                  + "; the launch would be refused", "warn")
        except Exception as e:       # the layout rules refused the config
            d("smem-budget", f"the shared-memory layout rejected the tuned "
                             f"config: {e}")

    # --- halo geometry: block starts within the raw image -------------
    if lp.input_mode == "halo":
        try:
            hg = spec.halo_block_geometry(lp.geo, tn.block_p)
            sh, sw = spec.halo_block_starts(lp.geo, hg)
            if (sh.size and (sh.min() < 0
                             or sh.max() + hg.rh > lp.geo.h_in)) or \
               (sw.size and (sw.min() < 0
                             or sw.max() + hg.rw > lp.geo.w_in)):
                d("halo/starts",
                  f"halo block starts leave the raw image: rows "
                  f"{sh.min()}..{sh.max()}+{hg.rh} vs H={lp.geo.h_in}, "
                  f"cols {sw.min()}..{sw.max()}+{hg.rw} vs W={lp.geo.w_in}")
            gr, gc = spec.halo_gather_matrices(lp.geo, hg)
            if (gr.sum(axis=2) > 1).any() or (gc.sum(axis=2) > 1).any():
                d("halo/gather-onehot",
                  "gather selector has a row with >1 non-zero: the window "
                  "gather would sum raw pixels")
        except Exception as e:
            d("halo/geometry", f"halo geometry rejected block_p="
                               f"{tn.block_p}: {e}")

    # --- the CUDA launch geometry ---------------------------------------
    if tables_ok:
        try:
            _geometry_diagnostics(lp, batch, d)
        except Exception as e:
            d("dma/tile-bounds", f"the launch rules rejected the tuned "
                                 f"config: {e}")

    if lp.pe_utilization is not None and not (
            0.0 < lp.pe_utilization <= 1.0):
        d("schedule/utilization",
          f"Eq-14 utilization {lp.pe_utilization} outside (0, 1]")
    return out


def validate_graph(plan) -> list[Diagnostic]:
    """DAG invariants of a ``core.plan.NetworkPlan``: topo order with
    unique, non-reserved ids; every edge (main and shortcut) resolving to
    an earlier node; conv nodes pointing at the layer of their name;
    shortcut shapes equal to the node's post-stride output; a
    residual-fused epilogue only on stride-1 fused-backend layers
    (anything else must sit on the 'add' rung)."""
    out: list[Diagnostic] = []
    d = lambda layer, check, msg, sev="error": out.append(
        Diagnostic(layer, check, msg, sev))
    seen: set[str] = set()
    for node in plan.graph:
        if node.id == "input" or node.id in seen:
            d(node.id, "graph/node-id",
              f"node id {node.id!r} is duplicated or reserved")
        refs = list(node.inputs)
        if node.residual_from is not None:
            refs.append(node.residual_from)
        for ref in refs:
            if ref != "input" and ref not in seen:
                d(node.id, "graph/order",
                  f"node {node.id!r} consumes {ref!r} before it is "
                  f"produced (unknown id, cycle, or bad topo order)")
        if node.kind == "conv":
            if not 0 <= node.layer_index < len(plan.layers):
                d(node.id, "graph/layer-index",
                  f"layer_index {node.layer_index} outside "
                  f"[0, {len(plan.layers)})")
            else:
                lp = plan.layers[node.layer_index]
                if lp.layer.name != node.id:
                    d(node.id, "graph/layer-index",
                      f"node {node.id!r} resolves to layer "
                      f"{lp.layer.name!r}")
                residual = lp.epilogue.residual
                if residual == "fused" and (lp.backend != "fused"
                                            or lp.layer.stride != 1):
                    d(node.id, "graph/residual-fused",
                      f"residual-fused epilogue on backend={lp.backend!r} "
                      f"stride={lp.layer.stride}: the in-kernel add needs "
                      f"the fused backend at stride 1 (demote to the "
                      f"residual-add rung)")
                if residual is not None and node.residual_from is None:
                    d(node.id, "graph/residual-fused",
                      f"epilogue residual={residual!r} but the node has no "
                      f"residual_from edge")
        seen.add(node.id)
    if not any(x.check in ("graph/order", "graph/layer-index") for x in out):
        from repro_torch.core.plan import node_output_shapes
        try:
            node_output_shapes([lp.layer for lp in plan.layers], plan.graph)
        except PlanValidationError as e:
            d(e.layer, e.site or "graph", str(e).splitlines()[0])
    return out


def validate_plan(plan, *, smem_budget: int | None = None,
                  raise_on_error: bool = True) -> list[Diagnostic]:
    """Validate every layer of a ``core.plan.NetworkPlan`` and its DAG
    (``validate_graph``).  Returns every diagnostic; with
    ``raise_on_error`` (default) raises ``PlanValidationError`` carrying
    the error-severity ones, at build time rather than at launch."""
    diags: list[Diagnostic] = []
    for lp in plan.layers:
        diags.extend(validate_layer_plan(lp, batch=plan.batch,
                                         smem_budget=smem_budget))
    diags.extend(validate_graph(plan))
    errors = [x for x in diags if x.severity == "error"]
    if errors and raise_on_error:
        raise PlanValidationError(
            f"plan {plan.name!r} failed validation ({len(errors)} error(s))",
            layer=errors[0].layer, site="validate_plan", diagnostics=errors)
    return diags


# ---------------------------------------------------------------------------
# Per-layer execution by the layer's backend (the bottom of the ladder)
# ---------------------------------------------------------------------------

def _spatial_epilogue(y: torch.Tensor, lp, shortcut=None) -> torch.Tensor:
    """bias -> (+ shortcut) -> ReLU, the fused kernels' flush order."""
    if lp.epilogue.bias:
        y = y + lp.bias[0][None, :, None, None]
    if shortcut is not None:
        y = y + shortcut
    return torch.relu(y) if lp.epilogue.relu else y


def execute_planned_layer(x: torch.Tensor, lp, *,
                          shortcut=None) -> torch.Tensor:
    """Run one conv layer by ``lp.backend``: 'fused' runs the plan's
    kernel variant (``fsc.execute_layer_plan``), 'staged' the three
    staged kernels (``ops.spectral_conv2d_staged``: B7a fft, B7b, B7a ifft
    on a CUDA tensor) and 'einsum' the torch.fft + einsum oracle, the
    ladder's last rung; the latter two apply the epilogue on the host.
    Stride and pooling stay with the caller.  ``shortcut`` is the
    residual operand of a residual-fused node, added after the bias and
    before the ReLU; on the 'add' rung the caller adds it."""
    if lp.backend == "einsum":
        y = spec.spectral_conv2d_pretransformed(x, lp.kernels, lp.geo)
        return _spatial_epilogue(y, lp, shortcut)
    if lp.backend == "staged":
        fault_check("lowering", layer=lp.layer.name, backend="staged")
        from repro_torch.kernels import ops
        y = ops.spectral_conv2d_staged(x, lp.kernels.values, lp.geo)
        return _spatial_epilogue(y, lp, shortcut)
    from repro_torch.kernels.fused_spectral_conv import execute_layer_plan
    return execute_layer_plan(x, lp, shortcut=shortcut)


# ---------------------------------------------------------------------------
# (2) Tiered graceful degradation
# ---------------------------------------------------------------------------

# The ladder, cheapest rung first: (axis, from, to).  'backend' rungs
# change the execution path; the others keep the fused kernel with a
# safer variant.
DEMOTION_LADDER = (
    ("input_mode", "halo", "windowed"),
    ("hadamard", "scheduled", "dense"),
    ("epilogue", "residual-fused", "residual-add"),
    ("backend", "fused", "staged"),
    ("backend", "staged", "einsum"),
)

# CUDA errors after which the context is lost (every later launch on it
# fails): an illegal or misaligned address, a device-side assert, an
# illegal instruction, a launch failure; by cudaError number (the
# wrappers' "launch failed: cudaError N") or by the runtime's text.
_STICKY = re.compile(
    r"cudaError (700|702|710|714|715|716|717|718|719)\b"
    r"|illegal memory access|misaligned address|device-side assert"
    r"|illegal instruction|unspecified launch failure", re.IGNORECASE)


def is_sticky_cuda_error(err: BaseException) -> bool:
    """Whether ``err`` reads as a CUDA error that leaves the context
    unusable, so no lower rung could run either."""
    return bool(_STICKY.search(str(err)))


def _summarize(err: BaseException) -> str:
    first = str(err).strip().splitlines()
    return f"{type(err).__name__}: {first[0] if first else ''}"


def _residual_add_fallback(lp):
    """A residual-FUSED layer on the unfused-add rung: the kernel stores
    the bias-only output (its ReLU off: it would clamp the pre-add value)
    and the executor applies ``relu(y + shortcut)`` on the host; the
    tuning's shortcut placement is cleared."""
    return dataclasses.replace(
        lp, epilogue=dataclasses.replace(lp.epilogue, residual="add",
                                         relu=False),
        tuning=dataclasses.replace(lp.tuning, residual=None))


def _reprice_tuning(lp, batch: int):
    """The tuning of a (demoted) layer as its backend runs it.  On the
    fused rungs: the cost model's best configuration of the layer's flow
    under its new Hadamard mode, input path and epilogue
    (``autotune.autotune_layer`` through ``hopper_fused_flow_cost`` /
    ``predict_seconds`` / ``price``, as ``plan.with_input_mode`` re-tunes:
    the m-range width and a shortcut's placement follow the new kernel).
    The staged and einsum rungs have no cost model: their bytes, shared
    memory and seconds are None rather than the fused kernel's."""
    from repro_torch.core.plan import _kernel_tuning
    if lp.backend == "fused":
        return _kernel_tuning(lp, lp.geo.fft_size, batch, lp.tuning.flow,
                              lp.input_mode)
    return dataclasses.replace(lp.tuning, hbm_bytes=None, smem_bytes=None,
                               predicted_s=None, grid_steps=None,
                               measured_s=None, measured=())


def _note(reason: BaseException | str) -> str:
    return (_summarize(reason) if isinstance(reason, BaseException)
            else str(reason))


def demote_layer(lp, *, batch: int = 1, reason: BaseException | str = ""):
    """``lp`` one rung down ``DEMOTION_LADDER`` (tuning re-priced,
    the rung recorded in ``provenance``), or None on the last rung
    (einsum)."""
    note = _note(reason)
    fused = lp.backend == "fused"
    if fused and lp.input_mode == "halo":
        new = dataclasses.replace(lp, input_mode="windowed")
        rung = "input_mode halo->windowed"
    elif fused and lp.hadamard == "scheduled":
        plane = "bin" if lp.active is not None else "dense"
        new = dataclasses.replace(lp, hadamard=plane, tables=None)
        rung = f"hadamard scheduled->{plane}"
    elif fused and lp.epilogue.residual == "fused":
        new = _residual_add_fallback(lp)
        rung = "epilogue residual-fused->residual-add"
    elif fused:
        new = dataclasses.replace(lp, backend="staged")
        rung = "backend fused->staged"
    elif lp.backend == "staged":
        new = dataclasses.replace(lp, backend="einsum")
        rung = "backend staged->einsum"
    else:
        return None
    return dataclasses.replace(
        new, tuning=_reprice_tuning(new, batch),
        provenance=lp.provenance + (f"{rung} ({note})" if note else rung,))


# The backend axis alone: the rungs a serving front end trades under
# load (the input_mode / hadamard rungs stay with fault-driven hardening).
BACKEND_RUNGS = df.EXEC_BACKENDS


def demote_layer_backend(lp, *, batch: int = 1,
                         reason: BaseException | str = ""):
    """``lp`` one rung down the backend axis only (fused -> staged ->
    einsum), re-priced and provenance-stamped like ``demote_layer``; None
    on einsum.  A residual-fused layer leaving 'fused' moves to the
    residual-add rung in the same step (its own provenance entry)."""
    note = _note(reason)
    nxt = {"fused": "staged", "staged": "einsum"}.get(lp.backend)
    if nxt is None:
        return None
    new, extra = lp, ()
    if lp.backend == "fused" and lp.epilogue.residual == "fused":
        new = _residual_add_fallback(new)
        extra = ("epilogue residual-fused->residual-add "
                 "(backend demotion)",)
    new = dataclasses.replace(new, backend=nxt)
    rung = f"backend {lp.backend}->{nxt}"
    return dataclasses.replace(
        new, tuning=_reprice_tuning(new, batch),
        provenance=lp.provenance + extra
        + (f"{rung} ({note})" if note else rung,))


def plan_at_backend_rung(plan, backend: str, *, reason: str = ""):
    """``plan`` with every layer demoted to at least the ``backend`` rung
    ('fused' | 'staged' | 'einsum'), one recorded rung at a time; layers
    already there are untouched, and a plan with nothing to move comes
    back as it is."""
    if backend not in BACKEND_RUNGS:
        raise ValueError(f"backend must be one of {BACKEND_RUNGS}, "
                         f"got {backend!r}")
    target = BACKEND_RUNGS.index(backend)
    new_layers, changed = [], False
    for lp in plan.layers:
        while BACKEND_RUNGS.index(lp.backend) < target:
            lp = demote_layer_backend(lp, batch=plan.batch, reason=reason)
            changed = True
        new_layers.append(lp)
    return dataclasses.replace(plan, layers=tuple(new_layers)) \
        if changed else plan


def _device_of(lp) -> torch.device:
    return lp.bias.device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _probe(run) -> BaseException | None:
    """Run ``run`` inside the probe boundary: None when it ran, else the
    exception (KeyboardInterrupt and SystemExit pass through)."""
    try:
        run()
        return None
    except Exception as e:              # noqa: BLE001 — probe boundary
        return e


def probe_layer_plan(lp, *, batch: int = 1) -> BaseException | None:
    """Capability probe: one forward of the layer's variant on zeros at
    ``batch`` images on the plan's device (a CPU plan probes the plain
    versions), with a zero shortcut on a residual-fused layer (the
    kernel reads it where ``fsc.placement_at_batch`` puts it), then a
    device synchronization, since a kernel fault surfaces asynchronously.
    Returns None when the variant ran, else the exception."""
    dev = _device_of(lp)
    layer = lp.layer

    def run():
        x = torch.zeros((batch, layer.c_in, layer.h_in, layer.w_in),
                        device=dev)
        sc = None
        if lp.epilogue.residual == "fused" and lp.backend == "fused":
            sc = torch.zeros((batch, layer.c_out, *layer.out_hw), device=dev)
        execute_planned_layer(x, lp, shortcut=sc)
        _sync(dev)

    return _probe(run)


def _walk(lp, check, probe, step, site: str, name: str):
    """The hardening loop of one layer (or sharded layer): validate
    (``check``: the diagnostics of the current rung), probe (``probe``,
    None to skip), and on a finding take ``step`` one rung down, until
    the layer validates and its probe runs."""
    for _ in range(len(DEMOTION_LADDER) + 1):
        finding: BaseException | None = None
        bad = [x for x in check(lp)
               if x.severity == "error" or x.check == "smem-budget"]
        if bad:
            finding = PlanValidationError(
                f"layer {name} failed validation: "
                f"{', '.join(sorted({x.check for x in bad}))}",
                layer=name, site=site, diagnostics=bad)
        elif probe is not None:
            finding = probe(lp)
        if finding is None:
            return lp
        if is_sticky_cuda_error(finding):
            raise KernelLoweringError(
                f"layer {name}: the probe hit a CUDA error that leaves the "
                f"context unusable, so no lower rung can run: "
                f"{_summarize(finding)}", layer=name, site=site) from finding
        demoted = step(lp, finding)
        if demoted is None:
            raise KernelLoweringError(
                f"layer {name} failed on the terminal einsum rung: "
                f"{_summarize(finding)}", layer=name, site=site) from finding
        lp = demoted
    return lp


def harden_network_plan(plan, *, smem_budget: int | None = None,
                        probe: bool = True):
    """Walk every layer down the ladder until it validates (no error, no
    ``smem-budget`` finding) and its probe runs (``probe_layer_plan``),
    one rung at a time.  A healthy plan comes back with the same layer
    objects and empty provenance.  Tables that fail validation are never
    probed.  Raises ``KernelLoweringError`` when the einsum rung fails
    too, or at once on a sticky CUDA error.  Inspect ``health_report()``
    of the result for what moved and why."""
    batch = plan.batch

    def check(lp):
        return (validate_layer_plan(lp, batch=batch, smem_budget=smem_budget)
                if lp.backend == "fused" else [])

    new_layers = tuple(
        _walk(lp, check,
              (lambda l: probe_layer_plan(l, batch=batch)) if probe
              else None,
              lambda l, e: demote_layer(l, batch=batch, reason=e),
              "harden", lp.layer.name)
        for lp in plan.layers)
    if all(a is b for a, b in zip(new_layers, plan.layers)):
        return plan
    return dataclasses.replace(plan, layers=new_layers)


# ---------------------------------------------------------------------------
# (2b) Per-backend circuit breaker
# ---------------------------------------------------------------------------

BREAKER_STATES = ("closed", "open", "half_open")


@dataclasses.dataclass
class CircuitBreaker:
    """Consecutive-failure circuit breaker for one execution backend.

      closed     every request allowed; ``failure_threshold`` consecutive
                 failures open it (a success resets the count);
      open       the rung is skipped until ``cooldown_s`` elapses, then
                 half_open;
      half_open  traffic allowed again; ``recovery_successes`` consecutive
                 successes close it, one failure re-opens it.

    ``clock`` is injectable (any zero-argument callable of seconds).
    Every state change is appended to ``transitions``."""

    name: str = ""
    failure_threshold: int = 3
    cooldown_s: float = 1.0
    recovery_successes: int = 1
    clock: Callable[[], float] = time.monotonic
    state: str = "closed"
    failures: int = 0                 # consecutive failures
    successes: int = 0                # consecutive successes (half_open)
    opened_at: float | None = None
    n_opens: int = 0
    transitions: list = dataclasses.field(default_factory=list)

    def _to(self, state: str, why: str) -> None:
        self.transitions.append({"t": self.clock(), "from": self.state,
                                 "to": state, "why": why})
        self.state = state

    def _open(self, why: str) -> None:
        self.opened_at = self.clock()
        self.n_opens += 1
        self._to("open", why)

    def allow(self) -> bool:
        """May a request be attempted on this backend now?"""
        if self.state == "open":
            if self.clock() - self.opened_at >= self.cooldown_s:
                self.successes = 0
                self._to("half_open", f"cooldown {self.cooldown_s}s elapsed")
                return True
            return False
        return True

    def record_success(self) -> None:
        if self.state == "half_open":
            self.successes += 1
            if self.successes >= self.recovery_successes:
                self._to("closed",
                         f"{self.successes} recovery probe(s) succeeded")
                self.failures = 0
        else:
            self.failures = 0

    def record_failure(self, reason: str = "") -> None:
        self.successes = 0
        if self.state == "half_open":
            self._open(f"recovery probe failed ({reason})" if reason
                       else "recovery probe failed")
        elif self.state == "closed":
            self.failures += 1
            if self.failures >= self.failure_threshold:
                self._open(f"{self.failures} consecutive failure(s)"
                           + (f" ({reason})" if reason else ""))

    def snapshot(self) -> dict:
        return {"name": self.name, "state": self.state,
                "consecutive_failures": self.failures,
                "n_opens": self.n_opens,
                "transitions": list(self.transitions)}


# ---------------------------------------------------------------------------
# (3) Runtime numeric guards
# ---------------------------------------------------------------------------

GUARD_POLICIES = ("raise", "demote", "warn")


@dataclasses.dataclass
class NumericGuards:
    """Opt-in per-layer runtime checks for ``forward_spectral``.

    nan_scan:  scan every layer output for NaN/Inf.
    parity:    recompute ``parity_channels`` evenly spaced output channels
               of the first ``parity_batch`` images through the einsum
               oracle and compare within ``parity_tol``: catches operands
               or tables that are finite but wrong.
    policy:    'raise' (``NumericGuardError``), 'demote' (recompute the
               layer through the oracle and go on) or 'warn' (warn and
               keep the suspect output).
    events:    every trip, whatever the policy.
    """

    nan_scan: bool = True
    parity: bool = False
    parity_tol: float = 1e-4
    parity_channels: int = 4
    parity_batch: int = 1
    policy: str = "raise"
    events: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.policy not in GUARD_POLICIES:
            raise ValueError(f"policy must be one of {GUARD_POLICIES}, "
                             f"got {self.policy!r}")


def _oracle_layer(x, lp, shortcut=None) -> torch.Tensor:
    y = spec.spectral_conv2d_pretransformed(x, lp.kernels, lp.geo)
    return _spatial_epilogue(y, lp, shortcut)


def _sampled_parity_err(x, y, lp, guards: NumericGuards,
                        shortcut=None) -> float:
    """max|y - oracle| on the sampled channels and images (the oracle on
    the layer's device; one host read)."""
    sk = lp.kernels
    n = sk.n_out
    sel = np.unique(np.linspace(
        0, n - 1, max(1, min(guards.parity_channels, n))).astype(int))
    idx = torch.as_tensor(sel, device=sk.values.device)
    sub = sp.SparseSpectralKernels(
        values=sk.values[idx], mask=sk.mask[idx], indices=sk.indices[idx],
        alpha=sk.alpha, active_bins=sk.active_bins)
    nb = max(1, min(guards.parity_batch, x.shape[0]))
    ref = spec.spectral_conv2d_pretransformed(x[:nb], sub, lp.geo)
    idx = idx.to(y.device)
    if lp.epilogue.bias:
        ref = ref + lp.bias[0][idx][None, :, None, None]
    if shortcut is not None:
        ref = ref + shortcut[:nb, idx]
    if lp.epilogue.relu:
        ref = torch.relu(ref)
    return float((y[:nb, idx] - ref).abs().max())


def apply_guards(x, y, lp, guards: NumericGuards, shortcut=None):
    """Run the enabled guards on one layer's output ``y`` (``x`` its
    input, ``shortcut`` the residual operand fused into ``y``, so the
    oracle reproduces bias -> +shortcut -> ReLU).  Returns the output to
    carry forward: ``y``, or the oracle's recompute under 'demote'."""
    name = lp.layer.name

    def trip(check: str, message: str):
        guards.events.append({"layer": name, "check": check,
                              "message": message, "policy": guards.policy})
        if guards.policy == "raise":
            raise NumericGuardError(message, layer=name, site=check)
        if guards.policy == "warn":
            warnings.warn(f"[numeric-guard] {message}", RuntimeWarning,
                          stacklevel=3)
            return y
        return _oracle_layer(x, lp, shortcut)

    if guards.nan_scan and not bool(torch.isfinite(y).all()):
        return trip("nan_scan",
                    f"non-finite values in {name} output "
                    f"(backend={lp.backend}, hadamard={lp.hadamard}, "
                    f"input_mode={lp.input_mode})")
    if guards.parity and lp.backend != "einsum":
        err = _sampled_parity_err(x, y, lp, guards, shortcut)
        if not err <= guards.parity_tol:
            return trip(
                "parity",
                f"sampled parity vs einsum oracle failed on {name}: max abs "
                f"err {err:.3e} > tol {guards.parity_tol:.1e} "
                f"({guards.parity_channels} channels, "
                f"{guards.parity_batch} image(s))")
    return y


# ---------------------------------------------------------------------------
# (5) Sharded plans: partition validation and the sharded ladder
# ---------------------------------------------------------------------------

def validate_layer_partition(slp, *, batch: int = 1) -> list[Diagnostic]:
    """Partition invariants of one ``core.plan.ShardedLayerPlan``: the
    shapes the executor's split, halo exchange and sum assume.

      spatial   one band plan; pre_halo_h == k-1 (the rows the exchange
          ships); tile rows == ``shard_band_rows`` (so the D bands cover
          the tile grid); h_in == k-1 + tr*t and h_pad == tr*t; the W axis
          and the channels are the base's;
      channel   D plans; D | c_in; every shard the same local channels,
          output channels and geometry as the base; bias and ReLU
          deferred; the shards' tables of one T;
      replicate no shard plans.
    """
    del batch           # the reference's signature; no check reads it
    out: list[Diagnostic] = []
    name = slp.base.layer.name
    d = lambda check, msg: out.append(Diagnostic(name, check, msg))
    if slp.strategy not in df.SHARD_STRATEGIES:
        d("shard/strategy", f"unknown strategy {slp.strategy!r}; must be "
                            f"one of {df.SHARD_STRATEGIES}")
        return out
    if slp.strategy == "replicate":
        if slp.shards:
            d("shard/replicate", f"replicate carries {len(slp.shards)} shard "
                                 f"plans; expected none")
        return out
    if slp.base.backend != "fused":
        d("shard/backend", f"sharded execution runs the fused kernels; the "
                           f"base is on {slp.base.backend!r} (replicate it)")
    geo, n_shards = slp.base.geo, slp.n_shards
    if slp.strategy == "spatial":
        if len(slp.shards) != 1:
            d("shard/spatial", f"spatial wants one band plan, got "
                               f"{len(slp.shards)}")
            return out
        band = slp.shards[0]
        bg, ov = band.geo, geo.ksize - 1
        tr = spec.shard_band_rows(geo, n_shards)
        if bg.pre_halo_h != ov:
            d("shard/halo-rows", f"band pre_halo_h={bg.pre_halo_h} != "
                                 f"k-1={ov}, the rows the halo exchange "
                                 f"ships")
        if bg.n_tiles_h != tr:
            d("shard/band-rows", f"band has {bg.n_tiles_h} tile rows, "
                                 f"shard_band_rows says {tr}")
        if bg.h_in != ov + tr * geo.tile or bg.h_pad != tr * geo.tile:
            d("shard/band-height",
              f"band h_in={bg.h_in}/h_pad={bg.h_pad} do not match {tr} tile "
              f"rows of {geo.tile} plus {ov} halo rows")
        if (bg.w_in, bg.w_pad, bg.n_tiles_w) != (geo.w_in, geo.w_pad,
                                                 geo.n_tiles_w):
            d("shard/band-width",
              f"band W axis {(bg.w_in, bg.w_pad, bg.n_tiles_w)} != base "
              f"{(geo.w_in, geo.w_pad, geo.n_tiles_w)}")
        if band.layer.c_in != slp.base.layer.c_in:
            d("shard/band-channels", f"band c_in={band.layer.c_in} != "
                                     f"{slp.base.layer.c_in}: bands keep "
                                     f"every channel")
        return out
    if len(slp.shards) != n_shards:
        d("shard/channel", f"channel wants {n_shards} shard plans, got "
                           f"{len(slp.shards)}")
        return out
    m = slp.base.layer.c_in
    if m % n_shards:
        d("shard/divisibility", f"c_in={m} is not divisible by D={n_shards}")
        return out
    t_lens = set()
    for i, sh in enumerate(slp.shards):
        if sh.layer.c_in != m // n_shards:
            d("shard/local-dims", f"shard {i} c_in={sh.layer.c_in} != c_in/D="
                                  f"{m // n_shards}")
        if sh.layer.c_out != slp.base.layer.c_out or sh.geo != geo:
            d("shard/psum-shape",
              f"shard {i} output (c_out={sh.layer.c_out}, geometry "
              f"{'equal' if sh.geo == geo else 'differs'}) is not the base's; "
              f"the partial sums must agree elementwise")
        if sh.epilogue.bias or sh.epilogue.relu:
            d("shard/epilogue", f"shard {i} applies bias/ReLU to a partial "
                                f"sum; channel shards defer the epilogue")
        if sh.tables is not None:
            t_lens.add(int(sh.tables.idx.shape[2]))
    if len(t_lens) > 1:
        d("shard/table-pad", f"shard tables disagree on the cycle count T "
                             f"{sorted(t_lens)}; pad them to one T")
    return out


def validate_sharded_plan(splan, *, smem_budget: int | None = None,
                          raise_on_error: bool = True) -> list[Diagnostic]:
    """Validate a ``core.plan.ShardedNetworkPlan``: its layers aligned
    with the base plan's, every shard-local ``LayerPlan``
    (``validate_layer_plan``: shard plans carry local dims, so the table,
    operator and halo checks see the shapes the kernel will) and the
    partition invariants (``validate_layer_partition``)."""
    diags: list[Diagnostic] = []
    batch = splan.base.batch
    if len(splan.layers) != len(splan.base.layers) or any(
            slp.base is not lp
            for slp, lp in zip(splan.layers, splan.base.layers)):
        diags.append(Diagnostic("<plan>", "shard/alignment",
                                "sharded layers do not align with the base "
                                "plan's"))
    if int(np.prod(splan.mesh_shape)) != splan.n_shards:
        diags.append(Diagnostic(
            "<plan>", "shard/mesh",
            f"mesh_shape {splan.mesh_shape} has "
            f"{int(np.prod(splan.mesh_shape))} devices, the plan "
            f"n_shards={splan.n_shards}"))
    for slp in splan.layers:
        for sh in slp.shards:
            diags.extend(validate_layer_plan(sh, batch=batch,
                                             smem_budget=smem_budget))
        diags.extend(validate_layer_partition(slp, batch=batch))
    errors = [x for x in diags if x.severity == "error"]
    if errors and raise_on_error:
        raise PlanValidationError(
            f"sharded plan {splan.name!r} failed validation "
            f"({len(errors)} error(s))", layer=errors[0].layer,
            site="validate_sharded_plan", diagnostics=errors)
    return diags


def probe_sharded_layer(slp, *, batch: int = 1) -> BaseException | None:
    """Capability probe of one sharded layer: consult the shard-scoped
    fault site, then run every shard-local plan on zeros as the executor
    runs it (a spatial band through ``fsc.execute_band_plan`` on the
    extended band, a channel shard through ``execute_planned_layer``),
    synchronized; a replicated layer probes its base.  Host-side and
    shard by shard, so a shard whose tables or variant fail is caught at
    plan time."""
    from repro_torch.kernels.fused_spectral_conv import execute_band_plan
    name = slp.base.layer.name
    for i, sh in enumerate(slp.shards):
        err = _probe(lambda: fault_check("shard_tables", layer=name, shard=i,
                                         strategy=slp.strategy))
        if err is not None:
            return err
        if slp.strategy == "spatial":
            dev = _device_of(sh)

            def run(sh=sh, dev=dev):
                execute_band_plan(torch.zeros(
                    (batch, sh.layer.c_in, sh.geo.h_in, sh.geo.w_in),
                    device=dev), sh)
                _sync(dev)

            err = _probe(run)
        else:
            err = probe_layer_plan(sh, batch=batch)
        if err is not None:
            return err
    if not slp.shards:
        return probe_layer_plan(slp.base, batch=batch)
    return None


def harden_sharded_plan(splan, *, smem_budget: int | None = None,
                        probe: bool = True):
    """The ladder for a sharded plan, one layer at a time: every check
    and probe runs on the host, shard by shard
    (``validate_layer_plan`` of each shard, ``validate_layer_partition``,
    ``probe_sharded_layer``); a failing layer's base plan moves one rung
    down (``demote_layer``) and its shards are rebuilt from it
    (``plan.resharded_layer_plan``, provenance "shard ladder: ..."); once
    the base leaves the fused backend the layer is replicated.  Returns a
    ``ShardedNetworkPlan`` (the same layer objects where healthy)."""
    from repro_torch.core import plan as pl
    batch = splan.base.batch

    def check(slp):
        return ([x for sh in slp.shards
                 for x in validate_layer_plan(sh, batch=batch,
                                              smem_budget=smem_budget)]
                + validate_layer_partition(slp, batch=batch))

    def step(slp, finding):
        demoted = demote_layer(slp.base, batch=batch, reason=finding)
        return None if demoted is None else pl.resharded_layer_plan(
            slp, demoted, note=f"shard ladder: {_summarize(finding)}")

    new_layers = tuple(
        _walk(slp, check,
              (lambda s: probe_sharded_layer(s, batch=batch)) if probe
              else None, step, "harden_sharded", slp.base.layer.name)
        for slp in splan.layers)
    if all(a is b for a, b in zip(new_layers, splan.layers)):
        return splan
    base = dataclasses.replace(
        splan.base, layers=tuple(slp.base for slp in new_layers))
    return dataclasses.replace(splan, base=base, layers=new_layers)

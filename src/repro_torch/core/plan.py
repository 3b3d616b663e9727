"""Compile-once network plan: everything the forward pass needs,
precomputed (counterpart of ``repro.core.plan``).

``build_network_plan`` runs the paper's offline steps once — spectral
transform and magnitude pruning of every conv kernel, active-bin
compaction, the restricted DFT operators, the fused epilogue — on the
CPU, and moves the finished operands to the device.  The forward pass
(``models.cnn.forward_spectral``) only walks the plan's DAG and launches
kernels.

For layers whose Hadamard mode is 'scheduled', the plan also holds the
full Alg-2 INDEX/VALUE tables (one exact-cover schedule per
kernel-group x channel, ``scheduler.compile_layer_tables``, spread over a
process pool at full width) and their exact Eq-14 statistics; with
``schedule=True`` the plane layers carry sampled statistics, as in the
reference.

Each layer's kernel configuration comes from Alg 1 on the H100
(``autotune.autotune_layer``): ``hadamard`` and ``input_mode`` are forced
('dense' | 'bin' | 'scheduled', 'windowed' | 'halo') or 'auto', which
ranks the available modes, and then the reuse flows and their m-range
widths, per layer; ``measure=True`` re-ranks the best predictions by
their time on the card.

Residual graphs (a node with ``residual_from``, ResNet-18): a stride-1
node fuses the shortcut add into its kernel's flush ('fused'), and
where the kernel reads the shortcut ('hbm' at the flush, or 'vmem',
staged in shared memory by the output-stationary kernel) is the
autotuner's per-layer choice, recorded as ``PlanNode.shortcut_on_chip``;
a strided node adds it on the host after the subsample ('add').

``PlanCache`` keeps built plans by ``plan_cache_key`` (the reference's
key tuple) for the serving front end, which warms one per batch bucket.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import resource_tracker
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

import repro_torch
from repro_torch.core import autotune as at
from repro_torch.core import dataflow as df
from repro_torch.core import resilience as res
from repro_torch.core import scheduler as sch
from repro_torch.core import sparse as sp
from repro_torch.core import spectral as spec
from repro_torch.core.autotune import FusedTuning
from repro_torch.kernels import fused_spectral_conv as fsc


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """Post-conv elementwise work fused into the kernel (bias, relu) or
    run right after it (pool).

    ``residual`` is the shortcut-add mode of a DAG node with a
    ``residual_from`` edge:

      None     no shortcut;
      'fused'  the shortcut is one more operand of the kernel, added at
               its flush after the bias and before the ReLU (stride 1:
               the kernel flushes the stride-1 output);
      'add'    the conv runs with its ReLU off and the executor applies
               ``relu(y[::stride, ::stride] + shortcut)`` on the host.
    """

    bias: bool = True
    relu: bool = True
    pool: bool = False       # 2x2 max-pool follows this layer (spatial)
    residual: str | None = None   # None | 'fused' | 'add'


class PlanTables(NamedTuple):
    """Device-resident Alg-2 INDEX/VALUE tables for one scheduled layer
    (stacked layout of ``scheduler.LayerTables``; consumed verbatim by
    ``kernels.fused_spectral_conv.fused_spectral_pipeline_scheduled``).
    """

    idx: torch.Tensor                 # [GN, Mp, T, r]  int32
    sel: torch.Tensor                 # [GN, Mp, T, N'] int32
    vr: torch.Tensor                  # [GN, Mp, T, N'] f32
    vi: torch.Tensor

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self)


@dataclasses.dataclass(frozen=True)
class PlanNode:
    """One node of the compiled DAG plan.

      id            stable node id; for 'conv' nodes the ConvLayer name.
      kind          'conv' | 'pool'.
      inputs        producer ids (length 1; 'input' = network input).
      layer_index   index into ``NetworkPlan.layers`` (-1 for pools).
      pool          'max' | 'avg' (2x2, stride 2) for pool nodes.
      residual_from shortcut producer id, or None.
      relu          apply ReLU at this node's output (for a residual
                    node, after the add).
      shortcut_on_chip  a fused shortcut is staged in shared memory
                    (the tuning's 'vmem' placement) rather than read
                    from device memory at the flush ('hbm').
    """

    id: str
    kind: str = "conv"
    inputs: tuple[str, ...] = ("input",)
    layer_index: int = -1
    pool: str = "max"
    residual_from: str | None = None
    relu: bool = True
    shortcut_on_chip: bool = False


def _linear_node_specs(layers, pool_after) -> tuple:
    """The chain graph of a linear conv stack: one 'conv' node per layer
    and a 'max' pool node ('<name>:pool') after every layer named in
    ``pool_after``."""
    nodes = []
    prev = "input"
    for layer in layers:
        nodes.append(df.NodeSpec(id=layer.name, inputs=(prev,)))
        prev = layer.name
        if layer.name in pool_after:
            pid = f"{layer.name}:pool"
            nodes.append(df.NodeSpec(id=pid, kind="pool", inputs=(prev,)))
            prev = pid
    return tuple(nodes)


def _topo_order_specs(specs) -> list:
    """Kahn topo-order of NodeSpecs (shortcut edges included).  Raises
    ``PlanValidationError`` (site 'graph') on duplicate or reserved ids,
    unknown references, or a cycle."""
    by_id: dict[str, object] = {}
    for s in specs:
        if s.id == "input" or s.id in by_id:
            raise res.PlanValidationError(
                f"graph node id {s.id!r} is duplicated or reserved",
                layer=s.id, site="graph")
        by_id[s.id] = s
    deps: dict[str, set] = {}
    for s in specs:
        edges = set(s.inputs)
        if s.residual_from is not None:
            edges.add(s.residual_from)
        edges.discard("input")
        unknown = edges - by_id.keys()
        if unknown:
            raise res.PlanValidationError(
                f"graph node {s.id!r} references unknown node(s) "
                f"{sorted(unknown)}", layer=s.id, site="graph")
        deps[s.id] = edges
    order, ready = [], [s for s in specs if not deps[s.id]]
    done: set[str] = set()
    while ready:
        s = ready.pop(0)
        order.append(s)
        done.add(s.id)
        for t in specs:
            if t.id not in done and t not in ready and deps[t.id] <= done:
                ready.append(t)
    if len(order) != len(list(specs)):
        stuck = sorted(set(by_id) - done)
        raise res.PlanValidationError(
            f"graph has a cycle through node(s) {stuck}", layer=stuck[0],
            site="graph")
    return order


def graph_sink(nodes) -> str:
    """Id of the network output node of a topo-ordered node sequence:
    the last node no other node consumes (main or shortcut edge)."""
    consumed: set[str] = set()
    for n in nodes:
        consumed.update(n.inputs)
        if n.residual_from is not None:
            consumed.add(n.residual_from)
    sinks = [n.id for n in nodes if n.id not in consumed]
    return sinks[-1] if sinks else nodes[-1].id


def node_output_shapes(layers, specs) -> dict[str, tuple[int, int, int]]:
    """Every node's output shape ``{id: (C, H, W)}`` (batch elided) for
    a topo-ordered NodeSpec or PlanNode sequence.  Conv nodes produce
    their layer's post-stride 'same' extent, pool nodes halve H and W
    (floor).  Raises ``PlanValidationError`` when a conv node's declared
    input disagrees with its producer (site 'graph/input-shape') or a
    shortcut edge's shape differs from the node's output (site
    'graph/residual-shape')."""
    by_name = {l.name: l for l in layers}
    first = next((by_name[s.id] for s in specs
                  if s.kind == "conv" and s.id in by_name), None)
    shapes: dict[str, tuple[int, int, int]] = {}
    if first is not None:
        shapes["input"] = (first.c_in, first.h_in, first.w_in)
    for s in specs:
        src = shapes.get(s.inputs[0])
        if s.kind == "pool":
            if src is None:
                raise res.PlanValidationError(
                    f"pool node {s.id!r} has no resolvable input shape",
                    layer=s.id, site="graph/input-shape")
            c, h, w = src
            out = (c, h // 2, w // 2)
        else:
            layer = by_name.get(s.id)
            if layer is None:
                raise res.PlanValidationError(
                    f"conv node {s.id!r} has no matching ConvLayer",
                    layer=s.id, site="graph/input-shape")
            want = (layer.c_in, layer.h_in, layer.w_in)
            if src is not None and src != want:
                raise res.PlanValidationError(
                    f"conv node {s.id!r} declares input {want} but its "
                    f"producer {s.inputs[0]!r} emits {src}",
                    layer=s.id, site="graph/input-shape")
            out = (layer.c_out, *layer.out_hw)
        if s.residual_from is not None:
            sc = shapes.get(s.residual_from)
            if sc != out:
                raise res.PlanValidationError(
                    f"residual edge {s.residual_from!r} -> {s.id!r} adds "
                    f"shape {sc} to output shape {out}",
                    layer=s.id, site="graph/residual-shape")
        shapes[s.id] = out
    return shapes


@dataclasses.dataclass(frozen=True, eq=False)
class LayerPlan:
    """Precompiled state of one spectral conv layer (N = c_out,
    M = c_in, S = K^2, S2 = t^2, Fa = active bins).

      layer / geo / kernels / alpha  layer description, tile geometry,
          pruned spectral kernels (on the plan's device; the einsum
          backend reads them) and the layer's alpha.
      tuning      the fused kernel's flow and block sizes.
      epilogue / bias   fused bias + ReLU (+ pool-after flag); bias is
          [1, N] f32.
      active      compacted active-bin set (numpy) or None (all K^2).
      wr / wi     [Fa, N, M] f32 kernel planes.
      dfr / dfi   [Fa, S] forward DFT rows; dvr / dvi [S2, Fa] inverse
          DFT on the valid rows.
      hadamard    'dense' | 'bin' | 'scheduled'; input_mode 'windowed'
          (host windows) | 'halo' (the kernel reads the raw activation).
      tables      ``PlanTables`` for scheduled layers, else None.
      schedule_cycles / pe_utilization   Alg-2 stats: exact totals when
          the full tables were compiled (scheduled mode), otherwise
          sampled (None when scheduling was skipped).
      backend     'fused' | 'staged' | 'einsum' (``df.EXEC_BACKENDS``):
          the path that runs this layer under ``forward_spectral(backend=
          "fused")``; 'fused' as built, moved down only by the
          degradation ladder of ``core.resilience``.
      provenance  the demotions that ladder applied (empty as built).

    Frozen with identity equality: ``dataclasses.replace`` (every ladder
    rung) makes a new plan, which caches keyed on the plan object (the
    sharded executor's placed copies) see as a new entry.
    """

    layer: df.ConvLayer
    geo: spec.SpectralGeometry
    kernels: sp.SparseSpectralKernels
    alpha: float
    tuning: FusedTuning
    epilogue: EpilogueSpec
    bias: torch.Tensor
    active: np.ndarray | None
    wr: torch.Tensor
    wi: torch.Tensor
    dfr: torch.Tensor
    dfi: torch.Tensor
    dvr: torch.Tensor
    dvi: torch.Tensor
    hadamard: str = "bin"
    input_mode: str = "windowed"
    schedule_cycles: int | None = None
    pe_utilization: float | None = None
    tables: PlanTables | None = None
    backend: str = "fused"
    provenance: tuple[str, ...] = ()

    @property
    def n_active_bins(self) -> int:
        k2 = self.geo.fft_size ** 2
        return k2 if self.active is None else len(self.active)

    def stats(self) -> dict:
        """One summary row of the layer (the reference's keys; the
        CTA's shared memory where the reference has VMEM bytes)."""
        return {
            "layer": self.layer.name,
            "alpha": self.alpha,
            "nnz": self.kernels.nnz,
            "active_bins": self.n_active_bins,
            "flow": self.tuning.flow,
            "hadamard": self.hadamard,
            "input_mode": self.input_mode,
            "backend": self.backend,
            "demotions": len(self.provenance),
            "block_n": self.tuning.block_n,
            "block_m": self.tuning.block_m,
            "block_p": self.tuning.block_p,
            "hbm_bytes": self.tuning.hbm_bytes,
            "smem_bytes": self.tuning.smem_bytes,
            "table_bytes": (self.tables.nbytes
                            if self.tables is not None else 0),
            "schedule_cycles": self.schedule_cycles,
            "pe_utilization": self.pe_utilization,
            "pool": self.epilogue.pool,
        }

    @property
    def kernel_name(self) -> str:
        """The kernel wrapper this layer runs (its entry point under the
        tuning's flow is ``fsc.entry_point(kernel_name, flow)``)."""
        name = ("fused_spectral_pipeline_scheduled"
                if self.hadamard == "scheduled"
                else "fused_spectral_pipeline")
        return name + ("_halo" if self.input_mode == "halo" else "")


@dataclasses.dataclass(frozen=True, eq=False)
class NetworkPlan:
    """The compile-once artifact ``models.cnn.forward_spectral`` runs:
    per-layer plans plus the topo-ordered DAG to walk.
    ``schedule_seconds`` is the host time spent compiling Alg-2 tables."""

    name: str
    fft_size: int
    batch: int
    layers: tuple[LayerPlan, ...]
    graph: tuple[PlanNode, ...]
    schedule_seconds: float = 0.0

    def node_plan(self, node: PlanNode) -> LayerPlan:
        """The LayerPlan a 'conv' node runs."""
        if node.kind != "conv":
            raise ValueError(f"node {node.id!r} is {node.kind!r}, not "
                             f"'conv'")
        return self.layers[node.layer_index]

    def summary(self) -> list[dict]:
        return [lp.stats() for lp in self.layers]

    def health_report(self) -> dict:
        """The plan's validation diagnostics and demotions
        (``core.resilience``): ``healthy`` (no error-severity diagnostic
        and no demoted layer), ``demoted_layers``, ``demotions_by_node``,
        ``issues`` (counts by severity) and one row per graph node, keyed
        by its stable id, with the layer's modes, provenance and
        diagnostics."""
        diags = res.validate_plan(self, raise_on_error=False)
        rows = []
        for node in self.graph:
            if node.kind != "conv":
                rows.append({"node": node.id, "kind": node.kind,
                             "pool": node.pool, "demotions": [],
                             "issues": []})
                continue
            lp = self.layers[node.layer_index]
            rows.append({
                "node": node.id, "kind": "conv", "layer": node.id,
                "backend": lp.backend, "flow": lp.tuning.flow,
                "hadamard": lp.hadamard, "input_mode": lp.input_mode,
                "residual": lp.epilogue.residual,
                "demotions": list(lp.provenance),
                "issues": [str(d) for d in diags if d.layer == node.id],
            })
        n_err = sum(d.severity == "error" for d in diags)
        n_warn = sum(d.severity == "warn" for d in diags)
        demoted = {lp.layer.name: list(lp.provenance)
                   for lp in self.layers if lp.provenance}
        return {
            "name": self.name,
            "batch": self.batch,
            "healthy": n_err == 0 and not demoted,
            "demoted_layers": list(demoted),
            "demotions_by_node": demoted,
            "issues": {"error": n_err, "warn": n_warn},
            "layers": rows,
        }


# Compile a plan's tables in a process pool of at most SCHEDULE_WORKERS
# processes (and no more than the CPUs) from this many (group, channel)
# schedules on (full VGG16 has 25,539); below it, serially.
SCHEDULE_POOL_MIN_PAIRS = 1024
SCHEDULE_WORKERS = 8


def _sampled_schedule_stats(sk: sp.SparseSpectralKernels, k2: int, *,
                            r: int, n_par: int, channel_sample: int,
                            ) -> tuple[int, float, np.ndarray]:
    """Run Alg 2 on a bounded sample of (group, channel) pairs; return
    (total cycles, Eq-14 utilization, bins the sampled schedules touch).
    By the exact-cover property the sampled bins are a subset of
    ``sk.active_bins``."""
    idx = sk.indices.cpu().numpy()
    n_out, c_in, _ = idx.shape
    chans = np.linspace(0, c_in - 1, min(channel_sample, c_in)).astype(int)
    group = slice(0, min(n_par, n_out))
    total_ops = 0
    total_cycles = 0
    n_pe = group.stop
    bins: set[int] = set()
    for m in np.unique(chans):
        s = sch.schedule_exact_cover(idx[group, m, :], k2, r)
        total_ops += s.total_ops
        total_cycles += s.n_cycles
        for _, fs in s.cycles:
            bins.update(fs.tolist())
    mu = total_ops / max(1, total_cycles * n_pe)
    return total_cycles, mu, np.asarray(sorted(bins), np.int64)


def _resolve_hadamard_modes(hadamard: str, alpha: float, schedule: bool,
                            active: np.ndarray | None) -> list[str]:
    """Hadamard-mode candidates for one layer, honoring availability.

    'bin' needs a compacted active set (otherwise it IS dense);
    'scheduled' needs a non-degenerate schedule (alpha > 1 and
    scheduling enabled) — when it degenerates, the request falls back
    to the plane datapath; 'auto' ranks the plane datapath and, where
    available, the scheduled one.
    """
    plane = "bin" if active is not None else "dense"
    sched_ok = schedule and alpha > 1.0
    if hadamard == "auto":
        return [plane] + (["scheduled"] if sched_ok else [])
    if hadamard == "scheduled":
        return ["scheduled"] if sched_ok else [plane]
    if hadamard == "bin":
        return [plane]
    if hadamard == "dense":
        return ["dense"]
    raise ValueError(
        f"hadamard must be 'auto' or one of {df.HADAMARD_MODES}, "
        f"got {hadamard!r}")


def _resolve_input_modes(input_mode: str) -> list[str]:
    """Input-path candidates for the autotuner ('auto' ranks both; the
    windowed path is always a valid forced choice)."""
    if input_mode == "auto":
        return list(df.INPUT_MODES)
    if input_mode in df.INPUT_MODES:
        return [input_mode]
    raise ValueError(
        f"input_mode must be 'auto' or one of {df.INPUT_MODES}, "
        f"got {input_mode!r}")


def _resolve_flows(hadamard: str, input_mode: str) -> list[str]:
    """Flow candidates: all three when a mode is 'auto' (the reference's
    default plan ranks everything), output-stationary for forced modes
    (the port's default; ``with_flow`` moves a built plan to another
    flow)."""
    return (list(df.FLOWS) if "auto" in (hadamard, input_mode)
            else [fsc.OS])


def _shortcut_search(epilogue: EpilogueSpec) -> str | None:
    """The autotuner's ``residual`` for a layer: a fused shortcut tries
    the staged placement first ('vmem', falling back to 'hbm')."""
    return "vmem" if epilogue.residual == "fused" else None


def _kernel_tuning(lp: LayerPlan, fft_size: int, batch: int, flow: str,
                   input_mode: str) -> FusedTuning:
    """The predicted-best configuration of a built layer under a forced
    flow and input path (its Hadamard mode, tables and epilogue as they
    are): the m-range width for ws/is, the kernels' fixed n and tile
    blocks (a halo CTA takes one halo block of a single image, so its
    ``block_p`` is per image) and a fused shortcut's placement."""
    t_cycles = lp.tables.idx.shape[2] if lp.tables is not None else None
    return at.autotune_layer(
        lp.layer, fft_size, lp.alpha, batch=batch, flows=(flow,),
        active_bins=lp.n_active_bins, hadamard_modes=(lp.hadamard,),
        input_modes=(input_mode,), t_cycles=t_cycles,
        residual=_shortcut_search(lp.epilogue))


def _graph_nodes(order, layers: tuple[LayerPlan, ...]) -> tuple:
    """The plan's DAG: topo-ordered NodeSpecs resolved against the layer
    plans, with each fused shortcut's placement from its tuning."""
    index = {lp.layer.name: i for i, lp in enumerate(layers)}
    return tuple(
        PlanNode(id=s.id, kind="conv", inputs=tuple(s.inputs),
                 layer_index=index[s.id], residual_from=s.residual_from,
                 relu=s.relu, shortcut_on_chip=(
                     layers[index[s.id]].tuning.residual == "vmem"))
        if s.kind == "conv" else
        PlanNode(id=s.id, kind="pool", inputs=tuple(s.inputs),
                 pool=s.pool)
        for s in order)


def _retuned(plan: NetworkPlan, flow: str | None,
             input_mode: str | None) -> NetworkPlan:
    layers = []
    for lp in plan.layers:
        imode = input_mode or lp.input_mode
        tn = _kernel_tuning(lp, plan.fft_size, plan.batch,
                            flow or lp.tuning.flow, imode)
        layers.append(dataclasses.replace(lp, input_mode=imode, tuning=tn))
    return dataclasses.replace(plan, layers=tuple(layers),
                               graph=_graph_nodes(plan.graph, tuple(layers)))


def with_input_mode(plan: NetworkPlan, input_mode: str) -> NetworkPlan:
    """The same plan on another input path: operands and Alg-2 tables do
    not depend on it, so nothing is rebuilt; each ``LayerPlan`` keeps its
    flow and epilogue (residual modes included) and gets the mode and the
    kernel blocks that go with it, and a fused shortcut the placement
    that fits it (equal to what ``build_network_plan(...,
    input_mode=input_mode)`` builds)."""
    if input_mode not in df.INPUT_MODES:
        raise ValueError(f"input_mode must be one of {df.INPUT_MODES}, "
                         f"got {input_mode!r}")
    return _retuned(plan, None, input_mode)


def with_flow(plan: NetworkPlan, flow: str) -> NetworkPlan:
    """The same plan under another reuse flow: operands and tables do not
    depend on it, so nothing is rebuilt; each ``LayerPlan`` keeps its
    Hadamard mode, input path and epilogue (residual modes included) and
    gets the flow with the m-range width the cost model prefers for it
    (a fused shortcut is read from device memory under ws/is, which have
    no staged placement)."""
    if flow not in df.FLOWS:
        raise ValueError(f"flow must be one of {df.FLOWS}, got {flow!r}")
    return _retuned(plan, flow, None)


@contextlib.contextmanager
def _schedule_pool(workers: int):
    """A spawn-context process pool for table compilation (spawn: the
    parent may hold a CUDA context), or None when serial.

    On exit the workers are joined and, when this pool started it, the
    multiprocessing resource tracker (a helper process that spawn starts
    and that otherwise lives until the interpreter exits) is stopped and
    reaped, so a plan build leaves no process behind."""
    if workers <= 1:
        yield None
        return
    tracker = resource_tracker._resource_tracker
    started_tracker = tracker._fd is None
    pool = ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        yield pool
    finally:
        pool.shutdown(wait=True)
        del pool
        gc.collect()    # the pool's semaphores unregister from the tracker
        if started_tracker:
            tracker._stop()


# The pruning of ``build_network_plan(prune=)``: the paper's magnitude
# pruning, or Fig 10's uniformly random positions (seed 0 every layer).
PRUNERS = {"magnitude": sp.prune_magnitude, "random": sp.prune_random}


def build_network_plan(params: dict, cfg, *, batch: int = 1,
                       prune: str = "magnitude",
                       hadamard: str = "bin",
                       input_mode: str = "windowed",
                       measure: bool = False,
                       schedule: bool = True,
                       schedule_r: int = 10,
                       schedule_n_par: int = 64,
                       schedule_channel_sample: int = 2,
                       device=None, validate: bool = True) -> NetworkPlan:
    """Compile the whole conv stack once.

    Args:
      params: spatial conv weights and biases (``models.cnn.init`` or
        ``interop.params_from_numpy``); kernels are transformed and
        pruned here, on the CPU.
      cfg: ``models.cnn.SpectralCNNConfig`` (duck-typed on ``layers``,
        ``fft_size``, ``alpha``, ``pool_after``, ``graph``, ``name``).
      batch: images per forward call the plan is built for (recorded).
      prune: 'magnitude' (the K^2/alpha largest bins of each kernel) or
        'random' (Fig 10: ``sparse.prune_random`` with its default seed
        0 for every layer, as the reference draws them).
      hadamard: 'bin' (compact the kernel planes to the active bins;
        the same as 'dense' when no bin is empty), 'dense', 'scheduled'
        (Alg-2 INDEX/VALUE tables; falls back to the plane datapath
        where alpha <= 1 or ``schedule`` is off), or 'auto' (Alg 1 ranks
        the plane and, where available, the scheduled datapath per
        layer; the reference's default).
      input_mode: 'windowed' (host-built overlap-save windows), 'halo'
        (the kernels gather the windows from the raw activation; a halo
        block's tiles come from one image, so ``block_p`` is per image),
        or 'auto' (Alg 1 ranks both per layer; the reference's default).
        With either mode 'auto', Alg 1 also ranks the three reuse flows
        (with the m-range widths of ws/is); forced modes build
        output-stationary layers (``with_flow`` moves them).
      measure: re-rank each layer's three best predictions by their time
        on the card (``autotune._make_measure_fn``: the layer's own
        operands, tables compiled at most once per layer); raises when
        the plan is not on a CUDA device (there is no CPU timing).
      schedule: run Alg 2 at all (False skips the schedule stats AND
        disables the scheduled datapath).
      schedule_r: r, the BRAM-replica analogue (paper S6.3: 10).
      schedule_n_par / schedule_channel_sample: PE-group size and
        channel count of the SAMPLED stats of plane-mode layers
        (scheduled layers group by the scheduled kernel's block_n).
      device: where the plan's operands live; None means the CUDA
        device (raises when there is none).
      validate: run ``resilience.validate_plan`` on the finished plan
        (default), so a corrupted table, inconsistent operators or halo
        starts off the image are refused at build, not at launch; a
        layout over the shared-memory budget is a warning here
        (``resilience.harden_network_plan`` demotes it).
    """
    if prune not in PRUNERS:
        raise ValueError(f"prune must be one of {tuple(PRUNERS)}, "
                         f"got {prune!r}")
    prune_fn = PRUNERS[prune]
    if hadamard not in df.HADAMARD_MODES + ("auto",):
        raise ValueError(f"hadamard must be 'auto' or one of "
                         f"{df.HADAMARD_MODES}, got {hadamard!r}")
    imodes = _resolve_input_modes(input_mode)
    flows = _resolve_flows(hadamard, input_mode)
    device = repro_torch.resolve_device(device)
    layers = list(cfg.layers)
    alphas = sp.per_layer_alphas(cfg.alpha, len(layers))
    pool_after = getattr(cfg, "pool_after", frozenset())
    k2 = cfg.fft_size * cfg.fft_size

    graph_specs = getattr(cfg, "graph", None)
    explicit_graph = graph_specs is not None
    if not explicit_graph:
        graph_specs = _linear_node_specs(layers, pool_after)
    order = _topo_order_specs(graph_specs)
    conv_specs = {s.id: s for s in order if s.kind == "conv"}
    names = [l.name for l in layers]
    if sorted(conv_specs) != sorted(names):
        raise res.PlanValidationError(
            f"graph conv nodes {sorted(conv_specs)} do not match "
            f"cfg.layers {sorted(names)} (each conv layer must appear "
            f"in exactly one node)", site="graph")
    node_output_shapes(layers, order)   # DAG shape checks (raises)

    # (group, channel) schedules the tables may need, to size the pool
    n_pairs = sum(-(-l.c_out // fsc.SCHED_BLOCK_N) * l.c_in
                  for l, a in zip(layers, alphas)
                  if hadamard in ("scheduled", "auto") and schedule
                  and a > 1.0)
    workers = (min(SCHEDULE_WORKERS, os.cpu_count() or 1)
               if n_pairs >= SCHEDULE_POOL_MIN_PAIRS else 1)
    schedule_seconds = 0.0
    plans: list[LayerPlan] = []
    with _schedule_pool(workers) as pool:
        for layer, conv, alpha in zip(layers, params["convs"], alphas):
            geo = spec.make_geometry(layer.h_in, layer.w_in, layer.ksize,
                                     cfg.fft_size, layer.pad)
            w = conv["w"].detach().to("cpu", torch.float32)
            sk = prune_fn(spec.spectral_kernel(w, cfg.fft_size), alpha)
            cycles = mu = None
            if schedule and alpha > 1.0:
                cycles, mu, sampled_bins = _sampled_schedule_stats(
                    sk, k2, r=schedule_r, n_par=schedule_n_par,
                    channel_sample=schedule_channel_sample)
                if not np.isin(sampled_bins, sk.active_bins).all():
                    raise res.PlanValidationError(
                        f"Alg-2 schedule for {layer.name} touched a "
                        f"frequency bin outside the pruned kernel support",
                        layer=layer.name, site="schedule-stats")
            active = sp.compacted_active_bins(sk, pad_to=fsc.BIN_CHUNK)
            wr, wi = sp.compact_planes(sk, active)
            dfr, dfi, dvr, dvi = fsc.device_operators(geo, active, device)
            modes = _resolve_hadamard_modes(hadamard, alpha, schedule,
                                            active)
            compiled: list = []

            def tables(sk=sk, layer=layer, active=active):
                """The layer's Alg-2 tables, compiled at most once: the
                paper's offline schedule compilation, one exact-cover
                schedule per (kernel-group, channel), remapped to the
                compacted bins of the operators above; group size and
                channel padding are the scheduled kernel's block_n and
                block_m (the tables do not depend on the flow)."""
                nonlocal schedule_seconds
                if not compiled:
                    t0 = time.perf_counter()
                    lt = sch.compile_layer_tables(
                        sk.indices.numpy(),
                        sk.values.reshape(layer.c_out, layer.c_in,
                                          k2).numpy(),
                        k2, schedule_r,
                        min(fsc.SCHED_BLOCK_N, layer.c_out),
                        active=active, m_pad_to=fsc.SCHED_BLOCK_M,
                        pool=pool)
                    schedule_seconds += time.perf_counter() - t0
                    compiled.append((PlanTables(
                        *(torch.from_numpy(a).to(device)
                          for a in (lt.idx, lt.sel, lt.vr, lt.vi))),
                        lt.total_cycles, lt.pe_utilization))
                return compiled[0][0]

            node = conv_specs[layer.name]
            # the fused add needs the stride-1 output the kernel flushes
            # (the subsample follows the kernel): strided nodes add on the
            # host, with the kernel's ReLU off (it would clamp the
            # pre-add value)
            residual = (None if node.residual_from is None
                        else "fused" if layer.stride == 1 else "add")
            epi = EpilogueSpec(bias=True,
                               relu=node.relu and residual != "add",
                               pool=(not explicit_graph
                                     and layer.name in pool_after),
                               residual=residual)
            bias = conv["b"].detach().to(device, torch.float32).reshape(1, -1)
            lp = LayerPlan(
                layer=layer, geo=geo, kernels=sk.to(device), alpha=alpha,
                tuning=None, epilogue=epi, bias=bias.contiguous(),
                active=active, wr=wr.to(device), wi=wi.to(device),
                dfr=dfr, dfi=dfi, dvr=dvr, dvi=dvi, hadamard=modes[0],
                schedule_cycles=cycles, pe_utilization=mu)
            tuning = at.autotune_layer(
                layer, cfg.fft_size, alpha, batch=batch, flows=flows,
                active_bins=lp.n_active_bins, hadamard_modes=modes,
                input_modes=imodes, schedule_r=schedule_r,
                residual=_shortcut_search(epi),
                measure_fn=(at._make_measure_fn(lp, batch, tables)
                            if measure else None))
            lp = dataclasses.replace(lp, tuning=tuning,
                                     hadamard=tuning.hadamard,
                                     input_mode=tuning.input_mode)
            if tuning.hadamard == "scheduled":
                lp = dataclasses.replace(lp, tables=tables(),
                                         schedule_cycles=compiled[0][1],
                                         pe_utilization=compiled[0][2])
                # priced at an estimated table length: re-price at the
                # tables' own, and where they outgrew the cap take the
                # flow's width (or the shortcut's placement) that fits
                tn = at.price(tuning, layer, cfg.fft_size, alpha,
                              batch=batch, active_bins=lp.n_active_bins,
                              schedule_r=schedule_r,
                              t_cycles=lp.tables.idx.shape[2])
                if tn.smem_bytes > fsc.SMEM_PER_CTA and (
                        tn.flow != fsc.OS or tn.residual == "vmem"):
                    tn = _kernel_tuning(lp, cfg.fft_size, batch, tn.flow,
                                        tn.input_mode)
                lp = dataclasses.replace(lp, tuning=tn)
            plans.append(lp)
    net = NetworkPlan(name=getattr(cfg, "name", "spectral-cnn"),
                      fft_size=cfg.fft_size, batch=batch,
                      layers=tuple(plans),
                      graph=_graph_nodes(order, tuple(plans)),
                      schedule_seconds=schedule_seconds)
    if validate:
        res.validate_plan(net)
    return net


# ---------------------------------------------------------------------------
# Keyed plan cache (the serving front end, ``launch.spectral_serve``)
# ---------------------------------------------------------------------------

def plan_cache_key(cfg, batch: int, *,
                   mesh_shape: Sequence[int] | None = None,
                   **build_kwargs) -> tuple:
    """Cache key of one compiled ``NetworkPlan``, the reference's tuple:
    (config name, fft_size, per-layer alphas, batch bucket, ("mesh",
    mesh shape), ("graph", DAG signature), the sorted ``repr`` of the
    build kwargs).

    Alphas are normalized, so a scalar and the same per-layer sequence
    key alike.  ``mesh_shape`` is the topology the plan targets: a plan
    built for one mesh is never served to another (None, unsharded, keys
    apart from every mesh, ``(1,)`` too).  The graph signature (node id,
    kind, inputs, pool, shortcut source, relu) keeps configs that share a
    name but are wired differently apart; None (a linear config) keys
    apart from an explicit chain.  The device a plan lives on enters as
    the ``device=`` build kwarg (``build_network_plan``'s own): pass a
    ``torch.device`` with its index, since ``device('cuda')`` and
    ``device('cuda', 0)`` have different reprs."""
    alphas = sp.per_layer_alphas(cfg.alpha, len(list(cfg.layers)))
    mesh = (tuple(int(d) for d in mesh_shape)
            if mesh_shape is not None else None)
    graph = getattr(cfg, "graph", None)
    gsig = (None if graph is None else tuple(
        (n.id, n.kind, tuple(n.inputs), n.pool, n.residual_from,
         bool(getattr(n, "relu", True)))
        for n in graph))
    return (getattr(cfg, "name", "spectral-cnn"), int(cfg.fft_size),
            tuple(float(a) for a in alphas), int(batch),
            ("mesh", mesh), ("graph", gsig),
            tuple(sorted((k, repr(v)) for k, v in build_kwargs.items())))


@dataclasses.dataclass
class PlanCache:
    """Keyed, warmable cache of compile-once ``NetworkPlan``s.

    A plan build (prune, operators, Alg-2 tables, Alg 1) is set-up work a
    request must never pay: a server warms one plan per batch bucket at
    start (``warm``) and fetches them by ``plan_cache_key`` (``get``).
    ``invalidate(key)`` drops one entry, so the next ``get`` rebuilds it.
    The hit, miss, build and invalidation counts and the seconds spent
    building are in ``stats()``.  ``builder`` (default
    ``build_network_plan``) is called as ``builder(params, cfg,
    batch=..., **build_kwargs)``; ``mesh_shape`` enters the key only."""

    builder: Callable | None = None
    _plans: dict = dataclasses.field(default_factory=dict)
    hits: int = 0
    misses: int = 0
    builds: int = 0
    invalidations: int = 0
    build_s: float = 0.0

    def warm(self, params: dict, cfg, batches: Sequence[int],
             mesh_shape: Sequence[int] | None = None,
             **build_kwargs) -> dict:
        """Build (or confirm) one plan per batch bucket; returns
        {bucket: key}."""
        return {int(b): self.key_of(params, cfg, int(b),
                                    mesh_shape=mesh_shape, **build_kwargs)
                for b in batches}

    def key_of(self, params: dict, cfg, batch: int,
               mesh_shape: Sequence[int] | None = None,
               **build_kwargs) -> tuple:
        """``get``, returning the key instead of the plan."""
        self.get(params, cfg, batch, mesh_shape=mesh_shape, **build_kwargs)
        return plan_cache_key(cfg, batch, mesh_shape=mesh_shape,
                              **build_kwargs)

    def get(self, params: dict, cfg, batch: int,
            mesh_shape: Sequence[int] | None = None,
            **build_kwargs) -> NetworkPlan:
        key = plan_cache_key(cfg, batch, mesh_shape=mesh_shape,
                             **build_kwargs)
        plan = self._plans.get(key)
        if plan is not None:
            self.hits += 1
            return plan
        self.misses += 1
        t0 = time.perf_counter()
        builder = self.builder or build_network_plan
        plan = builder(params, cfg, batch=batch, **build_kwargs)
        self.build_s += time.perf_counter() - t0
        self.builds += 1
        self._plans[key] = plan
        return plan

    def invalidate(self, key: tuple) -> bool:
        """Drop one entry; the next ``get`` of its key rebuilds it."""
        if key in self._plans:
            del self._plans[key]
            self.invalidations += 1
            return True
        return False

    def __len__(self) -> int:
        return len(self._plans)

    def stats(self) -> dict:
        return {"entries": len(self._plans), "hits": self.hits,
                "misses": self.misses, "builds": self.builds,
                "invalidations": self.invalidations,
                "build_s": self.build_s}


# ---------------------------------------------------------------------------
# Sharded plans: a NetworkPlan partitioned over a D-device mesh
# ---------------------------------------------------------------------------

def _pad_layer_tables(tabs, device) -> list[PlanTables]:
    """Per-shard Alg-2 tables (``scheduler.LayerTables``) padded to one
    cycle count T, on ``device``.  Padded cycles carry idx = sel = 0 and
    vr = vi = 0, so they are inert (``compile_layer_tables``' own
    padding)."""
    t_max = max(t.idx.shape[2] for t in tabs)
    pads = ((0, 0), (0, 0), (0, 0), (0, 0))
    out = []
    for t in tabs:
        pad = list(pads)
        pad[2] = (0, t_max - t.idx.shape[2])
        out.append(PlanTables(*(torch.from_numpy(np.pad(a, pad)).to(device)
                                for a in (t.idx, t.sel, t.vr, t.vi))))
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedLayerPlan:
    """One conv layer's plan on a D-device mesh.

    ``base`` is the unsharded ``LayerPlan`` (full geometry, kernels and
    epilogue; what a replicated layer runs).  ``shards`` holds the
    shard-local plans the executor (``distributed.executor``) runs:

      'replicate'  () — every device would run ``base``;
      'spatial'    (band_plan,) — one plan for every shard: the
          shard-local layer (``dataflow.shard_local_layer``) on the band
          geometry (``spectral.make_band_geometry``, pre_halo_h = k-1),
          full channels and the base epilogue;
      'channel'    D plans — shard d owns input channels [d*M/D,
          (d+1)*M/D): kernels, planes and tables sliced on the channel
          axis, bias and ReLU deferred (the outputs are partial sums; the
          executor applies ``base.epilogue`` after the sum).

    ``tuning`` is the two-level Alg-1 choice (``autotune.ShardTuning``);
    ``provenance`` the shard-level demotions of
    ``resilience.harden_sharded_plan``.
    """

    base: LayerPlan
    strategy: str                     # dataflow.SHARD_STRATEGIES
    n_shards: int
    tuning: at.ShardTuning
    shards: tuple[LayerPlan, ...]
    provenance: tuple[str, ...] = ()

    def stats(self) -> dict:
        row = self.base.stats()
        row.update({"strategy": self.strategy, "n_shards": self.n_shards,
                    "shard_demotions": len(self.provenance)})
        return row


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedNetworkPlan:
    """A ``NetworkPlan`` and its per-layer partitioning for one mesh.
    ``base`` stays executable on one device (the sharded forward's
    reference); ``layers`` align with ``base.layers``; ``mesh_shape`` is
    the device topology the plan was built for."""

    base: NetworkPlan
    n_shards: int
    mesh_shape: tuple[int, ...]
    layers: tuple[ShardedLayerPlan, ...]

    @property
    def name(self) -> str:
        return self.base.name

    @property
    def fft_size(self) -> int:
        return self.base.fft_size

    @property
    def batch(self) -> int:
        return self.base.batch

    @property
    def strategies(self) -> dict[str, str]:
        return {slp.base.layer.name: slp.strategy for slp in self.layers}

    def summary(self) -> list[dict]:
        return [slp.stats() for slp in self.layers]


def _compile_tables(lp: LayerPlan, sk: sp.SparseSpectralKernels,
                    schedule_r: int):
    """Alg-2 tables of ``sk`` (the layer's kernels or a channel slice) for
    the scheduled kernel (groups of its block_n lanes, the layer's active
    bins), compiled serially."""
    n, m = sk.values.shape[:2]
    k2 = lp.geo.fft_size ** 2
    return sch.compile_layer_tables(
        sk.indices.cpu().numpy(), sk.values.reshape(n, m, k2).cpu().numpy(),
        k2, schedule_r, min(fsc.SCHED_BLOCK_N, n), active=lp.active,
        m_pad_to=fsc.SCHED_BLOCK_M)


def _band_tables(lp: LayerPlan, tn: FusedTuning,
                 schedule_r: int) -> PlanTables | None:
    """Tables of a spatial band plan (full channels): the base plan's
    when it has them (the port's tables do not depend on the flow or its
    m ranges), else compiled."""
    if tn.hadamard != "scheduled":
        return None
    if lp.tables is not None:
        return lp.tables
    return _pad_layer_tables([_compile_tables(lp, lp.kernels, schedule_r)],
                             lp.wr.device)[0]


def make_sharded_layer_plan(lp: LayerPlan, st: at.ShardTuning,
                            n_shards: int, *,
                            schedule_r: int = 10) -> ShardedLayerPlan:
    """The shard-local plans of one layer (see ``ShardedLayerPlan``).  A
    strategy that is infeasible at ``n_shards`` (or any strategy on one
    shard), and a base plan off the fused backend (a rung of the
    degradation ladder), replicates.

    A channel shard of a scheduled layer takes the base plan's tables
    sliced on the channel axis where the base has them: Alg 2 schedules
    every (kernel group, channel) pair on its own, so the slices are the
    tables a compile of the shard's kernels gives, padded to the base's
    T (and the base carries the layer's schedule statistics); otherwise
    each shard's tables are compiled and padded to one T.
    """
    replicate = ShardedLayerPlan(base=lp, strategy="replicate",
                                 n_shards=n_shards, tuning=st, shards=())
    if n_shards <= 1 or st.strategy == "replicate" or lp.backend != "fused":
        return replicate
    local = df.shard_local_layer(lp.layer, lp.geo.fft_size, n_shards,
                                 st.strategy)
    if local is None:
        return replicate
    tn = st.base
    hadamard = tn.hadamard or lp.hadamard
    input_mode = tn.input_mode or lp.input_mode
    tn = dataclasses.replace(tn, hadamard=hadamard, input_mode=input_mode)
    if st.strategy == "spatial":
        band_geo = spec.make_band_geometry(
            lp.geo, spec.shard_band_rows(lp.geo, n_shards))
        band = dataclasses.replace(
            lp, layer=local, geo=band_geo, tuning=tn,
            epilogue=dataclasses.replace(lp.epilogue, pool=False),
            hadamard=hadamard, input_mode=input_mode,
            tables=_band_tables(lp, tn, schedule_r))
        return ShardedLayerPlan(base=lp, strategy="spatial",
                                n_shards=n_shards, tuning=st,
                                shards=(band,))
    mloc = local.c_in
    sk = lp.kernels
    sliced = [sk._replace(values=sk.values[:, d * mloc:(d + 1) * mloc],
                          mask=sk.mask[:, d * mloc:(d + 1) * mloc],
                          indices=sk.indices[:, d * mloc:(d + 1) * mloc])
              for d in range(n_shards)]
    tables: list = [None] * n_shards
    stats = [(lp.schedule_cycles, lp.pe_utilization)] * n_shards
    if hadamard == "scheduled" and lp.tables is not None:
        tables = [PlanTables(*(t[:, d * mloc:(d + 1) * mloc].contiguous()
                               for t in lp.tables))
                  for d in range(n_shards)]
        stats = [(None, None)] * n_shards
    elif hadamard == "scheduled":
        raw = [_compile_tables(lp, skd, schedule_r) for skd in sliced]
        tables = _pad_layer_tables(raw, lp.wr.device)
        stats = [(t.total_cycles, t.pe_utilization) for t in raw]
    no_epi = EpilogueSpec(bias=False, relu=False, pool=False)
    shards = tuple(
        dataclasses.replace(
            lp, layer=local, kernels=sliced[d], tuning=tn, epilogue=no_epi,
            bias=torch.zeros_like(lp.bias),
            wr=lp.wr[:, :, d * mloc:(d + 1) * mloc].contiguous(),
            wi=lp.wi[:, :, d * mloc:(d + 1) * mloc].contiguous(),
            hadamard=hadamard, input_mode=input_mode,
            schedule_cycles=stats[d][0], pe_utilization=stats[d][1],
            tables=tables[d])
        for d in range(n_shards))
    return ShardedLayerPlan(base=lp, strategy="channel", n_shards=n_shards,
                            tuning=st, shards=shards)


def resharded_layer_plan(slp: ShardedLayerPlan, new_base: LayerPlan, *,
                         schedule_r: int = 10,
                         note: str | None = None) -> ShardedLayerPlan:
    """A ``ShardedLayerPlan`` rebuilt around another base plan (one moved
    down the degradation ladder): the shard tuning takes the new base's
    Hadamard mode and input path, and ``note`` joins the provenance."""
    tn = dataclasses.replace(slp.tuning.base, hadamard=new_base.hadamard,
                             input_mode=new_base.input_mode)
    rebuilt = make_sharded_layer_plan(
        new_base, dataclasses.replace(slp.tuning, base=tn), slp.n_shards,
        schedule_r=schedule_r)
    return dataclasses.replace(
        rebuilt, provenance=slp.provenance + ((note,) if note else ()))


def validate_layer_partition(slp: ShardedLayerPlan) -> None:
    """Raise ``PlanValidationError`` naming every partition invariant of
    ``slp`` that fails (``resilience.validate_layer_partition``, which
    returns them as diagnostics)."""
    errors = res.validate_layer_partition(slp)
    if errors:
        raise res.PlanValidationError(
            f"layer {slp.base.layer.name}: partition invariants fail",
            layer=slp.base.layer.name, site="validate_layer_partition",
            diagnostics=errors)


def validate_sharded_plan(splan: ShardedNetworkPlan) -> None:
    """``resilience.validate_sharded_plan``: raises on an error."""
    res.validate_sharded_plan(splan)


def _shard_network_plan(base: NetworkPlan, *, n_shards: int,
                        mesh_shape=None, strategies=None,
                        hadamard: str = "bin", input_mode: str = "windowed",
                        schedule: bool = True, schedule_r: int = 10,
                        validate: bool = True) -> ShardedNetworkPlan:
    """Partition an already-built plan: the two-level Alg 1
    (``autotune.autotune_layer_sharded``) per layer over the Hadamard
    modes, input paths and flows that ``hadamard`` and ``input_mode``
    admit (as ``build_network_plan`` ranks them), then the shard-local
    plans."""
    imodes = _resolve_input_modes(input_mode)
    flows = _resolve_flows(hadamard, input_mode)
    layers = []
    for lp in base.layers:
        residual = (None if lp.epilogue.residual is None
                    else _shortcut_search(lp.epilogue) or "hbm")
        st = at.autotune_layer_sharded(
            lp.layer, base.fft_size, lp.alpha, n_shards=n_shards,
            strategies=strategies, batch=base.batch, flows=flows,
            active_bins=lp.n_active_bins,
            hadamard_modes=_resolve_hadamard_modes(hadamard, lp.alpha,
                                                   schedule, lp.active),
            input_modes=imodes, schedule_r=schedule_r,
            t_cycles=(lp.tables.idx.shape[2] if lp.tables is not None
                      else None),
            residual=residual)
        layers.append(make_sharded_layer_plan(lp, st, n_shards,
                                              schedule_r=schedule_r))
    splan = ShardedNetworkPlan(
        base=base, n_shards=n_shards,
        mesh_shape=(tuple(int(d) for d in mesh_shape)
                    if mesh_shape is not None else (n_shards,)),
        layers=tuple(layers))
    if validate:
        res.validate_sharded_plan(splan)
    return splan


def build_sharded_network_plan(params: dict, cfg, *, n_shards: int,
                               mesh_shape=None, batch: int = 1,
                               strategies=None, validate: bool = True,
                               **build_kwargs) -> ShardedNetworkPlan:
    """Compile a ``NetworkPlan`` and its per-layer partitioning for an
    ``n_shards``-device mesh.

    The base plan comes first (``build_network_plan(params, cfg,
    batch=batch, **build_kwargs)``; it is also the sharded forward's
    reference), then Alg 1 one level up picks each layer's strategy and
    shard-local configuration (``autotune.autotune_layer_sharded``, over
    the modes and flows that the build's ``hadamard`` and ``input_mode``
    admit), and the shard-local plans are built.  ``strategies``
    restricts the partitionings (e.g. ``("channel",)``); ``mesh_shape``
    defaults to ``(n_shards,)``; ``validate`` checks the base plan, every
    shard plan and every layer's partition invariants
    (``resilience.validate_sharded_plan``).
    """
    base = build_network_plan(params, cfg, batch=batch, validate=validate,
                              **build_kwargs)
    return _shard_network_plan(
        base, n_shards=n_shards, mesh_shape=mesh_shape,
        strategies=strategies,
        hadamard=build_kwargs.get("hadamard", "bin"),
        input_mode=build_kwargs.get("input_mode", "windowed"),
        schedule=build_kwargs.get("schedule", True),
        schedule_r=build_kwargs.get("schedule_r", 10), validate=validate)

"""Compile-once network plan: everything the forward pass needs,
precomputed (counterpart of ``repro.core.plan``).

``build_network_plan`` runs the paper's offline steps once — spectral
transform and magnitude pruning of every conv kernel, active-bin
compaction, the restricted DFT operators, the fused epilogue — on the
CPU, and moves the finished operands to the device.  The forward pass
(``models.cnn.forward_spectral``) only walks the plan's DAG and launches
kernels.

This package builds the narrowest plan the reference accepts:
``input_mode='windowed'``, ``hadamard='dense'|'bin'``, no Alg-2
schedule, and the output-stationary flow with the CUDA kernel's fixed
block sizes (no autotune).  Other modes raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import repro_torch
from repro_torch.core import dataflow as df
from repro_torch.core import sparse as sp
from repro_torch.core import spectral as spec
from repro_torch.core.autotune import FusedTuning
from repro_torch.kernels import fused_spectral_conv as fsc


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """Post-conv elementwise work fused into the kernel (bias, relu) or
    run right after it (pool).  The reference's residual-add modes come
    with residual graphs (ROADMAP A7)."""

    bias: bool = True
    relu: bool = True
    pool: bool = False       # 2x2 max-pool follows this layer (spatial)


@dataclasses.dataclass(frozen=True)
class PlanNode:
    """One node of the compiled DAG plan.

      id            stable node id; for 'conv' nodes the ConvLayer name.
      kind          'conv' | 'pool'.
      inputs        producer ids (length 1; 'input' = network input).
      layer_index   index into ``NetworkPlan.layers`` (-1 for pools).
      pool          'max' | 'avg' (2x2, stride 2) for pool nodes.
      residual_from shortcut producer id, or None.
      relu          apply ReLU at this node's output.
    """

    id: str
    kind: str = "conv"
    inputs: tuple[str, ...] = ("input",)
    layer_index: int = -1
    pool: str = "max"
    residual_from: str | None = None
    relu: bool = True


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
    ValueError on duplicate or reserved ids, unknown references, or a
    cycle."""
    by_id: dict[str, object] = {}
    for s in specs:
        if s.id == "input" or s.id in by_id:
            raise ValueError(
                f"graph node id {s.id!r} is duplicated or reserved")
        by_id[s.id] = s
    deps: dict[str, set] = {}
    for s in specs:
        edges = set(s.inputs)
        if s.residual_from is not None:
            edges.add(s.residual_from)
        edges.discard("input")
        unknown = edges - by_id.keys()
        if unknown:
            raise ValueError(f"graph node {s.id!r} references unknown "
                             f"node(s) {sorted(unknown)}")
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
        raise ValueError(f"graph has a cycle through node(s) {stuck}")
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
    (floor).  Raises ValueError when a conv node's declared input
    disagrees with its producer, or a shortcut edge's shape differs
    from the node's output."""
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
                raise ValueError(
                    f"pool node {s.id!r} has no resolvable input shape")
            c, h, w = src
            out = (c, h // 2, w // 2)
        else:
            layer = by_name.get(s.id)
            if layer is None:
                raise ValueError(
                    f"conv node {s.id!r} has no matching ConvLayer")
            want = (layer.c_in, layer.h_in, layer.w_in)
            if src is not None and src != want:
                raise ValueError(
                    f"conv node {s.id!r} declares input {want} but its "
                    f"producer {s.inputs[0]!r} emits {src}")
            out = (layer.c_out, *layer.out_hw)
        if s.residual_from is not None:
            sc = shapes.get(s.residual_from)
            if sc != out:
                raise ValueError(
                    f"residual edge {s.residual_from!r} -> {s.id!r} adds "
                    f"shape {sc} to output shape {out}")
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
      hadamard    'dense' | 'bin'; input_mode 'windowed'.
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

    @property
    def n_active_bins(self) -> int:
        k2 = self.geo.fft_size ** 2
        return k2 if self.active is None else len(self.active)


@dataclasses.dataclass(frozen=True, eq=False)
class NetworkPlan:
    """The compile-once artifact ``models.cnn.forward_spectral`` runs:
    per-layer plans plus the topo-ordered DAG to walk."""

    name: str
    fft_size: int
    batch: int
    layers: tuple[LayerPlan, ...]
    graph: tuple[PlanNode, ...]


def build_network_plan(params: dict, cfg, *, batch: int = 1,
                       hadamard: str = "bin",
                       input_mode: str = "windowed",
                       schedule: bool = False,
                       device=None) -> NetworkPlan:
    """Compile the whole conv stack once.

    Args:
      params: spatial conv weights and biases (``models.cnn.init`` or
        ``interop.params_from_numpy``); kernels are transformed and
        pruned here, on the CPU.
      cfg: ``models.cnn.SpectralCNNConfig`` (duck-typed on ``layers``,
        ``fft_size``, ``alpha``, ``pool_after``, ``graph``, ``name``).
      batch: images per forward call the plan is built for (recorded).
      hadamard: 'bin' (compact the kernel planes to the active bins;
        the same as 'dense' when no bin is empty) or 'dense'.
        'scheduled'/'auto' are not ported yet (ROADMAP B4, A6).
      input_mode: 'windowed'; 'halo'/'auto' are not ported yet
        (ROADMAP B3).
      schedule: must be False; Alg-2 scheduling is not ported yet
        (ROADMAP A6).
      device: where the plan's operands live; None means the CUDA
        device (raises when there is none).
    """
    if hadamard not in df.HADAMARD_MODES + ("auto",):
        raise ValueError(f"hadamard must be 'auto' or one of "
                         f"{df.HADAMARD_MODES}, got {hadamard!r}")
    if input_mode not in df.INPUT_MODES + ("auto",):
        raise ValueError(f"input_mode must be 'auto' or one of "
                         f"{df.INPUT_MODES}, got {input_mode!r}")
    if hadamard not in ("dense", "bin"):
        raise NotImplementedError(
            f"hadamard={hadamard!r} is not ported yet (ROADMAP B4 / A6: "
            f"scheduled Hadamard and core/scheduler.py)")
    if input_mode != "windowed":
        raise NotImplementedError(
            f"input_mode={input_mode!r} is not ported yet (ROADMAP B3: "
            f"in-kernel halo gather)")
    if schedule:
        raise NotImplementedError(
            "schedule=True is not ported yet (ROADMAP A6: "
            "core/scheduler.py)")
    device = repro_torch.resolve_device(device)
    layers = list(cfg.layers)
    alphas = sp.per_layer_alphas(cfg.alpha, len(layers))
    pool_after = getattr(cfg, "pool_after", frozenset())

    graph_specs = getattr(cfg, "graph", None)
    explicit_graph = graph_specs is not None
    if not explicit_graph:
        graph_specs = _linear_node_specs(layers, pool_after)
    order = _topo_order_specs(graph_specs)
    if any(s.residual_from is not None for s in order):
        raise NotImplementedError(
            "residual shortcut edges are not ported yet (ROADMAP A7)")
    conv_specs = {s.id: s for s in order if s.kind == "conv"}
    names = [l.name for l in layers]
    if sorted(conv_specs) != sorted(names):
        raise ValueError(
            f"graph conv nodes {sorted(conv_specs)} do not match "
            f"cfg.layers {sorted(names)} (each conv layer must appear "
            f"in exactly one node)")
    node_output_shapes(layers, order)   # DAG shape checks (raises)

    plans: list[LayerPlan] = []
    for layer, conv, alpha in zip(layers, params["convs"], alphas):
        geo = spec.make_geometry(layer.h_in, layer.w_in, layer.ksize,
                                 cfg.fft_size, layer.pad)
        w = conv["w"].detach().to("cpu", torch.float32)
        sk = sp.prune_magnitude(spec.spectral_kernel(w, cfg.fft_size),
                                alpha)
        active = sp.compacted_active_bins(sk, pad_to=fsc.BIN_CHUNK)
        wr, wi = sp.compact_planes(sk, active)
        key = tuple(int(a) for a in active) if active is not None else None
        dfr, dfi, dvr, dvi = (torch.from_numpy(a).to(device) for a in
                              fsc.overlap_save_operators(cfg.fft_size,
                                                     layer.ksize, key))
        mode = ("dense" if hadamard == "dense" or active is None
                else "bin")
        tuning = FusedTuning(
            layer=layer.name, flow="output_stationary",
            block_n=min(fsc.BLOCK_N, layer.c_out),
            block_m=min(fsc.BLOCK_M, layer.c_in),
            block_p=min(fsc.BLOCK_P, layer.tiles(cfg.fft_size) * batch),
            hadamard=mode, input_mode="windowed")
        node = conv_specs[layer.name]
        epi = EpilogueSpec(bias=True, relu=node.relu,
                           pool=(not explicit_graph
                                 and layer.name in pool_after))
        bias = conv["b"].detach().to(device, torch.float32).reshape(1, -1)
        plans.append(LayerPlan(
            layer=layer, geo=geo, kernels=sk.to(device), alpha=alpha,
            tuning=tuning, epilogue=epi, bias=bias.contiguous(),
            active=active, wr=wr.to(device), wi=wi.to(device),
            dfr=dfr, dfi=dfi, dvr=dvr, dvi=dvi, hadamard=mode,
            input_mode="windowed"))
    layer_index = {name: i for i, name in enumerate(names)}
    pnodes = tuple(
        PlanNode(id=s.id, kind="conv", inputs=tuple(s.inputs),
                 layer_index=layer_index[s.id], relu=s.relu)
        if s.kind == "conv" else
        PlanNode(id=s.id, kind="pool", inputs=tuple(s.inputs),
                 pool=s.pool)
        for s in order)
    return NetworkPlan(name=getattr(cfg, "name", "spectral-cnn"),
                       fft_size=cfg.fft_size, batch=batch,
                       layers=tuple(plans), graph=pnodes)

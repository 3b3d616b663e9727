"""Spectral CNNs end to end: VGG16 and the residual ResNet-18 DAG
(counterpart of ``repro.models.cnn``).

The conv stack runs in the spectral domain by executing a precompiled
``core.plan.NetworkPlan``; pools, host-side shortcut adds and the FC
head run in the spatial domain as plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

import repro_torch
from repro_torch.core import dataflow as df
from repro_torch.core import plan as pl
from repro_torch.core import sparse as sp
from repro_torch.core import spectral as spec
from repro_torch.kernels.fused_spectral_conv import execute_layer_plan
from repro_torch.kernels.ops import spectral_conv2d_staged
from repro_torch.models import layers as L

# after which conv layers a 2x2 max-pool follows
_POOL_AFTER = frozenset(
    {"conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3"})


@dataclasses.dataclass(frozen=True)
class SpectralCNNConfig:
    """``graph`` is an optional tuple of ``dataflow.NodeSpec`` describing
    a DAG over the conv layers; None is the linear VGG chain with
    max-pools after ``pool_after``."""

    name: str = "vgg16-spectral"
    layers: Sequence[df.ConvLayer] = df.VGG16_LAYERS
    fft_size: int = 8
    # spectral kernel compression: scalar, or one alpha per conv layer
    alpha: float | Sequence[float] = 4.0
    n_classes: int = 1000
    image_size: int = 224
    fc_dim: int = 4096
    pool_after: frozenset = _POOL_AFTER
    graph: Sequence[df.NodeSpec] | None = None


def _config_graph(cfg: SpectralCNNConfig):
    """The topo-ordered NodeSpec sequence a config describes."""
    specs = cfg.graph
    if specs is None:
        specs = pl._linear_node_specs(list(cfg.layers), cfg.pool_after)
    return pl._topo_order_specs(specs)


def feature_dim(cfg: SpectralCNNConfig) -> int:
    """Flattened feature size entering the FC head (the graph sink's
    output shape)."""
    order = _config_graph(cfg)
    shapes = pl.node_output_shapes(list(cfg.layers), order)
    c, h, w = shapes[pl.graph_sink(order)]
    return c * h * w


def init(cfg: SpectralCNNConfig, generator: torch.Generator | None = None,
         device=None) -> dict:
    """Spatial-domain weights (He-normal convs, zero biases, scaled
    normal FC head), drawn on the CPU from ``generator`` (default: seed
    0) and placed on ``device`` (default: the CUDA device).  The
    spectral transform and pruning happen in ``build_network_plan``."""
    device = repro_torch.resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    convs = []
    for layer in cfg.layers:
        fan_in = layer.c_in * layer.ksize ** 2
        w = torch.randn((layer.c_out, layer.c_in, layer.ksize, layer.ksize),
                        generator=generator, device=generator.device,
                        dtype=torch.float32) * (2.0 / fan_in) ** 0.5
        convs.append({"w": w.to(device),
                      "b": torch.zeros(layer.c_out, device=device)})
    kw = dict(generator=generator, device=device)
    return {
        "convs": convs,
        "fc1": L.dense_init(feature_dim(cfg), cfg.fc_dim, **kw),
        "fc2": L.dense_init(cfg.fc_dim, cfg.fc_dim, **kw),
        "fc3": L.dense_init(cfg.fc_dim, cfg.n_classes, **kw),
    }


def transform_kernels(params: dict, cfg: SpectralCNNConfig
                      ) -> list[sp.SparseSpectralKernels]:
    """Offline: spatial -> spectral -> pruned, per-layer alpha."""
    alphas = sp.per_layer_alphas(cfg.alpha, len(cfg.layers))
    return [sp.prune_magnitude(spec.spectral_kernel(conv["w"],
                                                    cfg.fft_size), alpha)
            for conv, alpha in zip(params["convs"], alphas)]


def _pool(x: torch.Tensor, kind: str = "max") -> torch.Tensor:
    """2x2 stride-2 max/avg pool; odd edge rows/cols are dropped."""
    b, c, h, w = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, :, :h2 * 2, :w2 * 2].reshape(b, c, h2, 2, w2, 2)
    return x.amax(dim=(3, 5)) if kind == "max" else x.mean(dim=(3, 5))


# 'staged' and 'fused' are the counterparts of the reference's
# 'pallas_staged' and 'pallas_fused'.
BACKENDS = ("einsum", "staged", "fused")


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """FC head, plain fp32 matmuls (TF32 off on the card)."""
    if x.is_cuda:
        repro_torch.strict_fp32()
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ params["fc1"])
    x = torch.relu(x @ params["fc2"])
    return x @ params["fc3"]


def forward_spectral(params: dict, plan: pl.NetworkPlan, x: torch.Tensor,
                     *, backend: str = "einsum") -> torch.Tensor:
    """Inference by executing a precompiled ``core.plan.NetworkPlan``.

    Args:
      params: the weights (the FC head reads them; the conv stack reads
        only the plan's operands).
      plan: a ``NetworkPlan`` built once by ``build_network_plan``.
      x: [B, C, H, W] f32 input on the plan's device.
      backend: 'einsum' (the torch.fft + einsum oracle), 'staged' (three
        kernel launches per conv layer: tile-FFT, spectral Hadamard over
        the dense K^2 kernel planes, tile-IFFT, with the spectra in
        device memory between them, then bias, stride, shortcut and ReLU
        on the host; the reference's 'pallas_staged') or 'fused' (one
        fused-kernel launch per conv layer with bias + ReLU, and a
        residual-fused node's shortcut add, inside the kernel; the
        reference's 'pallas_fused').  'staged' reads only the plan's
        ``kernels`` and ``geo``, so it runs any plan.

    Returns [B, n_classes] logits.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}")
    graph = plan.graph
    out_id = pl.graph_sink(graph)
    # reference counts free each activation after its last consumer
    refs: dict[str, int] = {out_id: 1}
    for node in graph:
        for src in (node.inputs[0], node.residual_from):
            if src is not None:
                refs[src] = refs.get(src, 0) + 1
    acts: dict[str, torch.Tensor] = {"input": x}
    for node in graph:
        src = acts[node.inputs[0]]
        if node.kind == "pool":
            y = _pool(src, node.pool)
        else:
            lp = plan.layers[node.layer_index]
            want = (lp.layer.c_in, lp.layer.h_in, lp.layer.w_in)
            if tuple(src.shape[1:]) != want:
                raise ValueError(
                    f"plan/input mismatch at {node.id}: plan expects "
                    f"[B, {want[0]}, {want[1]}, {want[2]}], got "
                    f"{tuple(src.shape)}")
            sc = (acts[node.residual_from]
                  if node.residual_from is not None else None)
            y = _conv_node(src, lp, node, sc, backend)
        acts[node.id] = y
        for s in (node.inputs[0], node.residual_from):
            if s is not None:
                refs[s] -= 1
                if refs[s] == 0:
                    acts.pop(s, None)
    return _head(params, acts[out_id])


def _conv_node(x: torch.Tensor, lp: pl.LayerPlan, node: pl.PlanNode,
               sc: torch.Tensor | None, backend: str) -> torch.Tensor:
    """One conv node; epilogue order bias -> stride subsample ->
    (+shortcut) -> ReLU.  The fused backend applies bias, and ReLU when
    no shortcut follows, in the kernel (both are elementwise, so
    subsampling after them is the same).  A residual-fused node
    (``lp.epilogue.residual == 'fused'``, stride 1) hands the shortcut
    to the kernel, which adds it before its ReLU; any other shortcut
    (the 'add' rung of strided nodes) is added on the host after the
    subsample, with the ReLU after it.  The einsum and staged backends
    run the whole epilogue on the host."""
    stride = lp.layer.stride
    if backend in ("einsum", "staged"):
        y = (spec.spectral_conv2d_pretransformed(x, lp.kernels, lp.geo)
             if backend == "einsum" else
             spectral_conv2d_staged(x, lp.kernels.values, lp.geo))
        if lp.epilogue.bias:
            y = y + lp.bias[0][None, :, None, None]
        y = y[:, :, ::stride, ::stride]
        if sc is not None:
            y = y + sc
        return torch.relu(y) if node.relu else y
    if sc is None:
        return execute_layer_plan(x, lp)[:, :, ::stride, ::stride]
    if lp.epilogue.residual == "fused":
        return execute_layer_plan(x, lp, shortcut=sc)
    lp = dataclasses.replace(
        lp, epilogue=dataclasses.replace(lp.epilogue, relu=False))
    y = execute_layer_plan(x, lp)[:, :, ::stride, ::stride] + sc
    return torch.relu(y) if node.relu else y


def forward_spatial(params: dict, cfg: SpectralCNNConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """Dense spatial-domain oracle of the same network: walks the same
    DAG with ``spatial_conv2d`` (bias -> stride -> (+shortcut) -> ReLU).
    """
    order = _config_graph(cfg)
    convs = {layer.name: (layer, conv)
             for layer, conv in zip(cfg.layers, params["convs"])}
    acts: dict[str, torch.Tensor] = {"input": x}
    for s in order:
        src = acts[s.inputs[0]]
        if s.kind == "pool":
            y = _pool(src, s.pool)
        else:
            layer, conv = convs[s.id]
            y = spec.spatial_conv2d(src, conv["w"], pad=layer.pad,
                                    stride=layer.stride)
            y = y + conv["b"][None, :, None, None]
            if s.residual_from is not None:
                y = y + acts[s.residual_from]
            if s.relu:
                y = torch.relu(y)
        acts[s.id] = y
    return _head(params, acts[pl.graph_sink(order)])

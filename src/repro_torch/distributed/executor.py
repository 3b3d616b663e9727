"""Sharded spectral inference: run a ``core.plan.ShardedNetworkPlan`` on a
``launch.mesh.SpectralMesh`` (counterpart of
``repro.distributed.executor``).

Alg 1 asks per layer whether to reuse kernels or activations; on a mesh
the two-level Alg 1 (``autotune.autotune_layer_sharded``) also picks a
partitioning per layer, and this module runs it.  Every layer's output
returns to the global layout on the mesh's first device, so strategies mix
freely across layers.  One process drives every shard (as ``shard_map``
does), and the collectives are explicit tensor moves between the mesh's
devices: ``.to(device)``, a peer copy between cards and nothing at all
when two shards share a device.

  channel   shard d owns input channels [d*M/D, (d+1)*M/D): it runs the
      fused kernel on its channel slice with the epilogue deferred (a
      partial sum through a ReLU is wrong), the partials are summed on the
      first device in shard order, then bias, the shortcut and ReLU.
  spatial   shard d owns a band of tile rows: it receives the last k-1 raw
      rows of shard d-1's band (zeros on shard 0: the global 'same'
      padding) and runs the band kernel
      (``kernels.fused_spectral_conv.execute_band_plan``); the uncropped
      band canvases are joined on H on the first device and cropped once.
  replicate the base plan runs as on one device, on its own backend
      (``resilience.execute_planned_layer``: a layer the sharded ladder
      demoted runs staged or einsum).

Before a sharded layer runs, its shards' tables pass the shard-scoped
fault site ('shard_tables', ``_stage_shard_tables``), on the host.

On a mesh that repeats one card the shards run one after another: the
result is the sharded computation, the time is not a scaling result.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.nn.functional as F

from repro_torch.core import resilience as res
from repro_torch.core import spectral as spec
from repro_torch.core.plan import graph_sink
from repro_torch.kernels.fused_spectral_conv import (execute_band_plan,
                                                     execute_layer_plan)
from repro_torch.launch.mesh import SpectralMesh, make_spectral_mesh
from repro_torch.models.cnn import _head, _pool


def _check_mesh(slp, mesh: SpectralMesh) -> None:
    if mesh.size != slp.n_shards:
        raise ValueError(
            f"layer {slp.base.layer.name}: the plan was built for "
            f"{slp.n_shards} shards but the mesh has {mesh.size} devices; "
            f"rebuild the plan for this mesh")


def _defer_epilogue(lp):
    """``lp`` with its ReLU off and no residual marker: a residual node
    applies relu(y + shortcut) after the collective, so the kernel
    stores the bias-only activation."""
    return dataclasses.replace(
        lp, epilogue=dataclasses.replace(lp.epilogue, relu=False,
                                         residual=None))


def _stage_shard_tables(slp) -> tuple:
    """The layer's shard plans as they run: each shard passes the
    shard-scoped fault site on the host (a raise, or a corruption of its
    tables), the one place a single shard's tables can fail or rot before
    the shards launch.  A shard the site leaves alone is the plan's own
    object (so ``_on_device``'s cache keeps it)."""
    name = slp.base.layer.name
    staged = []
    for d, sh in enumerate(slp.shards):
        res.fault_check("shard_tables", layer=name, shard=d,
                        strategy=slp.strategy)
        if sh.tables is not None:
            tb = res.fault_corrupt("shard_tables", sh.tables, layer=name,
                                   shard=d, strategy=slp.strategy)
            if tb is not sh.tables:
                sh = dataclasses.replace(sh, tables=tb)
        staged.append(sh)
    return tuple(staged)


# layer plan -> {device: the plan with its operands on that device}; an
# entry lives as long as its plan
_PLACED: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _on_device(lp, device: torch.device):
    """``lp`` with its operands on ``device``: ``lp`` itself when they are
    there, else a copy made on the first call for this plan and device
    and reused by every later forward."""
    if lp.wr.device == device:
        return lp
    placed = _PLACED.setdefault(lp, {})
    if device not in placed:
        moved = {f.name: getattr(lp, f.name).to(device)
                 for f in dataclasses.fields(lp)
                 if isinstance(getattr(lp, f.name), torch.Tensor)}
        tables = (None if lp.tables is None
                  else type(lp.tables)(*(t.to(device) for t in lp.tables)))
        placed[device] = dataclasses.replace(
            lp, kernels=lp.kernels.to(device), tables=tables, **moved)
    return placed[device]


def _execute_spatial(x: torch.Tensor, slp, mesh: SpectralMesh,
                     defer_relu: bool = False) -> torch.Tensor:
    geo = slp.base.geo
    ov = geo.ksize - 1
    n_shards = slp.n_shards
    shards = _stage_shard_tables(slp)
    hb = shards[0].geo.n_tiles_h * geo.tile         # raw rows per shard
    xp = F.pad(x, (0, 0, 0, n_shards * hb - x.shape[2]))
    first = mesh.devices[0]
    parts = [xp[:, :, d * hb:(d + 1) * hb].to(dev)
             for d, dev in enumerate(mesh.devices)]
    canvases = []
    for d, dev in enumerate(mesh.devices):
        # the last k-1 rows of shard d-1 move down to shard d; shard 0's
        # halo is the global 'same' zero padding
        halo = (parts[d].new_zeros(parts[d].shape[:2] + (ov, xp.shape[3]))
                if d == 0 else parts[d - 1][:, :, hb - ov:].to(dev))
        x_ext = torch.cat([halo, parts[d]], dim=2)
        band = _on_device(shards[0], dev)
        if defer_relu:
            band = _defer_epilogue(band)
        canvases.append(execute_band_plan(x_ext, band).to(first))
    return spec.crop_canvas_same(torch.cat(canvases, dim=2), geo)


def _execute_channel(x: torch.Tensor, slp, mesh: SpectralMesh,
                     defer_relu: bool = False) -> torch.Tensor:
    mloc = slp.shards[0].layer.c_in
    first = mesh.devices[0]
    y = None
    for d, (sh, dev) in enumerate(zip(_stage_shard_tables(slp),
                                      mesh.devices)):
        part = execute_layer_plan(x[:, d * mloc:(d + 1) * mloc].to(dev),
                                  _on_device(sh, dev)).to(first)
        y = part if y is None else y + part      # summed in shard order
    base = _defer_epilogue(slp.base) if defer_relu else slp.base
    return res._spatial_epilogue(y, base)


def execute_sharded_layer(x: torch.Tensor, slp, mesh: SpectralMesh, *,
                          defer_relu: bool = False) -> torch.Tensor:
    """Run one conv layer of a ``ShardedNetworkPlan`` on ``mesh``:
    x [B, M, H, W] -> the whole [B, N, H_out, W_out] output on the mesh's
    first device, whatever the strategy, so consecutive layers may differ.
    Stride and pooling stay with the caller.  ``defer_relu`` turns the
    ReLU off wherever it would run (kernel, band kernel, or after the
    sum) and returns the bias-only activation."""
    if slp.strategy == "replicate" or not slp.shards:
        base = _defer_epilogue(slp.base) if defer_relu else slp.base
        return res.execute_planned_layer(x, base)
    _check_mesh(slp, mesh)
    if slp.strategy == "spatial":
        return _execute_spatial(x, slp, mesh, defer_relu)
    if slp.strategy == "channel":
        return _execute_channel(x, slp, mesh, defer_relu)
    raise ValueError(f"unknown shard strategy {slp.strategy!r}")


def forward_spectral_sharded(params: dict, splan, x: torch.Tensor, *,
                             mesh: SpectralMesh | None = None
                             ) -> torch.Tensor:
    """The sharded counterpart of ``models.cnn.forward_spectral(backend=
    "fused")``: walks the base plan's DAG, running conv nodes through
    ``execute_sharded_layer`` and pools, strides, residual adds and the
    FC head on the mesh's first device.  A replicated residual-fused node
    on the fused backend adds its shortcut in the kernel; any other
    residual node adds it
    after the collective, then the ReLU.  ``mesh`` defaults to
    ``launch.mesh.make_spectral_mesh(splan.n_shards)`` (that many
    distinct CUDA devices).  x: [B, C, H, W] f32 on the mesh's first
    device; returns [B, n_classes] logits there."""
    if mesh is None:
        mesh = make_spectral_mesh(splan.n_shards)
    graph = splan.base.graph
    out_id = graph_sink(graph)
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
            slp = splan.layers[node.layer_index]
            base = slp.base
            stride = base.layer.stride
            sc = (acts[node.residual_from]
                  if node.residual_from is not None else None)
            replicated = slp.strategy == "replicate" or not slp.shards
            if sc is None:
                y = execute_sharded_layer(src, slp, mesh)
                y = y[:, :, ::stride, ::stride]
            elif (replicated and base.backend == "fused"
                  and base.epilogue.residual == "fused"):
                y = res.execute_planned_layer(src, base, shortcut=sc)
            else:
                y = execute_sharded_layer(src, slp, mesh, defer_relu=True)
                y = y[:, :, ::stride, ::stride] + sc
                if node.relu:
                    y = torch.relu(y)
        acts[node.id] = y
        for s in (node.inputs[0], node.residual_from):
            if s is not None:
                refs[s] -= 1
                if refs[s] == 0:
                    acts.pop(s, None)
    return _head(params, acts[out_id])

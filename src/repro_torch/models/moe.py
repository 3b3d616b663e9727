"""Mixture-of-Experts layer: top-k routing, capacity dispatch, expert
parallelism (counterpart of ``repro.models.moe``).

GShard-style capacity dispatch with scatter/gather (memory O(tokens *
top_k), never the [tokens, E, C] one-hot cube):

  1. ``route``: router logits in f32 -> top-k (prob, expert id) per token,
     ties broken toward the lower expert id as ``jax.lax.top_k`` does,
  2. ``_dispatch``: position-in-expert over the flattened (token, k)
     slots (the count of earlier slots of the same expert); slots past
     the expert capacity C are dropped; each kept slot's token lands in
     the [G, E*C, d] dispatch buffer,
  3. ``_experts``: all experts' SwiGLU as one stacked einsum,
  4. ``_combine``: each slot's expert output gathered back, weighted by
     its router probability.

``forward_ep`` is the expert-parallel form, driven from one process as
``distributed.executor`` drives sharded inference: each model-axis shard
runs its E/m experts on its own device, one shard after another, and the
partial outputs are summed on the first shard's device in shard order
(the reference's one ``psum`` over 'model').
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

# f32 elements drawn by one ``randn`` when the stacked expert weights
# are made (kimi-k2's w_gate is 5.6 G elements: drawn whole it would be
# a 22.5 GB f32 transient beside the bf16 model)
_DRAW_ELEMENTS = 1 << 26


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


def _expert_stack(e: int, rows: int, cols: int, *, generator, device,
                  dtype) -> torch.Tensor:
    """[e, rows, cols] normal weights scaled by ``rows ** -0.5``, drawn a
    chunk of experts at a time and cast to ``dtype`` as drawn."""
    out = torch.empty((e, rows, cols), dtype=dtype, device=device)
    if out.is_meta:
        return out
    step = max(1, _DRAW_ELEMENTS // (rows * cols))
    for lo in range(0, e, step):
        hi = min(lo + step, e)
        out[lo:hi] = L._normal((hi - lo, rows, cols), rows ** -0.5,
                               generator=generator, device=device,
                               dtype=dtype)
    return out


def init(cfg: MoEConfig, dtype=torch.float32, *,
         generator: torch.Generator, device) -> dict:
    """The router in f32 (whatever ``dtype``), the experts' stacked
    SwiGLU weights in ``dtype``."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "router": L.dense_init(d, e, generator=generator, device=device,
                               dtype=torch.float32),
        "w_gate": _expert_stack(e, d, f, **kw),
        "w_up": _expert_stack(e, d, f, **kw),
        "w_down": _expert_stack(e, f, d, **kw),
    }


def capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts)
    return max(4, c)


def route(params, cfg: MoEConfig, x: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [G, S, d] -> (probs [G, S, E] f32, top_p [G, S, K] renormalised,
    top_i [G, S, K] int64).  Of equal probabilities the lower expert id
    comes first (a stable descending sort), as in ``jax.lax.top_k``;
    ``torch.topk`` leaves that order unspecified."""
    logits = x.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :cfg.top_k], top_i[..., :cfg.top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_i


def _dispatch(x: torch.Tensor, flat_i: torch.Tensor, n_experts: int, c: int,
              k: int, local: torch.Tensor | None = None):
    """Capacity dispatch of ``x`` [G, S, d] over the (token, k) slots
    ``flat_i`` [G, S*K] (expert ids in [0, n_experts); ``local`` masks
    the slots of other shards' experts).  Returns (buffer [G, E*C, d],
    slots per expert [G, E], keep [G, S*K] bool, slot [G, S*K]; a
    dropped slot's ``slot`` is 0, its weight in ``_combine`` zero).

    A slot's position in its expert is the number of earlier slots of the
    same expert (the reference's cumulative sum of a one-hot over the
    slots): its rank in a stable sort by expert id, less the start of its
    expert's run (a cumulative sum down 4096 x 6 slots runs one thread a
    column on the card, ~5 ms a layer).  Kept slots are distinct, so each
    buffer row takes at most one token and is written, not added to.  The
    reference adds a dropped slot's zero row at slot 0, which leaves
    finite values as they are; here it goes to a spare row past the end,
    cut off before the buffer is returned (thousands of adds into one row
    serialise on the card's atomics)."""
    g, s, d = x.shape
    sk = flat_i.shape[1]
    # the other shards' slots sort into an extra run past the last expert
    key = flat_i if local is None else torch.where(local, flat_i, n_experts)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    runs = torch.arange(n_experts + 1, device=x.device).expand(g, -1)
    starts = torch.searchsorted(sorted_key, runs.contiguous())  # [G, E+1]
    rank = torch.arange(sk, device=x.device).expand(g, -1)
    pos_in_e = torch.empty_like(sorted_key).scatter_(
        1, order, rank - torch.gather(starts, 1, sorted_key))
    counts = torch.diff(starts, dim=1, append=torch.full(
        (g, 1), sk, dtype=starts.dtype, device=x.device))[:, :n_experts]
    keep = pos_in_e < c
    if local is not None:
        keep = local & keep
    slot = torch.where(keep, flat_i * c + pos_in_e, 0)
    xk = (x[:, :, None].expand(g, s, k, d).reshape(g, s * k, d)
          * keep[..., None].to(x.dtype))
    dest = torch.where(keep, slot, n_experts * c)
    buf = torch.zeros((g, n_experts * c + 1, d), dtype=x.dtype,
                      device=x.device)
    buf.scatter_(1, dest[..., None].expand(-1, -1, d), xk)
    return buf[:, :-1], counts, keep, slot


def _experts(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """The stacked SwiGLU: h [G, E, C, d] -> [G, E, C, d]."""
    gate = F.silu(torch.einsum("gecd,edf->gecf", h, w_gate.to(h.dtype)))
    up = torch.einsum("gecd,edf->gecf", h, w_up.to(h.dtype))
    return torch.einsum("gecf,efd->gecd", gate * up, w_down.to(h.dtype))


def _combine(out_flat: torch.Tensor, slot: torch.Tensor, top_p: torch.Tensor,
             keep: torch.Tensor, s: int, k: int) -> torch.Tensor:
    """Each slot's expert output (out_flat [G, E*C, d]) weighted by its
    router probability, summed over k -> [G, S, d].  A dropped slot reads
    slot 0 with weight zero."""
    g, _, d = out_flat.shape
    yk = torch.gather(out_flat, 1, slot[..., None].expand(-1, -1, d))
    w = (top_p.reshape(g, s * k) * keep).to(out_flat.dtype)
    return (yk * w[..., None]).reshape(g, s, k, d).sum(dim=2)


def forward(params, cfg: MoEConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, dict]:
    """x: [G, S, d] (G = routing groups; capacity is per group).

    Returns (y [G, S, d], aux) with aux = the load-balance loss terms
    ``lb_loss`` and ``dropped_frac`` (0-d f32 tensors)."""
    g, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, s)
    probs, top_p, top_i = route(params, cfg, x)
    buf, counts, keep, slot = _dispatch(x, top_i.reshape(g, s * k), e, c, k)
    out = _experts(buf.reshape(g, e, c, d), params["w_gate"],
                   params["w_up"], params["w_down"])
    y = _combine(out.reshape(g, e * c, d), slot, top_p, keep, s, k)

    # Switch-style load-balance aux loss
    me = probs.mean(dim=(0, 1))                                 # [E]
    ce = counts.sum(dim=0).to(torch.float32) / (g * s * k)
    aux = {
        "lb_loss": e * torch.sum(me * ce),
        "dropped_frac": 1.0 - keep.to(torch.float32).mean(),
    }
    return y, aux


# ---------------------------------------------------------------------------
# Expert parallelism, driven from one process
# ---------------------------------------------------------------------------

def _local_expert_ffn(params, cfg: MoEConfig, x: torch.Tensor, e_lo: int,
                      e_loc: int, w_gate, w_up, w_down) -> torch.Tensor:
    """One model shard's part: route every token, dispatch to the E_loc
    experts ``[e_lo, e_lo + e_loc)`` this shard owns (its capacity
    buffer is its own), run them, combine; the cross-shard sum is the
    caller's."""
    g, s, d = x.shape
    k = cfg.top_k
    c = capacity(cfg, s)
    _, top_p, top_i = route(params, cfg, x)
    flat_i = top_i.reshape(g, s * k)
    local = (flat_i >= e_lo) & (flat_i < e_lo + e_loc)
    loc_i = torch.where(local, flat_i - e_lo, 0)
    buf, _, keep, slot = _dispatch(x, loc_i, e_loc, c, k, local)
    out = _experts(buf.reshape(g, e_loc, c, d), w_gate, w_up, w_down)
    return _combine(out.reshape(g, e_loc * c, d), slot, top_p, keep, s, k)


def _axis_size(mesh, axes) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    axes = [axes] if isinstance(axes, str) else list(axes)
    for ax in axes:
        if ax not in sizes:
            raise ValueError(f"mesh axes {mesh.axis_names} have no {ax!r}")
    return math.prod(sizes[ax] for ax in axes)


def _shard_index(mesh, coord: tuple[int, ...], axes) -> int:
    """The row-major index of ``coord`` over ``axes`` (in their order)."""
    axes = [axes] if isinstance(axes, str) else list(axes)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    at = dict(zip(mesh.axis_names, coord))
    idx = 0
    for ax in axes:
        idx = idx * sizes[ax] + at[ax]
    return idx


def forward_ep(params, cfg: MoEConfig, x: torch.Tensor, *, mesh,
               data_axes: tuple[str, ...], model_axis: str = "model",
               fsdp_axes: tuple[str, ...] = ()) -> tuple[torch.Tensor, dict]:
    """Expert parallelism on a ``launch.mesh.HostMesh``: experts split over
    ``model_axis``, token groups over ``data_axes``.  For each data shard,
    each model shard runs its experts on its mesh device, one after
    another, and the partial outputs are summed on the first model
    shard's device in shard order.  The controller holds the whole
    weights, so ``fsdp_axes`` (the reference's all-gathers of the
    weights) change nothing.  Returns (y [G, S, d] on ``x``'s device,
    aux of zeros) as the reference does."""
    del fsdp_axes
    e = cfg.n_experts
    m_ways = _axis_size(mesh, model_axis)
    n_data = _axis_size(mesh, data_axes)
    if e % m_ways:
        raise ValueError(f"{e} experts do not split over {m_ways} model "
                         f"shards")
    g = x.shape[0]
    if g % n_data:
        raise ValueError(f"{g} routing groups do not split over {n_data} "
                         f"data shards")
    e_loc, g_loc = e // m_ways, g // n_data
    # the device of each (data shard, model shard): the first mesh
    # coordinate that holds it (the others are replicas)
    owner: dict[tuple[int, int], torch.device] = {}
    for coord in itertools.product(*map(range, mesh.shape)):
        key = (_shard_index(mesh, coord, data_axes),
               _shard_index(mesh, coord, model_axis))
        owner.setdefault(key, mesh.device_at(coord))
    ys = []
    for di in range(n_data):
        x_loc = x[di * g_loc:(di + 1) * g_loc]
        acc = None
        for mi in range(m_ways):
            dev = owner[(di, mi)]
            lo = mi * e_loc
            part = _local_expert_ffn(
                {"router": params["router"].to(dev)}, cfg, x_loc.to(dev), lo,
                e_loc, *(params[w][lo:lo + e_loc].to(dev)
                         for w in ("w_gate", "w_up", "w_down")))
            acc = part if acc is None else acc + part.to(acc.device)
        ys.append(acc.to(x.device))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return torch.cat(ys, dim=0), {"lb_loss": zero, "dropped_frac": zero}

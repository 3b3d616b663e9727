"""AdamW and Adafactor (factored second moment) optimizers (counterpart
of ``repro.optim.adamw``).

Plain functions on trees of tensors (``optim.tree``): the state mirrors
the parameter tree, and ``update`` writes the new parameters and state
in place under ``torch.no_grad()`` (the reference returns new trees) and
returns them.  The arithmetic is the reference's: f32 moments, bias
corrections ``1 - b ** count`` in f32 on the parameters' device, weight
decay inside the step, and a bf16 parameter updated in f32 and cast
back.  Adafactor factors the second moment of a matrix whose last two
dims are both at least ``min_dim_size_to_factor`` into row and column
statistics, with ``beta2 = 1 - t ** -decay`` and an RMS update clip.

The reference holds a layer stack as one leaf, so where it takes a
statistic over a whole leaf the port takes it over the group of that
leaf's layers (``tree.groups``): Adafactor's RMS clip.  The global norm
sums the per-layer leaves, so its order differs from the reference's at
the ulp level.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim import tree as T


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor
    decay: float = 0.8             # t^-decay second-moment schedule
    min_dim_size_to_factor: int = 128


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in T.flatten(tree).values()))


def clip_by_global_norm(grads, max_norm: float):
    """(the gradients scaled to a global norm of at most ``max_norm``,
    the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return T.map_tree(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                      grads), norm


def _first_device(params) -> torch.device:
    return next(iter(T.flatten(params).values())).device


def _zeros_f32(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_first_device(params))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params) -> dict:
    return {"mu": T.map_tree(_zeros_f32, params),
            "nu": T.map_tree(_zeros_f32, params),
            "count": _count(params)}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, state: dict, params):
    state["count"] += 1
    b1, b2 = cfg.b1, cfg.b2
    count = state["count"].to(torch.float32)
    # a fill, not a copy of a host scalar (which would wait for the card)
    c1 = 1.0 - torch.pow(torch.full_like(count, b1), count)
    c2 = 1.0 - torch.pow(torch.full_like(count, b2), count)
    for path, p in T.flatten(params).items():
        g = T.get(grads, path).to(torch.float32)
        m, v = T.get(state["mu"], path), T.get(state["nu"], path)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - cfg.lr * step).to(p.dtype))
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------

def _factored(shape: tuple[int, ...], threshold: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= threshold \
        and shape[-2] >= threshold


def adafactor_init(params, cfg: OptimizerConfig = OptimizerConfig()) -> dict:
    def per_leaf(p):
        if _factored(tuple(p.shape), cfg.min_dim_size_to_factor):
            return {"vr": _zeros_f32(p, p.shape[:-1]),
                    "vc": _zeros_f32(p, p.shape[:-2] + p.shape[-1:])}
        return {"v": _zeros_f32(p)}

    return {"v": T.map_tree(per_leaf, params), "count": _count(params)}


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, grads, state: dict, params):
    state["count"] += 1
    beta2 = 1.0 - state["count"].to(torch.float32) ** -cfg.decay
    for group in T.groups(params):
        steps = []
        for path in group:
            g = T.get(grads, path).to(torch.float32)
            v = T.get(state["v"], path)
            g2 = g * g + 1e-30
            if "vr" in v:
                v["vr"].copy_(beta2 * v["vr"] + (1 - beta2) * g2.mean(dim=-1))
                v["vc"].copy_(beta2 * v["vc"] + (1 - beta2) * g2.mean(dim=-2))
                denom = v["vr"].mean(dim=-1, keepdim=True)
                rms = (v["vr"] / torch.clamp_min(denom, 1e-30))[..., None] \
                    * v["vc"][..., None, :]
            else:
                v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
                rms = v["v"]
            steps.append(g * torch.rsqrt(rms + 1e-30))
        # update clipping (Adafactor's d=1.0 RMS clip) over the group: the
        # reference's layer-stacked leaf
        mean_sq = sum(torch.sum(s * s) for s in steps) \
            / sum(s.numel() for s in steps)
        clip = torch.clamp_min(torch.sqrt(mean_sq), 1.0)
        for path, step in zip(group, steps):
            p = T.get(params, path)
            step = step / clip + cfg.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - cfg.lr * step).to(p.dtype))
    return params, state


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def init(cfg: OptimizerConfig, params) -> dict:
    if cfg.name == "adamw":
        return adamw_init(params)
    if cfg.name == "adafactor":
        return adafactor_init(params, cfg)
    raise ValueError(cfg.name)


def update(cfg: OptimizerConfig, grads, state: dict, params):
    """Clip ``grads`` to ``cfg.grad_clip`` and take one step, writing the
    parameters and the state in place.  Returns (params, state, the
    gradients' global norm before clipping)."""
    grads, norm = clip_by_global_norm(grads, cfg.grad_clip)
    if cfg.name == "adamw":
        p, s = adamw_update(cfg, grads, state, params)
    else:
        p, s = adafactor_update(cfg, grads, state, params)
    return p, s, norm

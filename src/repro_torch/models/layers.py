"""Shared layers (counterpart of ``repro.models.layers``): initializers,
norms, rotary embeddings, MLPs and the cross-entropy loss as plain
functions on tensors, and ``ParamTree``, the module that holds a model's
parameters.

Each initializer draws float32 normals from ``generator`` on the
generator's own device and casts them to ``dtype`` on ``device`` as it
makes them, so a full-width model drawn by a generator on the card never
holds a float32 copy beside its bf16 weights.  On the ``meta`` device an
initializer draws nothing and allocates nothing (``api.init_abstract``).
"""

from __future__ import annotations

import torch
from torch import nn


class ParamTree(nn.Module):
    """A model's parameters as a module, indexed like the reference's
    parameter dicts: ``tree["blocks"][3]["attn"]["wq"]``.

    Built from a nested dict: a tensor becomes a parameter, a dict a
    sub-tree, a list an ``nn.ModuleList`` of sub-trees (or of such lists:
    a stack of layer groups, ``tree["groups"][g][i]``).  A parameter
    takes a gradient only in a ``trainable`` tree (inference trees take
    none).  ``.to(dtype)`` casts every weight in place of the old."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, (dict, list)):
                self.add_module(key, _module(value, trainable))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=trainable))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def tree(self) -> dict:
        """The parameters as a nested dict (a layer list as a list), the
        shape the optimizer and the checkpointer take."""
        out: dict = dict(self._parameters)
        for key, mod in self._modules.items():
            out[key] = _tree(mod)
        return out


def _module(value, trainable: bool) -> nn.Module:
    if isinstance(value, dict):
        return ParamTree(value, trainable)
    return nn.ModuleList(_module(v, trainable) for v in value)


def _tree(mod: nn.Module):
    if isinstance(mod, nn.ModuleList):
        return [_tree(m) for m in mod]
    return mod.tree()


def _normal(shape: tuple, scale: float, *, generator: torch.Generator,
            device, dtype) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device).mul_(scale)
    return w.to(device=device, dtype=dtype)


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               device, dtype=torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """[d_in, d_out] normal weights scaled by ``d_in ** -0.5`` (or
    ``scale``), drawn from ``generator`` on its device, returned on
    ``device``."""
    if scale is None:
        scale = d_in ** -0.5
    return _normal((d_in, d_out), scale, generator=generator, device=device,
                   dtype=dtype)


def embed_init(vocab: int, d: int, *, generator: torch.Generator, device,
               dtype=torch.float32) -> torch.Tensor:
    return _normal((vocab, d), 0.02, generator=generator, device=device,
                   dtype=dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(torch.float32)).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32)
            + bias.to(torch.float32)).to(dt)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, H, S, D]; positions: [B, S] or [S].  Half-split layout: the
    first and second halves of D are the rotated pairs."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)        # [D/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs     # [B,S,D/2]
    cos = torch.cos(angles)[:, None, :, :]
    sin = torch.sin(angles)[:, None, :, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_mlp_init(d_model: int, d_ff: int, dtype=torch.float32, *,
                    generator: torch.Generator, device) -> dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "w_gate": dense_init(d_model, d_ff, **kw),
        "w_up": dense_init(d_model, d_ff, **kw),
        "w_down": dense_init(d_ff, d_model, **kw),
    }


def swiglu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    gate = torch.nn.functional.silu(x @ params["w_gate"].to(x.dtype))
    up = x @ params["w_up"].to(x.dtype)
    return (gate * up) @ params["w_down"].to(x.dtype)


def gelu_mlp_init(d_model: int, d_ff: int, dtype=torch.float32, *,
                  generator: torch.Generator, device) -> dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "w_up": dense_init(d_model, d_ff, **kw),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_down": dense_init(d_ff, d_model, **kw),
        "b_down": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = torch.nn.functional.gelu(x @ params["w_up"].to(x.dtype)
                                 + params["b_up"].to(x.dtype),
                                 approximate="tanh")
    return h @ params["w_down"].to(x.dtype) \
        + params["b_down"].to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Mean token NLL in f32 (logsumexp minus the gold logit); labels
    equal to ``ignore_index`` are masked, the mean taken over
    ``max(count, 1)`` tokens."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp_min(0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (labels != ignore_index).to(torch.float32)
    return torch.sum(nll * mask) / torch.sum(mask).clamp_min(1.0)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time.  x: [B, S, C], w: [K, C].

    Returns (y, new_state) where state is the trailing K-1 inputs
    [B, K-1, C] for streaming decode (zeros when none is given)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
            for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else state
    return y, new_state

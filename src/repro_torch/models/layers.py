"""Shared layers (counterpart of ``repro.models.layers``): initializers,
norms, rotary embeddings and MLPs as plain functions on tensors, and
``ParamTree``, the module that holds a model's parameters.

Each initializer draws float32 normals from ``generator`` on the
generator's own device and casts them to ``dtype`` on ``device`` as it
makes them, so a full-width model drawn by a generator on the card never
holds a float32 copy beside its bf16 weights.
"""

from __future__ import annotations

import torch
from torch import nn


class ParamTree(nn.Module):
    """A model's parameters as a module, indexed like the reference's
    parameter dicts: ``tree["blocks"][3]["attn"]["wq"]``.

    Built from a nested dict: a tensor becomes a parameter (inference
    only: no gradient), a dict a sub-tree, a list an ``nn.ModuleList`` of
    sub-trees.  ``.to(dtype)`` casts every weight in place of the old."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            elif isinstance(value, list):
                self.add_module(key, nn.ModuleList(map(ParamTree, value)))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _normal(shape: tuple, scale: float, *, generator: torch.Generator,
            device, dtype) -> torch.Tensor:
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

"""Int8 error-feedback gradient compression for the data-parallel
all-reduce (counterpart of ``repro.optim.compression``).

Per-tensor symmetric: ``q = round(g / scale)``, ``scale = max|g| / 127``,
with the quantisation error carried to the next step (error feedback).
``torch.round`` rounds half to even, as ``jnp.round`` does.  A tensor is
the reference's leaf: a layer stack's per-layer gradients share one scale
(the max over the group, ``tree.groups``), and ``wire_bytes`` counts one
scale for the group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim import tree as T


class Compressed(NamedTuple):
    q: torch.Tensor          # int8 payload
    scale: torch.Tensor      # f32 scalar


def init_residual(params):
    return T.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def compress(grads, residual):
    """Returns (tree of ``Compressed``, new residual tree), both in
    ``grads``' structure."""
    comp, res = {}, {}
    for group in T.groups(grads):
        g = [T.get(grads, p).to(torch.float32) + T.get(residual, p)
             for p in group]
        amax = torch.stack([x.abs().max() for x in g]).max()
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        for path, x in zip(group, g):
            q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            comp[path] = Compressed(q, scale)
            res[path] = x - q.to(torch.float32) * scale
    return T.from_flat(grads, comp), T.from_flat(grads, res)


def decompress(comp):
    return T.map_tree(lambda c: c.q.to(torch.float32) * c.scale, comp)


def wire_bytes(grads) -> tuple[int, int]:
    """(uncompressed f32 bytes, compressed int8 bytes + one f32 scale per
    reference leaf) for reporting."""
    sizes = {p: g.numel() for p, g in T.flatten(grads).items()}
    full = sum(n * 4 for n in sizes.values())
    comp = sum(sum(sizes[p] for p in group) + 4
               for group in T.groups(grads))
    return full, comp

"""Parameter exchange with the reference package, through numpy.

``params_from_numpy`` turns the reference's CNN parameter tree
(``{"convs": [{"w", "b"}, ...], "fc1", "fc2", "fc3"}``), given as numpy
arrays, into this package's tensors, and ``lm_params_from_numpy`` an LM's
tree into this package's model, so both packages compute the same
network.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import ParamTree


def params_from_numpy(tree, device) -> object:
    """Map every numpy array of a nested dict/list tree to a float32
    tensor on ``device`` (structure preserved)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)


def _leaf(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype on ``device``.  A
    bfloat16 leaf (an ``ml_dtypes`` array, which torch does not take)
    goes through float32, which holds every bfloat16 value exactly."""
    a = np.array(a)             # a writable copy for torch.from_numpy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    return [tree]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_numpy(tree: dict, cfg, device) -> ParamTree:
    """The reference's LM parameters (``{"embed", "blocks": {...},
    "final_norm", "unembed"?}`` with every block leaf stacked on a
    leading ``n_layers`` axis, as numpy) as this package's model on
    ``device``: the blocks sliced per layer, each leaf's dtype kept."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} has no port yet")
    for a in _leaves(tree["blocks"]):
        if np.shape(a)[:1] != (cfg.n_layers,):
            raise ValueError(f"a block leaf of shape {np.shape(a)} is not "
                             f"stacked over {cfg.n_layers} layers")
    out = {k: _map(v, lambda a: _leaf(a, device))
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_map(tree["blocks"],
                          lambda a, i=i: _leaf(np.asarray(a)[i], device))
                     for i in range(cfg.n_layers)]
    return ParamTree(out)

"""Parameter exchange with the reference package, through numpy.

``params_from_numpy`` turns the reference's CNN parameter tree
(``{"convs": [{"w", "b"}, ...], "fc1", "fc2", "fc3"}``), given as numpy
arrays, into this package's tensors, and ``lm_params_from_numpy`` an LM's
tree into this package's model, so both packages compute the same
network.  ``lm_params_to_numpy`` is its inverse, and
``opt_state_from_numpy`` / ``opt_state_to_numpy`` map an optimizer state
(AdamW's ``mu`` / ``nu`` / ``count``, Adafactor's ``v`` / ``count``) the
same way, so training can move between the packages.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import ParamTree
from repro_torch.optim import tree as T


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


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} has no port yet")


def lm_tree_from_numpy(tree: dict, cfg, device) -> dict:
    """A tree laid out like the reference's LM parameters (``blocks``
    stacked over layers; numpy) as tensors on ``device``, ``blocks`` a
    list of per-layer trees."""
    for a in T.flatten(tree["blocks"]).values():
        if np.shape(a)[:1] != (cfg.n_layers,):
            raise ValueError(f"a block leaf of shape {np.shape(a)} is not "
                             f"stacked over {cfg.n_layers} layers")
    out = {k: T.map_tree(lambda a: _leaf(a, device), v)
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [T.map_tree(lambda a, i=i: _leaf(np.asarray(a)[i],
                                                     device),
                                tree["blocks"])
                     for i in range(cfg.n_layers)]
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 as float32, which
    holds it exactly (numpy has no bfloat16 of its own)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_tree_to_numpy(tree: dict) -> dict:
    """The inverse of ``lm_tree_from_numpy``: numpy, ``blocks`` stacked."""
    out = {k: T.map_tree(_numpy, v) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = T.map_tree(lambda *xs: np.stack([_numpy(x) for x in xs]),
                               *tree["blocks"])
    return out


def lm_params_from_numpy(tree: dict, cfg, device,
                         trainable: bool = False) -> ParamTree:
    """The reference's LM parameters (``{"embed", "blocks": {...},
    "final_norm", "unembed"?}`` with every block leaf stacked on a
    leading ``n_layers`` axis, as numpy) as this package's model on
    ``device``: the blocks sliced per layer, each leaf's dtype kept (an
    MoE block's router stays f32 beside bf16 experts); parameters that
    take a gradient when ``trainable``."""
    _check_family(cfg)
    return ParamTree(lm_tree_from_numpy(tree, cfg, device),
                     trainable=trainable)


def lm_params_to_numpy(params: ParamTree) -> dict:
    """The inverse of ``lm_params_from_numpy``: the reference's
    layer-stacked numpy tree (a bfloat16 leaf as float32)."""
    return lm_tree_to_numpy(params.tree())


def opt_state_from_numpy(state: dict, cfg, device) -> dict:
    """The reference's optimizer state (``{"mu", "nu", "count"}`` or
    Adafactor's ``{"v", "count"}``, every tree laid out like its
    parameters) as this package's, on ``device``."""
    _check_family(cfg)
    out = {k: lm_tree_from_numpy(v, cfg, device) for k, v in state.items()
           if k != "count"}
    out["count"] = _leaf(np.asarray(state["count"], np.int32), device)
    return out


def opt_state_to_numpy(state: dict) -> dict:
    """The inverse of ``opt_state_from_numpy``."""
    out = {k: lm_tree_to_numpy(v) for k, v in state.items() if k != "count"}
    out["count"] = _numpy(state["count"])
    return out

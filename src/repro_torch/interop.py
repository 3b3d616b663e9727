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


# The reference's layer-stacked parameter trees, by family: each stacked
# key and the number of its leading layer axes.  Here a key stacked on
# one axis is a list of per-layer trees, on two axes a list of such lists
# (``groups[g][i]``); any other key is one tree, as in the reference.
STACKED = {
    "dense": {"blocks": 1},
    "moe": {"blocks": 1},
    "encdec": {"enc_blocks": 1, "dec_blocks": 1},
    "hybrid": {"groups": 2, "rem": 1},
    "xlstm": {"m_groups": 2, "s_blocks": 1, "rem": 1},
}


def _check_family(cfg) -> None:
    if cfg.family not in STACKED:
        raise ValueError(f"unknown model family {cfg.family!r}")


def _unstack(tree, depth: int, device):
    """A layer-stacked numpy tree as ``depth`` nested lists of per-layer
    trees of tensors on ``device``."""
    leaves = list(T.flatten(tree).values())
    n = np.shape(leaves[0])[0]
    if any(np.shape(a)[:1] != (n,) for a in leaves):
        raise ValueError(f"the leaves of a stack do not share their "
                         f"leading axis: {[np.shape(a) for a in leaves]}")
    if depth == 1:
        return [T.map_tree(lambda a, i=i: _leaf(np.asarray(a)[i], device),
                           tree) for i in range(n)]
    return [_unstack(T.map_tree(lambda a, i=i: np.asarray(a)[i], tree),
                     depth - 1, device) for i in range(n)]


def lm_tree_from_numpy(tree: dict, cfg, device) -> dict:
    """A tree laid out like the reference's LM parameters (its layer
    stacks, ``STACKED[cfg.family]``, stacked on their leading axes;
    numpy) as tensors on ``device``, each stack as nested lists of
    per-layer trees."""
    _check_family(cfg)
    stacked = STACKED[cfg.family]
    if "blocks" in stacked:
        for a in T.flatten(tree["blocks"]).values():
            if np.shape(a)[:1] != (cfg.n_layers,):
                raise ValueError(f"a block leaf of shape {np.shape(a)} is "
                                 f"not stacked over {cfg.n_layers} layers")
    return {k: (_unstack(v, stacked[k], device) if k in stacked
                else T.map_tree(lambda a: _leaf(a, device), v))
            for k, v in tree.items()}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 as float32, which
    holds it exactly (numpy has no bfloat16 of its own)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack(tree):
    """The inverse of ``_unstack``: a list of per-layer trees (or a list
    of such lists) as one numpy tree stacked on the leading axes."""
    if isinstance(tree[0], list):
        tree = [_stack(t) for t in tree]
        return T.map_tree(lambda *xs: np.stack(xs), *tree)
    return T.map_tree(lambda *xs: np.stack([_numpy(x) for x in xs]), *tree)


def lm_tree_to_numpy(tree: dict) -> dict:
    """The inverse of ``lm_tree_from_numpy``: numpy, every list of
    per-layer trees (or list of such lists) stacked on its leading
    axes."""
    return {k: (_stack(v) if isinstance(v, list) else T.map_tree(_numpy, v))
            for k, v in tree.items()}


def lm_params_from_numpy(tree: dict, cfg, device,
                         trainable: bool = False) -> ParamTree:
    """The reference's LM parameters (for a dense model ``{"embed",
    "blocks": {...}, "final_norm", "unembed"?}`` with every block leaf
    stacked on a leading ``n_layers`` axis; every family's stacks in
    ``STACKED``; as numpy) as this package's model on ``device``: the
    stacks sliced per layer, each leaf's dtype kept (an MoE block's
    router stays f32 beside bf16 experts); parameters that take a
    gradient when ``trainable``."""
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
    out = {k: lm_tree_from_numpy(v, cfg, device) for k, v in state.items()
           if k != "count"}
    out["count"] = _leaf(np.asarray(state["count"], np.int32), device)
    return out


def opt_state_to_numpy(state: dict) -> dict:
    """The inverse of ``opt_state_from_numpy``."""
    out = {k: lm_tree_to_numpy(v) for k, v in state.items() if k != "count"}
    out["count"] = _numpy(state["count"])
    return out

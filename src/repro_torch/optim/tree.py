"""Trees of tensors: nested dicts and lists (a ``ParamTree.tree()``, an
optimizer state, a checkpoint's ``{"params", "opt"}``), the port's
counterpart of the pytrees the reference maps with ``jax.tree``.

A leaf's path is its keys and list indices from the root; ``key`` joins
them with "/", as the reference's checkpointer names its arrays.  The
reference stacks a model's layers on a leading axis (or two: a hybrid
model's ``groups``), so what is one leaf there is a list of per-layer
leaves here (or a list of such lists): ``groups`` gives those leaves,
for the updates whose result depends on the whole stacked leaf
(Adafactor's RMS clip, the compression scale).
"""

from __future__ import annotations

from typing import Any, Callable

Tree = Any


def _is_node(x) -> bool:
    # a NamedTuple (a compressed gradient) is a leaf
    return isinstance(x, dict) or (isinstance(x, (list, tuple))
                                   and not hasattr(x, "_fields"))


def flatten(tree: Tree, prefix: tuple = ()) -> dict[tuple, Any]:
    """Every leaf by its path, in the tree's order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif _is_node(tree):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, prefix + (k,)))
    return out


def key(path: tuple) -> str:
    return "/".join(map(str, path))


def map_tree(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied to each leaf of ``tree`` and the leaves at the same
    path of ``rest``, in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        return [map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _stack_members(tree) -> list[tuple] | None:
    """The members of a layer stack as (index path, layer tree): a list
    of dicts (one stacked axis), or a list of lists of dicts (the
    reference's leaf stacked on two axes, ``groups[g][i]``); None for
    any other node."""
    if not (isinstance(tree, list) and tree):
        return None
    if all(isinstance(v, dict) for v in tree):
        return [((i,), v) for i, v in enumerate(tree)]
    if all(isinstance(v, list) and v and all(isinstance(u, dict) for u in v)
           for v in tree):
        return [((i, j), u) for i, v in enumerate(tree)
                for j, u in enumerate(v)]
    return None


def groups(tree: Tree, prefix: tuple = ()) -> list[list[tuple]]:
    """The leaves' paths, grouped as the reference's leaves: a layer
    stack (a list of dicts, or a list of lists of dicts) is one stacked
    leaf per path inside the layer, and its members' leaves at that path
    form one group, layer by layer; any other leaf is a group of its
    own."""
    if isinstance(tree, dict):
        return [g for k, v in tree.items()
                for g in groups(v, prefix + (k,))]
    members = _stack_members(tree)
    if members is not None:
        inner = list(flatten(members[0][1]))
        return [[prefix + idx + p for idx, _ in members] for p in inner]
    if _is_node(tree):
        return [g for i, v in enumerate(tree)
                for g in groups(v, prefix + (i,))]
    return [[prefix]]


def get(tree: Tree, path: tuple):
    """The node or leaf at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def from_flat(like: Tree, values: dict, prefix: tuple = ()) -> Tree:
    """``values`` (path -> leaf, as ``flatten`` gives) in ``like``'s
    structure."""
    if isinstance(like, dict):
        return {k: from_flat(v, values, prefix + (k,))
                for k, v in like.items()}
    if _is_node(like):
        return [from_flat(v, values, prefix + (i,))
                for i, v in enumerate(like)]
    return values[prefix]

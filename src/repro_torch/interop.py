"""Parameter exchange with the reference package, through numpy.

``params_from_numpy`` turns the reference's parameter tree
(``{"convs": [{"w", "b"}, ...], "fc1", "fc2", "fc3"}``), given as numpy
arrays, into this package's tensors, so both packages compute the same
network.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device) -> object:
    """Map every numpy array of a nested dict/list tree to a float32
    tensor on ``device`` (structure preserved)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)

"""Step builders of the LM (counterpart of ``repro.launch.steps``): one
training step (loss, gradients by ``torch.autograd``, optimizer update in
place), one prefill step and one decode step.

The reference's abstract half (``batch_specs`` through ``cell_lowerable``:
input specs and sharded lowering of every dry-run cell) needs the port's
sharding plan and device mesh (ROADMAP A13.7 / A13.8).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw as optim
from repro_torch.optim import tree as T


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptimizerConfig
                    ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on a trainable ``ParamTree``: the parameters and the state
    are updated in place (the reference donates them), ``metrics`` holds
    the loss and the gradients' global norm before clipping, as 0-d
    tensors on the parameters' device."""
    def train_step(params, opt_state, batch):
        tree = params.tree()
        flat = T.flatten(tree)
        loss = api.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(flat.values()))
        grads = T.from_flat(tree, dict(zip(flat, grads)))
        _, opt_state, gnorm = optim.update(opt_cfg, grads, opt_state, tree)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        return api.decode(params, cfg, token, cache, pos)

    return serve_step

"""Unified model API: init / forward / prefill / caches / decode
(counterpart of ``repro.models.api``).

Families: ``dense`` (decoder-only transformer: qwen3, yi, smollm,
h2o-danube, the chameleon backbone) runs here.  ``moe``, ``hybrid``,
``xlstm`` and ``encdec`` are later slices and raise
``NotImplementedError`` naming their ROADMAP item.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

_LATER = {
    "moe": "the MoE family (moe.py, forward_ep) is a later slice "
           "(ROADMAP A13)",
    "hybrid": "the hybrid Mamba2 family (hybrid.py, ssm.py) is a later "
              "slice (ROADMAP A13)",
    "xlstm": "the xLSTM family (xlstm.py, xlstm_model.py) is a later slice "
             "(ROADMAP A13)",
    "encdec": "the encoder-decoder family (encdec.py, cross-attention) is a "
              "later slice (ROADMAP A13)",
}


def module(cfg: ModelConfig):
    if cfg.family in _LATER:
        raise NotImplementedError(_LATER[cfg.family])
    if cfg.family != "dense":
        raise ValueError(f"unknown model family {cfg.family!r}")
    return transformer


def init(cfg: ModelConfig, *, generator: torch.Generator | None = None,
         device=None):
    """Random weights on ``device`` (default: the card), drawn by
    ``generator`` (default: seed 0 on that device)."""
    return module(cfg).init(cfg, generator=generator, device=device)


def forward(params, cfg: ModelConfig, batch: dict,
            last_only: bool = False) -> torch.Tensor:
    """batch: {'tokens': [B, S]} (or {'frames': [B, S, d]} for a frames
    frontend)."""
    mod = module(cfg)
    inputs = batch["frames"] if cfg.frontend == "frames" else batch["tokens"]
    return mod.forward(params, cfg, inputs, last_only=last_only)


def prefill(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Prefill serving step: logits for the final position only."""
    return forward(params, cfg, batch, last_only=True)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    return module(cfg).init_cache(cfg, batch, max_len, device=device)


def decode(params, cfg: ModelConfig, token: torch.Tensor, cache, pos):
    """One decode step: token [B, 1] -> (logits [B, 1, V], new cache)."""
    return module(cfg).decode(params, cfg, token, cache, pos)

"""Unified model API: init / forward / prefill / caches / decode
(counterpart of ``repro.models.api``).

Families: ``dense`` (decoder-only transformer: qwen3, yi, smollm,
h2o-danube, the chameleon backbone), ``moe`` (the same stack with an MoE
feed-forward: moonshot, kimi-k2), ``hybrid`` (Mamba2 backbone + shared
attention: zamba2), ``xlstm`` (mLSTM/sLSTM stack: xlstm-350m) and
``encdec`` (the whisper backbone, stub frame frontend).

Entry points run on the card unless the caller passes ``device="cpu"``.
Training differentiates ``loss_fn`` with ``torch.autograd`` on a
``trainable`` parameter tree (``launch/steps.py``).
"""

from __future__ import annotations

import torch

from repro_torch.models import encdec, hybrid, transformer, xlstm_model
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_FAMILIES = {
    "dense": transformer,
    "moe": transformer,
    "hybrid": hybrid,
    "xlstm": xlstm_model,
    "encdec": encdec,
}


def module(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return _FAMILIES[cfg.family]


def init(cfg: ModelConfig, *, generator: torch.Generator | None = None,
         device=None, trainable: bool = False):
    """Random weights on ``device`` (default: the card), drawn by
    ``generator`` (default: seed 0 on that device); parameters that take
    a gradient when ``trainable``."""
    return module(cfg).init(cfg, generator=generator, device=device,
                            trainable=trainable)


def init_abstract(cfg: ModelConfig):
    """The parameter tree on the ``meta`` device: every shape and dtype,
    nothing drawn and nothing allocated (kimi-k2's 1 T parameters
    included), for every family."""
    return init(cfg, device="meta")


def forward(params, cfg: ModelConfig, batch: dict,
            last_only: bool = False) -> torch.Tensor:
    """batch: {'tokens': [B, S]} (or {'frames': [B, S, d]} for a frames
    frontend); encdec takes {'frames': [B, S_enc, d], 'tokens': [B,
    S_dec]}."""
    if cfg.family == "encdec":
        return encdec.forward(params, cfg, batch, last_only=last_only)
    inputs = batch["frames"] if cfg.frontend == "frames" else batch["tokens"]
    return module(cfg).forward(params, cfg, inputs, last_only=last_only)


def prefill(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Prefill serving step: logits for the final position only."""
    return forward(params, cfg, batch, last_only=True)


def loss_fn(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch['labels']`` in f32."""
    logits = forward(params, cfg, batch)
    return L.cross_entropy_loss(logits, batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               enc_len: int = 0, *, device=None):
    """The family's decode state: per-layer KV caches (dense, moe), the
    self caches and cross K/V of ``enc_len`` frames (encdec), the shared
    block's caches and the SSM states (hybrid), the recurrent states
    (xlstm)."""
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, enc_len, device=device)
    if cfg.family == "xlstm":
        return xlstm_model.init_state(cfg, batch, device=device)
    return module(cfg).init_cache(cfg, batch, max_len, device=device)


def decode(params, cfg: ModelConfig, token: torch.Tensor, cache, pos):
    """One decode step: token [B, 1] -> (logits [B, 1, V], new cache)."""
    return module(cfg).decode(params, cfg, token, cache, pos)

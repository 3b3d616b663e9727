"""Zamba2-style hybrid stack: a Mamba2 backbone and one SHARED attention
block (counterpart of ``repro.models.hybrid``).

The backbone is ``n_layers`` Mamba2 blocks; before every
``attn_every``-th block the single shared transformer block (attention
+ MLP, one parameter set reused at every application) refines the
residual stream:

    [shared attn] -> ssm x attn_every   ... repeated, then the remainder.

The parameters keep the reference's grouping: ``groups[g][i]`` (the
reference's leaves stacked [n_groups, attn_every, ...]), ``shared``, and
``rem`` for the remainder.  Each shared-block application has its own KV
cache (it sees the stream at another depth), so decode carries
``n_groups`` (+1) caches.  At S >= 4096 on the card every application's
attention is the flash-attention kernel (``attention.forward``).
"""

from __future__ import annotations

import torch

import repro_torch
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig


def ssm_config(cfg: ModelConfig) -> ssm_lib.SSMConfig:
    return ssm_lib.SSMConfig(
        d_model=cfg.d_model, d_inner=cfg.d_inner,
        n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
        chunk=cfg.ssm_chunk)


def _group_sizes(cfg: ModelConfig) -> tuple[int, int]:
    n_groups = cfg.n_layers // cfg.attn_every
    remainder = cfg.n_layers - n_groups * cfg.attn_every
    return n_groups, remainder


def init(cfg: ModelConfig, *, generator: torch.Generator | None = None,
         device=None, trainable: bool = False) -> L.ParamTree:
    """Random weights on ``device`` (default: the card), drawn by
    ``generator`` (default: seed 0 on ``device``); the SSM's decay,
    step bias and skip in f32, the rest in the config's parameter dtype;
    parameters that take a gradient when ``trainable``."""
    kw = tf.init_kwargs(generator, device)
    scfg = ssm_config(cfg)
    n_groups, remainder = _group_sizes(cfg)

    def ssm_block():
        return {"norm": tf._norm_init(cfg, kw["device"]),
                "ssm": ssm_lib.init(scfg, cfg.pdt, **kw)}

    tree = {
        "embed": L.embed_init(cfg.vocab, cfg.d_model, dtype=cfg.pdt, **kw),
        "groups": [[ssm_block() for _ in range(cfg.attn_every)]
                   for _ in range(n_groups)],
        "shared": tf.init_block(cfg, **kw),
        "final_norm": tf._norm_init(cfg, kw["device"]),
        "unembed": L.dense_init(cfg.d_model, cfg.vocab, dtype=cfg.pdt, **kw),
    }
    if remainder:
        tree["rem"] = [ssm_block() for _ in range(remainder)]
    return L.ParamTree(tree, trainable=trainable)


def _ssm_block_fwd(blk, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = tf.apply_norm(cfg, blk["norm"], x)
    y, _ = ssm_lib.forward(blk["ssm"], ssm_config(cfg), h)
    return x + y


def _ssm_block_step(blk, cfg: ModelConfig, x: torch.Tensor,
                    state: dict) -> tuple[torch.Tensor, dict]:
    h = tf.apply_norm(cfg, blk["norm"], x)
    y, new_state = ssm_lib.decode_step(blk["ssm"], ssm_config(cfg), h,
                                       state)
    return x + y, new_state


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor | None = None,
            last_only: bool = False) -> torch.Tensor:
    """tokens: [B, S] int -> logits [B, S, V] (``last_only``: [B, 1, V]).
    S must be a multiple of the SSD chunk when it exceeds it.  When a
    gradient is needed and ``cfg.remat`` is set, the grouped SSM blocks
    are recomputed in the backward pass (the reference's remat: not the
    shared block, not the remainder)."""
    x = tf.embed_tokens(params, cfg, tokens)
    shared = params["shared"]
    for group in params["groups"]:
        x = tf.block_forward(shared, cfg, x, positions)
        for blk in group:
            x = tf.remat(cfg, _ssm_block_fwd, blk, x)
    if _group_sizes(cfg)[1]:
        x = tf.block_forward(shared, cfg, x, positions)
        for blk in params["rem"]:
            x = _ssm_block_fwd(blk, cfg, x)
    if last_only:
        x = x[:, -1:]
    return tf.logits_head(params, cfg, x)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> dict:
    """``attn``: one KV cache per shared-block application (int8 when
    ``cfg.kv_quant``); ``ssm[g][i]`` and ``ssm_rem[i]``: one conv + SSM
    state per backbone block."""
    device = repro_torch.resolve_device(device)
    n_groups, remainder = _group_sizes(cfg)
    scfg = ssm_config(cfg)
    acfg = tf.attn_config(cfg)
    n_attn = n_groups + (1 if remainder else 0)

    def state():
        return ssm_lib.init_state(scfg, batch, cfg.cdt, device=device)

    cache = {
        "attn": [attn.init_cache(acfg, batch, max_len, cfg.cdt,
                                 quant=cfg.kv_quant, device=device)
                 for _ in range(n_attn)],
        "ssm": [[state() for _ in range(cfg.attn_every)]
                for _ in range(n_groups)],
    }
    if remainder:
        cache["ssm_rem"] = [state() for _ in range(remainder)]
    return cache


def decode(params, cfg: ModelConfig, token: torch.Tensor, cache: dict, pos
           ) -> tuple[torch.Tensor, dict]:
    """token: [B, 1] int; pos: scalar or [B] absolute position.  The KV
    caches are written in place; returns the logits and the new cache."""
    x = tf.embed_tokens(params, cfg, token)
    # one copy of a host position to the device, not one per layer
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    shared = params["shared"]
    new = {"attn": [], "ssm": []}
    for g, group in enumerate(params["groups"]):
        x, a_cache = tf.block_decode(shared, cfg, x, cache["attn"][g], pos)
        new["attn"].append(a_cache)
        states = []
        for blk, st in zip(group, cache["ssm"][g]):
            x, st = _ssm_block_step(blk, cfg, x, st)
            states.append(st)
        new["ssm"].append(states)
    if _group_sizes(cfg)[1]:
        x, a_cache = tf.block_decode(shared, cfg, x, cache["attn"][-1], pos)
        new["attn"].append(a_cache)
        new["ssm_rem"] = []
        for blk, st in zip(params["rem"], cache["ssm_rem"]):
            x, st = _ssm_block_step(blk, cfg, x, st)
            new["ssm_rem"].append(st)
    return tf.logits_head(params, cfg, x), new

"""Whisper-style encoder-decoder backbone (counterpart of
``repro.models.encdec``).

The conv/audio frontend is a stub: the batch carries precomputed frame
embeddings [B, S_enc, d_model].  The encoder is a bidirectional
transformer over frames with sinusoidal absolute positions; the decoder
is causal self-attention + cross-attention + GELU MLP over text tokens,
with sinusoidal positions too (the reference's deviation from Whisper's
learned decoder positions).  Neither side uses rope or qk-norm.

The encoder's attention is non-causal: on a CUDA tensor at S >= 4096 it
runs the flash-attention kernel when S is a whole number of the kernel's
blocks (``attention.forward``), ``_chunked_sdpa`` otherwise.  The layer
stacks are per-layer lists (``enc_blocks``, ``dec_blocks``); when a
gradient is needed and ``cfg.remat`` is set, each block is recomputed in
the backward pass, as the reference wraps its scan body in
``jax.checkpoint``.
"""

from __future__ import annotations

import math

import torch

import repro_torch
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """[.., S] int positions -> [.., S, d] sinusoidal embeddings (f32)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_attn_config(cfg: ModelConfig) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        causal=False, use_rope=False, qk_norm=False)


def _dec_attn_config(cfg: ModelConfig) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        causal=True, use_rope=False, qk_norm=False)


def _init_enc_block(cfg: ModelConfig, kw: dict) -> dict:
    return {
        "attn_norm": tf._norm_init(cfg, kw["device"]),
        "attn": attn.init(_enc_attn_config(cfg), cfg.pdt, **kw),
        "mlp_norm": tf._norm_init(cfg, kw["device"]),
        "mlp": L.gelu_mlp_init(cfg.d_model, cfg.d_ff, cfg.pdt, **kw),
    }


def _init_dec_block(cfg: ModelConfig, kw: dict) -> dict:
    return {
        "self_norm": tf._norm_init(cfg, kw["device"]),
        "self_attn": attn.init(_dec_attn_config(cfg), cfg.pdt, **kw),
        "cross_norm": tf._norm_init(cfg, kw["device"]),
        "cross_attn": attn.init(_dec_attn_config(cfg), cfg.pdt, **kw),
        "mlp_norm": tf._norm_init(cfg, kw["device"]),
        "mlp": L.gelu_mlp_init(cfg.d_model, cfg.d_ff, cfg.pdt, **kw),
    }


def init(cfg: ModelConfig, *, generator: torch.Generator | None = None,
         device=None, trainable: bool = False) -> L.ParamTree:
    """Random weights on ``device`` (default: the card), drawn by
    ``generator`` (default: seed 0 on ``device``) in the config's
    parameter dtype; parameters that take a gradient when
    ``trainable``."""
    kw = tf.init_kwargs(generator, device)
    tree = {
        "embed": L.embed_init(cfg.vocab, cfg.d_model, dtype=cfg.pdt, **kw),
        "enc_blocks": [_init_enc_block(cfg, kw)
                       for _ in range(cfg.n_enc_layers)],
        "enc_norm": tf._norm_init(cfg, kw["device"]),
        "dec_blocks": [_init_dec_block(cfg, kw)
                       for _ in range(cfg.n_layers)],
        "final_norm": tf._norm_init(cfg, kw["device"]),
        "unembed": L.dense_init(cfg.d_model, cfg.vocab, dtype=cfg.pdt, **kw),
    }
    return L.ParamTree(tree, trainable=trainable)


def _enc_block_fwd(blk, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = tf.apply_norm(cfg, blk["attn_norm"], x)
    x = x + attn.forward(blk["attn"], _enc_attn_config(cfg), h)
    h = tf.apply_norm(cfg, blk["mlp_norm"], x)
    return x + L.gelu_mlp(blk["mlp"], h)


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: [B, S_enc, d_model] (stub frontend output)."""
    s = frames.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=frames.device)
    x = frames.to(cfg.cdt) + _sinusoid(pos, cfg.d_model)[None].to(cfg.cdt)
    for blk in params["enc_blocks"]:
        x = tf.remat(cfg, _enc_block_fwd, blk, x)
    return tf.apply_norm(cfg, params["enc_norm"], x)


def _dec_block_fwd(blk, cfg: ModelConfig, x: torch.Tensor,
                   enc: torch.Tensor) -> torch.Tensor:
    """One decoder block over the whole sequence (its self-attention at
    the default positions ``arange(S)``, the reference's)."""
    h = tf.apply_norm(cfg, blk["self_norm"], x)
    x = x + attn.forward(blk["self_attn"], _dec_attn_config(cfg), h)
    h = tf.apply_norm(cfg, blk["cross_norm"], x)
    kv = attn.encode_kv(blk["cross_attn"], _dec_attn_config(cfg), enc)
    x = x + attn.cross_forward(blk["cross_attn"], _dec_attn_config(cfg),
                               h, kv)
    h = tf.apply_norm(cfg, blk["mlp_norm"], x)
    return x + L.gelu_mlp(blk["mlp"], h)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    return tf.embed_tokens(params, cfg, tokens) \
        + _sinusoid(positions, cfg.d_model).to(cfg.cdt)


def forward(params, cfg: ModelConfig, batch: dict,
            last_only: bool = False) -> torch.Tensor:
    """batch: {'frames': [B, S_enc, d], 'tokens': [B, S_dec]}."""
    enc = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens,
               torch.arange(s, dtype=torch.int32, device=tokens.device)[None])
    for blk in params["dec_blocks"]:
        x = tf.remat(cfg, _dec_block_fwd, blk, x, enc)
    if last_only:
        x = x[:, -1:]
    return tf.apply_norm(cfg, params["final_norm"], x) \
        @ params["unembed"].to(cfg.cdt)


# ---------------------------------------------------------------------------
# Decode: self KV cache + precomputed cross KV
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               *, device=None) -> dict:
    """One self-attention KV cache per decoder layer (``self``, a list),
    and the cross-attention K/V of every layer stacked
    [L, B, G, enc_len, D] in the compute dtype (``cross_k`` / ``cross_v``,
    zeros until ``precompute_cross``)."""
    device = repro_torch.resolve_device(device)
    acfg = _dec_attn_config(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, enc_len, cfg.hd)
    return {
        "self": [attn.init_cache(acfg, batch, max_len, cfg.cdt,
                                 device=device)
                 for _ in range(cfg.n_layers)],
        "cross_k": torch.zeros(shape, dtype=cfg.cdt, device=device),
        "cross_v": torch.zeros(shape, dtype=cfg.cdt, device=device),
    }


def precompute_cross(params, cfg: ModelConfig, frames: torch.Tensor,
                     cache: dict) -> dict:
    """Encode ``frames`` once and project every decoder layer's cross K/V
    into a copy of ``cache``."""
    enc = encode(params, cfg, frames)
    kv = [attn.encode_kv(blk["cross_attn"], _dec_attn_config(cfg), enc)
          for blk in params["dec_blocks"]]
    return dict(cache, cross_k=torch.stack([k for k, _ in kv]),
                cross_v=torch.stack([v for _, v in kv]))


def decode(params, cfg: ModelConfig, token: torch.Tensor, cache: dict, pos
           ) -> tuple[torch.Tensor, dict]:
    """token: [B, 1] int; pos: the scalar absolute position.  The self
    caches are updated in place and returned in a copy of ``cache``."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    x = _embed(params, cfg, token, pos[None, None])
    acfg = _dec_attn_config(cfg)
    new_self = []
    for i, blk in enumerate(params["dec_blocks"]):
        h = tf.apply_norm(cfg, blk["self_norm"], x)
        y, layer_cache = attn.decode_step(blk["self_attn"], acfg, h,
                                          cache["self"][i], pos)
        new_self.append(layer_cache)
        x = x + y
        h = tf.apply_norm(cfg, blk["cross_norm"], x)
        x = x + attn.cross_forward(blk["cross_attn"], acfg, h,
                                   (cache["cross_k"][i],
                                    cache["cross_v"][i]))
        h = tf.apply_norm(cfg, blk["mlp_norm"], x)
        x = x + L.gelu_mlp(blk["mlp"], h)
    logits = tf.apply_norm(cfg, params["final_norm"], x) \
        @ params["unembed"].to(cfg.cdt)
    return logits, dict(cache, self=new_self)

"""Decoder-only transformer stack, dense family (counterpart of
``repro.models.transformer``).

The parameters are a ``layers.ParamTree`` whose ``blocks`` is an
``nn.ModuleList`` of per-layer trees (the reference stacks them on a
leading axis and scans); the stack is a Python loop over it.  ``remat``
is a training knob and is not read here.
"""

from __future__ import annotations

import torch

import repro_torch
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family == "moe":
        raise NotImplementedError(
            "the MoE family (moe.py, forward_ep) is a later slice "
            "(ROADMAP A13)")
    if cfg.family != "dense":
        raise ValueError(f"transformer runs the dense family, got "
                         f"{cfg.family!r}")


def attn_config(cfg: ModelConfig) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        window=cfg.window, use_rope=True)


def _norm_init(cfg: ModelConfig, device) -> dict:
    p = {"scale": torch.ones((cfg.d_model,), dtype=cfg.pdt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=cfg.pdt, device=device)
    return p


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return L.layer_norm(x, p["scale"], p["bias"])
    return L.rms_norm(x, p["scale"])


def init_block(cfg: ModelConfig, *, generator: torch.Generator,
               device) -> dict:
    _dense_only(cfg)
    kw = dict(generator=generator, device=device)
    mlp_init = L.gelu_mlp_init if cfg.mlp == "gelu" else L.swiglu_mlp_init
    return {
        "attn_norm": _norm_init(cfg, device),
        "attn": attn.init(attn_config(cfg), cfg.pdt, **kw),
        "mlp_norm": _norm_init(cfg, device),
        "mlp": mlp_init(cfg.d_model, cfg.d_ff, cfg.pdt, **kw),
    }


def _mlp(cfg: ModelConfig, p, h: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "gelu":
        return L.gelu_mlp(p["mlp"], h)
    return L.swiglu_mlp(p["mlp"], h)


def block_forward(p, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor | None) -> torch.Tensor:
    h = apply_norm(cfg, p["attn_norm"], x)
    x = x + attn.forward(p["attn"], attn_config(cfg), h, positions)
    h = apply_norm(cfg, p["mlp_norm"], x)
    return x + _mlp(cfg, p, h)


def block_decode(p, cfg: ModelConfig, x: torch.Tensor,
                 cache: attn.KVCache, pos
                 ) -> tuple[torch.Tensor, attn.KVCache]:
    h = apply_norm(cfg, p["attn_norm"], x)
    y, cache = attn.decode_step(p["attn"], attn_config(cfg), h, cache, pos)
    x = x + y
    h = apply_norm(cfg, p["mlp_norm"], x)
    return x + _mlp(cfg, p, h), cache


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, *, generator: torch.Generator | None = None,
         device=None) -> L.ParamTree:
    """Random weights on ``device`` (default: the card), drawn by
    ``generator`` (default: seed 0 on ``device``), each made in the
    config's parameter dtype."""
    _dense_only(cfg)
    device = repro_torch.resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(generator=generator, device=device)
    tree = {
        "embed": L.embed_init(cfg.vocab, cfg.d_model, dtype=cfg.pdt, **kw),
        "blocks": [init_block(cfg, **kw) for _ in range(cfg.n_layers)],
        "final_norm": _norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = L.dense_init(cfg.d_model, cfg.vocab, dtype=cfg.pdt,
                                       **kw)
    return L.ParamTree(tree)


def logits_head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return x @ params["unembed"].to(x.dtype)


def embed_tokens(params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``tokens`` with the reference's index semantics:
    a negative id counts from the end, then ids are clamped to [0, vocab)
    (an out-of-range index on the card would fire a device assert)."""
    ids = torch.where(tokens < 0, tokens + cfg.vocab, tokens)
    return params["embed"][ids.clamp(0, cfg.vocab - 1)].to(cfg.cdt)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor | None = None,
            last_only: bool = False) -> torch.Tensor:
    """tokens: [B, S] int (or [B, S, d] frames for stub frontends).
    ``last_only`` heads only the final position (prefill serving).
    ``positions`` default to ``arange(S)`` in every row."""
    _dense_only(cfg)
    if tokens.dim() == 2:
        x = embed_tokens(params, cfg, tokens)
    else:
        x = tokens.to(cfg.cdt)
    for blk in params["blocks"]:
        x = block_forward(blk, cfg, x, positions)
    if last_only:
        x = x[:, -1:]
    return logits_head(params, cfg, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> list[attn.KVCache]:
    """One ring-buffered KV cache per layer, in the compute dtype."""
    device = repro_torch.resolve_device(device)
    return [attn.init_cache(attn_config(cfg), batch, max_len, cfg.cdt,
                            quant=cfg.kv_quant, device=device)
            for _ in range(cfg.n_layers)]


def decode(params, cfg: ModelConfig, token: torch.Tensor,
           cache: list[attn.KVCache], pos
           ) -> tuple[torch.Tensor, list[attn.KVCache]]:
    """token: [B, 1] int; pos: scalar or [B] absolute position.  The
    caches are updated in place and returned."""
    _dense_only(cfg)
    x = embed_tokens(params, cfg, token)
    # one copy of a host position to the device, not one per layer
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    new_caches = []
    for blk, layer_cache in zip(params["blocks"], cache):
        x, layer_cache = block_decode(blk, cfg, x, layer_cache, pos)
        new_caches.append(layer_cache)
    return logits_head(params, cfg, x), new_caches

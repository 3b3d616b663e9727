"""Decoder-only transformer stack, dense and MoE families (counterpart of
``repro.models.transformer``).

The parameters are a ``layers.ParamTree`` whose ``blocks`` is an
``nn.ModuleList`` of per-layer trees (the reference stacks them on a
leading axis and scans); the stack is a Python loop over it.  When a
gradient is needed, ``cfg.remat`` recomputes each block in the backward
pass (``torch.utils.checkpoint``, non-reentrant), as the reference wraps
its block in ``jax.checkpoint``: ``remat_policy="dots"`` keeps the weight
GEMMs' outputs (``aten.mm``, the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest, the
attention's batched products included.  An MoE block runs
``moe.forward``; the reference's dispatch to ``moe.forward_ep`` under a
``ShardCtx`` waits for the port's ``distributed/ctx.py``.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

import repro_torch
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig


def attn_config(cfg: ModelConfig) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        window=cfg.window, use_rope=True)


def moe_config(cfg: ModelConfig) -> moe_lib.MoEConfig:
    return moe_lib.MoEConfig(cfg.d_model, cfg.d_ff, cfg.n_experts,
                             cfg.top_k, cfg.capacity_factor)


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
    kw = dict(generator=generator, device=device)
    p = {
        "attn_norm": _norm_init(cfg, device),
        "attn": attn.init(attn_config(cfg), cfg.pdt, **kw),
        "mlp_norm": _norm_init(cfg, device),
    }
    if cfg.family == "moe":
        p["moe"] = moe_lib.init(moe_config(cfg), cfg.pdt, **kw)
    elif cfg.mlp == "gelu":
        p["mlp"] = L.gelu_mlp_init(cfg.d_model, cfg.d_ff, cfg.pdt, **kw)
    else:
        p["mlp"] = L.swiglu_mlp_init(cfg.d_model, cfg.d_ff, cfg.pdt, **kw)
    return p


def _mlp(cfg: ModelConfig, p, h: torch.Tensor) -> torch.Tensor:
    """The block's feed-forward: the MoE layer (its aux dropped) or the
    dense MLP."""
    if cfg.family == "moe":
        return moe_lib.forward(p["moe"], moe_config(cfg), h)[0]
    if cfg.mlp == "gelu":
        return L.gelu_mlp(p["mlp"], h)
    return L.swiglu_mlp(p["mlp"], h)


def block_forward(p, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor | None) -> torch.Tensor:
    h = apply_norm(cfg, p["attn_norm"], x)
    x = x + attn.forward(p["attn"], attn_config(cfg), h, positions)
    h = apply_norm(cfg, p["mlp_norm"], x)
    return x + _mlp(cfg, p, h)


def _save_weight_gemms(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat_policy="dots"``: a matmul without batch dimensions (a
    weight GEMM) is saved, everything else recomputed."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(cfg: ModelConfig, fn, blk, x: torch.Tensor, *args, **kw):
    """``fn(blk, cfg, x, *args)``, recomputed in the backward pass when
    ``cfg.remat`` and a gradient is needed (grad mode on, and ``x`` or a
    weight of ``blk`` requires grad; ``kw`` goes to
    ``torch.utils.checkpoint``); inference runs it as it is."""
    if not (cfg.remat and torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad
                                   for p in blk.parameters()))):
        return fn(blk, cfg, x, *args)
    return checkpoint(fn, blk, cfg, x, *args, use_reentrant=False, **kw)


def _block(blk, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor | None) -> torch.Tensor:
    """One block under ``remat``; ``remat_policy="dots"`` keeps the
    weight GEMMs' outputs.  (The other families' remat, like the
    reference's, takes no policy.)"""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_weight_gemms)
    return remat(cfg, block_forward, blk, x, positions, **kw)


def block_decode(p, cfg: ModelConfig, x: torch.Tensor,
                 cache: attn.KVCache | attn.QuantKVCache, pos
                 ) -> tuple[torch.Tensor, attn.KVCache | attn.QuantKVCache]:
    h = apply_norm(cfg, p["attn_norm"], x)
    y, cache = attn.decode_step(p["attn"], attn_config(cfg), h, cache, pos)
    x = x + y
    h = apply_norm(cfg, p["mlp_norm"], x)
    return x + _mlp(cfg, p, h), cache


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def init_kwargs(generator: torch.Generator | None, device) -> dict:
    """The ``generator`` / ``device`` keywords of a family's ``init``:
    the device resolved (default: the card), the generator seed 0 on it
    when none is given (none on the ``meta`` device)."""
    device = repro_torch.resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    return dict(generator=generator, device=device)


def init(cfg: ModelConfig, *, generator: torch.Generator | None = None,
         device=None, trainable: bool = False) -> L.ParamTree:
    """Random weights on ``device`` (default: the card), drawn by
    ``generator`` (default: seed 0 on ``device``), each made in the
    config's parameter dtype (an MoE router in f32); parameters that
    take a gradient when ``trainable``.  On the ``meta`` device nothing
    is drawn or allocated."""
    kw = init_kwargs(generator, device)
    device = kw["device"]
    tree = {
        "embed": L.embed_init(cfg.vocab, cfg.d_model, dtype=cfg.pdt, **kw),
        "blocks": [init_block(cfg, **kw) for _ in range(cfg.n_layers)],
        "final_norm": _norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = L.dense_init(cfg.d_model, cfg.vocab, dtype=cfg.pdt,
                                       **kw)
    return L.ParamTree(tree, trainable=trainable)


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
    if tokens.dim() == 2:
        x = embed_tokens(params, cfg, tokens)
    else:
        x = tokens.to(cfg.cdt)
    for blk in params["blocks"]:
        x = _block(blk, cfg, x, positions)
    if last_only:
        x = x[:, -1:]
    return logits_head(params, cfg, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> list[attn.KVCache | attn.QuantKVCache]:
    """One ring-buffered KV cache per layer: in the compute dtype, or
    int8 with f32 row scales when ``cfg.kv_quant``."""
    device = repro_torch.resolve_device(device)
    return [attn.init_cache(attn_config(cfg), batch, max_len, cfg.cdt,
                            quant=cfg.kv_quant, device=device)
            for _ in range(cfg.n_layers)]


def decode(params, cfg: ModelConfig, token: torch.Tensor, cache: list, pos
           ) -> tuple[torch.Tensor, list]:
    """token: [B, 1] int; pos: scalar or [B] absolute position.  The
    caches are updated in place and returned."""
    x = embed_tokens(params, cfg, token)
    # one copy of a host position to the device, not one per layer
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    new_caches = []
    for blk, layer_cache in zip(params["blocks"], cache):
        x, layer_cache = block_decode(blk, cfg, x, layer_cache, pos)
        new_caches.append(layer_cache)
    return logits_head(params, cfg, x), new_caches

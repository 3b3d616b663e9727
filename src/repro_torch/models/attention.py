"""Grouped-query attention with qk-norm / sliding-window / KV-cache decode
(counterpart of ``repro.models.attention``).

``forward(impl=...)`` keeps the reference's routes:
  * ``'flash'``   — ``kernels.ops.attention`` (the flash-attention kernel
    on a CUDA tensor, its plain version on a CPU tensor);
  * ``'chunked'`` (and ``'auto'`` at ``s >= CHUNKED_THRESHOLD``) — the
    online-softmax attention: on a CUDA tensor with the default positions
    the same kernel, otherwise the plain ``_chunked_sdpa``;
  * otherwise (``'reference'``, ``'auto'`` below the threshold) — the
    materialised ``_sdpa`` in torch ops.
Decode attends over the cache with ``_sdpa``.

``init_cache`` / ``decode_step`` keep a ring-buffered cache per layer;
``decode_step`` writes the new key and value into it in place (the
reference returns an updated copy) and returns it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L

NEG_INF = -1e30
# sequences at or above this length use the chunked online-softmax path
CHUNKED_THRESHOLD = 4096


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    qk_norm: bool = False
    window: int | None = None        # sliding-window size (None = full)
    causal: bool = True
    use_rope: bool = True


def init(cfg: AttnConfig, dtype=torch.float32, *,
         generator: torch.Generator, device) -> dict:
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "wq": L.dense_init(d, h * hd, **kw),
        "wk": L.dense_init(d, g * hd, **kw),
        "wv": L.dense_init(d, g * hd, **kw),
        "wo": L.dense_init(h * hd, d, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _project_qkv(params, cfg: AttnConfig, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (x @ params["wk"].to(x.dtype)).reshape(b, s, g, hd)
    v = (x @ params["wv"].to(x.dtype)).reshape(b, s, g, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, params["q_norm"])
        k = L.rms_norm(k, params["k_norm"])
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if cfg.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          cfg: AttnConfig, q_positions: torch.Tensor,
          k_positions: torch.Tensor,
          kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Reference attention. q: [B,H,S,D], k/v: [B,G,Skv,D]."""
    b, h, s, hd = q.shape
    g = k.shape[1]
    rep = h // g
    qg = q.reshape(b, g, rep, s, hd)
    logits = torch.einsum("bgrqd,bgkd->bgrqk", qg.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    qi = q_positions.reshape(b, 1, 1, s, 1)
    ki = k_positions.reshape(b, 1, 1, 1, -1)
    mask = torch.ones(logits.shape[-2:], dtype=torch.bool, device=q.device)
    if cfg.causal:
        mask = ki <= qi
    if cfg.window is not None:
        mask = mask & (ki > qi - cfg.window)
    if kv_valid is not None:
        mask = mask & kv_valid.reshape(b, 1, 1, 1, -1)
    # a Python fill value: a device scalar made from one would be a host
    # copy that waits for the card on every call
    logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.to(torch.float32))
    return out.reshape(b, h, s, hd).to(q.dtype)


def _chunked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: AttnConfig, q_positions: torch.Tensor,
                  k_positions: torch.Tensor,
                  chunk: int = 1024) -> torch.Tensor:
    """Flash-style online-softmax attention in torch ops: a loop over KV
    chunks with running (max, denom, acc), O(Sq * chunk) live memory.
    Matches ``_sdpa``; the plain version of the kernel's route."""
    b, h, sq, hd = q.shape
    g = k.shape[1]
    rep = h // g
    skv = k.shape[2]
    chunk = min(chunk, skv)
    pad = (-skv) % chunk
    big = torch.iinfo(torch.int32).max
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad),
                                              value=big)
    n_chunks = k.shape[2] // chunk
    qg = q.reshape(b, g, rep, sq, hd).to(torch.float32)
    qi = q_positions.reshape(b, 1, 1, sq, 1)
    scale = hd ** -0.5
    m = torch.full((b, g, rep, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, g, rep, sq, hd), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        kb = k[:, :, c * chunk:(c + 1) * chunk].to(torch.float32)
        vb = v[:, :, c * chunk:(c + 1) * chunk].to(torch.float32)
        ki = k_positions[:, c * chunk:(c + 1) * chunk].reshape(
            b, 1, 1, 1, chunk)
        logits = torch.einsum("bgrqd,bgkd->bgrqk", qg, kb) * scale
        mask = torch.ones(logits.shape[-2:], dtype=torch.bool,
                          device=q.device)
        if cfg.causal:
            mask = ki <= qi
        if cfg.window is not None:
            mask = mask & (ki > qi - cfg.window)
        mask = mask & (ki < big)
        logits = logits.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        p = torch.where(m_new > NEG_INF / 2, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bgrqk,bgkd->bgrqd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, h, sq, hd).to(q.dtype)


def _default_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def forward(params, cfg: AttnConfig, x: torch.Tensor,
            positions: torch.Tensor | None = None,
            impl: str = "auto") -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill).

    On a CUDA tensor the online-softmax route is the flash-attention
    kernel, whose masks come from the default positions ``arange(s)``
    (what ``transformer.forward`` passes unless its caller gives
    positions); given other positions it is the plain ``_chunked_sdpa``,
    the reference's route there, which masks by the positions
    themselves."""
    b, s, d = x.shape
    given = positions
    if positions is None:
        positions = _default_positions(b, s, x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    if impl == "flash":
        out = ops.attention(q, k, v, causal=cfg.causal, window=cfg.window)
    elif impl == "chunked" or (impl == "auto" and s >= CHUNKED_THRESHOLD):
        if x.device.type == "cpu" or (given is not None and not torch.equal(
                given.to(torch.int64).expand(b, s),
                _default_positions(b, s, x.device).to(torch.int64))):
            out = _chunked_sdpa(q, k, v, cfg, positions, positions)
        else:
            out = ops.attention(q, k, v, causal=cfg.causal,
                                window=cfg.window)
    else:
        out = _sdpa(q, k, v, cfg, positions, positions)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Ring-buffered KV cache.  For full attention the buffer length is the
    max context; for sliding-window layers it is the window size."""

    k: torch.Tensor     # [B, G, L, D]
    v: torch.Tensor     # [B, G, L, D]


def init_cache(cfg: AttnConfig, batch: int, max_len: int,
               dtype=torch.float32, quant: bool = False, *,
               device) -> KVCache:
    if quant:
        raise NotImplementedError(
            "the int8 KV cache (kv_quant) is a later slice (ROADMAP A13)")
    length = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, cfg.n_kv_heads, length, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def decode_step(params, cfg: AttnConfig, x: torch.Tensor, cache: KVCache,
                pos) -> tuple[torch.Tensor, KVCache]:
    """One-token attention.  x: [B, 1, d], pos: [] or [B] current index.
    Writes the new key/value into ``cache`` in place and returns it."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
    q, k_new, v_new = _project_qkv(params, cfg, x, pos[:, None])
    length = cache.k.shape[2]
    slot = (pos % length).long()
    bidx = torch.arange(b, device=x.device)
    cache.k[bidx, :, slot] = k_new[:, :, 0].to(cache.k.dtype)
    cache.v[bidx, :, slot] = v_new[:, :, 0].to(cache.v.dtype)

    # absolute positions of cache slots (ring arithmetic)
    slots = torch.arange(length, device=x.device)[None, :]       # [1, L]
    wrap = torch.where(slots <= slot[:, None], 0, length)          # [B, L]
    k_pos = slots - wrap + (pos[:, None].long() // length) * length
    k_valid = (k_pos >= 0) & (k_pos <= pos[:, None])

    out = _sdpa(q, cache.k, cache.v, cfg, pos[:, None], k_pos,
                kv_valid=k_valid)
    out = out.transpose(1, 2).reshape(b, 1, -1)
    return out @ params["wo"].to(x.dtype), cache

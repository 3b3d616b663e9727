"""Grouped-query attention with qk-norm / sliding-window / KV-cache decode
(counterpart of ``repro.models.attention``).

``forward(impl=...)`` keeps the reference's routes:
  * ``'flash'``   — ``kernels.ops.attention`` (the flash-attention kernel
    on a CUDA tensor, its plain version on a CPU tensor);
  * ``'chunked'`` (and ``'auto'`` at ``s >= CHUNKED_THRESHOLD``) — the
    online-softmax attention: on a CUDA tensor with the default positions
    the same kernel where it takes the shape (causal, or non-causal with
    ``s`` a whole number of the kernel's blocks), otherwise the plain
    ``_chunked_sdpa``; under autograd (grad mode on and q, k or v
    requiring grad) always ``_chunked_sdpa``, the reference's training
    route, since the kernel has no backward;
  * otherwise (``'reference'``, ``'auto'`` below the threshold) — the
    materialised ``_sdpa`` in torch ops.
Decode attends over the cache with ``_sdpa``; cross-attention
(``cross_forward``, over K/V that ``encode_kv`` projects once) with the
non-causal ``_sdpa`` at every length, as the reference does.

``init_cache`` / ``decode_step`` keep a ring-buffered cache per layer,
in the compute dtype (``KVCache``) or int8 with a f32 scale per (token,
head) row (``QuantKVCache``, ``quant=True``); ``decode_step`` writes the
new key and value into it in place (the reference returns an updated
copy) and returns it.  The int8 cache is dequantized whole in the
compute dtype on every step, as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import flash_attention as fa
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


def kernel_route(cfg: AttnConfig, b: int, s: int, device: torch.device,
                 grad: bool, positions: torch.Tensor | None) -> bool:
    """Whether ``forward``'s online-softmax route launches the
    flash-attention kernel: not under autograd, not on a CPU tensor, at
    a length the kernel takes (``flash_attention.takes_length``), and at
    the default positions (none given, or ``arange(s)`` in every row);
    else the route is ``_chunked_sdpa``.  Decided from the shapes, never
    by catching the kernel's raise."""
    if grad or device.type == "cpu" or not fa.takes_length(s, cfg.causal):
        return False
    return positions is None or torch.equal(
        positions.to(torch.int64).expand(b, s),
        _default_positions(b, s, positions.device).to(torch.int64))


def forward(params, cfg: AttnConfig, x: torch.Tensor,
            positions: torch.Tensor | None = None,
            impl: str = "auto") -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill).

    On a CUDA tensor the online-softmax route is the flash-attention
    kernel, whose masks come from the default positions ``arange(s)``
    (what ``transformer.forward`` passes unless its caller gives
    positions); given other positions it is the plain ``_chunked_sdpa``,
    the reference's route there, which masks by the positions
    themselves.  A non-causal ``s`` that is not a whole number of the
    kernel's blocks takes ``_chunked_sdpa`` too (decided from the shape;
    the kernel is not launched).  Under autograd that route is always
    ``_chunked_sdpa`` (the kernel has no backward)."""
    b, s, d = x.shape
    given = positions
    if positions is None:
        positions = _default_positions(b, s, x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if impl == "flash":
        out = ops.attention(q, k, v, causal=cfg.causal, window=cfg.window)
    elif impl == "chunked" or (impl == "auto" and s >= CHUNKED_THRESHOLD):
        if kernel_route(cfg, b, s, x.device, grad, given):
            out = ops.attention(q, k, v, causal=cfg.causal,
                                window=cfg.window)
        else:
            out = _chunked_sdpa(q, k, v, cfg, positions, positions)
    else:
        out = _sdpa(q, k, v, cfg, positions, positions)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ params["wo"].to(x.dtype)


def cross_forward(params, cfg: AttnConfig, x: torch.Tensor,
                  kv: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Cross-attention against precomputed encoder K/V [B, G, Senc, D]:
    the non-causal ``_sdpa`` with every position 0 (no rope, no mask)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, h, hd).transpose(1, 2)
    k, v = kv
    senc = k.shape[2]
    pos_q = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    pos_k = torch.zeros((b, senc), dtype=torch.int32, device=x.device)
    nc_cfg = cfg._replace(causal=False, window=None)
    out = _sdpa(q, k, v, nc_cfg, pos_q, pos_k)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ params["wo"].to(x.dtype)


def encode_kv(params, cfg: AttnConfig, enc: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Project encoder states once into cross-attention K/V [B, G, S, D]."""
    b, s, _ = enc.shape
    g, hd = cfg.n_kv_heads, cfg.head_dim
    k = (enc @ params["wk"].to(enc.dtype)).reshape(b, s, g, hd)
    v = (enc @ params["wv"].to(enc.dtype)).reshape(b, s, g, hd)
    return k.transpose(1, 2), v.transpose(1, 2)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Ring-buffered KV cache.  For full attention the buffer length is the
    max context; for sliding-window layers it is the window size."""

    k: torch.Tensor     # [B, G, L, D]
    v: torch.Tensor     # [B, G, L, D]


class QuantKVCache(NamedTuple):
    """Int8 ring-buffered KV cache with symmetric per-(token, head)
    scales: half the bytes of a bf16 cache (plus 4 bytes a row)."""

    k_q: torch.Tensor   # int8 [B, G, L, D]
    v_q: torch.Tensor   # int8 [B, G, L, D]
    k_s: torch.Tensor   # f32  [B, G, L, 1]
    v_s: torch.Tensor   # f32  [B, G, L, 1]


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [..., D] -> (int8 values, f32 scale over the last dim).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.to(torch.float32)
    scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def init_cache(cfg: AttnConfig, batch: int, max_len: int,
               dtype=torch.float32, quant: bool = False, *,
               device) -> KVCache | QuantKVCache:
    length = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, cfg.n_kv_heads, length, cfg.head_dim)
    if quant:
        sshape = shape[:-1] + (1,)
        return QuantKVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.ones(sshape, dtype=torch.float32, device=device),
            torch.ones(sshape, dtype=torch.float32, device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def decode_step(params, cfg: AttnConfig, x: torch.Tensor,
                cache: KVCache | QuantKVCache, pos
                ) -> tuple[torch.Tensor, KVCache | QuantKVCache]:
    """One-token attention.  x: [B, 1, d], pos: [] or [B] current index.
    Writes the new key/value (int8 rows and their scales in a
    ``QuantKVCache``) into ``cache`` in place and returns it."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
    q, k_new, v_new = _project_qkv(params, cfg, x, pos[:, None])
    quant = isinstance(cache, QuantKVCache)
    length = (cache.k_q if quant else cache.k).shape[2]
    slot = (pos % length).long()
    bidx = torch.arange(b, device=x.device)
    if quant:
        for rows, vals, scales in ((k_new, cache.k_q, cache.k_s),
                                   (v_new, cache.v_q, cache.v_s)):
            qv, sc = _quantize_rows(rows[:, :, 0])
            vals[bidx, :, slot] = qv
            scales[bidx, :, slot] = sc
        k = cache.k_q.to(x.dtype) * cache.k_s.to(x.dtype)
        v = cache.v_q.to(x.dtype) * cache.v_s.to(x.dtype)
    else:
        cache.k[bidx, :, slot] = k_new[:, :, 0].to(cache.k.dtype)
        cache.v[bidx, :, slot] = v_new[:, :, 0].to(cache.v.dtype)
        k, v = cache.k, cache.v

    # absolute positions of cache slots (ring arithmetic)
    slots = torch.arange(length, device=x.device)[None, :]       # [1, L]
    wrap = torch.where(slots <= slot[:, None], 0, length)          # [B, L]
    k_pos = slots - wrap + (pos[:, None].long() // length) * length
    k_valid = (k_pos >= 0) & (k_pos <= pos[:, None])

    out = _sdpa(q, k, v, cfg, pos[:, None], k_pos, kv_valid=k_valid)
    out = out.transpose(1, 2).reshape(b, 1, -1)
    return out @ params["wo"].to(x.dtype), cache

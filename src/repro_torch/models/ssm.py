"""Mamba2-style selective state-space block, chunked SSD algorithm
(counterpart of ``repro.models.ssm``).

Recurrence per head h with a scalar decay (Mamba2's A is one scalar a
head):

    S_t = exp(A dt_t) S_{t-1} + dt_t * x_t B_t^T        S in R^{P x N}
    y_t = S_t C_t + D x_t

Train and prefill use the chunked state-space-dual form: within a chunk
of length Lc a masked, decay-weighted product; across chunks a scan over
the chunks' summary states.  The reference's ``associative_scan`` over
chunks is a loop over them here (the same states; the sums run in
another order, an ulp-level difference).  Decode keeps the [H, P, N]
state and applies one step of the recurrence.  Plain PyTorch: the
reference computes all of it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


class SSMConfig(NamedTuple):
    d_model: int
    d_inner: int              # H * P
    n_heads: int
    d_state: int              # N
    d_conv: int = 4
    chunk: int = 128

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` at every
    x (``torch.nn.functional.softplus`` returns x above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init(cfg: SSMConfig, dtype=torch.float32, *,
         generator: torch.Generator, device) -> dict:
    d, di, h, n = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_state
    kw = dict(generator=generator, device=device, dtype=dtype)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wx": L.dense_init(d, di, **kw),
        "wbc": L.dense_init(d, 2 * n, **kw),
        "wdt": L.dense_init(d, h, **kw),
        "wz": L.dense_init(d, di, **kw),
        "conv_w": L._normal((cfg.d_conv, di + 2 * n), 0.2, **kw),
        "a_log": torch.zeros((h,), **f32),           # A = -exp(a_log)
        "dt_bias": torch.full((h,), -2.0, **f32),    # softplus ~ 0.12
        "d_skip": torch.ones((h,), **f32),
        "out_norm": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": L.dense_init(di, d, **kw),
    }


def _project(params, cfg: SSMConfig, u: torch.Tensor):
    n = cfg.d_state
    x = u @ params["wx"].to(u.dtype)
    bc = u @ params["wbc"].to(u.dtype)
    dt = u @ params["wdt"].to(u.dtype)
    z = u @ params["wz"].to(u.dtype)
    return x, bc[..., :n], bc[..., n:], dt, z


def _ssd_chunked(cfg: SSMConfig, xh: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, la: torch.Tensor, dt: torch.Tensor,
                 s0: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan.  xh: [B,T,H,P], b/c: [B,T,N], la/dt: [B,T,H].

    Returns (y [B,T,H,P], final_state [B,H,P,N])."""
    bs, t, h, p = xh.shape
    n = b.shape[-1]
    lc = min(cfg.chunk, t)
    assert t % lc == 0, "sequence length must divide the SSD chunk"
    nc = t // lc

    xh = xh.reshape(bs, nc, lc, h, p)
    bc = b.reshape(bs, nc, lc, n)
    cc = c.reshape(bs, nc, lc, n)
    la = la.reshape(bs, nc, lc, h)
    dt = dt.reshape(bs, nc, lc, h)

    cum = torch.cumsum(la, dim=2)                           # [B,NC,LC,H]
    # intra-chunk: y[l] = sum_{l'<=l} exp(cum_l - cum_l') dt_l' (C_l.B_l')
    #                     * x_l'
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,NC,L,L,H]
    mask = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                 device=xh.device))
    gate = torch.where(mask[None, None, :, :, None], torch.exp(decay), 0.0)
    scores = torch.einsum("bcln,bcmn->bclm", cc, bc)         # [B,NC,L,L]
    w = scores[..., None] * gate * dt[:, :, None, :, :]      # [B,NC,L,L,H]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", w, xh)

    # chunk summary state: S_c = sum_l exp(cum_L - cum_l) dt_l x_l B_l^T
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dt           # [B,NC,L,H]
    s_chunk = torch.einsum("bclhp,bcln->bchpn", tail[..., None] * xh, bc)
    a_chunk = torch.exp(cum[:, :, -1, :])                    # [B,NC,H]

    # inter-chunk scan: S_c_out = a_c * S_{c-1} + S_c, from s0 (or 0);
    # s_prev[c] is the state entering chunk c
    state = (s0 if s0 is not None
             else torch.zeros_like(s_chunk[:, 0]))
    s_prev = []
    for ci in range(nc):
        s_prev.append(state)
        state = a_chunk[:, ci, :, None, None] * state + s_chunk[:, ci]
    s_prev = torch.stack(s_prev, dim=1)                      # [B,NC,H,P,N]

    y_inter = torch.einsum("bcln,bchpn->bclhp", cc, s_prev) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bs, t, h, p)
    return y, state


def forward(params, cfg: SSMConfig, u: torch.Tensor,
            state: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward.  u: [B, T, d_model]."""
    bs, t, _ = u.shape
    h, p, n = cfg.n_heads, cfg.head_dim, cfg.d_state
    x, b, c, dt_raw, z = _project(params, cfg, u)

    conv_in = torch.cat([x, b, c], dim=-1)
    conv_state = None if state is None else state["conv"]
    conv_out, new_conv = L.causal_conv1d(conv_in, params["conv_w"],
                                         conv_state)
    conv_out = F.silu(conv_out)
    x, b, c = torch.split(conv_out, [cfg.d_inner, n, n], dim=-1)

    dt = softplus(dt_raw.to(torch.float32) + params["dt_bias"])  # [B,T,H]
    a = -torch.exp(params["a_log"])                              # [H]
    la = dt * a                                                  # log decay
    xh = x.reshape(bs, t, h, p).to(torch.float32)

    s0 = None if state is None else state["ssm"]
    y, s_last = _ssd_chunked(cfg, xh, b.to(torch.float32),
                             c.to(torch.float32), la, dt, s0)
    y = y + params["d_skip"][None, None, :, None] * xh
    y = y.reshape(bs, t, cfg.d_inner).to(u.dtype)
    y = L.rms_norm(y * F.silu(z), params["out_norm"])
    out = y @ params["out_proj"].to(u.dtype)
    return out, {"conv": new_conv, "ssm": s_last}


def init_state(cfg: SSMConfig, batch: int, dtype=torch.float32, *,
               device) -> dict:
    conv_ch = cfg.d_inner + 2 * cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


def decode_step(params, cfg: SSMConfig, u: torch.Tensor, state: dict
                ) -> tuple[torch.Tensor, dict]:
    """One-token step.  u: [B, 1, d_model].  Returns the new state (the
    given one is not written)."""
    bs = u.shape[0]
    h, p, n = cfg.n_heads, cfg.head_dim, cfg.d_state
    x, b, c, dt_raw, z = _project(params, cfg, u)

    conv_in = torch.cat([x, b, c], dim=-1)
    conv_out, new_conv = L.causal_conv1d(conv_in, params["conv_w"],
                                         state["conv"])
    conv_out = F.silu(conv_out)
    x, b, c = torch.split(conv_out, [cfg.d_inner, n, n], dim=-1)

    dt = softplus(dt_raw.to(torch.float32)
                  + params["dt_bias"])[:, 0]                     # [B,H]
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt * a)                                    # [B,H]
    xh = x.reshape(bs, h, p).to(torch.float32)
    bv = b[:, 0].to(torch.float32)                               # [B,N]
    cv = c[:, 0].to(torch.float32)

    s_new = (decay[..., None, None] * state["ssm"]
             + dt[..., None, None] * xh[..., None] * bv[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", s_new, cv) \
        + params["d_skip"][None, :, None] * xh
    y = y.reshape(bs, 1, cfg.d_inner).to(u.dtype)
    y = L.rms_norm(y * F.silu(z), params["out_norm"])
    out = y @ params["out_proj"].to(u.dtype)
    return out, {"conv": new_conv, "ssm": s_new}

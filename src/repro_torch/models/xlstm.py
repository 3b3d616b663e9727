"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
(counterpart of ``repro.models.xlstm``).

Recurrent, attention-free token mixing (xlstm-350m).  Both cells use
exponential input gating with the xLSTM paper's max-stabilizer; a
sequence runs as a Python loop over time on tensors (the reference's
``lax.scan``), and decode carries the explicit recurrent state.

mLSTM (per head, head dim P):
    m_t = max(f~_t + m_{t-1}, i~_t)
    f'  = exp(f~_t + m_{t-1} - m_t),  i' = exp(i~_t - m_t)
    C_t = f' C_{t-1} + i' v_t k_t^T          C in R^{P x P}
    n_t = f' n_{t-1} + i' k_t
    h_t = o_t * (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

sLSTM (per unit, block-diagonal recurrence over heads):
    z = tanh(Wz x + Rz h_{t-1}),  gates i~, f~, o from x and h_{t-1}
    c_t = f' c_{t-1} + i' z,  n_t = f' n_{t-1} + i',  h_t = o * c_t / n_t

The cell states (and the mLSTM's conv state) are f32 whatever the
compute dtype; the conv state is cast to the compute dtype on use.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

NEG_INF = -1e30


class XLSTMConfig(NamedTuple):
    d_model: int
    n_heads: int
    proj_factor: float = 2.0
    d_conv: int = 4

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(cfg: XLSTMConfig, dtype=torch.float32, *,
               generator: torch.Generator, device) -> dict:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "w_up": L.dense_init(d, di, **kw),
        "w_gate": L.dense_init(d, di, **kw),
        "conv_w": L._normal((cfg.d_conv, di), 0.2, **kw),
        "wq": L.dense_init(di, di, **kw),
        "wk": L.dense_init(di, di, **kw),
        "wv": L.dense_init(di, di, **kw),
        "w_if": L.dense_init(di, 2 * h, **kw),
        "if_bias": torch.cat([
            torch.zeros((h,), dtype=torch.float32, device=device),
            torch.full((h,), 3.0, dtype=torch.float32, device=device)]),
        "out_norm": torch.ones((di,), dtype=dtype, device=device),
        "w_down": L.dense_init(di, d, **kw),
    }


def mlstm_state(cfg: XLSTMConfig, batch: int, *, device) -> dict:
    h, p = cfg.n_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, h, p, p), **f32),
        "n": torch.zeros((batch, h, p), **f32),
        "m": torch.full((batch, h), NEG_INF, **f32),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), **f32),
    }


def _mlstm_gates(params, cfg: XLSTMConfig, conv_out: torch.Tensor,
                 u: torch.Tensor):
    bsz, t, _ = conv_out.shape
    h, p = cfg.n_heads, cfg.head_dim
    q = (conv_out @ params["wq"].to(conv_out.dtype)
         ).reshape(bsz, t, h, p) * p ** -0.5
    k = (conv_out @ params["wk"].to(conv_out.dtype)
         ).reshape(bsz, t, h, p) * p ** -0.5
    v = (u @ params["wv"].to(u.dtype)).reshape(bsz, t, h, p)
    if_raw = (conv_out @ params["w_if"].to(conv_out.dtype)
              ).to(torch.float32) + params["if_bias"]
    i_t, f_raw = torch.chunk(if_raw, 2, dim=-1)             # [B,T,H]
    f_t = F.logsigmoid(f_raw)
    return (q.to(torch.float32), k.to(torch.float32),
            v.to(torch.float32), i_t, f_t)


def _mlstm_step(state: dict, qkvif) -> tuple[dict, torch.Tensor]:
    """One time step: state {c, n, m (, conv)}, q/k/v [B,H,P], i/f [B,H]
    -> (new state, h_t [B,H,P])."""
    q, k, v, i_t, f_t = qkvif
    fm = f_t + state["m"]
    m_new = torch.maximum(fm, i_t)
    fp = torch.exp(fm - m_new)[..., None]
    ip = torch.exp(i_t - m_new)[..., None]
    c = fp[..., None] * state["c"] + ip[..., None] * (
        v[..., :, None] * k[..., None, :])
    n = fp * state["n"] + ip * k
    denom = torch.maximum(torch.abs(torch.sum(n * q, -1)),
                          torch.exp(-m_new))
    h_t = (c @ q[..., None])[..., 0] / denom[..., None]     # C_t q_t
    return dict(state, c=c, n=n, m=m_new), h_t


def mlstm_forward(params, cfg: XLSTMConfig, x: torch.Tensor,
                  state: dict | None = None) -> tuple[torch.Tensor, dict]:
    """x: [B, T, d_model] -> (out [B, T, d_model], new state)."""
    bsz, t, _ = x.shape
    if state is None:
        state = mlstm_state(cfg, bsz, device=x.device)
    u = x @ params["w_up"].to(x.dtype)
    z = x @ params["w_gate"].to(x.dtype)
    conv_out, new_conv = L.causal_conv1d(u, params["conv_w"],
                                         state["conv"].to(u.dtype))
    conv_out = F.silu(conv_out)
    q, k, v, i_t, f_t = _mlstm_gates(params, cfg, conv_out, u)

    cell = {k2: state[k2] for k2 in ("c", "n", "m")}
    hs = []
    for s in range(t):
        cell, h_t = _mlstm_step(cell, (q[:, s], k[:, s], v[:, s],
                                       i_t[:, s], f_t[:, s]))
        hs.append(h_t)
    hs = torch.stack(hs, dim=1).reshape(bsz, t, cfg.d_inner)

    y = L.rms_norm(hs.to(x.dtype), params["out_norm"])
    y = y * F.silu(z)
    out = y @ params["w_down"].to(x.dtype)
    return out, dict(cell, conv=new_conv.to(torch.float32))


def mlstm_decode(params, cfg: XLSTMConfig, x: torch.Tensor, state: dict
                 ) -> tuple[torch.Tensor, dict]:
    return mlstm_forward(params, cfg, x, state)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(cfg: XLSTMConfig, dtype=torch.float32, *,
               generator: torch.Generator, device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    kw = dict(generator=generator, device=device, dtype=dtype)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w": L._normal((d, 4 * d), d ** -0.5, **kw),
        "r": L._normal((h, hd, 4 * hd), hd ** -0.5, **kw),  # block-diagonal
        "bias": torch.cat([torch.zeros((2 * d,), **f32),
                           torch.full((d,), 3.0, **f32),
                           torch.zeros((d,), **f32)]),
        "ffn": L.swiglu_mlp_init(d, int(d * 4 / 3), dtype,
                                 generator=generator, device=device),
        "ffn_norm": torch.ones((d,), dtype=dtype, device=device),
    }


def slstm_state(cfg: XLSTMConfig, batch: int, *, device) -> dict:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, d), **f32),
        "n": torch.zeros((batch, d), **f32),
        "m": torch.full((batch, d), NEG_INF, **f32),
        "h": torch.zeros((batch, d), **f32),
    }


def _slstm_step(params, cfg: XLSTMConfig, state: dict, x_t: torch.Tensor
                ) -> tuple[dict, torch.Tensor]:
    """x_t: [B, 4d] pre-projected input; the recurrent term is added
    here."""
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    b = x_t.shape[0]
    h_prev = state["h"].reshape(b, h, hd)
    rec = torch.einsum("bhi,hij->bhj", h_prev,
                       params["r"].to(torch.float32)).reshape(b, 4 * d)
    pre = (x_t.to(torch.float32) + rec + params["bias"]).reshape(b, 4, d)
    z = torch.tanh(pre[:, 0])
    i_t = pre[:, 1]
    f_t = F.logsigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    fm = f_t + state["m"]
    m_new = torch.maximum(fm, i_t)
    fp = torch.exp(fm - m_new)
    ip = torch.exp(i_t - m_new)
    c = fp * state["c"] + ip * z
    n = fp * state["n"] + ip
    h_new = o * c / torch.clamp_min(n, 1e-6)
    return dict(c=c, n=n, m=m_new, h=h_new), h_new


def slstm_forward(params, cfg: XLSTMConfig, x: torch.Tensor,
                  state: dict | None = None) -> tuple[torch.Tensor, dict]:
    bsz, t, d = x.shape
    if state is None:
        state = slstm_state(cfg, bsz, device=x.device)
    pre = x @ params["w"].to(x.dtype)                       # [B,T,4d]
    hs = []
    for s in range(t):
        state, h_t = _slstm_step(params, cfg, state, pre[:, s])
        hs.append(h_t)
    hs = torch.stack(hs, dim=1).to(x.dtype)
    out = hs + L.swiglu_mlp(params["ffn"],
                            L.rms_norm(hs, params["ffn_norm"]))
    return out, state


def slstm_decode(params, cfg: XLSTMConfig, x: torch.Tensor, state: dict
                 ) -> tuple[torch.Tensor, dict]:
    return slstm_forward(params, cfg, x, state)

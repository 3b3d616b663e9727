"""xLSTM stack: groups of (slstm_every - 1) mLSTM blocks + 1 sLSTM block
(counterpart of ``repro.models.xlstm_model``).

xlstm-350m: 24 blocks with an sLSTM every 8th (the xLSTM paper's 7:1);
the remainder (when depth % slstm_every != 0) is mLSTM only.  The
parameters keep the reference's grouping: ``m_groups[g][i]`` (the
reference's leaves stacked [n_groups, slstm_every - 1, ...]),
``s_blocks[g]`` and ``rem[i]``; the recurrent states the same.
"""

from __future__ import annotations

import torch

import repro_torch
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xl
from repro_torch.models.config import ModelConfig


def xl_config(cfg: ModelConfig) -> xl.XLSTMConfig:
    return xl.XLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads)


def _group_sizes(cfg: ModelConfig) -> tuple[int, int, int]:
    per = cfg.slstm_every
    n_groups = cfg.n_layers // per
    remainder = cfg.n_layers - n_groups * per
    return n_groups, per - 1, remainder


def init(cfg: ModelConfig, *, generator: torch.Generator | None = None,
         device=None, trainable: bool = False) -> L.ParamTree:
    """Random weights on ``device`` (default: the card), drawn by
    ``generator`` (default: seed 0 on ``device``); gate biases in f32,
    the rest in the config's parameter dtype; parameters that take a
    gradient when ``trainable``."""
    kw = tf.init_kwargs(generator, device)
    xcfg = xl_config(cfg)
    n_groups, m_per, remainder = _group_sizes(cfg)

    def init_m():
        return {"norm": tf._norm_init(cfg, kw["device"]),
                "cell": xl.mlstm_init(xcfg, cfg.pdt, **kw)}

    def init_s():
        return {"norm": tf._norm_init(cfg, kw["device"]),
                "cell": xl.slstm_init(xcfg, cfg.pdt, **kw)}

    tree = {
        "embed": L.embed_init(cfg.vocab, cfg.d_model, dtype=cfg.pdt, **kw),
        "m_groups": [[init_m() for _ in range(m_per)]
                     for _ in range(n_groups)],
        "s_blocks": [init_s() for _ in range(n_groups)],
        "final_norm": tf._norm_init(cfg, kw["device"]),
        "unembed": L.dense_init(cfg.d_model, cfg.vocab, dtype=cfg.pdt, **kw),
    }
    if remainder:
        tree["rem"] = [init_m() for _ in range(remainder)]
    return L.ParamTree(tree, trainable=trainable)


def _m_block(blk, cfg: ModelConfig, x: torch.Tensor, st: dict
             ) -> tuple[torch.Tensor, dict]:
    h = tf.apply_norm(cfg, blk["norm"], x)
    y, new_st = xl.mlstm_forward(blk["cell"], xl_config(cfg), h, st)
    return x + y, new_st


def _run(params, cfg: ModelConfig, tokens: torch.Tensor,
         states: dict | None, last_only: bool = False
         ) -> tuple[torch.Tensor, dict]:
    """The stack over ``tokens`` from ``states`` (fresh when None):
    (logits, new states).  When a gradient is needed and ``cfg.remat``
    is set, the grouped mLSTM blocks are recomputed in the backward pass
    (the reference's remat: not the sLSTM blocks, not the remainder)."""
    xcfg = xl_config(cfg)
    x = tf.embed_tokens(params, cfg, tokens)
    if states is None:
        states = init_state(cfg, x.shape[0], device=x.device)
    new = {"m": [], "s": []}
    for g, (group, sblk) in enumerate(zip(params["m_groups"],
                                          params["s_blocks"])):
        m_states = []
        for blk, st in zip(group, states["m"][g]):
            x, st = tf.remat(cfg, _m_block, blk, x, st)
            m_states.append(st)
        new["m"].append(m_states)
        h = tf.apply_norm(cfg, sblk["norm"], x)
        y, s_state = xl.slstm_forward(sblk["cell"], xcfg, h, states["s"][g])
        new["s"].append(s_state)
        x = x + y
    if _group_sizes(cfg)[2]:
        new["rem"] = []
        for blk, st in zip(params["rem"], states["rem"]):
            x, st = _m_block(blk, cfg, x, st)
            new["rem"].append(st)
    if last_only:
        x = x[:, -1:]
    logits = tf.apply_norm(cfg, params["final_norm"], x) \
        @ params["unembed"].to(cfg.cdt)
    return logits, new


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor | None = None,
            last_only: bool = False) -> torch.Tensor:
    """tokens: [B, S] int -> logits (positions are unused: a recurrent
    model)."""
    return _run(params, cfg, tokens, None, last_only)[0]


def init_state(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    """``m[g][i]``, ``s[g]`` and ``rem[i]``: each block's recurrent state
    (f32)."""
    device = repro_torch.resolve_device(device)
    xcfg = xl_config(cfg)
    n_groups, m_per, remainder = _group_sizes(cfg)
    st = {
        "m": [[xl.mlstm_state(xcfg, batch, device=device)
               for _ in range(m_per)] for _ in range(n_groups)],
        "s": [xl.slstm_state(xcfg, batch, device=device)
              for _ in range(n_groups)],
    }
    if remainder:
        st["rem"] = [xl.mlstm_state(xcfg, batch, device=device)
                     for _ in range(remainder)]
    return st


def decode(params, cfg: ModelConfig, token: torch.Tensor, states: dict,
           pos) -> tuple[torch.Tensor, dict]:
    """One recurrent step: token [B, 1] -> (logits [B, 1, V], new
    states); ``pos`` is unused (a stateful model)."""
    return _run(params, cfg, token, states)

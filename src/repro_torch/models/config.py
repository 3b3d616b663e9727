"""Unified model configuration for every assigned architecture
(counterpart of ``repro.models.config``): the same fields, defaults and
analytic parameter counts, with ``DTYPES`` naming torch dtypes."""

from __future__ import annotations

import dataclasses

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | xlstm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    rope_theta: float = 1e4
    qk_norm: bool = False
    window: int | None = None    # sliding-window attention
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    mlp: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid (zamba2): shared attention block every `attn_every` ssm blocks
    attn_every: int = 6
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # xlstm: every `slstm_every`-th block is sLSTM (0 = none)
    slstm_every: int = 8
    # encoder-decoder
    n_enc_layers: int = 0
    dec_train_len: int = 512     # decoder length used in train/prefill cells
    # frontend stub: 'tokens' consumes ids, 'frames' consumes embeddings
    frontend: str = "tokens"
    # numerics / memory
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "full"   # full | dots (save matmul outputs)
    kv_quant: bool = False       # int8 KV cache (decode memory lever)
    max_position: int = 1 << 20

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdt(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def cdt(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.family == "moe":
            ffn = self.n_experts * 3 * d * f + d * self.n_experts
        elif self.mlp == "swiglu":
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        if self.family == "xlstm":
            di = int(d * 2)
            per = 2 * d * di + 3 * di * di + di * d   # mLSTM block approx
            body = self.n_layers * per
        elif self.family == "hybrid":
            di = self.d_inner
            per = d * (2 * di + 2 * self.ssm_state + self.ssm_heads) \
                + di * d
            n_attn = -(-self.n_layers // self.attn_every)
            body = self.n_layers * per + n_attn * 0 + (attn + 3 * d * f)
        elif self.family == "encdec":
            body = self.n_enc_layers * (attn + ffn) \
                + self.n_layers * (2 * attn + ffn)
        else:
            body = self.n_layers * (attn + ffn)
        embed = v * d * (1 if self.tie_embeddings else 2)
        return body + embed

    def active_param_count(self) -> int:
        """N_active for MoE (routed experts actually used per token)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        expert_ffn = self.n_layers * self.n_experts * 3 * d * f
        active_ffn = self.n_layers * self.top_k * 3 * d * f
        return self.param_count() - expert_ffn + active_ffn

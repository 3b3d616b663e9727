"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64
[arXiv:2411.15242; unverified].  Shared transformer block applied every
6th backbone block (single shared parameter set — Zamba2's weight-sharing
trick; the released model alternates two shared blocks, simplification
noted in DESIGN.md).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_heads=56, ssm_expand=2, ssm_chunk=128,
    attn_every=6, rope_theta=1e4,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat=True,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128,
    ssm_state=8, ssm_heads=4, ssm_expand=2, ssm_chunk=8,
    attn_every=3,
)

"""kimi-k2-1t-a32b [moe]: trillion-parameter 384-expert top-8 MoE.

61L d_model=7168 64H (GQA kv=8) d_ff(expert)=2048 vocab=163840
[arXiv:2501.kimi2; unverified / paper-table].  The memory-bound cell of
the assignment: the sharding planner must pick FSDP + factored optimizer
states (Adafactor) to fit 512 chips (DESIGN.md S4).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, head_dim=112,
    n_experts=384, top_k=8, capacity_factor=1.25,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat=True,
)

SMOKE = ModelConfig(
    name="kimi-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=32, vocab=256, head_dim=8, n_experts=8, top_k=2,
)

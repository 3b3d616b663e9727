"""moonshot-v1-16b-a3b [moe]: Moonlight-style 64-expert top-6 MoE.

48L d_model=2048 16H (GQA kv=16) d_ff(expert)=1408 vocab=163840
[hf:moonshotai/Moonlight-16B-A3B; hf].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840,
    n_experts=64, top_k=6, capacity_factor=1.25,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat=True,
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=128, n_experts=8, top_k=2,
)

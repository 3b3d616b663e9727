"""qwen3-8b [dense]: GQA + per-head qk RMS-norm.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936
[hf:Qwen/Qwen3-8B; hf].  head_dim=128, rope_theta=1e6.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat=True,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=128, head_dim=16, qk_norm=True, rope_theta=1e6,
)

"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attn.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000
[arXiv:2401.16818; hf].  SWA window 4096 -> O(window) decode state,
so long_500k runs for this arch.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000, window=4096,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat=True,
)

SMOKE = ModelConfig(
    name="danube-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=128, window=16,
)

"""whisper-medium [audio]: enc-dec, conv frontend stubbed to frame embeds.

24L (per side) d_model=1024 16H (kv=16) d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=16, d_ff=4096, vocab=51865,
    norm="layernorm", mlp="gelu", frontend="frames", dec_train_len=448,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128, norm="layernorm", mlp="gelu",
    frontend="frames", dec_train_len=16,
)

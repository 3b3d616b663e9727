"""chameleon-34b [vlm]: early-fusion token backbone (VQ frontend stub).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
[arXiv:2405.09818; unverified].  Image tokens live in the same vocab
(early fusion); qk-norm + layernorm as in the release.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536, qk_norm=True, norm="layernorm",
    param_dtype="bfloat16", compute_dtype="bfloat16", remat=True,
)

SMOKE = ModelConfig(
    name="chameleon-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab=256, qk_norm=True, norm="layernorm",
)

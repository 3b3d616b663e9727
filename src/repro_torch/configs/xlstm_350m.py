"""xlstm-350m [ssm]: sLSTM + mLSTM blocks (attention-free).

24L d_model=1024 4H d_ff=0 vocab=50304 [arXiv:2405.04517; unverified].
7:1 mLSTM:sLSTM ratio (sLSTM every 8th block).  d_ff=0: mixing blocks
carry their own up/down projections.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="xlstm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, slstm_every=8,
    param_dtype="float32", compute_dtype="bfloat16", remat=True,
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="xlstm",
    n_layers=4, d_model=32, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=64, slstm_every=2,
)

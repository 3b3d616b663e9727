"""smollm-135m [dense]: small llama-arch, tied embeddings.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152, tie_embeddings=True,
    param_dtype="float32", compute_dtype="bfloat16", remat=True,
)

SMOKE = ModelConfig(
    name="smollm-smoke", family="dense",
    n_layers=3, d_model=48, n_heads=3, n_kv_heads=1,
    d_ff=96, vocab=128, tie_embeddings=True,
)

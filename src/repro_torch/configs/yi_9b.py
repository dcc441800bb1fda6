"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA.  [arXiv:2403.04652; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, head_dim=128,
    mlp="swiglu", rope_theta=10_000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="yi-9b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=96, vocab_size=512, head_dim=16,
    mlp="swiglu", tie_embeddings=False,
)

"""rwkv6-1.6b "Finch" [ssm] — 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536, data-dependent decay.  [arXiv:2404.05892; unverified]

Sub-quadratic: runs the long_500k decode shape (O(1) per-head state).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65536, head_dim=64, rwkv_head_dim=64,
    mlp="swiglu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16, rwkv_head_dim=16,
    mlp="swiglu", tie_embeddings=False,
)

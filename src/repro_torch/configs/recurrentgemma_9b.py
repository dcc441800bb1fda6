"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention, pattern (rec, rec, attn),
window 2048.  [arXiv:2402.19427; unverified]

Sub-quadratic: runs the long_500k decode shape (O(1) recurrent state +
2048-slot ring-buffer KV).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    mlp="geglu", rope_theta=10_000.0, tie_embeddings=True,
    block_pattern=("rec", "rec", "attn"), window=2048,
    lru_width=4096, conv_width=4,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=128, vocab_size=512, head_dim=16,
    mlp="geglu", tie_embeddings=True,
    block_pattern=("rec", "rec", "attn"), window=16,
    lru_width=64, conv_width=4,
)

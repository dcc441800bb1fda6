"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (MHA kv=16) expert
d_ff=1408, vocab=151936, 60 routed experts top-4 + shared expert
(d_ff=5632).  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Experts are padded 60 -> 64 so the expert dimension divides the 16-wide
``model`` mesh axis; pads are masked out of routing (moe.py).
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128,
    mlp="swiglu", rope_theta=1_000_000.0, tie_embeddings=False,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408,
                  shared_d_ff=5632, num_experts_padded=64),
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=64, vocab_size=512, head_dim=16,
    mlp="swiglu", tie_embeddings=False,
    moe=MoEConfig(num_experts=6, top_k=2, d_expert=48, shared_d_ff=96,
                  num_experts_padded=8),
)

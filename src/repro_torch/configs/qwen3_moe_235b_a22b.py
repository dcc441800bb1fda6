"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536, vocab=151936, MoE 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B family config; hf]"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    mlp="swiglu", rope_theta=1_000_000.0, tie_embeddings=False,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536),
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=64, vocab_size=512, head_dim=16,
    mlp="swiglu", tie_embeddings=False,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=64),
)

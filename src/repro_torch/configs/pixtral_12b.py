"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

Backbone only, per the assignment: the vision tower is a STUB —
``input_specs()`` supplies 1024 pre-computed patch embeddings (B, 1024, d)
prepended to the token sequence.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    mlp="swiglu", rope_theta=1_000_000.0, tie_embeddings=False,
    num_prefix_embeds=1024,
)

SMOKE = ModelConfig(
    name="pixtral-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    mlp="swiglu", tie_embeddings=False,
    num_prefix_embeds=8,
)

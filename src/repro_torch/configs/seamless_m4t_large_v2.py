"""seamless-m4t-large-v2 [audio] — enc-dec, 24L+24L d_model=1024 16H
(MHA kv=16) d_ff=8192 vocab=256206.  [arXiv:2308.11596; hf]

Backbone only: the speech frontend is a STUB — ``input_specs()`` supplies
pre-computed frame embeddings (B, Se, d).  Decode shapes decode the text
decoder (self-attn KV cache of seq_len) with a 4096-frame cross-attention
cache (speech encoders emit ~6 frames/s; 4096 frames covers the inputs).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64,
    mlp="swiglu", rope_theta=10_000.0, tie_embeddings=True,
    encoder_layers=24, encoder_seq_len=4096,
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    mlp="swiglu", tie_embeddings=True,
    encoder_layers=2, encoder_seq_len=32,
)

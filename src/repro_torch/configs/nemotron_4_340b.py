"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU (non-gated).  [arXiv:2402.16819; unverified]

Memory note (DESIGN.md §5): at 340B params the AdamW m/v moments are kept
in bf16 (the paper's two-precision discipline applied to optimizer state)
so master+moments fit the 16 GB/chip HBM budget on a single pod.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000, head_dim=192,
    mlp="squared_relu", rope_theta=10_000.0, tie_embeddings=False,
    opt_state_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="nemotron-4-340b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=8,
    mlp="squared_relu", tie_embeddings=False,
    opt_state_dtype="bfloat16",
)

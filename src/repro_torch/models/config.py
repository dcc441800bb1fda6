"""Model configuration for the assigned architecture pool (the port's copy
of the JAX package's ``models/config.py``, hyperparameters only).

One frozen dataclass covers all six families (dense / moe / hybrid / ssm /
vlm / audio); family-specific fields default to None/0 and are validated in
``__post_init__``.  Exact per-arch instantiations live in
``repro_torch/configs/<arch>.py``.  The sharding and memory knobs are kept
so a configuration reads the same in both packages; on one device only
``moe_dispatch_shard`` changes what is computed (the MoE capacity groups).
``ShapeConfig``/``SHAPES`` are the dry-run's input-shape cells
(``launch/dryrun.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN width
    shared_d_ff: int = 0           # always-on shared expert width (qwen2-moe)
    capacity_factor: float = 1.25
    # experts padded up so they divide the model axis (e.g. 60 -> 64)
    num_experts_padded: int = 0

    @property
    def padded(self) -> int:
        return self.num_experts_padded or self.num_experts


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    mlp: str = "swiglu"            # swiglu | geglu | squared_relu
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    moe: MoEConfig | None = None

    # hybrid (recurrentgemma): block pattern repeated over depth
    block_pattern: tuple[str, ...] = ("attn",)   # e.g. ("rec","rec","attn")
    window: int = 0                # sliding-window size for local attention
    lru_width: int = 0             # RG-LRU width (0 -> d_model)
    conv_width: int = 4            # causal conv in the recurrent block

    # ssm (rwkv6)
    rwkv_head_dim: int = 64

    # vlm: number of prefix (patch) embeddings supplied by the stub frontend
    num_prefix_embeds: int = 0

    # audio / enc-dec
    encoder_layers: int = 0        # >0 -> encoder-decoder
    encoder_seq_len: int = 0       # max encoder length (frames), decode-time

    # training-memory knobs (per-arch overrides, see DESIGN.md)
    opt_state_dtype: str = "float32"   # AdamW m/v dtype ("bfloat16" for 340B)
    remat: bool = True
    # Megatron-SP-style sequence sharding of residual activations over the
    # `model` axis (see EXPERIMENTS.md §Perf for the before/after)
    seq_shard: bool = True
    # shard decode KV caches over `model` along the SEQUENCE dim when the
    # kv-head count cannot cover the TP axis (EXPERIMENTS.md §Perf H2)
    kv_seq_shard: bool = True
    # shard MoE dispatch buffers' capacity dim over `data` (§Perf H4)
    moe_dispatch_shard: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "hybrid" and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        if self.family == "moe":
            assert self.moe is not None
        if self.family == "audio":
            assert self.encoder_layers > 0
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so embeddings shard over the TP axis
        (only seamless's 256206 is affected; pad logits are masked)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def sub_quadratic(self) -> bool:
        """True when long-context decode is supported (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Approximate parameter count (used for 6·N·D roofline terms)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        n = 0
        per_layer = {}
        attn = d * self.attn_dim + 2 * d * self.num_kv_heads * self.head_dim \
            + self.attn_dim * d
        gated = self.mlp in ("swiglu", "geglu")
        mlp = (3 if gated else 2) * d * ff
        for kind in self._layer_kinds():
            if kind == "attn":
                n += attn + mlp
            elif kind == "moe":
                m = self.moe
                e_mlp = m.num_experts * 3 * d * m.d_expert + d * m.num_experts
                if m.shared_d_ff:
                    e_mlp += 3 * d * m.shared_d_ff + d
                n += attn + e_mlp
            elif kind == "rec":
                w = self.lru_width
                rec = 2 * d * w + w * d + self.conv_width * w + 3 * w
                n += rec + mlp
            elif kind == "rwkv":
                # time-mix (5 proj + decay lora) + channel-mix
                n += 5 * d * d + 2 * d * ff
        n += v * d * (1 if self.tie_embeddings else 2)
        if self.is_encdec:
            # encoder self-attn+mlp, decoder cross-attn already in layers?
            n += self.encoder_layers * (attn + mlp)
            n += self.num_layers * attn  # decoder cross-attention
        return n

    def active_param_count(self) -> int:
        """Params touched per token (= param_count for non-MoE)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        m = self.moe
        attn = d * self.attn_dim + 2 * d * self.num_kv_heads * self.head_dim \
            + self.attn_dim * d
        act = m.top_k * 3 * d * m.d_expert + d * m.num_experts
        if m.shared_d_ff:
            act += 3 * d * m.shared_d_ff
        n = self.num_layers * (attn + act)
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return n

    def _layer_kinds(self) -> list[str]:
        """Expanded per-layer block kinds for the decoder stack."""
        if self.family == "moe":
            return ["moe"] * self.num_layers
        if self.family == "ssm":
            return ["rwkv"] * self.num_layers
        if self.family == "hybrid":
            pat = self.block_pattern
            return [pat[i % len(pat)] for i in range(self.num_layers)]
        return ["attn"] * self.num_layers


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets traced in the dry-run."""
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

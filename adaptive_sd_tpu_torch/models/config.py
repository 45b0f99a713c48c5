"""Model architecture specs for the cascade tiers (a copy of
``adaptive_sd_tpu/models/config.py``: the hierarchy 7B→14B→32B→72B).
Architecture constants follow the public Qwen2.5 configs; tiny specs exist
for CPU tests."""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelSpec:
    """Static architecture description (shapes only — no weights)."""

    name: str
    vocab_size: int
    hidden: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn: int
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    max_seq_len: int = 4096
    tie_embeddings: bool = False
    attn_bias: bool = True  # Qwen2 uses QKV biases

    def __post_init__(self) -> None:
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"{self.name}: n_heads {self.n_heads} not divisible by n_kv_heads {self.n_kv_heads}"
            )

    @property
    def q_group(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def approx_params(self) -> int:
        """Parameter count estimate (embeds + blocks)."""
        embed = self.vocab_size * self.hidden * (1 if self.tie_embeddings else 2)
        per_layer = (
            self.hidden * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim  # qkv
            + self.n_heads * self.head_dim * self.hidden                        # o
            + 3 * self.hidden * self.ffn                                        # gate/up/down
        )
        return embed + self.n_layers * per_layer

    def weight_bytes(self, bits: int = 8) -> int:
        """Approximate on-device weight footprint at the given bit-width
        (embeddings stay bf16)."""
        embed = self.vocab_size * self.hidden * 2 * (1 if self.tie_embeddings else 2)
        rest = self.approx_params - self.vocab_size * self.hidden * (
            1 if self.tie_embeddings else 2
        )
        return embed + rest * bits // 8


# Qwen2.5 family (public configs). head_dim 128 throughout.
QWEN25_05B = ModelSpec("qwen2.5-0.5b", 151936, 896, 24, 14, 2, 64, 4864, tie_embeddings=True)
QWEN25_15B = ModelSpec("qwen2.5-1.5b", 151936, 1536, 28, 12, 2, 128, 8960, tie_embeddings=True)
QWEN25_3B = ModelSpec("qwen2.5-3b", 151936, 2048, 36, 16, 2, 128, 11008, tie_embeddings=True)
QWEN25_7B = ModelSpec("qwen2.5-7b", 152064, 3584, 28, 28, 4, 128, 18944)
QWEN25_14B = ModelSpec("qwen2.5-14b", 152064, 5120, 48, 40, 8, 128, 13824)
QWEN25_32B = ModelSpec("qwen2.5-32b", 152064, 5120, 64, 40, 8, 128, 27648)
QWEN25_72B = ModelSpec("qwen2.5-72b", 152064, 8192, 80, 64, 8, 128, 29568)

# Tiny specs for tests: "tiny" exercises the plain paths on the CPU;
# "tiny128" has head_dim 128, the width of the real models' heads.
TINY = ModelSpec("tiny", 256, 64, 2, 4, 2, 16, 128, max_seq_len=128, rope_theta=10_000.0)
TINY128 = ModelSpec("tiny128", 512, 256, 2, 4, 2, 128, 512, max_seq_len=512, rope_theta=10_000.0)

REGISTRY: dict[str, ModelSpec] = {
    s.name: s
    for s in (
        QWEN25_05B,
        QWEN25_15B,
        QWEN25_3B,
        QWEN25_7B,
        QWEN25_14B,
        QWEN25_32B,
        QWEN25_72B,
        TINY,
        TINY128,
    )
}


def get_spec(name: str) -> ModelSpec:
    try:
        return REGISTRY[name]
    except KeyError as exc:
        raise KeyError(f"unknown model spec {name!r}; known: {sorted(REGISTRY)}") from exc


def scaled_spec(base: ModelSpec, *, layers: int | None = None, name: str | None = None) -> ModelSpec:
    """Derive a reduced-depth variant: fewer layers, the same per-layer
    shapes (widths are never cut)."""
    return replace(
        base,
        n_layers=layers if layers is not None else base.n_layers,
        name=name or f"{base.name}-l{layers}",
    )


# The default cascade hierarchy (reference configs/qwen3_models.yaml).
DEFAULT_CASCADE = ("qwen2.5-7b", "qwen2.5-14b", "qwen2.5-32b", "qwen2.5-72b")

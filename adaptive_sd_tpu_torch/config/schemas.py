"""Concrete config trees: model/stage, serving, training, system.

Role parity: reference ``src/config/{model,serving,training,system}_config.py``
(StageConfig/ModelConfig with placement validation; OptimizationConfig/
QualityConfig/ServerConfig/CacheConfig/ServingConfig; TrainingConfig tree;
LoggingConfig/SecurityConfig/MonitoringConfig/SystemConfig). GPU ids become
TPU device ids; tensor_parallel_size becomes (dp, tp) mesh shape.

Own copy for the PyTorch port of ``adaptive_sd_tpu/config/schemas.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from ..core.exceptions import ConfigurationError
from .base import BaseConfig


# --------------------------------------------------------------------- model
@dataclass
class StageConfig(BaseConfig):
    """One cascade tier (reference model_config.py:12-55)."""

    name: str = ""
    spec: str = "qwen2.5-7b"           # models.config registry key
    weights_path: str = ""             # HF safetensors dir ("" => random init)
    bits: int = 8                      # weight quantization: 4, 8, 16
    dp: int = 1
    tp: int = 1
    device_ids: tuple[int, ...] = ()
    cost_per_token: float = 1.0        # calibrated by the cost profiler
    page_size: int = 128
    n_pages: int = 512
    max_batch: int = 64
    quality_range: tuple[float, float] = (0.0, 1.0)
    prefix_cache: bool = True          # content-addressed KV prefix reuse

    def validate(self) -> None:
        if self.bits not in (4, 8, 16):
            raise ConfigurationError(f"stage {self.name}: bits must be 4/8/16")
        if self.dp < 1 or self.tp < 1:
            raise ConfigurationError(f"stage {self.name}: dp/tp must be >= 1")
        if self.device_ids and len(self.device_ids) != self.dp * self.tp:
            raise ConfigurationError(
                f"stage {self.name}: {len(self.device_ids)} device_ids != dp*tp={self.dp * self.tp}"
            )
        if self.cost_per_token <= 0:
            raise ConfigurationError(f"stage {self.name}: cost_per_token must be > 0")
        if self.page_size % 128:
            raise ConfigurationError(f"stage {self.name}: page_size must be a multiple of 128")


@dataclass
class CascadeConfig(BaseConfig):
    """The tier hierarchy (reference ModelConfig, model_config.py:119-150)."""

    stages: list[StageConfig] = field(default_factory=list)

    def validate(self) -> None:
        names = [s.name for s in self.stages]
        if len(names) != len(set(names)):
            raise ConfigurationError(f"duplicate stage names: {names}")
        used: set[int] = set()
        for s in self.stages:
            s.validate()
            overlap = used & set(s.device_ids)
            if overlap:
                raise ConfigurationError(
                    f"stage {s.name}: device_ids {sorted(overlap)} already assigned"
                )
            used |= set(s.device_ids)
        costs = [s.cost_per_token for s in self.stages]
        if costs != sorted(costs):
            raise ConfigurationError("stage costs must be non-decreasing along the cascade")


# ------------------------------------------------------------------- serving
class OptimizationStrategyKind(str, Enum):
    DP = "dp"
    THRESHOLD = "threshold"
    UCB = "ucb"


class EvictionPolicy(str, Enum):
    LRU = "lru"
    FIFO = "fifo"
    LFU = "lfu"


@dataclass
class OptimizationConfig(BaseConfig):
    """reference serving_config.py:26-79."""

    strategy: str = "dp"
    lambda_value: float = 1.0
    risk_alpha: float = 1.0
    risk_beta: float = 1.0
    enable_dynamic_cost: bool = True
    reoptimize_interval_s: float = 30.0
    target_latency_s: float = 0.2
    max_error_rate: float = 0.01
    min_quality: float = 0.85
    quality_critical_patterns: tuple[str, ...] = (
        r"\bmedical\b", r"\blegal\b", r"\bsafety\b",
    )
    # Online dual-ascent lambda controller (cost_optimizer.
    # QualityGateController): adapt lambda per request until mean observed
    # quality sits ON quality_gate_target — spends aggregate quality slack
    # the way the gate-constrained oracle does, with no offline sweep.
    # 0 disables. quality_gate_lr is the dual step size in log-lambda.
    quality_gate_target: float = 0.0
    quality_gate_lr: float = 0.03

    def validate(self) -> None:
        if not 0.01 <= self.lambda_value <= 100:
            raise ConfigurationError("lambda_value must be in [0.01, 100]")
        if self.strategy not in [k.value for k in OptimizationStrategyKind]:
            raise ConfigurationError(f"unknown strategy {self.strategy}")
        if not 0.0 <= self.quality_gate_target <= 1.0:
            raise ConfigurationError(
                "quality_gate_target must be in [0, 1] (0 disables)"
            )


@dataclass
class QualityConfig(BaseConfig):
    """Metric weights summing to 1 (reference serving_config.py:92-118)."""

    bleu_weight: float = 0.3
    rouge_weight: float = 0.3
    task_weight: float = 0.4
    quality_threshold: float = 0.7

    def validate(self) -> None:
        total = self.bleu_weight + self.rouge_weight + self.task_weight
        if abs(total - 1.0) > 1e-6:
            raise ConfigurationError(f"quality weights must sum to 1, got {total}")


@dataclass
class CacheConfig(BaseConfig):
    """reference serving_config.py CacheConfig."""

    enable: bool = True
    max_bytes: int = 1 << 30
    ttl_s: float = 1800.0
    cleanup_interval_s: float = 300.0
    eviction: str = "lru"

    def validate(self) -> None:
        if self.eviction not in [e.value for e in EvictionPolicy]:
            raise ConfigurationError(f"unknown eviction policy {self.eviction}")


@dataclass
class ServerConfig(BaseConfig):
    """reference serving_config.py ServerConfig."""

    host: str = "0.0.0.0"
    port: int = 8000
    max_concurrent: int = 100
    request_timeout_s: float = 120.0
    max_prompt_len: int = 32768
    max_new_tokens: int = 1024
    cors_origins: tuple[str, ...] = ("*",)
    # Continuous-batching execution plane (cascade/scheduled.py): per-tier
    # lane schedulers with draft (verify) admissions for escalations. Needs
    # engine-backed stages.
    scheduled_batching: bool = False
    max_batch_lanes: int = 8
    max_context: int = 2048
    decode_scan_steps: int = 8  # fused decode steps per dispatch when idle
    # Page-pressure preemption flavour (engine/scheduler.py): "recompute"
    # re-prefills [prompt+generated] at resume; "swap" host-offloads the
    # victim's KV pages and restores them bit-exactly (recompute fallback
    # past the host budget).
    preemption_mode: str = "recompute"
    max_swap_mb: int = 256
    # Host-spill budget (MiB) for evicted prefix-cache pages (CPU KV
    # offload); 0 disables (the default — host spill and its warmup
    # compiles are OPT-IN; configs/serving.yaml enables 64 MiB). Consumed
    # by the stage builders in scripts/serve.py (TierEngine
    # prefix_spill_bytes = this << 20).
    prefix_spill_mb: int = 0

    def validate(self) -> None:
        if not 1 <= self.port <= 65535:
            raise ConfigurationError(f"bad port {self.port}")
        if self.preemption_mode not in ("recompute", "swap"):
            raise ConfigurationError(
                f"unknown preemption_mode {self.preemption_mode}"
            )


@dataclass
class ServingConfig(BaseConfig):
    """Top-level serving tree (reference serving_config.py:187-224)."""

    server: ServerConfig = field(default_factory=ServerConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    quality: QualityConfig = field(default_factory=QualityConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    cascade: CascadeConfig = field(default_factory=CascadeConfig)

    def validate(self) -> None:
        for sub in (self.server, self.optimization, self.quality, self.cache, self.cascade):
            sub.validate()


# ------------------------------------------------------------------ training
@dataclass
class DataGenerationConfig(BaseConfig):
    """reference training_config.py DataGenerationConfig."""

    n_prompts: int = 10000
    max_new_tokens: int = 128
    quality_threshold: float = 0.7
    datasets: tuple[str, ...] = ("mmlu", "gsm8k", "humaneval")
    output_path: str = "data/training_data.json"


@dataclass
class PredictorTrainingConfig(BaseConfig):
    """reference training_config.py PredictorTrainingConfig."""

    predictor: str = "mlp"             # mlp | ensemble
    feature_dim: int = 64
    hidden: tuple[int, ...] = (128, 64)
    epochs: int = 100
    batch_size: int = 256
    lr: float = 1e-3
    weight_decay: float = 1e-4
    k_fold: int = 5
    patience: int = 10
    checkpoint_path: str = "checkpoints/predictor.npz"

    def validate(self) -> None:
        if self.predictor not in ("mlp", "ensemble"):
            raise ConfigurationError(f"unknown predictor {self.predictor}")


@dataclass
class TrainingConfig(BaseConfig):
    data: DataGenerationConfig = field(default_factory=DataGenerationConfig)
    predictor: PredictorTrainingConfig = field(default_factory=PredictorTrainingConfig)

    def validate(self) -> None:
        self.data.validate()
        self.predictor.validate()


# -------------------------------------------------------------------- system
@dataclass
class LoggingConfig(BaseConfig):
    level: str = "INFO"
    structured: bool = False
    log_file: str = ""


@dataclass
class SecurityConfig(BaseConfig):
    """reference system_config.py SecurityConfig."""

    api_key: str = ""
    rate_limit_rps: float = 0.0        # 0 = unlimited
    rate_limit_burst: int = 10
    sanitize_inputs: bool = True


@dataclass
class MonitoringConfig(BaseConfig):
    """reference system_config.py MonitoringConfig."""

    enable_metrics: bool = True
    prometheus_port: int = 9090
    trace_sample_rate: float = 0.0


@dataclass
class SystemConfig(BaseConfig):
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    security: SecurityConfig = field(default_factory=SecurityConfig)
    monitoring: MonitoringConfig = field(default_factory=MonitoringConfig)
    environment: str = "development"

    def validate(self) -> None:
        if self.environment not in ("development", "staging", "production"):
            raise ConfigurationError(f"unknown environment {self.environment}")

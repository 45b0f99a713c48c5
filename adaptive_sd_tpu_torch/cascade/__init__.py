"""The cascade: text stages, the response cache, the serving pipeline, its
controllers (lambda, costs) and the replica router."""

from .cache_manager import CacheEntry, CascadeCacheManager
from .calibration import CALIBRATION_PROMPTS, calibrate_costs
from .cost_optimizer import (
    DynamicCostOptimizer,
    LoadPredictor,
    OptimizerTargets,
    PerformanceMonitor,
    QualityGateController,
)
from .pipeline import AdaptiveCascadePipeline, PipelineConfig
from .router import ReplicaRouter, build_replica_set
from .scheduled import ScheduledCascadePipeline
from .stages import EngineTextStage, MockStage, StageManager, TextStage

__all__ = [name for name in dir() if not name.startswith("_")]

"""The cascade: text stages, the response cache and the serving pipeline."""

from .cache_manager import CacheEntry, CascadeCacheManager
from .pipeline import AdaptiveCascadePipeline, PipelineConfig
from .scheduled import ScheduledCascadePipeline
from .stages import EngineTextStage, MockStage, StageManager, TextStage

__all__ = [name for name in dir() if not name.startswith("_")]

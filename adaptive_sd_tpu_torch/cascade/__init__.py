"""Text stages over the port's tier engines."""

from .stages import EngineTextStage, StageManager, TextStage

__all__ = ["EngineTextStage", "StageManager", "TextStage"]

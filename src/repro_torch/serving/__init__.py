"""Serving: the continuous-batching engine over the paged cache."""
from .config import EngineConfig, EngineConfigError  # noqa: F401
from .engine import GenerationEngine, Request  # noqa: F401

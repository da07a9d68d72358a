"""Public serving API: the reference's ``__all__``, name for name.

The continuous-batching engine over the paged cache, its typed
configuration, the async front end and router over engine replicas, and
the telemetry objects.  Everything else in this package is internal.
"""
from .config import EngineConfig, EngineConfigError  # noqa: F401
from .engine import GenerationEngine, Request  # noqa: F401
from .async_engine import (AsyncServingFrontend, FrontendClosed,  # noqa: F401
                           FrontendOverloaded, TokenStream)
from .router import Router  # noqa: F401
from .telemetry import MetricsRegistry, Telemetry  # noqa: F401
from .sampler import filter_logits, greedy, residual_probs, sample_logits  # noqa: F401
from .scheduler import Preempted, Scheduler  # noqa: F401
from . import spec  # noqa: F401

__all__ = [
    "EngineConfig",
    "EngineConfigError",
    "GenerationEngine",
    "Request",
    "AsyncServingFrontend",
    "TokenStream",
    "FrontendOverloaded",
    "FrontendClosed",
    "Router",
    "Telemetry",
    "MetricsRegistry",
]

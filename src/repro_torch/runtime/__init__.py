"""Runtime: the serving engine's span tracer and profiler hook
(``tracing``), its Chrome-trace export (``trace_export``), its step and
KV-cache monitors (``monitor``), the train / prefill / decode steps
(``steps``), the sharding rules (``sharding``) and the mesh's collectives
(``collectives``).  The package re-exports the reference's names; the
step factories load with ``steps`` on first use, since ``steps`` imports
the model and the optimizer, which import this package's collectives."""
from .sharding import (  # noqa: F401
    batch_axes, cache_pspecs, opt_pspecs, param_pspecs, ShardingRules,
)

_STEPS = ("make_decode_step", "make_prefill_step", "make_train_step")


def __getattr__(name):
    if name in _STEPS:
        from . import steps
        return getattr(steps, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

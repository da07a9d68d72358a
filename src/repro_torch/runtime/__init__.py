"""Runtime: the serving engine's span tracer and profiler hook
(``tracing``), its Chrome-trace export (``trace_export``), its step and
KV-cache monitors (``monitor``), the train step (``steps``), the sharding
rules (``sharding``) and the mesh's collectives (``collectives``)."""

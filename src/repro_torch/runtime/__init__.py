"""Runtime: the serving engine's span tracer and profiler hook
(``tracing``), its Chrome-trace export (``trace_export``) and its step and
KV-cache monitors (``monitor``)."""

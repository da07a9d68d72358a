"""--arch nemotron-4-15b (see registry.py for the full cited config)."""
from .registry import nemotron_4_15b as _cfg
from .base import smoke_variant

CONFIG = _cfg
SMOKE = smoke_variant(_cfg)

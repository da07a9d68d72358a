"""--arch llama4-scout-17b-a16e (see registry.py for the full cited config)."""
from .registry import llama4_scout_17b as _cfg
from .base import smoke_variant

CONFIG = _cfg
SMOKE = smoke_variant(_cfg)

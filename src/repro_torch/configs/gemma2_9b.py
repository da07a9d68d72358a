"""--arch gemma2-9b (see registry.py for the full cited config)."""
from .registry import gemma2_9b as _cfg
from .base import smoke_variant

CONFIG = _cfg
SMOKE = smoke_variant(_cfg)

"""--arch granite-20b (see registry.py for the full cited config)."""
from .registry import granite_20b as _cfg
from .base import smoke_variant

CONFIG = _cfg
SMOKE = smoke_variant(_cfg)

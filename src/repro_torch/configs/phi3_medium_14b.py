"""--arch phi3-medium-14b (see registry.py for the full cited config)."""
from .registry import phi3_medium_14b as _cfg
from .base import smoke_variant

CONFIG = _cfg
SMOKE = smoke_variant(_cfg)

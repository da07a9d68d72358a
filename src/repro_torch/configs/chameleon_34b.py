"""--arch chameleon-34b (see registry.py for the full cited config)."""
from .registry import chameleon_34b as _cfg
from .base import smoke_variant

CONFIG = _cfg
SMOKE = smoke_variant(_cfg)

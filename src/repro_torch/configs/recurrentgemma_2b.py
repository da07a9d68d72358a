"""--arch recurrentgemma-2b (see registry.py for the full cited config)."""
from .registry import recurrentgemma_2b as _cfg
from .base import smoke_variant

CONFIG = _cfg
SMOKE = smoke_variant(_cfg)

"""--arch moonshot-v1-16b-a3b (see registry.py for the full cited config)."""
from .registry import moonshot_v1_16b as _cfg
from .base import smoke_variant

CONFIG = _cfg
SMOKE = smoke_variant(_cfg)

"""--arch qwen3-8b (see registry.py for the full cited config)."""
from .registry import qwen3_8b as _cfg
from .base import smoke_variant

CONFIG = _cfg
SMOKE = smoke_variant(_cfg)

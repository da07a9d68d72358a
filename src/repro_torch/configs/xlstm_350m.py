"""--arch xlstm-350m (see registry.py for the full cited config)."""
from .registry import xlstm_350m as _cfg
from .base import smoke_variant

CONFIG = _cfg
SMOKE = smoke_variant(_cfg)

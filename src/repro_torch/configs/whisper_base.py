"""--arch whisper-base (see registry.py for the full cited config)."""
from .registry import whisper_base as _cfg
from .base import smoke_variant

CONFIG = _cfg
SMOKE = smoke_variant(_cfg)

"""Architecture configs: the reference's registry, copied."""
from .base import ArchConfig, smoke_variant  # noqa: F401
from .registry import ASSIGNED, get, names  # noqa: F401

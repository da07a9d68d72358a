"""The reference's synthetic token pipeline (``pipeline``)."""
from .pipeline import DataConfig, SyntheticLMData  # noqa: F401

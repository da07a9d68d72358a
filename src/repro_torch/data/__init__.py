"""The reference's synthetic token pipeline (``pipeline``)."""
from .pipeline import DataConfig, SyntheticLMData, make_global_array  # noqa: F401

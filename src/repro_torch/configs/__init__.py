"""Architecture configs: the reference's registry and workload shapes,
copied (10 assigned archs + the paper's eval arch)."""
from .base import SHAPES, ArchConfig, ShapeConfig, shape_applicable, smoke_variant  # noqa: F401
from .registry import ASSIGNED, get, names  # noqa: F401

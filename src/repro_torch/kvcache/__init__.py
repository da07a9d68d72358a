"""Paged KV cache (hot pool only; the cold pool and swap tier come later)."""
from .paged import GARBAGE_PAGE, OutOfPages, PagedKVCache  # noqa: F401

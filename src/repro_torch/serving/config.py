"""Typed engine configuration: the reference's ``EngineConfig`` fields.

The port serves the paged cache on one device.  It honours
``max_batch``, ``max_len``, ``rng_seed``, ``page_size``, ``n_pages``,
``compress_cold`` and ``n_cold_slots`` (the compressed cold pool),
``swap_bytes`` and ``preemption`` (the host swap tier: ``swap_bytes`` is its
capacity, -1 unbounded, 0 or None off), and ``prefill_chunk`` and
``prefill_budget`` (chunked, decode-interleaved prefill; 0 = whole-prompt
prefill); every other field of the reference keeps its name and default
here, and setting it to anything else raises ``EngineConfigError`` ("not
yet ported") — nothing falls back silently.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..configs.base import ArchConfig
from ..kvcache.paged import PAGED_KINDS

CACHE_MODES = ("paged", "monolithic")

# field -> the only value this slice serves
_NOT_YET_PORTED = {
    "mesh": None, "cache_mode": "paged", "prefix_sharing": False,
    "draft_params": None, "draft_cfg": None, "spec_k": 4,
    "telemetry": None, "kv_monitor": None,
}


class EngineConfigError(ValueError):
    """An EngineConfig field (or flag combination) that cannot be served."""


@dataclass(frozen=True)
class EngineConfig:
    """Declarative ``GenerationEngine`` configuration (module docstring)."""

    # -- batch window / keys --
    max_batch: int = 8
    max_len: int = 512
    rng_seed: int = 0
    mesh: object = field(default=None, compare=False, repr=False)
    # -- paged cache --
    cache_mode: str = "paged"
    page_size: int = 16
    n_pages: int | None = None
    compress_cold: bool = False
    n_cold_slots: int | None = None
    # -- swap + preemption --
    swap_bytes: int | None = None
    preemption: bool = True
    # -- chunked prefill --
    prefill_chunk: int = 0
    prefill_budget: int | None = None
    # -- prefix sharing --
    prefix_sharing: bool = False
    # -- speculative decoding --
    draft_params: object = field(default=None, compare=False, repr=False)
    draft_cfg: ArchConfig | None = None
    spec_k: int = 4
    # -- observability --
    telemetry: object = field(default=None, compare=False, repr=False)
    kv_monitor: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        bad = []
        if self.cache_mode not in CACHE_MODES:
            bad.append(f"cache_mode={self.cache_mode!r} "
                       f"(must be one of {CACHE_MODES})")
        if self.max_batch < 1:
            bad.append(f"max_batch={self.max_batch} (must be >= 1)")
        if self.max_len < 1:
            bad.append(f"max_len={self.max_len} (must be >= 1)")
        if self.page_size < 1:
            bad.append(f"page_size={self.page_size} (must be >= 1)")
        for name, served in _NOT_YET_PORTED.items():
            value = getattr(self, name)
            if value is not served and value != served:
                bad.append(f"{name}={value!r}: not yet ported")
        if bad:
            raise EngineConfigError("; ".join(bad))

    def validate(self, cfg: ArchConfig) -> "EngineConfig":
        """Check this config against architecture ``cfg`` and return the
        resolved copy the engine serves.  The paged cache (and with it
        chunked prefill) needs every layer to page ('attn'/'nope') and no
        encoder; the chunk is clamped to ``max_len``, and the budget
        defaults to one chunk and is at least 1 (0 without chunking)."""
        if cfg.encoder_decoder or not all(
                cfg.layer_kind(i) in PAGED_KINDS
                for i in range(cfg.n_layers)):
            raise EngineConfigError(
                f"{cfg.name}: serving a stack with non-paged layers is not "
                f"yet ported")
        chunk = min(max(self.prefill_chunk, 0), self.max_len)
        budget = max(self.prefill_budget or chunk, 1) if chunk else 0
        return replace(self, prefill_chunk=chunk, prefill_budget=budget)

    @classmethod
    def from_args(cls, args, cfg: ArchConfig) -> "EngineConfig":
        """Build a config from ``launch/serve.py``'s argparse namespace and
        check it against the served architecture."""
        return cls(max_batch=args.max_batch, max_len=args.max_len,
                   rng_seed=args.seed, page_size=args.page_size,
                   n_pages=args.n_pages,
                   compress_cold=args.cache == "paged-compressed",
                   swap_bytes=args.swap_bytes,
                   preemption=args.preemption,
                   prefill_chunk=args.prefill_chunk,
                   prefill_budget=args.prefill_budget or None).validate(cfg)

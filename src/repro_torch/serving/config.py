"""Typed engine configuration: the reference's ``EngineConfig`` and its
feature-gating matrix.

The port serves, on one device: the paged cache (``page_size``,
``n_pages``, the compressed cold pool ``compress_cold`` / ``n_cold_slots``,
the host swap tier ``swap_bytes`` (-1 unbounded, 0 or None off) with
``preemption``, chunked prefill ``prefill_chunk`` / ``prefill_budget``) or
the monolithic cache (``cache_mode="monolithic"``), and speculative
decoding (``draft_params``, ``draft_cfg``, ``spec_k``).  ``mesh``,
``prefix_sharing``, ``telemetry`` and ``kv_monitor`` keep their names and
defaults; setting one to anything else raises ``EngineConfigError`` ("not
yet ported").

The gating matrix (the reference's ``serving/config.py``):

========================  =================================================
feature                   requires
========================  =================================================
paged cache               a pageable decoder stack (an 'attn'/'nope' layer,
                          no encoder-decoder)
chunked prefill           the paged cache and an all-'attn'/'nope' stack
speculative decoding      the paged cache, an all-'attn'/'nope' target,
                          whole-prompt prefill and a same-vocabulary draft
========================  =================================================

``validate(cfg)`` resolves a config against an architecture.  Arch-driven
resolution (a stack with nothing to page resolves to the monolithic cache)
is silent.  A user-requested feature that cannot be served is a fallback:
lenient ``validate`` warns and disables it, ``strict=True`` raises one
``EngineConfigError`` listing every problem.  An architecture the port does
not serve yet (``models.model.check_supported``) is refused in both modes.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace

from ..configs.base import ArchConfig
from ..kvcache.paged import PAGED_KINDS
from ..models.model import check_supported

CACHE_MODES = ("paged", "monolithic")

# field -> the only value this slice serves
_NOT_YET_PORTED = {"mesh": None, "prefix_sharing": False,
                   "telemetry": None, "kv_monitor": None}


class EngineConfigError(ValueError):
    """An EngineConfig field (or flag combination) that cannot be served:
    invalid values, and under ``validate(strict=True)`` user-requested
    features the architecture cannot support."""


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
        if self.spec_k < 1:
            bad.append(f"spec_k={self.spec_k} (must be >= 1)")
        for name, served in _NOT_YET_PORTED.items():
            value = getattr(self, name)
            if value is not served and value != served:
                bad.append(f"{name}={value!r}: not yet ported")
        if bad:
            raise EngineConfigError("; ".join(bad))

    def validate(self, cfg: ArchConfig, *, strict: bool = False
                 ) -> "EngineConfig":
        """Resolve this config against architecture ``cfg`` and return the
        copy the engine serves (the reference's matrix and texts).

        Arch-driven resolution is silent.  Every user-requested feature that
        cannot be served warns and falls back, or, ``strict=True``, raises
        one ``EngineConfigError`` listing every problem at once."""
        for arch in (cfg, self.draft_cfg):
            if arch is None:
                continue
            try:
                check_supported(arch)
            except NotImplementedError as e:
                raise EngineConfigError(str(e)) from None
        problems: list[str] = []
        cache_mode = self.cache_mode
        # arch-driven: nothing to page is a silent resolve, never an error
        if cache_mode == "paged" and (
                cfg.encoder_decoder
                or not any(cfg.layer_kind(i) in ("attn", "nope")
                           for i in range(cfg.n_layers))):
            cache_mode = "monolithic"
        all_paged = all(cfg.layer_kind(i) in PAGED_KINDS
                        for i in range(cfg.n_layers))
        chunk = min(max(self.prefill_chunk, 0), self.max_len)
        if chunk and (cache_mode != "paged" or not all_paged
                      or cfg.encoder_decoder):
            problems.append(
                f"prefill_chunk={self.prefill_chunk} needs the paged "
                f"cache, an all-'attn'/'nope' layer stack and no model "
                f"mesh axis; falling back to whole-prompt prefill")
            chunk = 0
        budget = max(self.prefill_budget or chunk, 1) if chunk else 0
        draft_params, draft_cfg = self.draft_params, self.draft_cfg
        if draft_cfg is not None and (
                cache_mode != "paged" or not all_paged
                or cfg.encoder_decoder or draft_cfg.encoder_decoder
                or chunk or draft_cfg.vocab_size != cfg.vocab_size):
            problems.append(
                "speculative decoding needs the paged cache, an "
                "all-'attn'/'nope' target stack, no model mesh axis, "
                "whole-prompt prefill and a same-vocabulary draft; "
                "serving target-only")
            draft_params = draft_cfg = None
        if problems and strict:
            raise EngineConfigError(
                "incompatible engine configuration:\n  - "
                + "\n  - ".join(problems))
        for msg in problems:
            warnings.warn(msg, stacklevel=2)
        return replace(self, cache_mode=cache_mode, prefill_chunk=chunk,
                       prefill_budget=budget, draft_params=draft_params,
                       draft_cfg=draft_cfg)

    @classmethod
    def from_args(cls, args, cfg: ArchConfig | None = None,
                  **overrides) -> "EngineConfig":
        """Build a config from ``launch/serve.py``'s argparse namespace.

        ``--spec-k`` or ``--draft-seed`` without ``--draft`` raises
        ``EngineConfigError`` at once; with ``cfg`` the result is resolved
        with ``validate(cfg, strict=True)``, so incompatible requests fail
        before any weights exist.  ``overrides`` supply fields with no flag
        (``draft_cfg``, ``draft_params``)."""
        ignored = []
        if not getattr(args, "draft", None):
            if getattr(args, "spec_k", None) is not None:
                ignored.append("--spec-k")
            if getattr(args, "draft_seed", None) is not None:
                ignored.append("--draft-seed")
        if ignored:
            raise EngineConfigError(
                f"{'/'.join(ignored)} ha{'s' if len(ignored) == 1 else 've'}"
                f" no effect without --draft")
        spec_k = getattr(args, "spec_k", None)
        ecfg = cls(
            max_batch=args.max_batch, max_len=args.max_len,
            rng_seed=args.seed,
            cache_mode=("monolithic" if args.cache == "monolithic"
                        else "paged"),
            page_size=args.page_size, n_pages=args.n_pages,
            compress_cold=args.cache == "paged-compressed",
            swap_bytes=args.swap_bytes, preemption=args.preemption,
            prefill_chunk=args.prefill_chunk,
            prefill_budget=args.prefill_budget or None,
            spec_k=spec_k if spec_k is not None else 4, **overrides)
        if cfg is not None:
            ecfg = ecfg.validate(cfg, strict=True)
        return ecfg

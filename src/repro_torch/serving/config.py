"""Typed engine configuration: the reference's ``EngineConfig`` and its
feature-gating matrix.

The port serves, on one device or on a mesh of ranks: the paged cache
(``page_size``, ``n_pages``, the compressed cold pool ``compress_cold`` /
``n_cold_slots``, the host swap tier ``swap_bytes`` (-1 unbounded, 0 or None off) with
``preemption``, chunked prefill ``prefill_chunk`` / ``prefill_budget``) or
the monolithic cache (``cache_mode="monolithic"``), cross-request prefix
sharing (``prefix_sharing``), speculative decoding (``draft_params``,
``draft_cfg``, ``spec_k``) and the observability objects (``telemetry``,
a ``serving.telemetry.Telemetry``; ``kv_monitor``, a
``runtime.monitor.KVCacheMonitor``) and ``mesh``, a ``("data", "model")``
``DeviceMesh`` of ranks (``launch/mesh.py``; ``n_shards()`` its data axis,
``n_model_shards()`` its model axis).  On a mesh the port serves every
stack the engine serves on one device: the attention stacks ('attn',
'nope', 'local') and the mixture-of-experts ones paged (on a model axis
each rank holding its share of the experts, ``models/moe.py``), the
recurrent ones on the monolithic cache, whole on every rank.  A model axis
that does not divide a mixture-of-experts stack's experts raises
``EngineConfigError`` in both modes, as the encoder-decoder does.

The gating matrix (the reference's ``serving/config.py``):

========================  =================================================
feature                   requires
========================  =================================================
paged cache               a pageable decoder stack (an 'attn'/'nope' layer)
                          and ``max_batch`` divisible by the mesh's batch
                          shards
chunked prefill           the paged cache, an all-'attn'/'nope' stack and
                          no model mesh axis
prefix sharing            chunked prefill and one batch shard
speculative decoding      the paged cache, an all-'attn'/'nope' target, no
                          model mesh axis, whole-prompt prefill and a
                          same-vocabulary draft
========================  =================================================

``validate(cfg)`` resolves a config against an architecture.  Arch-driven
resolution (a stack with nothing to page, as recurrentgemma's RG-LRU and
local layers or xlstm's cells, resolves to the monolithic cache) is silent.
A stack that pages some layers and rings others (gemma2's, llama4's local
layers beside their 'attn' / 'nope' ones) is served paged, without chunks,
prefix sharing or speculation.
A draft may be of any kind the port serves, recurrent or with local rings,
as in the reference: the engine rolls back its states as well as its
timeline.  A user-requested feature that cannot be served is a fallback:
lenient ``validate`` warns and disables it, ``strict=True`` raises one
``EngineConfigError`` listing every problem.  An architecture the port does
not serve (``models.model.check_supported``: the port serves the 'attn',
'local', 'nope', 'rglru', 'slstm' and 'mlstm' kinds, no paged layer in a
tail) is refused in both modes, and so is an encoder-decoder, whose model
functions the port runs (``prefill(..., frames=...)``) but whose frames
no engine request carries: the reference's engine resolves it to the
monolithic cache and then fails in its prefill, which calls the encoder
without frames.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace

from ..configs.base import ArchConfig
from ..kvcache.paged import PAGED_KINDS
from ..models.model import check_supported
from ..runtime.sharding import axis_size, n_batch_shards

CACHE_MODES = ("paged", "monolithic")


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
        if bad:
            raise EngineConfigError("; ".join(bad))

    # -- mesh-derived helpers ---------------------------------------------

    def n_shards(self) -> int:
        """Size of the mesh's batch axes, ``("pod", "data")`` folded (1
        without a mesh): the divisor ``max_batch`` must honour for per-shard
        slot ranges."""
        return n_batch_shards(self.mesh)

    def n_model_shards(self) -> int:
        return axis_size(self.mesh, "model")

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
            if arch.encoder_decoder:
                raise EngineConfigError(
                    f"{arch.name}: the engine does not serve an "
                    f"encoder-decoder (a request carries no frames); run "
                    f"models.model.prefill(..., frames=...) and "
                    f"decode_step directly")
            n_model = self.n_model_shards()
            if arch.n_experts and arch.n_experts % n_model:
                raise EngineConfigError(
                    f"{arch.name}: its {arch.n_experts} experts do not "
                    f"split over a model axis of {n_model} "
                    f"({arch.n_experts} % {n_model} = "
                    f"{arch.n_experts % n_model})")
        problems: list[str] = []
        cache_mode = self.cache_mode
        n_shards, n_model = self.n_shards(), self.n_model_shards()
        # arch-driven: nothing to page is a silent resolve, never an error
        if cache_mode == "paged" and not any(
                cfg.layer_kind(i) in ("attn", "nope")
                for i in range(cfg.n_layers)):
            cache_mode = "monolithic"
        if cache_mode == "paged" and self.max_batch % n_shards:
            problems.append(
                f"max_batch={self.max_batch} not divisible by the mesh "
                f"batch-axes size {n_shards}; falling back to the "
                f"monolithic cache")
            cache_mode = "monolithic"
        all_paged = all(cfg.layer_kind(i) in PAGED_KINDS
                        for i in range(cfg.n_layers))
        chunk = min(max(self.prefill_chunk, 0), self.max_len)
        if chunk and (cache_mode != "paged" or not all_paged
                      or n_model > 1):
            problems.append(
                f"prefill_chunk={self.prefill_chunk} needs the paged "
                f"cache, an all-'attn'/'nope' layer stack and no model "
                f"mesh axis; falling back to whole-prompt prefill")
            chunk = 0
        budget = max(self.prefill_budget or chunk, 1) if chunk else 0
        prefix_sharing = bool(self.prefix_sharing)
        if prefix_sharing and (not chunk or n_shards != 1):
            problems.append(
                "prefix_sharing needs chunked prefill (prefill_chunk > 0, "
                "with its paged-cache requirements) and a single batch "
                "shard; serving without sharing")
            prefix_sharing = False
        draft_params, draft_cfg = self.draft_params, self.draft_cfg
        if draft_cfg is not None and (
                cache_mode != "paged" or not all_paged
                or n_model > 1 or chunk
                or draft_cfg.vocab_size != cfg.vocab_size):
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
                       prefill_budget=budget, prefix_sharing=prefix_sharing,
                       draft_params=draft_params, draft_cfg=draft_cfg)

    @classmethod
    def from_args(cls, args, cfg: ArchConfig | None = None,
                  **overrides) -> "EngineConfig":
        """Build a config from ``launch/serve.py``'s argparse namespace.

        ``--spec-k`` or ``--draft-seed`` without ``--draft`` raises
        ``EngineConfigError`` at once; with ``cfg`` the result is resolved
        with ``validate(cfg, strict=True)``, so incompatible requests (e.g.
        ``--prefix-sharing`` with ``--draft``) fail before any weights
        exist.  ``overrides`` supply fields with no flag (``mesh``,
        ``draft_cfg``, ``draft_params``, ``telemetry``, ``kv_monitor``)."""
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
            prefix_sharing=args.prefix_sharing,
            spec_k=spec_k if spec_k is not None else 4, **overrides)
        if cfg is not None:
            ecfg = ecfg.validate(cfg, strict=True)
        return ecfg

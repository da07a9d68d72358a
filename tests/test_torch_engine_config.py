"""The port's ``EngineConfig`` against the JAX package's: scalar validation,
the gating matrix (resolved fields, warning texts in lenient mode, one
error listing every problem under ``strict=True``), ``from_args`` and the
engine built from it.  The reference's ``tests/test_engine_config.py``
cases that involve no mesh, no prefix sharing and no legacy keyword
arguments (none of which the port serves yet), each also held against
the reference's own ``EngineConfig`` on the same request."""
import dataclasses
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import EngineConfigError as RefEngineConfigError  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.serving import EngineConfig, EngineConfigError, \
    GenerationEngine, Request  # noqa: E402


@pytest.fixture(scope="module")
def arch():
    return smoke_variant(get("qwen3-8b")), ref_smoke(ref_get("qwen3-8b"))


@pytest.fixture(scope="module")
def world(arch):
    cfg, ref_cfg = arch
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu"), cfg


def _both(cls, cfg, **kw):
    """Resolve ``kw`` leniently -> (resolved config, warning texts)."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = cls(**kw).validate(cfg)
    return out, [str(w.message) for w in rec]


# -- scalar field validation ------------------------------------------------

@pytest.mark.parametrize("kw, frag", [
    (dict(cache_mode="lru"), "cache_mode"),
    (dict(max_batch=0), "max_batch"),
    (dict(max_len=0), "max_len"),
    (dict(page_size=0), "page_size"),
    (dict(spec_k=0), "spec_k"),
])
def test_scalar_errors(kw, frag):
    with pytest.raises(EngineConfigError, match=frag):
        EngineConfig(**kw)
    with pytest.raises(RefEngineConfigError, match=frag):
        RefEngineConfig(**kw)


def test_scalar_errors_are_collected():
    with pytest.raises(EngineConfigError) as e:
        EngineConfig(max_batch=0, spec_k=-1)
    assert "max_batch" in str(e.value) and "spec_k" in str(e.value)


# -- the gating matrix ------------------------------------------------------

def _draft(port: bool, **over):
    cfg = smoke_variant(get("qwen3-8b")) if port else \
        ref_smoke(ref_get("qwen3-8b"))
    return dataclasses.replace(cfg, **over)


# (EngineConfig fields, draft config overrides or None) of each row
_MATRIX = {
    "valid-paged": (dict(max_batch=4, max_len=64), None),
    "monolithic": (dict(cache_mode="monolithic"), None),
    "chunk-monolithic": (dict(cache_mode="monolithic", prefill_chunk=8),
                         None),
    "chunk-clamped": (dict(max_len=32, prefill_chunk=100), None),
    "chunk-budget": (dict(prefill_chunk=8, prefill_budget=24), None),
    "spec": (dict(spec_k=3), {}),
    "spec-chunk": (dict(prefill_chunk=8), {}),
    "spec-monolithic": (dict(cache_mode="monolithic"), {}),
    "spec-vocab": (dict(), {"vocab_size": 1024}),
    "everything-wrong": (dict(cache_mode="monolithic", prefill_chunk=8),
                         {"vocab_size": 1024}),
}


@pytest.mark.parametrize("row", sorted(_MATRIX))
def test_matrix_resolves_and_warns_as_the_reference(arch, row):
    """Every row of the matrix: the resolved fields and the lenient
    warnings equal the reference's word for word, and ``strict=True``
    raises where the reference raises, with the same text."""
    cfg, ref_cfg = arch
    kw, draft = _MATRIX[row]
    port_kw, ref_kw = dict(kw), dict(kw)
    if draft is not None:
        port_kw.update(draft_cfg=_draft(True, **draft), draft_params=object())
        ref_kw.update(draft_cfg=_draft(False, **draft), draft_params=object())
    got, got_w = _both(EngineConfig, cfg, **port_kw)
    want, want_w = _both(RefEngineConfig, ref_cfg, **ref_kw)
    assert got_w == want_w
    for f in ("cache_mode", "prefill_chunk", "prefill_budget", "spec_k"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.draft_cfg is None) == (want.draft_cfg is None)
    assert (got.draft_params is None) == (want.draft_params is None)
    if want_w:
        with pytest.raises(RefEngineConfigError) as ref_e:
            RefEngineConfig(**ref_kw).validate(ref_cfg, strict=True)
        with pytest.raises(EngineConfigError) as e:
            EngineConfig(**port_kw).validate(cfg, strict=True)
        assert str(e.value) == str(ref_e.value)
    else:
        assert EngineConfig(**port_kw).validate(cfg, strict=True) == got


def test_chunked_prefill_needs_paged_cache(arch):
    cfg, _ = arch
    with pytest.warns(UserWarning, match="prefill_chunk"):
        out = EngineConfig(cache_mode="monolithic",
                           prefill_chunk=8).validate(cfg)
    assert out.prefill_chunk == 0 and out.prefill_budget == 0


def test_prefill_chunk_clamped_and_budget_defaulted(arch):
    cfg, _ = arch
    out = EngineConfig(max_len=32, prefill_chunk=100).validate(cfg)
    assert out.prefill_chunk == 32 and out.prefill_budget == 32
    out = EngineConfig(prefill_chunk=8, prefill_budget=24).validate(cfg)
    assert (out.prefill_chunk, out.prefill_budget) == (8, 24)


def test_speculative_incompatible_with_chunked_prefill(arch):
    cfg, _ = arch
    with pytest.warns(UserWarning, match="speculative"):
        out = EngineConfig(prefill_chunk=8, draft_cfg=_draft(True),
                           draft_params=object()).validate(cfg)
    assert out.draft_cfg is None and out.draft_params is None
    assert out.prefill_chunk == 8           # the chunk itself survives


def test_speculative_needs_same_vocab(arch):
    cfg, _ = arch
    draft = _draft(True, vocab_size=cfg.vocab_size * 2)
    with pytest.warns(UserWarning, match="speculative"):
        out = EngineConfig(draft_cfg=draft,
                           draft_params=object()).validate(cfg)
    assert out.draft_cfg is None


def test_strict_mode_collects_every_problem(arch):
    cfg, _ = arch
    with pytest.raises(EngineConfigError) as e:
        EngineConfig(cache_mode="monolithic", prefill_chunk=8,
                     draft_cfg=_draft(True),
                     draft_params=object()).validate(cfg, strict=True)
    msg = str(e.value)
    assert msg.startswith("incompatible engine configuration:")
    for frag in ("prefill_chunk", "speculative"):
        assert frag in msg, frag


def test_valid_config_resolves_unchanged(arch):
    cfg, _ = arch
    ecfg = EngineConfig(max_batch=4, max_len=64, prefill_chunk=8)
    out = ecfg.validate(cfg, strict=True)      # no warning, no error
    assert out == dataclasses.replace(ecfg, prefill_budget=8)
    assert out.validate(cfg, strict=True) == out       # idempotent


def test_arch_driven_resolution_is_silent():
    """A stack with nothing to page resolves to the monolithic cache with
    no warning in the reference; the port does not serve such a stack yet
    and refuses it, in both modes, without a warning either."""
    xl, ref_xl = smoke_variant(get("xlstm-350m")), \
        ref_smoke(ref_get("xlstm-350m"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert RefEngineConfig().validate(ref_xl).cache_mode == "monolithic"
        for strict in (False, True):
            with pytest.raises(EngineConfigError, match="not yet ported"):
                EngineConfig().validate(xl, strict=strict)


@pytest.mark.parametrize("field,value", [
    ("mesh", object()), ("prefix_sharing", True), ("telemetry", object()),
    ("kv_monitor", object())])
def test_unported_fields_still_refused(field, value):
    with pytest.raises(EngineConfigError, match="not yet ported"):
        EngineConfig(**{field: value})


# -- from_args --------------------------------------------------------------

def _args(**over):
    base = dict(max_batch=2, max_len=48, seed=0, cache="paged",
                page_size=16, n_pages=None, swap_bytes=None,
                preemption=True, prefill_chunk=0, prefill_budget=0,
                prefix_sharing=False, draft=None, spec_k=None,
                draft_seed=None)
    base.update(over)
    return SimpleNamespace(**base)


def test_from_args_spec_flags_require_draft():
    for cls, err in ((EngineConfig, EngineConfigError),
                     (RefEngineConfig, RefEngineConfigError)):
        with pytest.raises(err, match="--spec-k has no effect"):
            cls.from_args(_args(spec_k=4))
        with pytest.raises(err,
                           match="--spec-k/--draft-seed have no effect"):
            cls.from_args(_args(spec_k=4, draft_seed=1))


@pytest.mark.parametrize("cache", ["paged", "paged-compressed",
                                   "monolithic"])
def test_from_args_mapping_matches_reference(arch, cache):
    cfg, ref_cfg = arch
    got = EngineConfig.from_args(_args(cache=cache), cfg)
    want = RefEngineConfig.from_args(_args(cache=cache), ref_cfg)
    for f in ("max_batch", "max_len", "rng_seed", "cache_mode", "page_size",
              "n_pages", "compress_cold", "swap_bytes", "preemption",
              "prefill_chunk", "prefill_budget", "spec_k"):
        assert getattr(got, f) == getattr(want, f), f


def test_from_args_strict_validation(arch):
    cfg, _ = arch
    ecfg = EngineConfig.from_args(
        _args(cache="paged-compressed", prefill_chunk=8), cfg)
    assert ecfg.cache_mode == "paged" and ecfg.compress_cold
    assert ecfg.prefill_chunk == 8 and ecfg.prefill_budget == 8
    assert ecfg.spec_k == 4                  # default when the flag is unset
    # incompatible feature requests fail at parse time, not in the engine
    with pytest.raises(EngineConfigError, match="speculative"):
        EngineConfig.from_args(_args(draft="qwen3-8b", spec_k=2,
                                     prefill_chunk=8), cfg,
                               draft_cfg=_draft(True))
    with pytest.raises(EngineConfigError, match="prefill_chunk"):
        EngineConfig.from_args(_args(cache="monolithic", prefill_chunk=8),
                               cfg)


@pytest.mark.parametrize("cache", ["paged", "monolithic"])
def test_from_args_engine_round_trip(world, cache):
    """args -> from_args -> engine: the engine serves the resolved config
    and generates."""
    params, cfg = world
    ecfg = EngineConfig.from_args(_args(cache=cache), cfg)
    eng = GenerationEngine(params, cfg, config=ecfg, device="cpu")
    assert eng.config == ecfg and eng.cache_mode == cache
    assert (eng.paged is None) == (cache == "monolithic")
    r = Request(prompt=[1, 2, 3], max_new_tokens=3, id=7_500)
    eng.submit(r)
    eng.run()
    assert r.done and len(r.out_tokens) == 3


def test_engine_serves_a_draft_config(world):
    """``EngineConfig(draft_cfg=..., draft_params=...)`` serves speculative
    rounds; the lenient fallback (monolithic cache) warns and serves
    target-only."""
    params, cfg = world
    eng = GenerationEngine(params, cfg, config=EngineConfig(
        max_batch=2, max_len=32, draft_cfg=cfg, draft_params=params,
        spec_k=2), device="cpu")
    r = Request(prompt=[4, 5, 6], max_new_tokens=5, id=7_700)
    eng.submit(r)
    eng.run()
    assert eng.spec_on and r.done and len(r.out_tokens) == 5
    assert eng.spec_counters()["spec_rounds"] > 0
    with pytest.warns(UserWarning, match="speculative"):
        eng = GenerationEngine(params, cfg, config=EngineConfig(
            max_batch=2, max_len=32, cache_mode="monolithic",
            draft_cfg=cfg, draft_params=params), device="cpu")
    assert not eng.spec_on


def test_draft_params_and_cfg_must_travel_together(world):
    params, cfg = world
    with pytest.raises(ValueError, match="together"):
        GenerationEngine(params, cfg, config=EngineConfig(draft_cfg=cfg),
                         device="cpu")

"""The port's ``EngineConfig`` against the JAX package's: scalar validation,
the gating matrix (resolved fields, warning texts in lenient mode, one
error listing every problem under ``strict=True``), ``from_args`` and the
engine built from it.  The reference's ``tests/test_engine_config.py``
cases that involve no mesh and no legacy keyword arguments (neither of
which the port serves), each also held against the reference's own
``EngineConfig`` on the same request; the prefix-sharing rows of the
matrix too."""
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
    "prefix": (dict(prefix_sharing=True, prefill_chunk=8), None),
    "prefix-no-chunk": (dict(prefix_sharing=True), None),
    "prefix-monolithic": (dict(prefix_sharing=True, prefill_chunk=8,
                               cache_mode="monolithic"), None),
    "prefix-spec": (dict(prefix_sharing=True, prefill_chunk=8), {}),
    "prefix-spec-no-chunk": (dict(prefix_sharing=True), {}),
}


def _check_row(cfg, ref_cfg, kw, draft, ref_draft):
    """One row: the resolved fields and the lenient warnings equal the
    reference's word for word, and ``strict=True`` raises where the
    reference raises, with the same text."""
    port_kw, ref_kw = dict(kw), dict(kw)
    if draft is not None:
        port_kw.update(draft_cfg=draft, draft_params=object())
        ref_kw.update(draft_cfg=ref_draft, draft_params=object())
    got, got_w = _both(EngineConfig, cfg, **port_kw)
    want, want_w = _both(RefEngineConfig, ref_cfg, **ref_kw)
    assert got_w == want_w
    for f in ("cache_mode", "prefill_chunk", "prefill_budget", "spec_k",
              "prefix_sharing"):
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
    return got_w


@pytest.mark.parametrize("row", sorted(_MATRIX))
def test_matrix_resolves_and_warns_as_the_reference(arch, row):
    """Every row of the matrix, held against the reference (``_check_row``)."""
    cfg, ref_cfg = arch
    kw, draft = _MATRIX[row]
    _check_row(cfg, ref_cfg, kw,
               None if draft is None else _draft(True, **draft),
               None if draft is None else _draft(False, **draft))


# gemma2's ("local", "attn") stack: chunked prefill, prefix sharing and
# speculation fall back as the reference's validate makes them (a 'local'
# layer keeps a ring, not pages), the warnings word for word
_GEMMA2_ROWS = {
    "valid-paged": (dict(max_batch=4, max_len=64), False),
    "monolithic": (dict(cache_mode="monolithic"), False),
    "chunk": (dict(prefill_chunk=8), False),
    "prefix": (dict(prefix_sharing=True, prefill_chunk=8), False),
    "prefix-no-chunk": (dict(prefix_sharing=True), False),
    "spec": (dict(spec_k=3), True),
    "everything": (dict(prefix_sharing=True, prefill_chunk=8), True),
}


@pytest.mark.parametrize("row", sorted(_GEMMA2_ROWS))
def test_gemma2_falls_back_as_the_reference(row):
    cfg, ref_cfg = (smoke_variant(get("gemma2-9b")),
                    ref_smoke(ref_get("gemma2-9b")))
    kw, spec = _GEMMA2_ROWS[row]
    warned = _check_row(cfg, ref_cfg, kw, cfg if spec else None,
                        ref_cfg if spec else None)
    assert bool(warned) == (row not in ("valid-paged", "monolithic"))


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
    """A stack with nothing to page (xlstm's recurrent cells,
    recurrentgemma's RG-LRU and local layers) resolves to the monolithic
    cache with no warning, in both modes, as in the reference."""
    for arch in ("xlstm-350m", "recurrentgemma-2b"):
        cfg, ref_cfg = smoke_variant(get(arch)), ref_smoke(ref_get(arch))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert RefEngineConfig().validate(
                ref_cfg).cache_mode == "monolithic"
            for strict in (False, True):
                assert EngineConfig().validate(
                    cfg, strict=strict).cache_mode == "monolithic"


@pytest.mark.parametrize("field,value", [
    ("mesh", object()), ("prefix_sharing", True), ("telemetry", object()),
    ("kv_monitor", object())])
def test_unported_fields_still_refused(field, value):
    """Every field of the reference's config is served now: ``mesh`` (the
    mesh engine; its gates are in ``test_torch_mesh.py``), prefix sharing
    and the observability objects; none raises "not yet ported"."""
    assert getattr(EngineConfig(**{field: value}), field) is value


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
              "prefill_chunk", "prefill_budget", "prefix_sharing", "spec_k"):
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


def test_n_shards_folds_the_pod_axis_as_the_reference():
    """The batch shards of a multi-pod mesh are ``pod x data`` (32 on the
    reference's production shape), the reference's ``n_shards`` on a
    stand-in mesh; the rank's shard folds its pod and data indices."""
    from repro_torch.runtime.sharding import MeshShape
    axes, sizes = ("pod", "data", "model"), (2, 16, 16)
    stand_in = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))
    want = RefEngineConfig(mesh=stand_in).n_shards()
    assert want == 32
    assert EngineConfig(mesh=MeshShape(axes, sizes)).n_shards() == want
    assert EngineConfig(mesh=MeshShape(("data", "model"), (4, 2))
                        ).n_shards() == 4
    from repro_torch.runtime.sharding import batch_index, n_batch_shards
    # a (pod, data) stand-in: shard p * 16 + d on every model index
    for p, d, m in ((0, 0, 3), (0, 15, 0), (1, 0, 7), (1, 9, 15)):
        mesh = MeshShape(axes, sizes, coords=(p, d, m))
        assert n_batch_shards(mesh) == 32
        assert batch_index(mesh) == p * 16 + d
    assert n_batch_shards(None) == 1 and batch_index(None) == 0

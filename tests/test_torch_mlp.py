"""The port's feed-forward blocks against the JAX package: the dense MLP
types (``gelu``, ``geglu``, ``sqrelu`` beside ``swiglu``), and the
architectures this slice makes servable, at their smoke sizes on the
reference's own weights converted with
``repro_torch.convert.params_from_numpy``: granite-20b (GELU, multi-query
attention with one KV head, untied embeddings), nemotron-4-15b (squared
ReLU) and, for prefill and decode logits, moonshot-v1-16b-a3b (mixture of
experts at capacity factor 1.25, so a 40-token prompt drops tokens; its
engine runs are in tests/test_torch_moe.py).

MLP outputs are f32 and held within 1e-5; logits within 1e-4
(tests/test_torch_model.py's); greedy tokens exactly."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import store as ref_store  # noqa: E402
from repro.kvcache import paged as ref_paged  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.core import store  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import EngineConfig, GenerationEngine, \
    Request  # noqa: E402

MLP_ATOL = 1e-5
LOGIT_ATOL = 1e-4
ARCHS = ["granite-20b", "nemotron-4-15b"]
MOE_ARCH = "moonshot-v1-16b-a3b"


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "geglu", "sqrelu"])
def test_mlp_apply_matches_reference(mlp_type):
    ref_p = ref_layers.mlp_init(jax.random.PRNGKey(0), 64, 96, mlp_type)
    p = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                               ref_p)
    x = np.random.default_rng(0).normal(size=(2, 7, 64)).astype(np.float32)
    want = ref_layers.mlp_apply(ref_p, jnp.asarray(x), mlp_type,
                                jnp.float32)
    got = layers.mlp_apply(p, torch.from_numpy(x), mlp_type, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MLP_ATOL)

    def new(name, shape, scale=None):       # the port's init: same leaves
        return torch.zeros(shape)

    mine = layers.mlp_init(new, 64, 96, mlp_type)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in ref_p.items()}


def _weights(arch, **kw):
    cfg = replace(smoke_variant(get(arch)), **kw)
    ref_cfg = replace(ref_smoke(ref_get(arch)), **kw)
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


@pytest.fixture(scope="module", params=ARCHS)
def dense(request):
    return _weights(request.param)


@pytest.fixture(scope="module", params=ARCHS + [MOE_ARCH])
def served(request):
    kw = {"capacity_factor": 1.25} if request.param == MOE_ARCH else {}
    return _weights(request.param, **kw)


def test_smoke_configs_keep_their_traits(dense):
    cfg, _, _, params = dense
    assert cfg.mlp_type in ("gelu", "sqrelu") and not cfg.tie_embeddings
    assert "unembed" in params
    assert set(params["units"]["pos0"]["mlp"]) == {"wi", "wo"}
    if cfg.name.startswith("granite"):
        assert cfg.n_kv_heads == 1 < cfg.n_heads        # multi-query


@pytest.mark.parametrize("kind", ["raw", "ecf8"])
def test_prefill_and_paged_decode_logits_match_reference(served, kind):
    cfg, ref_cfg, ref_params, params = served
    if kind == "ecf8":
        ref_params, _ = ref_store.compress_tree(ref_params, min_elems=4096,
                                                out_dtype="float32")
        params, _ = store.compress_tree(params, min_elems=4096,
                                        out_dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 9)]
    ref_pc = ref_paged.PagedKVCache(ref_cfg, 2, 64, dtype=jnp.float32,
                                    page_size=4)
    pc = paged.PagedKVCache(cfg, 2, 64, dtype=torch.float32, device="cpu",
                            page_size=4)
    ref_cache, cache = ref_pc.init_cache(), pc.init_cache()
    last = []
    for slot, p in enumerate(prompts):
        want, frag = RM.prefill(ref_params, ref_cfg, jnp.asarray(p)[None],
                                max_len=64)
        got, frag_t = M.prefill(params, cfg, torch.tensor(p)[None],
                                max_len=64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL)
        ref_cache = ref_pc.admit(ref_cache, slot, frag, len(p))
        cache = pc.admit(cache, slot, frag_t, len(p))
        last.append(int(jnp.argmax(want[0, -1])))
    for step in range(3):
        for slot, p in enumerate(prompts):
            ref_cache = ref_pc.ensure(ref_cache, slot, len(p) + step)
            cache = pc.ensure(cache, slot, len(p) + step)
        tok = np.asarray(last, np.int32)[:, None]
        want, ref_cache = RM.decode_step(ref_params, ref_cfg,
                                         jnp.asarray(tok), ref_cache)
        got, cache = M.decode_step(params, cfg, torch.from_numpy(tok).long(),
                                   cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")
        last = np.asarray(jnp.argmax(want[:, -1], axis=-1)).tolist()


@pytest.mark.parametrize("chunk", [0, 8])
def test_greedy_tokens_match_reference_engine(dense, chunk):
    cfg, ref_cfg, ref_params, params = dense
    rng = np.random.default_rng(2)
    work = [(rng.integers(1, 512, n).tolist(), m)
            for n, m in ((5, 6), (19, 4), (9, 7), (13, 5))]
    kw = dict(max_batch=2, max_len=48, prefill_chunk=chunk)
    ref_eng = RefEngine(ref_params, ref_cfg, config=RefEngineConfig(**kw))
    ref_reqs = [RefRequest(prompt=p, max_new_tokens=n) for p, n in work]
    eng = GenerationEngine(params, cfg, config=EngineConfig(**kw),
                           device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in work]
    for e, rs in ((ref_eng, ref_reqs), (eng, reqs)):
        for r in rs:
            e.submit(r)
        e.run()
    assert all(r.done for r in reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert eng.steps == ref_eng.steps

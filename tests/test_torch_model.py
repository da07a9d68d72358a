"""The port's qwen3 model and paged-cache ops against the JAX package, on
the reference's own smoke weights converted with
``repro_torch.convert.params_from_numpy``.

Logits are f32 and held within 1e-4 (the same operations in another
summation order, through a few layers); page ops are held bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import store as ref_store  # noqa: E402
from repro.kvcache import paged as ref_paged  # noqa: E402
from repro.models import model as RM  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.core import store  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    ref_c, _ = ref_store.compress_tree(ref_params, min_elems=4096,
                                       out_dtype="float32")
    got_c, _ = store.compress_tree(params, min_elems=4096,
                                   out_dtype="float32")
    return cfg, ref_cfg, {"raw": (ref_params, params),
                          "ecf8": (ref_c, got_c)}


@pytest.mark.parametrize("kind", ["raw", "ecf8"])
def test_prefill_logits_and_cache_match_reference(weights, kind):
    cfg, ref_cfg, trees = weights
    ref_params, params = trees[kind]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11))
    want, ref_cache = RM.prefill(ref_params, ref_cfg, jnp.asarray(toks),
                                 max_len=16)
    got, cache = M.prefill(params, cfg, torch.from_numpy(toks), max_len=16)
    assert got.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(
        cache["units"]["pos0"]["k"].numpy(),
        np.asarray(ref_cache["units"]["pos0"]["k"]), atol=LOGIT_ATOL)


@pytest.mark.parametrize("kind", ["raw", "ecf8"])
def test_paged_decode_step_logits_match_reference(weights, kind):
    cfg, ref_cfg, trees = weights
    ref_params, params = trees[kind]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 9)]
    ref_pc = ref_paged.PagedKVCache(ref_cfg, 2, 32, dtype=jnp.float32,
                                    page_size=4)
    pc = paged.PagedKVCache(cfg, 2, 32, dtype=torch.float32, device="cpu",
                            page_size=4)
    ref_cache, cache = ref_pc.init_cache(), pc.init_cache()
    last = []
    for slot, p in enumerate(prompts):
        logits, frag = RM.prefill(ref_params, ref_cfg,
                                  jnp.asarray(p)[None], max_len=32)
        ref_cache = ref_pc.admit(ref_cache, slot, frag, len(p))
        _, frag_t = M.prefill(params, cfg, torch.tensor(p)[None], max_len=32)
        cache = pc.admit(cache, slot, frag_t, len(p))
        last.append(int(jnp.argmax(logits[0, -1])))
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
        np.testing.assert_array_equal(cache["page_table"].numpy(),
                                      np.asarray(ref_cache["page_table"]))
        last = np.asarray(jnp.argmax(want[:, -1], axis=-1)).tolist()


def test_page_write_and_gather_bit_equal():
    rng = np.random.default_rng(2)
    pool = rng.normal(size=(9, 2, 4, 8)).astype(np.float32)
    table = np.array([[3, 1, 0], [5, 2, 7], [0, 0, 0]], np.int32)
    cur = np.array([5, 9, 0], np.int32)
    kv = rng.normal(size=(3, 2, 1, 8)).astype(np.float32)
    want = ref_paged.page_write(jnp.asarray(pool), jnp.asarray(table),
                                jnp.asarray(cur), jnp.asarray(kv))
    got = paged.page_write(torch.from_numpy(pool.copy()),
                           torch.from_numpy(table), torch.from_numpy(cur),
                           torch.from_numpy(kv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        paged.page_gather(got, torch.from_numpy(table)).numpy(),
        np.asarray(ref_paged.page_gather(want, jnp.asarray(table))))

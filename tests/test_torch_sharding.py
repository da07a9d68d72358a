"""The port's sharding rules (``runtime/sharding.py``) against the
reference's: ``param_pspecs`` leaf for leaf for every registry config at
full width (shape-only trees: ``jax.eval_shape`` there, ``meta``-device
tensors here) on (2, 2), (4, 1) and (16, 16) meshes, and on a compressed
tree; ``cache_pspecs`` of the paged and contiguous caches; ``batch_axes``
and ``_fit`` at their edges; ``local_shard`` cutting a tensor as the specs
say."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import store as ref_store  # noqa: E402
from repro.kvcache import PagedKVCache as RefPagedKVCache  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.runtime import sharding as RSH  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, registry, smoke_variant  # noqa: E402
from repro_torch.core import store  # noqa: E402
from repro_torch.kvcache import PagedKVCache  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402

MESHES = [(("data", "model"), (2, 2)), (("data", "model"), (4, 1)),
          (("data", "model"), (16, 16))]


def _meshes(names, sizes):
    return (SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes))),
            SH.MeshShape(names, sizes))


def _ref_flat(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            tuple(s) for p, s in flat}


def _port_flat(specs) -> dict:
    return {k: tuple(v) for k, v in SH.flatten(specs).items()}


def _meta_params(cfg, monkeypatch):
    """The port's parameter tree at full width with ``meta`` leaves: every
    draw of ``init_params`` replaced by an empty tensor of its shape."""
    def meta(self, name, shape, scale=None, uniform=None):
        lead = () if self.n_layers is None else (self.n_layers,)
        return torch.empty(lead + tuple(shape), device="meta")

    with monkeypatch.context() as m:
        m.setattr(M._Draws, "__call__", meta)
        return M.init_params(cfg, device="cpu")


@pytest.mark.parametrize("arch", registry.names())
def test_param_pspecs_equal_reference_at_full_width(arch, monkeypatch):
    cfg, ref_cfg = get(arch), ref_get(arch)
    shapes = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0),
                                                   ref_cfg))
    params = _meta_params(cfg, monkeypatch)
    for names, sizes in MESHES:
        ref_mesh, mesh = _meshes(names, sizes)
        want = _ref_flat(RSH.param_pspecs(ref_cfg, shapes, ref_mesh))
        got = _port_flat(SH.param_pspecs(cfg, params, mesh))
        assert got == want, (arch, sizes)
        for rules in (SH.ShardingRules(serve_tp=True, vocab_tp=False),
                      SH.ShardingRules(expert_fsdp=False)):
            ref_rules = RSH.ShardingRules(**vars(rules))
            assert _port_flat(SH.param_pspecs(cfg, params, mesh, rules)) \
                == _ref_flat(RSH.param_pspecs(ref_cfg, shapes, ref_mesh,
                                              ref_rules)), (arch, rules)


@pytest.mark.parametrize("arch", ["qwen3-8b", "moonshot-v1-16b-a3b",
                                  "gemma2-9b"])
def test_param_pspecs_of_a_compressed_tree(arch):
    """The ECF8 tree: a container's children keyed by position (the
    reference's pytree keys), equal leaf for leaf."""
    cfg, ref_cfg = smoke_variant(get(arch)), ref_smoke(ref_get(arch))
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    ref_c, _ = ref_store.compress_tree(ref_params, min_elems=64,
                                       out_dtype="float32")
    got_c, _ = store.compress_tree(params, min_elems=64, out_dtype="float32")
    for names, sizes in MESHES[:2]:
        ref_mesh, mesh = _meshes(names, sizes)
        assert _port_flat(SH.param_pspecs(cfg, got_c, mesh)) == _ref_flat(
            RSH.param_pspecs(ref_cfg, ref_c, ref_mesh))


@pytest.mark.parametrize("arch,paged", [
    ("qwen3-8b", True), ("qwen3-8b", False), ("gemma2-9b", True),
    ("gemma2-9b", False), ("recurrentgemma-2b", False)])
def test_cache_pspecs_equal_reference(arch, paged):
    """The paged caches' pools, cold leaves, rings, page table and
    timelines, and the contiguous caches' K/V and recurrent states."""
    cfg, ref_cfg = smoke_variant(get(arch)), ref_smoke(ref_get(arch))
    if paged:
        ref_cache = RefPagedKVCache(ref_cfg, 4, 64, dtype=jnp.float32,
                                    page_size=16,
                                    compress_cold=True).init_cache()
        cache = PagedKVCache(cfg, 4, 64, dtype=torch.float32, device="cpu",
                             page_size=16, compress_cold=True).init_cache()
    else:
        ref_cache = RM.init_cache(ref_cfg, 4, 64, dtype=jnp.float32,
                                  per_slot=True)
        cache = M.init_cache(cfg, 4, 64, torch.float32, "cpu",
                             per_slot=True)
    for names, sizes in MESHES + [(("data",), (2,)), (("model",), (2,))]:
        ref_mesh, mesh = _meshes(names, sizes)
        assert _port_flat(SH.cache_pspecs(cfg, cache, mesh)) == _ref_flat(
            RSH.cache_pspecs(ref_cfg, ref_cache, ref_mesh)), sizes


@pytest.mark.parametrize("names", [("data", "model"), ("pod", "data",
                                                       "model"),
                                   ("model",), ("data",), ("pod", "model")])
def test_batch_axes_edges(names):
    ref_mesh, mesh = _meshes(names, (2,) * len(names))
    assert SH.batch_axes(mesh) == RSH.batch_axes(ref_mesh)


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), (6, 8)), (("data", "model"), (3, 8)),
    ((("pod", "data"), None), (8, 5)), ((("pod", "data"), None), (6, 5)),
    ((None, "model"), (4, 7)), (("model", "data"), (1, 1)),
    ((), ())])
def test_fit_edges(spec, shape):
    names, sizes = ("pod", "data", "model"), (2, 2, 4)
    ref_mesh, mesh = _meshes(names, sizes)
    assert tuple(SH._fit(mesh, spec, shape)) == tuple(
        RSH._fit(ref_mesh, spec, shape))


def test_opt_pspecs_and_p():
    p = SH.P("data", None)
    assert p == ("data", None) and repr(p) == "P('data', None)"
    assert SH.opt_pspecs({"w": p}) == {"mu": {"w": p}, "nu": {"w": p},
                                       "count": SH.P()}


def test_local_shard_cuts_as_the_spec_says():
    """A rank's slice: each sharded dim cut into equal parts, the part at
    the rank's index along the axes (a tuple of axes folded row-major)."""
    class FakeMesh(SH.MeshShape):
        def get_local_rank(self, axis):
            return {"pod": 1, "data": 0, "model": 3}[axis]

    mesh = FakeMesh(("pod", "data", "model"), (2, 2, 4))
    x = torch.arange(8 * 12).reshape(8, 12)
    got = SH.local_shard(x, SH.P(("pod", "data"), "model"), mesh)
    assert torch.equal(got, x[4:6, 9:12])
    assert torch.equal(SH.local_shard(x, SH.P(None, None), mesh), x)


def test_runtime_package_reexports_the_reference_names():
    """Every public name of ``repro.runtime`` imports from
    ``repro_torch.runtime``: the sharding rules' and the step factories'
    re-exports, and any submodule the reference's package holds."""
    import importlib
    import types

    import repro.runtime as ref_runtime
    import repro_torch.runtime as port_runtime
    names = [n for n in vars(ref_runtime) if not n.startswith("_")]
    assert {"ShardingRules", "batch_axes", "cache_pspecs", "opt_pspecs",
            "param_pspecs", "make_train_step", "make_prefill_step",
            "make_decode_step"} <= set(names)
    for name in names:
        if isinstance(getattr(ref_runtime, name), types.ModuleType):
            importlib.import_module(f"repro_torch.runtime.{name}")
            continue
        got = getattr(port_runtime, name)
        assert got.__name__.lstrip("_") == name.lstrip("_"), name

"""ECF8-FR (the fixed-rate container) in the port against the JAX package:
encoder containers byte-equal field by field, the plain decode and the host
oracle bit-exact against the reference's jnp decode and its oracle, the
fixed-table encoder against ``encode_jnp`` (overflow included), the store's
ECF8-FR leaves (stacked and unstacked, streamed or cast from masters)
byte-equal to the reference's ``compress_tree(fmt="fixedrate")`` with the
same report, and serving from ECF8-FR weights: greedy tokens equal to the
reference engine's on the same weights and to the fp8 baseline's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import fixedrate as ref_fr, stats as ref_stats  # noqa: E402
from repro.core import store as ref_store  # noqa: E402
from repro.kernels import ref as ref_kref  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.core import fixedrate, store  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import EngineConfig  # noqa: E402

# tests/test_lossless.py:47's shapes and alphas, and its adversarial
# distributions (:56)
SHAPES = [(4096,), (128, 512), (3, 1000), (7,)]
ALPHAS = [1.2, 1.6, 1.9, 2.0]
_ADVERSARIAL = {
    "one-exponent": np.full(5000, 0b0_0111_010, np.uint8),
    "two-exponents": np.where(np.arange(5000) % 2, 0b0_0111_000,
                              0b1_1000_111).astype(np.uint8),
    "all-fields": (np.arange(5000) * 7 % 256).astype(np.uint8),
}
_ENCODE_KW = {"default": {}, "capacity": dict(esc_capacity=5),
              "margin": dict(margin=1.5),
              "capacity+margin": dict(esc_capacity=3000, margin=1.25)}
_FIELDS = ("codes", "escapes", "table", "signmant")


def _bits(case):
    if case in _ADVERSARIAL:
        return _ADVERSARIAL[case]
    shape, alpha = case
    return ref_stats.synthesize_fp8_weights(shape, alpha=alpha,
                                            seed=len(shape) * 7 + shape[0])


_CASES = [(s, a) for s in SHAPES for a in ALPHAS] + sorted(_ADVERSARIAL)


def _id(case):
    return case if isinstance(case, str) else f"{case[0]}-a{case[1]}"


def _assert_same_container(got, want):
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
    assert (got.n_elem, got.esc_capacity, got.esc_count, got.shape) == (
        want.n_elem, want.esc_capacity, want.esc_count, tuple(want.shape))
    assert got.nbytes == want.nbytes and got.ratio == want.ratio


@pytest.mark.parametrize("kw", sorted(_ENCODE_KW))
@pytest.mark.parametrize("case", _CASES, ids=_id)
def test_encode_byte_equal_to_reference(case, kw, monkeypatch):
    bits = _bits(case)
    want = ref_fr.encode(bits, **_ENCODE_KW[kw])
    got = fixedrate.encode(torch.from_numpy(bits.copy()), **_ENCODE_KW[kw])
    _assert_same_container(got, want)
    # the slices of the encoder change nothing
    monkeypatch.setattr(fixedrate, "SLICE_ELEMS", 64)
    small = fixedrate.encode(torch.from_numpy(bits.copy()),
                             **_ENCODE_KW[kw])
    _assert_same_container(small, want)


@pytest.mark.parametrize("case", _CASES, ids=_id)
def test_decode_bit_exact_against_reference(case, monkeypatch):
    """``decode_plain`` (one slice, and slices of 12 elements carrying the
    escape count across them) equals the reference's ``_decode_jnp_impl``;
    ``decode_ref`` and ``kernels.ref.decode_fixedrate_ref`` equal its
    oracle; all are lossless."""
    bits = _bits(case)
    want_c = ref_fr.encode(bits)
    c = fixedrate.encode(torch.from_numpy(bits.copy()))
    want = np.asarray(ref_fr._decode_jnp_impl(
        jnp.asarray(want_c.codes), jnp.asarray(want_c.escapes),
        jnp.asarray(want_c.table), jnp.asarray(want_c.signmant),
        n_elem=want_c.n_elem))
    for slice_elems in (fixedrate.SLICE_ELEMS, 12):
        monkeypatch.setattr(fixedrate, "SLICE_ELEMS", slice_elems)
        got = fixedrate.decode_plain(c.codes, c.escapes, c.table, c.signmant,
                                     n_elem=c.n_elem)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, bits.reshape(-1))
    np.testing.assert_array_equal(fixedrate.decode_ref(c).numpy(),
                                  ref_fr.decode_ref(want_c))
    np.testing.assert_array_equal(kref.decode_fixedrate_ref(c).numpy(),
                                  ref_kref.decode_fixedrate_ref(want_c))


def test_decode_reads_escapes_past_the_count_as_the_reference_clips(
        monkeypatch):
    """A capacity of 1 for a tensor with many escapes (a hand-cut escape
    array): ranks past the array clip to its last nibble in both."""
    bits = _bits("all-fields")
    want_c = ref_fr.encode(bits)
    esc = want_c.escapes[:1]
    monkeypatch.setattr(fixedrate, "SLICE_ELEMS", 100)
    want = np.asarray(ref_fr._decode_jnp_impl(
        jnp.asarray(want_c.codes), jnp.asarray(esc),
        jnp.asarray(want_c.table), jnp.asarray(want_c.signmant),
        n_elem=want_c.n_elem))
    got = fixedrate.decode_plain(
        torch.from_numpy(want_c.codes), torch.from_numpy(esc.copy()),
        torch.from_numpy(want_c.table), torch.from_numpy(want_c.signmant),
        n_elem=want_c.n_elem)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16,
                                       torch.float32])
def test_decode_out_dtype_matches_reference_materialize(out_dtype):
    bits = _bits(((128, 512), 1.9))
    ref_ct = ref_store.compress_array(bits, fmt="fixedrate")
    ct = store.compress_array(torch.from_numpy(bits.copy()),
                              fmt="fixedrate")
    name = str(out_dtype).split(".")[-1]
    want = np.asarray(ref_store.materialize(ref_ct, getattr(jnp, name)))
    got = store.materialize(ct, name)
    assert got.dtype == out_dtype and got.shape == (128, 512)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("seed", range(12))
def test_roundtrip_arbitrary_bytes(seed, monkeypatch):
    """Any uint8 array of 1-600 bytes (tests/test_properties.py:81's
    property, on seeded draws) encodes, decodes through the plain decode
    and the oracle, and comes back."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 256, int(rng.integers(1, 601))).astype(np.uint8)
    c = fixedrate.encode(torch.from_numpy(bits))
    np.testing.assert_array_equal(fixedrate.decode_ref(c).numpy(), bits)
    monkeypatch.setattr(fixedrate, "SLICE_ELEMS", 8)
    got = fixedrate.decode_plain(c.codes, c.escapes, c.table, c.signmant,
                                 n_elem=c.n_elem)
    np.testing.assert_array_equal(got.numpy(), bits)


try:
    from hypothesis import given, settings, strategies as st
    from hypothesis.extra.numpy import arrays
except ImportError:     # the seeded sweep above holds the same property
    given = None

if given is not None:
    @settings(max_examples=25, deadline=None)
    @given(arrays(np.uint8, st.integers(1, 600)))
    def test_roundtrip_any_bytes_hypothesis(bits):
        c = fixedrate.encode(torch.from_numpy(bits.copy()))
        np.testing.assert_array_equal(fixedrate.decode_ref(c).numpy(), bits)


@pytest.mark.parametrize("n,seed,cap", [(64, 0, None), (1000, 1, None),
                                        (4096, 2, None), (4096, 3, 17),
                                        (777, 4, 0)])
def test_fixed_table_encode_matches_encode_jnp(n, seed, cap):
    """``encode_plain`` against ``encode_jnp`` with the host encoder's
    table: every output equal, escapes dropped past a capacity the escape
    count exceeds and the overflow flag raised (``cap`` 17 and 0), as
    tests/test_properties.py:138 holds it."""
    bits = np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8)
    host = ref_fr.encode(bits, esc_capacity=n, margin=1.0)
    cap = host.esc_capacity if cap is None else cap
    want = ref_fr.encode_jnp(jnp.asarray(bits), jnp.asarray(host.table),
                             esc_capacity=cap)
    got = fixedrate.encode_plain(torch.from_numpy(bits),
                                 torch.from_numpy(host.table), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[3]) == (host.esc_count > cap)
    if cap == host.esc_capacity:
        np.testing.assert_array_equal(got[0].numpy(), host.codes)


# -- the store -----------------------------------------------------------------

def _containers(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _containers(v, path + (k,))
    elif hasattr(tree, "arrays"):
        yield path, tree


@pytest.fixture(scope="module")
def qwen():
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


def test_compress_tree_containers_and_report_match_reference(qwen):
    cfg, _, ref_params, params = qwen
    ref_c, ref_rep = ref_store.compress_tree(
        ref_params, fmt="fixedrate", min_elems=4096, out_dtype="float32")
    got_c, rep = store.compress_tree(params, fmt="fixedrate",
                                     min_elems=4096, out_dtype="float32")
    assert rep == ref_rep and rep["n_compressed"] == 8
    ref_map, mine = dict(_containers(ref_c)), dict(_containers(got_c))
    assert sorted(mine) == sorted(ref_map)
    stacked = 0
    for path, ct in mine.items():
        ref = ref_map[path]
        assert ct.meta == store.CompressedMeta(
            fmt=ref.meta.fmt, shape=tuple(ref.meta.shape),
            n_elem=ref.meta.n_elem, sym_per_lane=ref.meta.sym_per_lane,
            esc_capacity=ref.meta.esc_capacity,
            out_dtype=ref.meta.out_dtype), path
        for name, a in ct.arrays.items():
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(ref.arrays[name]),
                                          err_msg=f"{path}/{name}")
        if path[0] == "units":
            stacked += 1
            for i in range(cfg.n_layers):
                want = ref_store.materialize(
                    jax.tree_util.tree_map(lambda a: a[i], ref),
                    jnp.float32)
                got = store.materialize(ct.layer(i), torch.float32)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_array_equal(
                store.materialize(ct, torch.float32).numpy(),
                np.asarray(ref_store.materialize(ref, jnp.float32)))
    assert stacked == 7


def test_compress_stacked_pads_escapes_like_reference():
    """Layers with different escape counts: the escape arrays are padded to
    the stack's widest, ``meta`` is layer 0's, and every layer still
    decodes bit-exactly."""
    stack = np.stack([_bits(((64 * 512,), a)).reshape(64, 512)
                      for a in (1.2, 2.0, 1.6)])
    ref = ref_store.compress_stacked(stack, fmt="fixedrate",
                                     out_dtype="float32")
    got = store.compress_stacked(torch.from_numpy(stack), fmt="fixedrate",
                                 out_dtype="float32")
    caps = {ref_fr.encode(stack[i]).esc_capacity for i in range(3)}
    assert len(caps) == 3
    assert got.meta.esc_capacity == ref.meta.esc_capacity == \
        ref_fr.encode(stack[0]).esc_capacity
    for name, arr in ref.arrays.items():
        np.testing.assert_array_equal(got.arrays[name].numpy(),
                                      np.asarray(arr), err_msg=name)
    for i in range(3):
        w = store.materialize(got.layer(i), torch.float32)
        want = torch.from_numpy(stack[i]).view(torch.float8_e4m3fn)
        assert torch.equal(w, want.to(torch.float32))


def test_streamed_build_equals_compress_tree():
    """``build_trees(fmt="fixedrate")`` (leaves drawn a layer at a time)
    gives ``compress_tree(init_params(...), fmt="fixedrate")``'s containers
    and report, and the fp8 baseline beside them."""
    cfg = smoke_variant(get("qwen3-8b"))
    tree, base, report = store.build_trees(
        lambda leaf: M.init_params(cfg, 3, "cpu", leaf=leaf),
        fmt="fixedrate", min_elems=4096, out_dtype="float32")
    masters = M.init_params(cfg, 3, "cpu")
    want, want_rep = store.compress_tree(masters, fmt="fixedrate",
                                         min_elems=4096, out_dtype="float32")
    assert report == want_rep
    got_c, want_c = dict(_containers(tree)), dict(_containers(want))
    assert sorted(got_c) == sorted(want_c) and len(got_c) == 8
    for path, ct in got_c.items():
        assert ct.meta == want_c[path].meta
        for name, a in ct.arrays.items():
            assert torch.equal(a, want_c[path].arrays[name]), (path, name)
    fp8_tree = store.fp8_cast_tree(masters, min_elems=4096)
    assert torch.equal(base["embed"].view(torch.uint8),
                       fp8_tree["embed"].view(torch.uint8))


def test_unknown_format_is_refused():
    with pytest.raises(ValueError, match="unknown format"):
        store.compress_array(torch.zeros(64, 64, dtype=torch.uint8),
                             fmt="paper")


# -- serving -------------------------------------------------------------------

_WORK = [([1, 2, 3, 4], 9), ([5, 6, 7], 12), ([9, 10], 6),
         (list(range(20, 43)), 10), ([11, 12, 13], 7)]


def _serve(eng, Req):
    reqs = [Req(prompt=p, max_new_tokens=n) for p, n in _WORK]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("cache_mode", ["paged", "monolithic"])
def test_fixedrate_engine_matches_reference_engine_and_fp8(qwen, cache_mode):
    cfg, ref_cfg, ref_params, params = qwen
    ref_c, _ = ref_store.compress_tree(ref_params, fmt="fixedrate",
                                       min_elems=4096, out_dtype="float32")
    got_c, _ = store.compress_tree(params, fmt="fixedrate", min_elems=4096,
                                   out_dtype="float32")
    kw = dict(max_batch=3, max_len=64, cache_mode=cache_mode)
    want = _serve(RefEngine(ref_c, ref_cfg, config=RefEngineConfig(**kw)),
                  RefRequest)
    got = _serve(serve.GenerationEngine(got_c, cfg, config=EngineConfig(**kw),
                                        device="cpu"), serve.Request)
    assert got == want
    base = store.fp8_cast_tree(params, min_elems=4096)
    assert _serve(serve.GenerationEngine(base, cfg,
                                         config=EngineConfig(**kw),
                                         device="cpu"), serve.Request) == got


def test_serve_cli_fixedrate_check_lossless(capsys):
    """``launch/serve.py --smoke --device cpu --compress fixedrate
    --check-lossless``: the report line in the reference's words, the
    tokens identical to the fp8 baseline's, and a draft tree compressed
    the same way."""
    done = serve.main(["--smoke", "--device", "cpu", "--compress",
                       "fixedrate", "--check-lossless", "--requests", "4",
                       "--max-new", "8"])
    out = capsys.readouterr().out
    assert "[serve] ECF8(fixedrate) encode" in out and "% saved)" in out
    assert "lossless check vs fp8 baseline: IDENTICAL" in out
    assert len(done) == 4 and all(len(r.out_tokens) == 8 for r in done)
    serve.main(["--smoke", "--device", "cpu", "--compress", "fixedrate",
                "--draft", "qwen3-8b", "--spec-k", "2", "--requests", "2",
                "--max-new", "6", "--check-lossless"])
    out = capsys.readouterr().out
    assert "speculative:" in out and "IDENTICAL" in out

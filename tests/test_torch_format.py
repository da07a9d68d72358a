"""The port's fp8 / Huffman / ECF8-TPU container and compressed store
against the JAX package, plus the port's isolation guards.

Integer paths are held bit for bit: the fp8 cast, the codebooks, the
container bytes, the decoded fp8 bits and the ``compress_tree`` byte
report."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import huffman as ref_huffman, stats  # noqa: E402
from repro.core import store as ref_store, tpu_format as ref_tpu  # noqa: E402
from repro.models import model as RM  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.core import fp8, huffman, store, tpu_format  # noqa: E402
from repro_torch.kernels import ecf8_decode, flash_fwd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_kernels.py's decode sweep plus its two degenerate codebooks
_SWEEP = [("synth", n, alpha, spl)
          for n in (128 * 32, 128 * 32 * 3 + 5, 100_000)
          for alpha in (1.2, 1.9) for spl in (32, 64)]
_SWEEP += [("one-symbol", 128 * 64, 0, 32), ("near-uniform", 128 * 64, 0, 32),
           ("matrix", 300 * 517, 1.5, 256), ("tiny", 3, 1.2, 256)]


def _bits(kind, n, alpha):
    if kind == "one-symbol":
        return np.full(n, 0b0_0111_010, np.uint8)
    if kind == "near-uniform":
        return (np.arange(n) * 11 % 256).astype(np.uint8)
    return stats.synthesize_fp8_weights((n,), alpha=alpha, seed=n % 97)


def test_fp8_cast_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    vals = np.concatenate(
        [rng.normal(size=20_000).astype(np.float32) * s
         for s in (1e-4, 1e-2, 1.0, 100.0, 600.0)])
    special = np.array(
        [0.0, 448.0, 449.0, 463.99, 464.0, 464.01, 479.9, 480.0, 1e6,
         np.inf, np.nan, 2 ** -6, 2 ** -9, 2 ** -10, 1.5 * 2 ** -10,
         2.5 * 2 ** -9, 2 ** -6 * (1 - 2 ** -5), 1e-30], np.float32)
    patterns = np.arange(0, 2 ** 32, 65_537, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    vals = np.concatenate([vals, special, -special, patterns])
    want = np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn)).view(
        np.uint8)
    got = fp8.cast_to_fp8_bits(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_codebooks_identical(seed):
    rng = np.random.default_rng(seed)
    freqs = rng.integers(0, 1000, size=16) ** rng.integers(1, 4)
    freqs[rng.integers(0, 16, size=seed)] = 0
    a = ref_huffman.Codebook.from_freqs(freqs, max_len=8)
    b = huffman.Codebook.from_freqs(freqs, max_len=8)
    for name in ("lengths", "codes", "sorted_syms", "lj_limit", "first_lj",
                 "offset"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)


@pytest.mark.parametrize("kind,n,alpha,spl", _SWEEP)
def test_encode_byte_identical_and_decode_bit_exact(kind, n, alpha, spl):
    bits = _bits(kind, n, alpha)
    ref = ref_tpu.encode(bits, sym_per_lane=spl)
    got = tpu_format.encode(torch.from_numpy(bits.copy()), sym_per_lane=spl)
    for name in ("payload", "signmant", "lj_limit", "first_lj", "offset",
                 "perm"):
        a, b = getattr(ref, name), getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert got.sym_per_lane == ref.sym_per_lane
    dec = tpu_format.decode_plain(
        got.payload, got.signmant, got.lj_limit, got.first_lj, got.offset,
        got.perm, sym_per_lane=got.sym_per_lane, n_elem=got.n_elem)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(
        ref_tpu.decode_jnp(ref)))
    np.testing.assert_array_equal(dec.numpy(), bits)


def test_encode_in_groups_matches_one_pass(monkeypatch):
    bits = _bits("synth", 100_000, 1.9)
    one = tpu_format.encode(torch.from_numpy(bits.copy()), sym_per_lane=32)
    monkeypatch.setattr(tpu_format, "ENCODE_GROUP_ELEMS", 128 * 32 * 3)
    grouped = tpu_format.encode(torch.from_numpy(bits.copy()), sym_per_lane=32)
    assert torch.equal(one.payload, grouped.payload)


def test_decode_ref_matches_reference_oracle():
    bits = _bits("synth", 128 * 8 + 3, 1.9)
    got = tpu_format.encode(torch.from_numpy(bits.copy()), sym_per_lane=8)
    ref = ref_tpu.encode(bits, sym_per_lane=8)
    np.testing.assert_array_equal(tpu_format.decode_ref(got).numpy(),
                                  ref_tpu.decode_ref(ref))


_INT_BITS = {torch.bfloat16: (torch.int16, np.int16),
             torch.float16: (torch.int16, np.int16),
             torch.float32: (torch.int32, np.int32)}
_JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
        torch.float32: jnp.float32}


def _assert_same_values(got: torch.Tensor, want) -> None:
    """Bit-equal to the reference's array, NaNs (whose payload a cast may
    set differently) by ``isnan``."""
    want = np.asarray(want)
    t_bits, np_bits = _INT_BITS[got.dtype]
    nan = np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(torch.isnan(got).numpy(), nan)
    np.testing.assert_array_equal(got.view(t_bits).numpy()[~nan],
                                  want.view(np_bits)[~nan])


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16,
                                       torch.float32])
@pytest.mark.parametrize("kind", ["all-256-codes", "synth"])
def test_decode_out_dtype_matches_reference_decode_and_astype(out_dtype,
                                                               kind):
    """``ops.decode_ecf8(..., out_dtype)`` against the reference's decode
    followed by its ``astype`` (what ``repro.core.store.materialize``
    computes), on every fp8 code and on a random container."""
    from repro_torch.kernels import ops
    bits = ((np.arange(128 * 32 * 3 + 5) * 37 % 256).astype(np.uint8)
            if kind == "all-256-codes" else _bits("synth", 100_003, 1.5))
    ref = ref_tpu.encode(bits, sym_per_lane=32)
    want = ref_tpu.decode_jnp(ref).view(jnp.float8_e4m3fn).astype(
        _JNP[out_dtype])
    c = tpu_format.encode(torch.from_numpy(bits.copy()), sym_per_lane=32)
    got = ops.decode_ecf8(c.payload, c.signmant, c.lj_limit, c.first_lj,
                          c.offset, c.perm, sym_per_lane=c.sym_per_lane,
                          n_elem=c.n_elem, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (bits.size,)
    _assert_same_values(got, want)
    if kind == "all-256-codes":
        assert int(torch.isnan(got).sum()) == int(
            ((bits & 0x7F) == 0x7F).sum())
    bits_only = ops.decode_ecf8(c.payload, c.signmant, c.lj_limit,
                                c.first_lj, c.offset, c.perm,
                                sym_per_lane=c.sym_per_lane, n_elem=c.n_elem)
    np.testing.assert_array_equal(bits_only.numpy(), bits)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_materialize_decodes_into_dtype_like_reference(monkeypatch, dtype):
    """``store.materialize`` asks the decode for the weight's dtype and casts
    nothing itself; its values equal the reference's ``materialize``."""
    from repro_torch.kernels import ops
    bits = _bits("synth", 300 * 517, 1.9).reshape(300, 517)
    ref_ct = ref_store.compress_array(bits, out_dtype=dtype)
    ct = store.compress_array(torch.from_numpy(bits.copy()), out_dtype=dtype)
    asked, decoded = [], []
    decode = ops.decode_ecf8

    def spy(*a, **kw):
        asked.append(kw.get("out_dtype"))
        decoded.append(decode(*a, **kw))
        return decoded[-1]

    monkeypatch.setattr(ops, "decode_ecf8", spy)
    got = store.materialize(ct)
    assert asked == [store.torch_dtype(dtype)]
    # the decode's own output, reshaped: no cast or copy after it
    assert got.data_ptr() == decoded[0].data_ptr()
    assert got.shape == (300, 517) and got.dtype == store.torch_dtype(dtype)
    _assert_same_values(got, ref_store.materialize(ref_ct))


def _smoke_params():
    cfg = smoke_variant(get("qwen3-8b"))
    ref_params = RM.init_params(jax.random.PRNGKey(0),
                                ref_smoke(ref_get("qwen3-8b")))
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    return cfg, ref_params, convert.params_from_numpy(tree, cfg, "cpu")


def test_compress_tree_report_and_containers_match_reference():
    cfg, ref_params, params = _smoke_params()
    ref_c, ref_report = ref_store.compress_tree(ref_params, min_elems=4096,
                                                out_dtype="float32")
    got_c, report = store.compress_tree(params, min_elems=4096,
                                        out_dtype="float32")
    assert report == ref_report
    assert report["n_compressed"] == 8
    ref_leaf = ref_c["units"]["pos0"]["mlp"]["wi_gate"]
    leaf = got_c["units"]["pos0"]["mlp"]["wi_gate"]
    for name, arr in ref_leaf.arrays.items():
        np.testing.assert_array_equal(leaf.arrays[name].numpy(),
                                      np.asarray(arr), err_msg=name)
    for i in range(cfg.n_layers):
        want = ref_store.materialize(
            jax.tree_util.tree_map(lambda a: a[i], ref_leaf), jnp.float32)
        got = store.materialize(leaf.layer(i), torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref_fp8 = ref_store.fp8_cast_tree(ref_params, min_elems=4096)
    got_fp8 = store.fp8_cast_tree(params, min_elems=4096)
    np.testing.assert_array_equal(
        got_fp8["embed"].view(torch.uint8).numpy(),
        np.asarray(ref_fp8["embed"]).view(np.uint8))
    assert got_fp8["final_norm"].dtype == torch.float32


def test_compress_stacked_pads_strides_like_reference():
    """Layers of different entropy get different strides; the stack pads
    every payload to the widest, and each padded layer still decodes
    bit-exactly."""
    stack = np.stack([_bits("synth", 64 * 512, alpha).reshape(64, 512)
                      for alpha in (1.2, 1.9, 1.5)])
    ref = ref_store.compress_stacked(stack, out_dtype="float32")
    got = store.compress_stacked(torch.from_numpy(stack),
                                 out_dtype="float32")
    strides = {ref_tpu.encode(stack[i]).stride for i in range(3)}
    assert len(strides) > 1
    for name, arr in ref.arrays.items():
        np.testing.assert_array_equal(got.arrays[name].numpy(),
                                      np.asarray(arr), err_msg=name)
    for i in range(3):
        w = store.materialize(got.layer(i), torch.float32)
        want = torch.from_numpy(stack[i]).view(torch.float8_e4m3fn)
        assert torch.equal(w, want.to(torch.float32))


# --------------------------------------------------------------------------
# isolation guards
# --------------------------------------------------------------------------

def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_and_no_reference_package():
    bad = []
    for path in _port_files():
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert len(_port_files()) > 20
    assert not bad, bad


def test_serve_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving import GenerationEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_variant(get("qwen3-8b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_from_numpy({"embed": np.zeros((512, 64))}, cfg)
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationEngine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--requests", "1"])


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper never falls back: the plain path is chosen by the
    dispatcher only for CPU tensors, and the kernel entry raises."""
    c = tpu_format.encode(torch.from_numpy(_bits("synth", 4096, 1.9)))
    before = ecf8_decode.run.launches, flash_fwd.run.launches
    with pytest.raises(ValueError, match="CUDA"):
        ecf8_decode.run(c.payload, c.signmant, c.lj_limit, c.first_lj,
                        c.offset, c.perm, sym_per_lane=c.sym_per_lane,
                        n_elem=c.n_elem)
    q = torch.zeros((1, 2, 4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd.run(q, q, q)
    assert (ecf8_decode.run.launches, flash_fwd.run.launches) == before

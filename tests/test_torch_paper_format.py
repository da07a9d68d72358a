"""The paper's own container (§3.1, Algorithm 1) and the Huffman functions
it uses, in the port against the JAX package: unrestricted Huffman
lengths, the Kraft sum and the expected length equal to the reference's;
the bitstream encoder byte-equal and the sequential decoder equal; every
field of ``paper_format.encode`` byte-equal; the sequential and the
block-parallel decoders bit-exact; and the properties of the reference's
own six tests (tests/test_paper_format.py) held on the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import huffman as ref_huffman  # noqa: E402
from repro.core import paper_format as ref_pf, stats as ref_stats  # noqa: E402

from repro_torch.core import fp8, huffman, paper_format, stats  # noqa: E402

_FREQS = [np.asarray([3, 1000, 500, 7, 90, 0, 2, 44, 800, 1, 0, 0, 60, 5,
                      10, 9]),
          np.asarray([2 ** max(0, 14 - i) for i in range(16)]),
          np.asarray([0] * 5 + [17] + [0] * 10),
          np.asarray([5, 5] + [0] * 14),
          np.zeros(16, np.int64),
          np.arange(1, 17) ** 3]
_FIELDS = ("encoded", "packed", "lut", "gaps", "outpos")


@pytest.mark.parametrize("i", range(len(_FREQS)))
def test_huffman_functions_match_reference(i):
    freqs = _FREQS[i]
    got = huffman.huffman_lengths(freqs)
    want = ref_huffman.huffman_lengths(freqs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    for lens in (got, huffman.package_merge_lengths(freqs, 16)):
        assert huffman.kraft_sum(lens) == ref_huffman.kraft_sum(lens)
        assert (huffman.expected_length(freqs, lens)
                == ref_huffman.expected_length(freqs, lens))
    assert huffman.N_SYMBOLS == ref_huffman.N_SYMBOLS


@pytest.mark.parametrize("max_len", [8, 16])
@pytest.mark.parametrize("i", [0, 1, 2, 3, 5])
def test_bitstream_encode_and_decode_match_reference(i, max_len):
    freqs = _FREQS[i]
    cb = huffman.Codebook.from_freqs(freqs, max_len=max_len)
    ref_cb = ref_huffman.Codebook.from_freqs(freqs, max_len=max_len)
    rng = np.random.default_rng(i)
    syms = rng.choice(16, 3000, p=freqs / freqs.sum())
    got, nbits = cb.encode_symbols(syms)
    want, want_bits = ref_cb.encode_symbols(syms)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and nbits == want_bits
    for start in (0, int(cb.lengths[syms[0]])):
        n = 500 if start else 3000
        dec = cb.decode_bitstream(got, n, start_bit=start)
        np.testing.assert_array_equal(
            dec, ref_cb.decode_bitstream(want, n, start_bit=start))
    np.testing.assert_array_equal(cb.decode_bitstream(got, 3000), syms)
    empty, zero = cb.encode_symbols(np.zeros(0, np.int64))
    assert zero == 0 and empty.shape == (0,)


def _cases():
    out = {f"synth-{s}-a{a}": ref_stats.synthesize_fp8_weights(
        s, alpha=a, seed=sum(s)) for s in [(40_000,), (64, 1024), (3, 999)]
        for a in (1.2, 1.9)}
    out["all-fields"] = (np.arange(100_003) * 37 % 256).astype(np.uint8)
    out["one-exponent"] = np.full(5000, 0b0_0111_010, np.uint8)
    out["two-exponents"] = np.where(np.arange(5000) % 2, 0b0_0111_000,
                                    0b1_1000_111).astype(np.uint8)
    for n in (1, 2, 127, 128, 1025):
        out[f"bytes-{n}"] = np.random.default_rng(n).integers(
            0, 256, n).astype(np.uint8)
    return out


_CASES = _cases()


@pytest.mark.parametrize("name", sorted(_CASES))
def test_encode_byte_equal_and_decoders_bit_exact(name):
    bits = _CASES[name]
    want = ref_pf.encode(bits)
    got = paper_format.encode(torch.from_numpy(bits.copy()))
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert (got.n_elem, got.shape) == (want.n_elem, tuple(want.shape))
    assert got.n_bytes_total == want.n_bytes_total
    assert got.ratio == want.ratio
    np.testing.assert_array_equal(got.codebook.lengths, want.codebook.lengths)
    np.testing.assert_array_equal(paper_format.decode_blockparallel(got),
                                  bits)
    if bits.size <= 5000:       # the reference's oracles walk symbol by symbol
        np.testing.assert_array_equal(ref_pf.decode_blockparallel(want),
                                      paper_format.decode_blockparallel(got))
        np.testing.assert_array_equal(paper_format.decode_sequential(got),
                                      ref_pf.decode_sequential(want))


def test_lut_step_matches_reference_scalar_and_vectorized():
    """``_decode_with_lut`` on an int (the reference's form) and on an
    array of bit positions (every thread's step at once)."""
    freqs = _FREQS[0]
    cb = huffman.Codebook.from_freqs(freqs, max_len=16)
    lut = paper_format.build_cascaded_lut(cb)
    np.testing.assert_array_equal(
        lut, ref_pf.build_cascaded_lut(
            ref_huffman.Codebook.from_freqs(freqs, max_len=16)))
    syms = np.random.default_rng(0).choice(16, 400, p=freqs / freqs.sum())
    enc, _ = cb.encode_symbols(syms)
    pos, starts = 0, []
    for _ in syms:
        starts.append(pos)
        got = paper_format._decode_with_lut(enc, lut, pos)
        assert got == ref_pf._decode_with_lut(enc, lut, pos)
        pos = got[2]
    x, l, nxt = paper_format._decode_with_lut(enc, lut, np.asarray(starts))
    np.testing.assert_array_equal(x, syms)
    np.testing.assert_array_equal(nxt - l, starts)


# -- the reference's own properties (tests/test_paper_format.py) --------------

def test_lut_cascade_structure():
    freqs = _FREQS[1]
    cb = huffman.Codebook.from_freqs(freqs, max_len=16)
    lut = paper_format.build_cascaded_lut(cb)
    assert lut.shape[1] == 256 and lut.shape[0] > 2
    np.testing.assert_array_equal(lut[-1, :16], cb.lengths[:16])
    assert (lut[0] >= paper_format.LUT_POINTER_BASE).any()


def test_lut_decode_matches_codebook():
    freqs = _FREQS[0]
    cb = huffman.Codebook.from_freqs(freqs, max_len=16)
    lut = paper_format.build_cascaded_lut(cb)
    rng = np.random.default_rng(0)
    syms = rng.choice(np.nonzero(freqs)[0], 500,
                      p=freqs[freqs > 0] / freqs.sum())
    enc, nbits = cb.encode_symbols(syms)
    pos = 0
    for want in syms:
        got, _, pos = paper_format._decode_with_lut(enc, lut, pos)
        assert got == want
    assert pos == nbits


def test_gaps_fit_four_bits():
    bits = stats.synthesize_fp8_weights((40_000,), alpha=1.2, seed=2)
    c = paper_format.encode(bits)
    gaps = fp8.unpack_nibbles(torch.from_numpy(c.gaps), len(c.gaps) * 2)
    assert int(gaps.max()) <= 15


def test_outpos_monotone_and_complete():
    bits = stats.synthesize_fp8_weights((30_000,), alpha=1.9, seed=3)
    c = paper_format.encode(bits)
    assert (np.diff(c.outpos) >= 0).all()
    assert c.outpos[0] == 0 and c.outpos[-1] == c.n_elem


def test_compressed_footprint_accounting():
    bits = stats.synthesize_fp8_weights((64, 1024), alpha=1.9, seed=4)
    c = paper_format.encode(bits)
    assert c.n_bytes_total == (c.encoded.nbytes + c.packed.nbytes
                               + c.lut.nbytes + c.gaps.nbytes
                               + c.outpos.nbytes)
    assert c.ratio < 1.0


@pytest.mark.parametrize("n", [1, 2, 127, 128, 1025])
def test_tiny_tensors(n):
    bits = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    c = paper_format.encode(bits)
    np.testing.assert_array_equal(paper_format.decode_blockparallel(c), bits)

"""The ECF8-FR compressed all-gather (``runtime/collectives.py``) against the
reference's ``runtime/collectives.py``: over 2 and 4 gloo ranks the
gathered weight is bit-exact, each rank's three byte arrays (codes, packed
escapes, packed sign/mantissa) equal the reference's ``encode_jnp`` of the
same rows, and ``calibrate`` and the overflow flag match; the wire cost
functions are the reference's."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fixedrate as ref_fixedrate  # noqa: E402
from repro.core import fp8 as ref_fp8  # noqa: E402
from repro.core import stats as ref_stats  # noqa: E402
from repro.runtime import collectives as RC  # noqa: E402

from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.runtime import collectives as C  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402


@pytest.fixture(scope="module")
def bits():
    """The reference's test weight (tests/test_sharding.py:157): fp8 bits
    of a (1024, 64) tensor with exponent concentration."""
    return np.array(ref_stats.synthesize_fp8_weights((1024, 64), alpha=1.8,
                                                     seed=0), np.uint8)


def test_calibrate_matches_reference(bits):
    for margin in (1.0, 1.3, 2.0):
        table, cap = C.calibrate(torch.from_numpy(bits), margin=margin)
        ref_table, ref_cap = RC.calibrate(bits, margin=margin)
        assert table.tolist() == np.asarray(ref_table).tolist()
        assert cap == ref_cap


@pytest.fixture(scope="module", params=[2, 4])
def gathered(request, bits):
    world = request.param
    table, cap = RC.calibrate(bits, margin=1.3)
    # a shard's capacity: its share of the escapes with a margin for skew
    # (the reference test's), and one too small, which must overflow
    cap_shard = max(2, math.ceil(cap / world * 1.5))
    cap_shard += cap_shard % 2
    caps = {"ok": cap_shard, "small": 2}
    out = MESH.spawn(R.gather_main, world, dict(
        bits=bits, table=np.asarray(table, np.uint8), caps=caps),
        device="cpu", timeout=300)
    return world, np.asarray(table, np.uint8), caps, out


def test_compressed_all_gather_bit_exact(bits, gathered):
    world, _, _, out = gathered
    for rank in out:
        full, over, _ = rank["ok"]
        assert not over
        np.testing.assert_array_equal(full, bits)


def test_wire_bytes_equal_reference_encode(bits, gathered):
    """Each rank's codes, packed escapes and packed sign/mantissa: the
    reference's ``encode_jnp`` of the same rows, byte for byte."""
    world, table, caps, out = gathered
    rows = bits.shape[0] // world
    for rank, got in enumerate(out):
        local = bits[rank * rows:(rank + 1) * rows].reshape(-1)
        codes, esc, sm, _ = ref_fixedrate.encode_jnp(
            jnp.asarray(local), jnp.asarray(table), caps["ok"])
        want = (np.asarray(codes), np.asarray(ref_fp8.pack_nibbles(
            esc, xp=jnp)), np.asarray(ref_fp8.pack_nibbles(sm, xp=jnp)))
        for g, w in zip(got["ok"][2], want):
            np.testing.assert_array_equal(g, w)


def test_overflow_flag_matches_reference(bits, gathered):
    """Too small a capacity: every rank sees the any-reduced overflow, as
    the reference's per-shard ``encode_jnp`` reports it on some shard."""
    world, table, caps, out = gathered
    rows = bits.shape[0] // world
    want = any(bool(ref_fixedrate.encode_jnp(
        jnp.asarray(bits[r * rows:(r + 1) * rows].reshape(-1)),
        jnp.asarray(table), caps["small"])[3]) for r in range(world))
    assert want
    assert all(rank["small"][1] == want for rank in out)


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.3])
def test_wire_cost_functions(frac):
    assert C.wire_bytes_per_elem(frac) == RC.wire_bytes_per_elem(frac)
    for dt in ("float8", "bfloat16", "float32"):
        assert C.raw_wire_bytes_per_elem(dt) == RC.raw_wire_bytes_per_elem(dt)

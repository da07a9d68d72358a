"""whisper-base, the encoder-decoder, in the port against the JAX package:
``encode_frames``, ``forward``, ``prefill(frames=...)`` (logits, self
K/V and cross K/V) and greedy ``decode_step``s, the ECF8 containers of the
encoder and of the cross attention, tokens from the ECF8 tree against the
fp8 tree's, ``layer_norm``, the engine's refusal of an encoder-decoder,
and ``forward`` on two decoder-only stacks (dense and mixture-of-experts,
its load-balancing loss included).

The weights are the reference's own smoke weights (2 + 2 layers, 16
frames) converted with ``repro_torch.convert``, with random norm scales
set in both trees (the reference draws zeros, under which a swapped
``norm_x`` / ``norm2`` would not show).  Tolerances: f32 values within
1e-5 absolute + 1e-5 relative (the same operations in another summation
order: the port runs the encoder's and the prefill's cross attention
through the flash forward's plain version, where the reference runs
``blockwise_attention``); greedy tokens, containers and the engine's
refusal exactly.  In bf16 the two frameworks' products round apart (the
encoder output differs by up to two bf16 steps whichever attention the
port runs, and teacher-forced greedy tokens part at about one step in 30
at this size), so tokens are held in f32 and bf16 values within 2^-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import store as ref_store  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as RM  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.core import store  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import EngineConfig, EngineConfigError, \
    GenerationEngine  # noqa: E402

ARCH = "whisper-base"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 2 ** -4
B, T, MAX_LEN, STEPS = 2, 5, 16, 8
MIN_ELEMS = 64          # every matrix of the smoke model is compressed


def _noisy_norms(tree, rng, path=()):
    """Random scales for every norm leaf (``norm*``, ``final_norm``)."""
    if isinstance(tree, dict):
        return {k: _noisy_norms(v, rng, path + (k,)) for k, v in tree.items()}
    if "norm" in path[-1]:
        return (rng.normal(size=tree.shape) * 0.3).astype(tree.dtype)
    return tree


def _greedy(step, logits, n):
    """``n`` greedy steps from prefill ``logits`` -> (tokens (B, n),
    [step logits])."""
    toks, outs = [], []
    tok = np.asarray(logits)[:, -1].argmax(-1)[:, None]
    for _ in range(n):
        toks.append(tok[:, 0])
        out = np.asarray(step(tok))
        outs.append(out)
        tok = out[:, -1].argmax(-1)[:, None]
    return np.stack(toks, 1), outs


def _ref_world(dtype):
    ref_cfg = dataclasses.replace(ref_smoke(ref_get(ARCH)), dtype=dtype)
    cfg = dataclasses.replace(smoke_variant(get(ARCH)), dtype=dtype)
    tree = _noisy_norms(jax.tree_util.tree_map(
        np.asarray, RM.init_params(jax.random.PRNGKey(0), ref_cfg)),
        np.random.default_rng(1))
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((B, cfg.encoder_frames, cfg.d_model)
                                 ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return cfg, ref_cfg, tree, frames, toks


@pytest.fixture(scope="module")
def world():
    """The reference's outputs on its smoke whisper, computed once."""
    cfg, ref_cfg, tree, frames, toks = _ref_world("float32")
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    f, t = jnp.asarray(frames), jnp.asarray(toks)
    ref = {"enc": np.asarray(RM.encode_frames(rp, ref_cfg, f, jnp.float32)),
           "fwd": np.asarray(RM.forward(rp, ref_cfg, t, frames=f)[0])}
    logits, cache = RM.prefill(rp, ref_cfg, t, frames=f, max_len=MAX_LEN)
    ref["prefill"] = np.asarray(logits)
    ref["cache"] = jax.tree_util.tree_map(np.asarray, cache)
    box = [cache]

    def step(tok):
        out, box[0] = RM.decode_step(rp, ref_cfg, jnp.asarray(tok, jnp.int32),
                                     box[0])
        return out

    ref["tokens"], ref["steps"] = _greedy(step, logits, STEPS)
    params = convert.params_from_numpy(tree, cfg, "cpu")
    return dict(cfg=cfg, ref_cfg=ref_cfg, rp=rp, params=params,
                frames=torch.from_numpy(frames), toks=torch.from_numpy(toks),
                ref=ref)


def _port_greedy(params, cfg, frames, toks):
    logits, cache = M.prefill(params, cfg, toks, max_len=MAX_LEN,
                              frames=frames)
    box = [cache]

    def step(tok):
        out, box[0] = M.decode_step(params, cfg, torch.from_numpy(tok).long(),
                                    box[0])
        return out.numpy()

    return logits, cache, _greedy(step, logits.numpy(), STEPS)


def test_param_tree_matches_reference(world):
    mine = M.init_params(world["cfg"], 0, "cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    assert shapes(mine) == shapes(world["params"])
    enc = mine["encoder"]
    assert enc["layers"]["attn"]["wq"].shape[0] == 2
    assert enc["pos_embed"].shape == (16, 64)
    assert set(mine["units"]["pos0"]) >= {"norm_x", "cross"}


def test_encode_frames_matches_reference(world):
    got = M.encode_frames(world["params"], world["cfg"], world["frames"],
                          torch.float32)
    np.testing.assert_allclose(got.numpy(), world["ref"]["enc"], **TOL)


def test_forward_logits_match_reference(world):
    logits, aux = M.forward(world["params"], world["cfg"],
                            world["toks"].long(), frames=world["frames"])
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), world["ref"]["fwd"], **TOL)


def test_prefill_logits_and_caches_match_reference(world):
    logits, cache = M.prefill(world["params"], world["cfg"],
                              world["toks"].long(), max_len=MAX_LEN,
                              frames=world["frames"])
    ref = world["ref"]
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], **TOL)
    assert int(cache["cur_len"]) == T
    for group in ("pos0", "cross"):
        for n in "kv":
            got = cache["units"][group][n].numpy()
            want = ref["cache"]["units"][group][n]
            assert got.shape == want.shape, (group, n)
            np.testing.assert_allclose(got, want, **TOL,
                                       err_msg=f"{group}/{n}")


def test_greedy_decode_matches_reference(world):
    _, cache, (toks, steps) = _port_greedy(
        world["params"], world["cfg"], world["frames"], world["toks"].long())
    ref = world["ref"]
    np.testing.assert_array_equal(toks, ref["tokens"])
    for got, want in zip(steps, ref["steps"]):
        np.testing.assert_allclose(got, want, **TOL)
    assert int(cache["cur_len"]) == T + STEPS


def test_prefill_without_frames_raises(world):
    with pytest.raises(ValueError, match="frames"):
        M.prefill(world["params"], world["cfg"], world["toks"].long())


def _containers(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _containers(v, path + (k,))
    elif hasattr(tree, "arrays"):
        yield path, tree


@pytest.mark.parametrize("part", ["encoder", "cross", "decoder"])
def test_containers_byte_identical_to_reference(world, part):
    """The encoder's stacked layers and ``pos_embed`` (a 2-D leaf), the
    decoder's cross attention, and the rest of the decoder compress into
    the reference's container bytes."""
    ref_c, ref_rep = ref_store.compress_tree(world["rp"], min_elems=MIN_ELEMS,
                                             out_dtype="float32")
    got_c, rep = store.compress_tree(world["params"], min_elems=MIN_ELEMS,
                                     out_dtype="float32")
    assert rep == ref_rep
    ref_map = dict(_containers(ref_c))
    mine = {p: ct for p, ct in _containers(got_c)
            if (p[0] == "encoder") == (part == "encoder")
            and ("cross" in p) == (part == "cross")}
    assert mine and set(mine) <= set(ref_map)
    if part == "encoder":
        assert ("encoder", "pos_embed") in mine
        assert ("encoder", "layers", "mlp", "wi") in mine
    for path, ct in mine.items():
        ref = ref_map[path]
        assert ct.meta.shape == tuple(ref.meta.shape), path
        for name, a in ct.arrays.items():
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(ref.arrays[name]),
                                          err_msg=f"{path}/{name}")


def test_ecf8_tokens_identical_to_fp8_tree(world):
    """Greedy tokens from the streamed ECF8 tree equal the fp8 tree's;
    both trees equal ``compress_tree`` / ``fp8_cast_tree`` of the f32
    draws of ``init_params``."""
    cfg = world["cfg"]

    def init(leaf=None):
        return M.init_params(cfg, 3, "cpu", leaf=leaf)

    ecf8, fp8_tree, report = store.build_trees(init, min_elems=MIN_ELEMS,
                                               out_dtype="float32")
    want_c, want_rep = store.compress_tree(init(), min_elems=MIN_ELEMS,
                                           out_dtype="float32")
    assert report == want_rep
    got, want = dict(_containers(ecf8)), dict(_containers(want_c))
    assert set(got) == set(want)
    assert ("encoder", "pos_embed") in got
    for path, ct in got.items():
        for name, a in ct.arrays.items():
            assert torch.equal(a, want[path].arrays[name]), (path, name)
    runs = [_port_greedy(tree, cfg, world["frames"], world["toks"].long())
            for tree in (ecf8, fp8_tree)]
    np.testing.assert_array_equal(runs[0][2][0], runs[1][2][0])
    np.testing.assert_array_equal(runs[0][0].numpy(), runs[1][0].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x, s, b = (rng.normal(size=n).astype(np.float32) * 3
               for n in ((3, 5, 64), 64, 64))
    got = layers.layer_norm(*(torch.from_numpy(a).to(getattr(torch, dtype))
                              for a in (x, s, b)))
    want = ref_layers.layer_norm(*(jnp.asarray(a, dtype) for a in (x, s, b)))
    # f32 within TOL (rsqrt and the sums round apart); bf16 exactly
    tol = TOL if dtype == "float32" else dict(rtol=0, atol=0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_bf16_values_within_tolerance():
    """bf16: the encoder output and the prefill logits within 2^-4 of the
    reference's (module docstring)."""
    cfg, ref_cfg, tree, frames, toks = _ref_world("bfloat16")
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    params = convert.params_from_numpy(tree, cfg, "cpu")
    f, t = torch.from_numpy(frames), torch.from_numpy(toks).long()
    enc = M.encode_frames(params, cfg, f, torch.bfloat16).float().numpy()
    want = RM.encode_frames(rp, ref_cfg, jnp.asarray(frames), jnp.bfloat16)
    np.testing.assert_allclose(enc, np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=BF16_ATOL)
    got, _ = M.prefill(params, cfg, t, max_len=MAX_LEN, frames=f)
    want, _ = RM.prefill(rp, ref_cfg, jnp.asarray(toks),
                         frames=jnp.asarray(frames), max_len=MAX_LEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BF16_ATOL)


def test_engine_refuses_the_encoder_decoder(world):
    """The engine refuses whisper (lenient and strict), as a draft too,
    and ``launch/serve.py --arch whisper-base`` exits with that error."""
    cfg = world["cfg"]
    for strict in (False, True):
        with pytest.raises(EngineConfigError, match="encoder-decoder"):
            EngineConfig().validate(cfg, strict=strict)
    with pytest.raises(EngineConfigError, match="encoder-decoder"):
        GenerationEngine(world["params"], cfg, device="cpu")
    with pytest.raises(EngineConfigError, match="encoder-decoder"):
        EngineConfig(draft_cfg=cfg, draft_params=world["params"]).validate(
            smoke_variant(get("qwen3-8b")))
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert e.value.code == 2


@pytest.mark.parametrize("arch", ["qwen3-8b", "moonshot-v1-16b-a3b"])
def test_forward_matches_reference_decoder_only(arch):
    """``forward`` on decoder-only stacks: logits within TOL and, for the
    mixture-of-experts family, the summed load-balancing loss too."""
    ref_cfg = ref_smoke(ref_get(arch))
    cfg = smoke_variant(get(arch))
    rp = RM.init_params(jax.random.PRNGKey(5), ref_cfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rp), cfg, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 11))
    want, want_aux = RM.forward(rp, ref_cfg, jnp.asarray(toks, jnp.int32))
    got, aux = M.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert (float(aux) > 0) == bool(cfg.n_experts)

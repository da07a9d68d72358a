"""The port's prefill and decode step factories on a mesh of ranks, and
whisper-base trained there, against the reference, on the CPU.

The ranks are gloo processes (``launch.mesh.spawn``) running
``tests/torch_steps_mesh_ranks.py::world_main``: a 4-rank and a 2-rank
world, spawned once for the module side by side, each running every mesh
of its own in turn.  The reference's mesh runs equal its one-device runs
on these stacks (f32 smoke variants, logits within 4e-6, tokens
identical), so its one-device functions are the oracle; moonshot's is the
reference's own mesh run, in a fresh process with four virtual devices
(its MoE routing may depend on the mesh's shape).

  * ``make_prefill_step(cfg, mesh=, max_len=)`` then four greedy
    ``make_decode_step(cfg, mesh=)`` calls on ``1x4``, ``2x2``, ``4`` and
    ``1x2``, each rank on its batch shard's rows (global batch 4), for
    whisper-base (with its frames), qwen3-8b (``max_len`` 32 and 30),
    gemma2-9b (40, past its window of 32, and 30) and recurrentgemma-2b
    (32): each rank's logits within 1e-5 of the reference's rows, its
    greedy tokens identical; moonshot on ``1x2`` and ``2`` likewise;
  * the rank cache: rows over the batch axes, each self-attention row
    whose length the model axis divides cut to the rank's positions, every
    other row, the cross K/V and the recurrent states whole (at d_model
    1024 too, where ``cache_pspecs`` would split a state's features); the
    flash kernel splitting the prefill's self-attention query rows
    (``q_base`` past the first model rank), never the encoder's or the
    cross attention's;
  * whisper-base's train step on ``2x2``, ``1x4`` and ``4`` under the
    sequence split and on ``1x2`` with the stream whole, against the
    reference's ``jax.jit(make_train_step(cfg, AdamWConfig(lr=1e-3),
    remat=False))`` on the same weights, tokens and frames: loss within
    rtol 2e-4, every updated parameter within atol 2e-4, the first moments
    within 2e-4 of the reference moment's largest magnitude; ``grad_accum
    =2`` with remat on ``2x2`` against the port's one-rank step.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticLMData as RefData  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim.adamw import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as ref_adamw_init  # noqa: E402
from repro.runtime.steps import make_train_step as ref_make_train_step  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init, iter_leaves  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402

import torch_steps_mesh_ranks as R  # noqa: E402
import torch_train_mesh_ranks as TR  # noqa: E402
from test_torch_train_mesh import _close_trees  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WHISPER, QWEN, GEMMA, RG = ("whisper-base", "qwen3-8b", "gemma2-9b",
                            "recurrentgemma-2b")
MOON = "moonshot-v1-16b-a3b"
B, STEPS, LOGIT_TOL = 4, 4, 1e-5
# {case: (arch, max_len, prompt length, config overrides)}: max_len 30 is
# a row length that a model axis of 4 does not divide; gemma2's 36-token
# prompt wraps its 32-position rings, its max_len 30 rings are the whole
# timeline, and its rings of 30 at max_len 40 wrap beside global rows that
# 4 divides
CASES = {f"{QWEN}/32": (QWEN, 32, 24, {}), f"{QWEN}/30": (QWEN, 30, 24, {}),
         f"{GEMMA}/40": (GEMMA, 40, 36, {}),
         f"{GEMMA}/30": (GEMMA, 30, 26, {}),
         f"{GEMMA}/40w30": (GEMMA, 40, 36, dict(local_window=30)),
         f"{RG}/32": (RG, 32, 24, {}),
         f"{WHISPER}/32": (WHISPER, 32, 24, {})}
MESHES4 = {"1x4": (1, 4), "2x2": (2, 2), "4": (4, 1)}
MESHES2 = {"1x2": (1, 2)}
MOON_MESHES = {"1x2": (1, 2), "2": (2, 1)}
MOON_CASE = (MOON, 32, 24)
# whisper trained at seq 16, the global batch 4, lr 1e-3
TRAIN4 = {"2x2": (2, 2, "seq", False, 1), "1x4": (1, 4, "seq", False, 1),
          "4": (4, 1, "seq", False, 1)}
ACCUM4 = {"2x2/accum2": (2, 2, "seq", True, 2)}
TRAIN2 = {"1x2/none": (1, 2, "none", False, 1)}
TRAIN_SEQ = 16
RTOL = ATOL = MOMENT_TOL = 2e-4
# recurrentgemma's smoke stack widened past cache_pspecs' 1024-feature rule
WIDE = (RG, dict(d_model=1024, n_layers=3), (1, 4), 32, 24)

_REF_MOON = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get, smoke_variant
from repro.models import model as M
from repro.runtime.steps import make_decode_step, make_prefill_step
cfg = smoke_variant(get('moonshot-v1-16b-a3b'))
params = M.init_params(jax.random.PRNGKey(0), cfg)
toks = jnp.asarray(np.load(__TOKS__))
devs = np.array(jax.devices()[:4])
out = {}
for name, dims in (('2', (2,)), ('1x2', (1, 2))):
    axes = ('data',) if len(dims) == 1 else ('data', 'model')
    mesh = Mesh(devs[:int(np.prod(dims))].reshape(dims), axes)
    with mesh:
        pre = jax.jit(make_prefill_step(cfg, mesh=mesh, max_len=__MAXLEN__))
        dec = jax.jit(make_decode_step(cfg, mesh=mesh))
        logits, cache = pre(params, {'tokens': toks})
        got, tok_list = [np.asarray(logits)[:, -1]], []
        for _ in range(__STEPS__):
            tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            tok_list.append(np.asarray(tok)[:, 0])
            logits, cache = dec(params, {'token': tok}, cache)
            got.append(np.asarray(logits)[:, -1])
    out[name] = (got, tok_list)
np.save(__OUT__, out, allow_pickle=True)
"""


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _greedy(prefill, decode):
    """The reference's prefill then ``STEPS`` greedy steps -> ([logits of
    each call (B, V)], [tokens of each step (B,)])."""
    logits, cache = prefill()
    out, toks = [np.asarray(logits)[:, -1]], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok)[:, 0])
        logits, cache = decode(tok, cache)
        out.append(np.asarray(logits)[:, -1])
    return out, toks


def _ref_runs(arch_params):
    """The reference's one-device prefill and greedy steps of every case."""
    rng = np.random.default_rng(3)
    frames = {WHISPER: rng.standard_normal(
        (B, ref_smoke(ref_get(WHISPER)).encoder_frames,
         ref_smoke(ref_get(WHISPER)).d_model)).astype(np.float32)}
    tokens, runs = {}, {}
    for case, (arch, max_len, T, over) in CASES.items():
        cfg = dataclasses.replace(ref_smoke(ref_get(arch)), **over)
        rp = arch_params[arch]
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        tokens[case] = toks
        f = jnp.asarray(frames[arch]) if arch in frames else None
        runs[case] = _greedy(
            lambda: RM.prefill(rp, cfg, jnp.asarray(toks), frames=f,
                               max_len=max_len),
            lambda tok, cache: RM.decode_step(rp, cfg, tok, cache))
    return tokens, frames, runs


def _ref_train(params):
    """The reference's one-device whisper train step on the smoke stack,
    and the port's one-rank step with grad_accum 2 and remat."""
    ref_cfg = ref_smoke(ref_get(WHISPER))
    frames = np.random.default_rng(4).standard_normal(
        (TR.BATCH, ref_cfg.encoder_frames, ref_cfg.d_model)).astype(
            np.float32)
    batch = dict(RefData(RefDataConfig(vocab_size=ref_cfg.vocab_size,
                                       seq_len=TRAIN_SEQ,
                                       global_batch=TR.BATCH)).batch(0))
    batch["frames"] = jnp.asarray(frames)
    step = jax.jit(ref_make_train_step(ref_cfg, RefAdamWConfig(lr=TR.LR),
                                       remat=False))
    p_ref, o_ref, m_ref = step(params, ref_adamw_init(params), batch,
                               jnp.zeros((), jnp.int32))
    cfg = R.smoke(WHISPER)
    p = convert._convert(_np_tree(params), R.CPU)
    pb = SyntheticLMData(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                    TR.BATCH)).batch(0, "cpu")
    pb["frames"] = torch.from_numpy(frames)
    p, o, m = make_train_step(cfg, AdamWConfig(lr=TR.LR), remat=True,
                              grad_accum=2)(p, adamw_init(p), pb, 0)
    return dict(frames=frames, loss=float(m_ref["loss"]),
                new_params=_ref_leaves(p_ref), mu=_ref_leaves(o_ref["mu"]),
                accum=dict(metrics={k: float(v) for k, v in m.items()},
                           params={k: v.detach().numpy()
                                   for k, v in iter_leaves(p)},
                           mu={k: v.numpy() for k, v in iter_leaves(o["mu"])}))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's runs here, its moonshot mesh runs in a fresh process
    with four virtual devices meanwhile."""
    work = tmp_path_factory.mktemp("steps_mesh")
    moon_toks = np.random.default_rng(5).integers(
        0, 512, (B, MOON_CASE[2])).astype(np.int32)
    np.save(work / "toks.npy", moon_toks)
    script = (textwrap.dedent(_REF_MOON)
              .replace("__TOKS__", repr(str(work / "toks.npy")))
              .replace("__OUT__", repr(str(work / "moon.npy")))
              .replace("__MAXLEN__", str(MOON_CASE[1]))
              .replace("__STEPS__", str(STEPS)))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        params = {arch: RM.init_params(jax.random.PRNGKey(0),
                                       ref_smoke(ref_get(arch)))
                  for arch in (WHISPER, QWEN, GEMMA, RG, MOON)}
        tokens, frames, runs = _ref_runs(params)
        train = _ref_train(params[WHISPER])
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return dict(params={a: _np_tree(p) for a, p in params.items()},
                tokens={**tokens, MOON: moon_toks}, frames=frames, runs=runs,
                moon=np.load(work / "moon.npy", allow_pickle=True).item(),
                train=train)


def _spec(ref, meshes, train, wide=None, moon=False):
    runs = {f"{case}@{tag}": (case, dims) for case in CASES
            for tag, dims in meshes.items()}
    cases = {case: (arch, max_len, over) for case, (arch, max_len, _, over)
             in CASES.items()}
    if moon:
        cases[MOON] = MOON_CASE[:2] + ({},)
        runs.update({f"{MOON}@{tag}": (MOON, dims)
                     for tag, dims in MOON_MESHES.items()})
    return dict(runs=runs, cases=cases, params=ref["params"],
                tokens=ref["tokens"], frames=ref["frames"], wide=wide,
                train=train, train_params=ref["params"][WHISPER],
                train_frames=ref["train"]["frames"], train_seq=TRAIN_SEQ)


@pytest.fixture(scope="module")
def worlds(ref):
    """The 4- and 2-rank worlds, spawned side by side."""
    with ThreadPoolExecutor(2) as pool:
        w4 = pool.submit(MESH.spawn, R.world_main, 4,
                         _spec(ref, MESHES4, {**TRAIN4, **ACCUM4}, WIDE),
                         device="cpu", timeout=600)
        w2 = pool.submit(MESH.spawn, R.world_main, 2,
                         _spec(ref, MESHES2, TRAIN2, moon=True),
                         device="cpu", timeout=600)
        return {4: w4.result(), 2: w2.result()}


def _world(worlds, dims):
    return worlds[dims[0] * dims[1]]


def _rows(dims, rank):
    per = B // dims[0]
    lo = rank // dims[1] * per
    return slice(lo, lo + per)


def _check_rank_runs(ranks, tag, dims, want_logits, want_tokens):
    for rank, r in enumerate(ranks):
        got = r["factory"][tag]
        rows = _rows(dims, rank)
        assert len(got["logits"]) == STEPS + 1
        for i, (g, w) in enumerate(zip(got["logits"], want_logits)):
            np.testing.assert_allclose(g, w[rows], atol=LOGIT_TOL, rtol=0,
                                       err_msg=f"{tag} rank {rank} call {i}")
        for g, w in zip(got["tokens"], want_tokens):
            np.testing.assert_array_equal(g, w[rows], err_msg=f"{tag} {rank}")


ALL_MESHES = {**MESHES4, **MESHES2}


@pytest.mark.parametrize("mesh", list(ALL_MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_factories_match_reference_single_device(worlds, ref, case, mesh):
    """Each rank's prefill and decode logits within 1e-5 of the
    reference's one-device rows, its greedy tokens identical."""
    dims = ALL_MESHES[mesh]
    want_logits, want_tokens = ref["runs"][case]
    _check_rank_runs(_world(worlds, dims), f"{case}@{mesh}", dims,
                     want_logits, want_tokens)


@pytest.mark.parametrize("mesh", list(MOON_MESHES))
def test_moe_factories_match_reference_mesh_run(worlds, ref, mesh):
    """moonshot's smoke stack through the factories: the reference's own
    run on the same mesh, rows and tokens."""
    dims = MOON_MESHES[mesh]
    want_logits, want_tokens = ref["moon"][mesh]
    _check_rank_runs(_world(worlds, dims), f"{MOON}@{mesh}", dims,
                     want_logits, want_tokens)


def _whole_shapes(cfg, b_loc: int, max_len: int) -> dict:
    cache = M.init_cache(cfg, b_loc, max_len, torch.float32, "meta")
    return {"/".join(k): tuple(v.shape)
            for k, v in SH.flatten(cache).items()}


@pytest.mark.parametrize("mesh", list(ALL_MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_rank_cache_layout(worlds, case, mesh):
    """The rank cache: its batch shard's rows; each self-attention row that
    the model axis divides cut to the rank's positions (``seq_split``);
    every other row, the cross K/V and the recurrent states whole; the
    whole length recorded.  The prefill's flash calls split the
    self-attention query rows where the model axis divides the prompt
    (``q_base`` on the model ranks past the first), never an encoder's or
    a cross attention's."""
    arch, max_len, T, over = CASES[case]
    dims = ALL_MESHES[mesh]
    n_model = dims[1]
    cfg = R.smoke(arch, **over)
    whole = _whole_shapes(cfg, B // dims[0], max_len)
    for rank, r in enumerate(_world(worlds, dims)):
        got = r["factory"][f"{case}@{mesh}"]
        want = dict(whole, max_len=())
        for section, key, kind in M.cache_groups(cfg):
            if M.seq_split(cfg, kind, max_len, SH.MeshShape(
                    ("data", "model"), dims)):
                for n in ("k", "v"):
                    s = list(whole[f"{section}/{key}/{n}"])
                    s[-2] //= n_model
                    want[f"{section}/{key}/{n}"] = tuple(s)
        assert got["shapes"] == want, (case, mesh, rank)
        split_q = n_model > 1 and T % n_model == 0
        # the self-attention layers that run the flash kernel: the global
        # ones, and a local one whose window covers the prompt
        n_self = sum(k in ("attn", "nope") or cfg.local_window >= T
                     for k in map(cfg.layer_kind, range(cfg.n_layers))
                     if k in M.ATTN_KINDS)
        n_cross = 2 * cfg.n_layers if cfg.encoder_decoder else 0
        assert got["flash"]["all"] == n_self + n_cross // 2 + (
            cfg.n_encoder_layers if cfg.encoder_decoder else 0), got
        past_first = rank % n_model != 0
        assert got["flash"]["q_base"] == (
            n_self if split_q and past_first else 0), (case, mesh, rank, got)


def test_unsplit_rows_decode_whole_on_the_model_axis(worlds, ref):
    """A row whose whole length the model axis does not divide stays whole
    on every rank and decodes without the stat merge: qwen3's max_len 30
    on ``1x4`` (``cache_pspecs`` splits its heads there), gemma2's rings of
    30 on ``1x4``, wrapped by the prompt, beside its global rows of 40 cut
    in four (a decode that took a whole ring for a quarter of 120
    positions would write and mask the wrong slots), and gemma2's
    30-position rings and rows cut in half on ``1x2``: all match the
    reference."""
    r4 = _world(worlds, (1, 4))[1]["factory"][f"{QWEN}/30@1x4"]
    assert r4["shapes"]["units/pos0/k"][-2] == 30
    w4 = _world(worlds, (1, 4))[1]["factory"][f"{GEMMA}/40w30@1x4"]
    assert w4["shapes"]["units/pos0/k"][-2] == 30
    assert w4["shapes"]["units/pos1/k"][-2] == 10
    r2 = _world(worlds, (1, 2))[1]["factory"][f"{GEMMA}/30@1x2"]
    assert r2["shapes"]["units/pos0/k"][-2] == 15
    assert r2["shapes"]["units/pos1/k"][-2] == 15
    for case, dims in ((f"{QWEN}/30", (1, 4)), (f"{GEMMA}/40w30", (1, 4)),
                       (f"{GEMMA}/30", (1, 2))):
        tag = f"{case}@{'x'.join(map(str, dims))}"
        _check_rank_runs(_world(worlds, dims), tag, dims, *ref["runs"][case])


def test_rank_cache_keeps_wide_states_whole(worlds):
    """At d_model 1024 ``cache_pspecs`` splits each RG-LRU state's features
    over ``model``; the rank cache keeps them whole (the decode step reads
    them whole) and cuts only the local ring's positions."""
    arch, over, dims, max_len, T = WIDE
    cfg = R.smoke(arch, **over)
    whole = _whole_shapes(cfg, B, max_len)
    specs = SH.flatten(SH.cache_pspecs(cfg, M.init_cache(
        cfg, B, max_len, torch.float32, "meta"), SH.MeshShape(
            ("data", "model"), dims)))
    assert specs[("units", "pos0", "h")][-1] == "model"
    for r in _world(worlds, dims):
        got = r["wide"]["shapes"]
        assert got["units/pos0/h"] == whole["units/pos0/h"]
        assert got["units/pos1/conv"] == whole["units/pos1/conv"]
        ring = list(whole["units/pos2/k"])
        ring[-2] //= dims[1]
        assert got["units/pos2/k"] == tuple(ring)
        np.testing.assert_array_equal(r["wide"]["tokens"][0],
                                      _world(worlds, dims)[0]["wide"][
                                          "tokens"][0])


@pytest.mark.parametrize("tag", [*TRAIN4, *TRAIN2])
def test_whisper_train_step_matches_reference(worlds, ref, tag):
    """whisper-base's sharded train step: the reference's one-device step
    (loss, updated parameters, first moments)."""
    ranks = worlds[4 if tag in TRAIN4 else 2]
    want = ref["train"]
    for r in ranks:
        np.testing.assert_allclose(r["train"][tag]["metrics"]["loss"],
                                   want["loss"], rtol=RTOL)
    got = ranks[0]["train"][tag]
    _close_trees(got["params"], want["new_params"], tag, ATOL)
    scale = max(float(np.abs(m).max()) for m in want["mu"].values())
    _close_trees(got["mu"], want["mu"], tag, MOMENT_TOL * scale)


def test_whisper_grad_accum_and_remat_match_one_rank(worlds, ref):
    tag, want = "2x2/accum2", ref["train"]["accum"]
    for r in worlds[4]:
        np.testing.assert_allclose(r["train"][tag]["metrics"]["loss"],
                                   want["metrics"]["loss"], rtol=RTOL)
        np.testing.assert_allclose(r["train"][tag]["metrics"]["grad_norm"],
                                   want["metrics"]["grad_norm"], rtol=RTOL)
    got = worlds[4][0]["train"][tag]
    _close_trees(got["params"], want["params"], tag, ATOL)
    scale = max(float(np.abs(m).max()) for m in want["mu"].values())
    _close_trees(got["mu"], want["mu"], tag, MOMENT_TOL * scale)


@pytest.mark.parametrize("tag", [*TRAIN4, *ACCUM4, *TRAIN2])
def test_whisper_flash_calls_on_the_mesh(worlds, tag):
    """The flash forward and backward run a micro-batch on each decoder
    self-attention, encoder and cross-attention layer (the forward again
    in the remat recompute of the decoder's units, not of the encoder's,
    which is not checkpointed); ``q_base`` only on the decoder's
    self-attention of the model ranks past the first."""
    d, m, rule, remat, accum = {**TRAIN4, **ACCUM4, **TRAIN2}[tag]
    cfg = R.smoke(WHISPER)
    n_dec, n_enc = cfg.n_layers, cfg.n_encoder_layers
    per_mb_fwd = n_enc + 2 * n_dec * (2 if remat else 1)
    per_mb_bwd = n_enc + 2 * n_dec
    for rank, r in enumerate(worlds[4 if tag in {**TRAIN4, **ACCUM4}
                                    else 2]):
        got = r["train"][tag]
        assert got["flash"] == {"fwd": per_mb_fwd * accum,
                                "bwd": per_mb_bwd * accum}, (rank, got)
        q = n_dec * accum if rank % m else 0
        assert got["q_base"] == {"fwd": q * (2 if remat else 1),
                                 "bwd": q}, (rank, got)

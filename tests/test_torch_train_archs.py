"""``loss_fn`` and its gradients against the JAX package for every assigned
architecture at smoke size (the reference's ``test_arch_smoke_train_step``
made a parity test), on the reference's weights converted with
``repro_torch.convert``; f32.

Tolerances, relative to the reference gradient leaf's largest magnitude
(the loss relative to itself), by family: 1e-5 where the mixer is
attention (dense, MoE, local / global, NoPE, the encoder-decoder; measured
at most 3.2e-6), 5e-5 for the recurrent families (recurrentgemma's RG-LRU
scan and xlstm's sLSTM loop and mLSTM chunks carry f32 states through
every position, summed in another order: measured 7.3e-6 and 1.0e-5)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.models import model as RM  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ASSIGNED, get, smoke_variant  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import iter_leaves  # noqa: E402

RECURRENT = {"rglru", "slstm", "mlstm"}


def _tolerance(cfg) -> float:
    return 5e-5 if RECURRENT & set(cfg.pattern) else 1e-5


@pytest.mark.parametrize("name", ASSIGNED)
def test_loss_and_grads_match_reference(name):
    cfg = smoke_variant(get(name))
    ref_cfg = ref_smoke(ref_get(name))
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    frames = None
    if cfg.encoder_decoder:
        frames = rng.normal(size=(2, cfg.encoder_frames,
                                  cfg.d_model)).astype(np.float32)

    def ref_loss(p):
        return RM.loss_fn(p, ref_cfg, jnp.asarray(toks), jnp.asarray(labels),
                          frames=None if frames is None
                          else jnp.asarray(frames))

    (want, want_met), want_g = jax.jit(jax.value_and_grad(
        ref_loss, has_aux=True))(ref_params)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    paths, leaves = zip(*iter_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, met = M.loss_fn(params, cfg, torch.from_numpy(toks),
                          torch.from_numpy(labels),
                          frames=None if frames is None
                          else torch.from_numpy(frames))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    tol = _tolerance(cfg)
    assert np.isfinite(float(loss))
    for got, ref, what in ((loss, want, "loss"), (met["nll"],
                                                  want_met["nll"], "nll"),
                           (met["aux"], want_met["aux"], "aux")):
        got, ref = float(got.detach()), float(ref)
        assert abs(got - ref) <= tol * max(abs(ref), 1e-6), (what, got, ref)
    flat = jax.tree_util.tree_flatten_with_path(want_g)[0]
    ref = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
           for path, v in flat}
    assert set(paths) == set(ref)
    gnorm = 0.0
    for path, g in zip(paths, grads):
        w = ref[path]
        got = np.zeros_like(w) if g is None else g.numpy()
        err = float(np.abs(got - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-30), (path, err)
        gnorm += float(np.sum(np.square(got)))
    assert np.isfinite(gnorm) and gnorm > 0

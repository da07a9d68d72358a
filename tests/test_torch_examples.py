"""The port's examples (``examples/torch_*.py``) on the CPU (``--device
cpu``: the kernels' plain versions), against the reference's ``repro.core``
and its examples' own inputs, at small sizes:

  * ``torch_quickstart``: on a 256 x 512 draw of the same seed, every
    round trip bit-exact, and the entropy, the fitted alpha, each
    container's bytes, bits a weight and savings equal to what the
    reference's ``repro.core`` gives for the same weights;
  * ``torch_compress_checkpoint``: its config at one layer and a vocabulary
    of 2048, made fp8 and trained-like, saved raw and ECF8, the ECF8 one
    restored bit-identical and smaller;
  * ``torch_serve_lm``: ``make_requests`` draws the reference example's
    stream (lengths and tokens); ``main`` on its first four requests
    prints ``IDENTICAL`` (the paged + compressed tokens the monolithic
    run's);
  * ``torch_train_lm``: its config's ``param_count()`` the reference
    example's, and two steps of it through ``launch/train.py`` at batch 2
    x 16 give finite losses.
"""
import importlib.util
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fixedrate as ref_fr  # noqa: E402
from repro.core import paper_format as ref_paper  # noqa: E402
from repro.core import stats as ref_stats  # noqa: E402
from repro.core import tpu_format as ref_tpu  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads a test: the plain decodes run many small
    operations, and beside other busy processes eight threads a process
    spin far longer than they compute (a restore here took 53 s at 8 and
    1.2 s at 4)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _example(name):
    """``examples/<name>.py`` as a module (the directory is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_figures_equal_the_reference_core():
    E = _example("torch_quickstart")
    w = ref_stats.synthesize_fp8_weights((256, 512), alpha=E.ALPHA, seed=0)
    got = E.report(w, torch.device("cpu"))
    s = ref_stats.summarize_tensor(w)
    paper, tpu, fr = ref_paper.encode(w), ref_tpu.encode(w), ref_fr.encode(w)
    assert got["entropy_bits"] == s["entropy_bits"]
    assert got["alpha_hat"] == s["alpha_hat"]
    assert got["tpu_ragged_bytes"] == tpu.nbytes("ragged")
    assert got["tpu_uniform_bytes"] == tpu.nbytes("uniform")
    assert got["esc_count"] == fr.esc_count
    want = dict(paper_bits=8 * paper.ratio,
                tpu_ragged_bits=8 * tpu.ratio("ragged"),
                tpu_uniform_bits=8 * tpu.ratio("uniform"),
                fr_bits=8 * fr.ratio,
                saving_paper=100 * (1 - paper.ratio),
                saving_tpu=100 * (1 - tpu.ratio("ragged")),
                saving_fr=100 * (1 - fr.ratio))
    for key, value in want.items():
        assert got[key] == value, (key, got[key], value)


def test_compress_checkpoint_restores_bit_identical(tmp_path):
    import dataclasses
    E = _example("torch_compress_checkpoint")
    from repro_torch.models import model as M
    dev = torch.device("cpu")
    cfg = dataclasses.replace(E.checkpoint_config(), n_layers=1,
                              vocab_size=2048)
    params = E.fp8_trained_like(M.init_params(cfg, 0, device="cpu"), dev)
    assert any(x.dtype == torch.float8_e4m3fn for _, x in E.leaves(params))
    sizes = E.round_trip(params, dev, str(tmp_path))
    assert 0 < sizes["ecf8_bytes"] < sizes["raw_bytes"]


def test_serve_example_is_lossless_on_the_reference_stream(capsys,
                                                           monkeypatch):
    E = _example("torch_serve_lm")
    ref = _example("serve_lm")
    from repro_torch.configs import get, smoke_variant
    V = smoke_variant(get("qwen3-8b")).vocab_size
    mine, theirs = E.make_requests(V), ref.make_requests(V)
    assert [(r.prompt, r.max_new_tokens) for r in mine] == \
        [(r.prompt, r.max_new_tokens) for r in theirs]
    stream = E.make_requests
    monkeypatch.setattr(E, "make_requests",
                        lambda vocab_size: stream(vocab_size)[:4])
    got = E.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "paged+compressed vs monolithic tokens: IDENTICAL" in out
    assert got["n_tokens"] == sum(r.max_new_tokens for r in theirs[:4])


def test_train_example_config_and_steps(tmp_path):
    E = _example("torch_train_lm")
    ref = _example("train_lm")
    cfg = E.make_100m()
    assert cfg.param_count() == ref.make_100m().param_count()
    losses = E.train(cfg, 2, 2, 16, str(tmp_path), "cpu")
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)

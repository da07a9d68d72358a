"""The port's checkpointing: ``tests/test_checkpoint.py``'s cases (all but
the restore onto a mesh, which waits for the port's multi-GPU slice), the
on-disk layout shared with the JAX package (each restores the other's
leaves bit for bit: the reference's f32, int32, bf16, raw fp8 and ECF8
leaves in the port; the port's f32, int32 and fp8, raw and ECF8, in the
reference), and the restart drill through ``repro_torch.launch.train`` on
the CPU."""
import glob
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as ref_mgr  # noqa: E402
from repro.core import stats as ref_stats  # noqa: E402

from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree  # noqa: E402
from repro_torch.checkpoint.manager import available_steps  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP8 = torch.float8_e4m3fn


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((32, 16), generator=g),
                   "norm": torch.ones((16,))},
        "opt": {"mu": torch.zeros((32, 16))},
        "step": torch.tensor(seed, dtype=torch.int32),
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a numpy array of unsigned ints."""
    width = {1: np.uint8, 2: np.uint16, 4: np.uint32}[t.element_size()]
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(view).numpy().view(width)


def _fp8_bits(shape, seed=0) -> np.ndarray:
    return ref_stats.synthesize_fp8_weights(shape, alpha=1.9, seed=seed)


def test_atomic_save_and_restore(tmp_path):
    d = str(tmp_path)
    t = _tree(3)
    save_tree(t, d, step=3)
    r, step = restore_tree(d, t, device="cpu")
    assert step == 3
    assert torch.equal(r["params"]["w"], t["params"]["w"])
    assert r["step"].dtype == torch.int32 and int(r["step"]) == 3


def test_crash_mid_write_leaves_no_visible_checkpoint(tmp_path):
    """A .tmp dir (simulated crash) is invisible to restore and GC'd."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    r, step = restore_tree(d, _tree(), device="cpu")
    assert r is None and step == -1
    mgr = CheckpointManager(d, keep=2)
    mgr.save_sync(1, _tree(1))
    assert not glob.glob(os.path.join(d, "*.tmp"))
    mgr.close()


def test_corruption_falls_back_to_previous(tmp_path):
    d = str(tmp_path)
    save_tree(_tree(1), d, step=1)
    save_tree(_tree(2), d, step=2)
    p = os.path.join(d, "step_00000002", "manifest.json")
    with open(p) as f:
        m = json.load(f)
    next(iter(m["leaves"].values()))["crc32"] = 123
    with open(p, "w") as f:
        json.dump(m, f)
    r, step = restore_tree(d, _tree(), device="cpu")
    assert step == 1
    assert int(r["step"]) == 1


def _garble_manifest(step_dir):
    with open(os.path.join(step_dir, "manifest.json"), "w") as f:
        f.write('{"step": 2, "leaves": {')


def _truncate_arrays(step_dir):
    p = os.path.join(step_dir, "arrays.npz")
    with open(p, "rb") as f:
        head = f.read(os.path.getsize(p) // 2)
    with open(p, "wb") as f:
        f.write(head)


def _drop_arrays(step_dir):
    os.remove(os.path.join(step_dir, "arrays.npz"))


def _reshape_in_manifest(step_dir):
    p = os.path.join(step_dir, "manifest.json")
    with open(p) as f:
        m = json.load(f)
    m["leaves"]["params\x1ew"]["shape"] = [16, 16]
    with open(p, "w") as f:
        json.dump(m, f)


@pytest.mark.parametrize("damage", [_garble_manifest, _truncate_arrays,
                                    _drop_arrays, _reshape_in_manifest])
def test_damaged_step_falls_back_to_previous(tmp_path, damage):
    """A truncated, garbled or missing file, or a manifest shape that is
    not the stored one, makes restore take the previous step."""
    d = str(tmp_path)
    save_tree(_tree(1), d, step=1)
    save_tree(_tree(2), d, step=2)
    damage(os.path.join(d, "step_00000002"))
    r, step = restore_tree(d, _tree(), device="cpu")
    assert step == 1 and int(r["step"]) == 1


def test_failed_decode_is_raised_not_skipped(tmp_path, monkeypatch):
    """An ECF8 leaf whose decode fails (on the card: a B1 launch that
    fails) stops the restore; it is not taken for a damaged step, which
    would resume silently from an older one."""
    from repro_torch.kernels import ops
    d = str(tmp_path)
    bits = _fp8_bits((64, 32))
    t = {"w8": torch.from_numpy(bits.copy()).view(FP8).reshape(64, 32)}
    save_tree(t, d, step=1, compress="ecf8")
    save_tree(t, d, step=2, compress="ecf8")

    def failed_launch(*args, **kwargs):
        raise RuntimeError("ecf8_decode: launch failed")

    monkeypatch.setattr(ops, "decode_ecf8", failed_launch)
    with pytest.raises(RuntimeError, match="launch failed"):
        restore_tree(d, t, device="cpu")


def test_async_and_retention(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2)
    trees = [_tree(s) for s in range(5)]
    for s, t in enumerate(trees):
        mgr.save_async(s, t)
        t["params"]["w"].add_(1.0)     # the snapshot was taken: no effect
    mgr.wait()
    steps = sorted(int(p[-8:]) for p in
                   glob.glob(os.path.join(d, "step_*")))
    assert steps == [3, 4]
    r, _ = mgr.restore(_tree(), device="cpu")
    assert torch.equal(r["params"]["w"], _tree(4)["params"]["w"])
    mgr.close()


def test_ecf8_compressed_checkpoint_bit_exact(tmp_path):
    d = str(tmp_path)
    bits = _fp8_bits((256, 128))
    t = {"w8": torch.from_numpy(bits.copy()).view(FP8).reshape(256, 128),
         "f32": torch.ones((4,))}
    save_tree(t, d, step=0, compress="ecf8")
    z = glob.glob(os.path.join(d, "step_00000000", "ecf8_*.npz"))
    assert z, "fp8 leaf was not ECF8-compressed"
    # the compressed file must actually be smaller than the raw fp8 bytes
    assert os.path.getsize(z[0]) < bits.nbytes
    r, _ = restore_tree(d, t, device="cpu")
    assert r["w8"].dtype == FP8 and r["w8"].shape == (256, 128)
    np.testing.assert_array_equal(_bits(r["w8"]), bits)


def test_bf16_leaves_restore_as_bf16(tmp_path):
    """A bf16 leaf is written as its 16-bit patterns (``|V2``) with the
    manifest dtype ``bfloat16`` and read back as the same bf16 bits."""
    d = str(tmp_path)
    w = torch.randn((7, 33), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    save_tree({"w": w}, d, step=5)
    with open(os.path.join(d, "step_00000005", "manifest.json")) as f:
        entry = json.load(f)["leaves"]["w"]
    assert entry["dtype"] == "bfloat16"
    with np.load(os.path.join(d, "step_00000005", "arrays.npz")) as z:
        assert z["w"].dtype == np.dtype("V2")
    r, _ = restore_tree(d, {"w": w}, device="cpu")
    assert r["w"].dtype == torch.bfloat16
    assert torch.equal(r["w"].view(torch.int16), w.view(torch.int16))


def test_close_surfaces_pending_write_errors(tmp_path):
    """A failed async write queued right before close() must raise, not
    be silently dropped."""
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2)
    mgr.save_async(0, _tree(0))
    mgr.wait()
    # an unserializable leaf makes the worker's write raise
    mgr.save_async(1, {"w": np.array([object()], dtype=object)})
    with pytest.raises(IOError, match="async checkpoint writes"):
        mgr.close()


def test_available_steps_skips_stray_entries(tmp_path):
    """A non-numeric step_foo/ dir must not take down restore."""
    d = str(tmp_path)
    save_tree(_tree(4), d, step=4)
    stray = os.path.join(d, "step_foo")
    os.makedirs(stray)
    with open(os.path.join(stray, "manifest.json"), "w") as f:
        f.write("{}")
    assert available_steps(d) == [4]
    r, step = restore_tree(d, _tree(), device="cpu")
    assert step == 4 and int(r["step"]) == 4


def test_restore_onto_shardings_is_refused(tmp_path):
    save_tree(_tree(1), str(tmp_path), step=1)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        restore_tree(str(tmp_path), _tree(), shardings={}, device="cpu")


@pytest.mark.slow
def test_concurrent_writers_do_not_destroy_each_other(tmp_path):
    """Interleaved save_async / save_sync / GC / restore on one directory:
    the regression drill for the tmp-dir race."""
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=3)
    errors = []

    def sync_writer():
        try:
            for s in range(30, 45):
                mgr.save_sync(s, _tree(s))
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(repr(e))

    def restorer():
        try:
            for _ in range(10):
                restore_tree(d, _tree(), device="cpu")
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=sync_writer),
               threading.Thread(target=restorer)]
    for s in range(15):
        mgr.save_async(s, _tree(s))  # each worker write runs _gc() too
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    mgr.wait()
    mgr.close()
    assert not errors, errors
    steps = available_steps(d)
    assert steps, "no checkpoint survived the stress run"
    r, step = restore_tree(d, _tree(), device="cpu")
    assert step == max(steps)
    assert int(r["step"]) == step
    mgr2 = CheckpointManager(d, keep=3)
    mgr2.save_sync(99, _tree(99))
    mgr2.close()
    assert not glob.glob(os.path.join(d, "*.tmp*"))


# -- the layout shared with the reference ------------------------------------

def _mixed_numpy():
    """f32, int32, bf16 and fp8 leaves as numpy (bf16 as its bit patterns,
    fp8 as its uint8 bits)."""
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(64, 48)).astype(np.float32)
    bf16 = (rng.normal(size=(33, 17)).astype(np.float32).view(np.uint32)
            >> 16).astype(np.uint16)
    return {"opt": {"mu": f32}, "params": {"w16": bf16,
                                           "w8": _fp8_bits((96, 128), 1),
                                           "raw8": _fp8_bits((40,), 2)},
            "step": np.asarray(7, np.int32)}


def _as_jax(a):
    conv = {"w16": lambda x: jax.lax.bitcast_convert_type(jnp.asarray(x),
                                                          jnp.bfloat16),
            "w8": lambda x: jnp.asarray(x).view(jnp.float8_e4m3fn),
            "raw8": lambda x: jnp.asarray(x).view(jnp.float8_e4m3fn)}
    return {"opt": {"mu": jnp.asarray(a["opt"]["mu"])},
            "params": {k: conv[k](x) for k, x in a["params"].items()},
            "step": jnp.asarray(a["step"])}


def _as_torch(a):
    conv = {"w16": lambda x: torch.from_numpy(x.view(np.int16)).view(
                torch.bfloat16),
            "w8": lambda x: torch.from_numpy(x).view(FP8),
            "raw8": lambda x: torch.from_numpy(x).view(FP8)}
    return {"opt": {"mu": torch.from_numpy(a["opt"]["mu"])},
            "params": {k: conv[k](x) for k, x in a["params"].items()},
            "step": torch.from_numpy(a["step"])}


@pytest.mark.parametrize("compress", ["none", "ecf8"])
def test_reference_checkpoint_restores_bit_exact_in_port(tmp_path, compress):
    """f32, int32, bf16 and fp8 (raw, or ECF8 with ``compress="ecf8"``)
    leaves written by the reference's ``save_tree`` restore in the port
    with their dtypes and bits."""
    a = _mixed_numpy()
    d = str(tmp_path)
    ref_mgr.save_tree(_as_jax(a), d, step=7, compress=compress)
    if compress == "ecf8":
        assert len(glob.glob(os.path.join(d, "step_00000007",
                                          "ecf8_*.npz"))) == 2
    r, step = restore_tree(d, _as_torch(a), device="cpu")
    assert step == 7
    assert r["opt"]["mu"].dtype == torch.float32
    np.testing.assert_array_equal(r["opt"]["mu"].numpy(), a["opt"]["mu"])
    assert r["step"].dtype == torch.int32 and int(r["step"]) == 7
    assert r["params"]["w16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(r["params"]["w16"]),
                                  a["params"]["w16"])
    for k in ("w8", "raw8"):
        assert r["params"][k].dtype == FP8
        np.testing.assert_array_equal(_bits(r["params"][k]), a["params"][k])


@pytest.mark.parametrize("compress", ["none", "ecf8"])
def test_port_checkpoint_restores_in_reference(tmp_path, compress):
    """f32, int32 and fp8 (raw and ECF8) leaves written by the port restore
    in the reference bit for bit, its CRCs verified; the container files
    are byte-identical to the ones the reference writes."""
    a = _mixed_numpy()
    del a["params"]["w16"]          # the reference cannot use bf16 (|V2)
    d_port, d_ref = str(tmp_path / "port"), str(tmp_path / "ref")
    save_tree(_as_torch(a), d_port, step=3, compress=compress)
    tpl = _as_jax(a)
    r, step = ref_mgr.restore_tree(d_port, tpl)
    assert step == 3
    np.testing.assert_array_equal(np.asarray(r["opt"]["mu"]), a["opt"]["mu"])
    assert np.asarray(r["step"]).dtype == np.int32
    assert int(np.asarray(r["step"])) == 7
    for k in ("w8", "raw8"):
        np.testing.assert_array_equal(np.asarray(r["params"][k]).view(
            np.uint8), a["params"][k])
    # the same manifest and container bytes as the reference's own write
    ref_mgr.save_tree(tpl, d_ref, step=3, compress=compress)
    manifests = []
    for d in (d_port, d_ref):
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    for fn in glob.glob(os.path.join(d_ref, "step_00000003", "ecf8_*.npz")):
        with np.load(fn) as want, np.load(os.path.join(
                d_port, "step_00000003", os.path.basename(fn))) as got:
            assert sorted(got.files) == sorted(want.files)
            for f in want.files:
                np.testing.assert_array_equal(got[f], want[f])


# -- the restart drill -------------------------------------------------------

@pytest.mark.slow
def test_train_failure_restart_continuity(tmp_path):
    """Kill the trainer mid-run (os._exit at step 25), restart, and verify
    the run resumes from the checkpoint and completes.  The latest durable
    checkpoint is the periodic one at step 20, unless a straggler alarm in
    steps 21-24 eager-saved a later one (host jitter on a shared CPU; the
    reference's jitted steps stay under the monitor's 50 ms floor)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-8b", "--smoke", "--device", "cpu", "--steps", "40",
            "--batch", "2", "--seq-len", "16", "--save-every", "10",
            "--log-every", "100", "--ckpt-dir", str(tmp_path)]
    p1 = subprocess.run(args + ["--fail-at-step", "25"], env=env,
                        capture_output=True, text=True, timeout=300)
    assert p1.returncode == 42, p1.stderr[-2000:]
    assert "simulating hard failure at step 25" in p1.stdout
    eager = {int(s) for s in re.findall(r"straggler alarm at step (\d+)",
                                        p1.stdout)}
    p2 = subprocess.run(args, env=env, capture_output=True, text=True,
                        timeout=300)
    assert p2.returncode == 0, p2.stderr[-2000:]
    got = re.search(r"resumed from step (\d+) -> starting at (\d+)",
                    p2.stdout)
    assert got, p2.stdout
    at, start = int(got.group(1)), int(got.group(2))
    assert at in {20} | {s for s in eager if 20 < s < 25}, (at, eager)
    assert start == at + 1
    if not eager & set(range(21, 25)):
        assert "resumed from step 20 -> starting at 21" in p2.stdout
    assert "done at step 39" in p2.stdout

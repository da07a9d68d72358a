"""Fault-tolerant checkpointing: atomic, checksummed, async, ECF8-compressed
(the reference's ``checkpoint/manager.py`` over trees of torch tensors, on
the reference's on-disk layout).

  * **Atomic**: a checkpoint is written into ``step_XXXXXXXX.tmp.<pid>.<tid>``
    and renamed into place; the manifest is written last, so a visible
    ``step_XXXXXXXX`` directory with a manifest is complete.  A crash
    mid-write leaves only a ``.tmp`` that restore ignores and the next
    save's garbage collection removes (never one a live writer owns).
  * **Checksummed**: every leaf's CRC32 (zlib, over its bytes) is in the
    manifest; ``restore`` verifies it and falls back to the previous
    checkpoint on a mismatch.
  * **Async**: ``save_async`` copies the tree to host memory now (training
    may then update its tensors in place) and writes on a background
    thread; ``wait`` and ``close`` raise the errors of failed writes.
  * **ECF8**: with ``compress="ecf8"`` every fp8 leaf is encoded into the
    ECF8-TPU container (``core/tpu_format``, on the leaf's device, when the
    tree is snapshotted) and written as ``ecf8_<i>.npz``; a restore onto
    the card decodes it with the ECF8 decode kernel (``ops.decode_ecf8``,
    B1), the reference decoding with its jnp twin, and checks the decoded
    bits against the CRC.

Layout (the reference's, so each restores the other's leaves):

    <root>/step_00000042/
        manifest.json   {step, compress, leaves: {key: {shape, dtype, crc32,
                         format, file[, stored_as]}}}
        arrays.npz      raw leaves by key
        ecf8_<i>.npz    compressed fp8 leaves (payload, signmant, lj_limit,
                        first_lj, offset, perm, lengths, meta=[n_elem,
                        sym_per_lane]), i the leaf's rank in key order

Keys are a leaf's dict keys joined by ``\\x1e``, leaves taken in sorted key
order.  An fp8 leaf is stored as its uint8 bits (``stored_as``
``uint8_bits``); a bf16 leaf as its 16-bit patterns in a ``|V2`` array,
which is what ``np.savez`` makes of the reference's bf16 arrays, with the
manifest ``dtype`` ``bfloat16``: the port restores it as bf16 bits (the
reference hands a ``|V2`` array back and cannot use it).

Not yet ported: the reference's elastic restore onto a mesh
(``shardings``), which waits for the port's multi-GPU slice.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import zipfile
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..core import tpu_format
from ..device import resolve
from ..kernels import ops

_SEP = "\x1e"  # path separator in flattened keys (never appears in names)
_FP8 = torch.float8_e4m3fn
_ECF8_FIELDS = ("payload", "signmant", "lj_limit", "first_lj", "offset",
                "perm", "lengths")
# what a damaged or partial checkpoint raises while it is read (a missing
# file, a checksum mismatch, a truncated or garbled npz or manifest, a
# missing key, a size that is not the manifest's); anything else, such as
# a kernel that fails to launch, is not a reason to try an older step
_CORRUPT = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)

# live tmp-dir registry: every in-flight ``save_tree`` in this process
# registers its (unique) tmp path here so GC never reclaims a directory a
# concurrent writer is still filling.  Tmp names carry the owning pid so a
# *different* process's GC can tell a live foreign writer from the orphan
# of a crashed one.
_TMP_LOCK = threading.Lock()
_LIVE_TMPS: set = set()


def _tmp_is_orphan(path: str) -> bool:
    """True when a ``step_XXXXXXXX.tmp[.pid.tid]`` dir belongs to no live
    writer and is safe to garbage-collect."""
    with _TMP_LOCK:
        if path in _LIVE_TMPS:
            return False
    name = os.path.basename(path)
    if name.endswith(".tmp"):
        return True                     # unowned: only a crash leaves one
    parts = name.rsplit(".", 2)         # step_XXXXXXXX.tmp, pid, tid
    try:
        pid = int(parts[1])
    except (IndexError, ValueError):
        return True
    if pid == os.getpid():
        return True                     # ours but unregistered: finished
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True                     # owning process is gone
    except OSError:
        pass                            # e.g. EPERM: alive, other user
    return False


def _flatten(tree, path=()) -> dict:
    """{key: leaf} of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], path + (str(k),)))
        return out
    return {_SEP.join(path): tree}


def _unflatten_like(template, flat: dict, path=()):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, path + (str(k),))
                for k, v in template.items()}
    return flat[_SEP.join(path)]


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).view(np.uint8))


@dataclass
class _HostLeaf:
    """One leaf in host memory: ``bits`` its values (bf16 and fp8 as their
    16- / 8-bit patterns), ``dtype`` the manifest's name, ``ecf8`` the
    encoded container's arrays (numpy) when it is written compressed."""
    bits: np.ndarray
    dtype: str
    ecf8: dict | None = None


def _host_leaf(x, compress: str) -> _HostLeaf:
    if not torch.is_tensor(x):
        a = np.asarray(x)
        return _HostLeaf(a, str(a.dtype))
    x = x.detach().contiguous()

    def host(t):        # a copy: the caller may update ``x`` in place
        return t.to("cpu", copy=True).numpy()

    if x.dtype == _FP8:
        bits = x.view(torch.uint8)
        ecf8 = None
        if compress == "ecf8":
            c = tpu_format.encode(bits.reshape(-1))
            ecf8 = {f: host(getattr(c, f)) for f in _ECF8_FIELDS}
            ecf8["meta"] = np.asarray([c.n_elem, c.sym_per_lane])
        return _HostLeaf(host(bits), "float8_e4m3fn", ecf8)
    if x.dtype == torch.bfloat16:
        return _HostLeaf(host(x.view(torch.int16)).view(np.uint16),
                         "bfloat16")
    a = host(x)
    return _HostLeaf(a, str(a.dtype))


def _snapshot(tree, compress: str) -> dict:
    """The tree in host memory, {key: leaf}: what a save writes.  fp8 leaves
    are ECF8-encoded here when ``compress="ecf8"``."""
    if compress not in ("none", "ecf8"):
        raise ValueError(f"compress={compress!r} (none or ecf8)")
    return {k: _host_leaf(v, compress)
            for k, v in _flatten(tree).items()}


def save_tree(tree, directory: str, step: int, compress: str = "none"):
    """Synchronous atomic checkpoint write of ``tree`` (tensors on any
    device).  compress: none|ecf8."""
    return _write(_snapshot(tree, compress), directory, step, compress)


def _write(flat: dict, directory: str, step: int, compress: str):
    """Write a :func:`_snapshot`.  Each writer gets a **unique** tmp dir
    (``step_XXXXXXXX.tmp.<pid>.<tid>``) registered in the live-writer set,
    so concurrent writers (the async worker and a ``save_sync``, or two
    processes sharing a directory) never delete each other's work and GC
    only reclaims orphans."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = f"{final}.tmp.{os.getpid()}.{threading.get_ident()}"
    with _TMP_LOCK:
        _LIVE_TMPS.add(tmp)
    try:
        return _save_into(flat, tmp, final, step, compress)
    finally:
        with _TMP_LOCK:
            _LIVE_TMPS.discard(tmp)
        shutil.rmtree(tmp, ignore_errors=True)   # no-op after rename


def _save_into(flat: dict, tmp: str, final: str, step: int, compress: str):
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "compress": compress, "leaves": {}}
    raw = {}
    for i, (key, leaf) in enumerate(sorted(flat.items())):
        entry = {"shape": list(leaf.bits.shape), "dtype": leaf.dtype,
                 "crc32": _crc(leaf.bits)}
        if leaf.ecf8 is not None:
            fn = f"ecf8_{i}.npz"
            np.savez(os.path.join(tmp, fn), **leaf.ecf8)
            entry.update(format="ecf8", file=fn)
        else:
            if leaf.dtype == "float8_e4m3fn":
                raw[key] = leaf.bits
                entry["stored_as"] = "uint8_bits"
            elif leaf.dtype == "bfloat16":
                raw[key] = leaf.bits.view(np.dtype("V2"))
            else:
                raw[key] = leaf.bits
            entry.update(format="raw", file="arrays.npz")
        manifest["leaves"][key] = entry
    np.savez(os.path.join(tmp, "arrays.npz"), **raw)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    try:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except OSError:
        # another writer renamed its copy of this step between our rmtree
        # and rename: the step is durable either way, discard our tmp
        if not os.path.isfile(os.path.join(final, "manifest.json")):
            raise
        shutil.rmtree(tmp, ignore_errors=True)
    return final


def _decode_ecf8(path: str, entry: dict, dev: torch.device) -> torch.Tensor:
    """An ``ecf8_<i>.npz`` leaf -> its fp8 bits (uint8, flat) on ``dev``,
    decoded by B1 on the card (its plain version on the CPU)."""
    with np.load(os.path.join(path, entry["file"])) as z:
        a = {f: torch.from_numpy(z[f]).to(dev) for f in _ECF8_FIELDS}
        n_elem, spl = (int(v) for v in z["meta"])
    return ops.decode_ecf8(a["payload"], a["signmant"], a["lj_limit"],
                           a["first_lj"], a["offset"], a["perm"],
                           sym_per_lane=spl, n_elem=n_elem)


def _check_size(n: int, shape: tuple, key: str) -> None:
    if n != int(np.prod(shape)):
        raise ValueError(f"{key}: {n} elements stored, the manifest's "
                         f"shape is {list(shape)}")


def _load_dir(path: str, template_tree, dev: torch.device,
              verify: bool = True):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        for key in _flatten(template_tree):
            entry = manifest["leaves"][key]
            shape, dtype = tuple(entry["shape"]), entry["dtype"]
            if entry["format"] == "ecf8":
                t = _decode_ecf8(path, entry, dev)
                _check_size(t.numel(), shape, key)
                bits = t.cpu().numpy()
                t = t.view(_FP8).reshape(shape)
            else:
                bits = npz[key]
                _check_size(bits.size, shape, key)
                if dtype == "bfloat16":       # |V2 (or uint16) patterns
                    bits = bits.view(np.uint16)
                    t = torch.from_numpy(bits.view(np.int16)).view(
                        torch.bfloat16)
                elif entry.get("stored_as") == "uint8_bits":
                    t = torch.from_numpy(bits).view(_FP8)
                else:
                    t = torch.from_numpy(bits)
                t = t.reshape(shape).to(dev)
            if verify and _crc(bits) != entry["crc32"]:
                raise IOError(f"checksum mismatch for {key} in {path}")
            out[key] = t
    return _unflatten_like(template_tree, out), manifest["step"]


def restore_tree(directory: str, template_tree, shardings=None,
                 step: int | None = None, verify: bool = True,
                 device="cuda"):
    """Restore the latest (or given) valid checkpoint onto ``device`` (the
    card unless the caller asks for the CPU), shaped as ``template_tree``.
    Returns (tree, step) or (None, -1) when nothing restorable exists.  A
    damaged step is skipped for an older one; any other error (a failed
    decode launch) is raised."""
    if shardings is not None:
        raise NotImplementedError(
            "restore onto shardings: not yet ported (the port restores onto "
            "one device)")
    dev = resolve(device)
    steps = available_steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
    for s in sorted(steps, reverse=True):
        path = os.path.join(directory, f"step_{s:08d}")
        try:
            return _load_dir(path, template_tree, dev, verify=verify)
        except _CORRUPT as e:       # damaged: try an older one
            print(f"[checkpoint] skipping {path}: {e}")
    return None, -1


def available_steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not name.startswith("step_") or ".tmp" in name:
            continue
        if not os.path.exists(os.path.join(directory, name,
                                           "manifest.json")):
            continue
        try:
            out.append(int(name[5:]))
        except ValueError:
            # stray entry (step_foo/, junk from an interrupted copy): skip
            # it instead of taking down restore
            print(f"[checkpoint] ignoring stray entry {name!r} in "
                  f"{directory}")
    return sorted(out)


@dataclass
class CheckpointManager:
    """Async checkpoint manager with retention and auto-resume."""

    directory: str
    keep: int = 3
    compress: str = "none"

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._errors: list = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, flat = item
            try:
                _write(flat, self.directory, step, self.compress)
                self._gc()
            except Exception as e:  # noqa: BLE001 — surfaced by wait/close
                self._errors.append((step, repr(e)))
            finally:
                self._q.task_done()

    def _gc(self):
        steps = available_steps(self.directory)
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
        # stale tmp dirs from crashes, never one a live writer owns
        for name in os.listdir(self.directory):
            if ".tmp" not in name:
                continue
            path = os.path.join(self.directory, name)
            if _tmp_is_orphan(path):
                shutil.rmtree(path, ignore_errors=True)

    def save_async(self, step: int, tree):
        """Snapshot to host now; write on the background thread."""
        self._q.put((step, _snapshot(tree, self.compress)))

    def save_sync(self, step: int, tree):
        save_tree(tree, self.directory, step, compress=self.compress)
        self._gc()

    def wait(self):
        self._q.join()
        if self._errors:
            errs, self._errors = self._errors, []
            raise IOError(f"async checkpoint writes failed: {errs}")

    def restore(self, template_tree, device="cuda"):
        self.wait()
        return restore_tree(self.directory, template_tree, device=device)

    def close(self):
        """Drain the queue, stop the worker, and raise any pending write
        errors (a failed final async save must not be swallowed)."""
        self._q.put(None)
        self._q.join()
        self._thread.join(timeout=30.0)
        if self._errors:
            errs, self._errors = self._errors, []
            raise IOError(f"async checkpoint writes failed: {errs}")

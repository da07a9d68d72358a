"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function that launches its
kernel on the stream it is given and returns ``cudaGetLastError()``.  It is
compiled for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` at the
repository root, keyed by a hash of the source so an edited source is
rebuilt; nothing is compiled or imported until a kernel is first needed.

    python -c "from repro_torch.kernels import build; print(build.build())"
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("ecf8_decode", "flash_fwd", "kv_page_decode",
           "fused_decode_matmul", "flash_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}
_n_built = 0            # sources compiled by this process


def events() -> int:
    """Kernel builds and library loads so far in this process: the count
    behind the serving engine's compile counters (which read it as a delta,
    so a process whose kernels are already loaded reads 0)."""
    return _n_built + len(_loaded)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``,
    else the one on ``PATH``; raises when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile every source in ``names`` that has no library yet, one
    ``nvcc`` per source, all started together.  Returns
    ``{name: (seconds, ptxas report)}`` for the sources it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    global _n_built
    exe = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        tmp.replace(library_path(n))
        _n_built += 1
        out[n] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str, argtypes: list) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use); its
    entry point ``name`` gets ``argtypes`` and an int return."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]

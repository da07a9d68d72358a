"""Compressed parameter store (the paper's §3.3 tensor manager).

Parameters are a nested dict in which large weights are
``CompressedTensor`` leaves; model code calls :func:`materialize` at the
point of use (``models/layers.py::mat``), so only one decoded weight is
alive at a time.  Stacked layer weights (``params["units"]``) carry a
leading layer dim in every child tensor; :meth:`CompressedTensor.layer`
slices one layer's container out (views, no copy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from . import fp8, tpu_format
from ..kernels import ops

FORMAT_TPU = "tpu"          # ECF8-TPU interleaved Huffman (uniform layout)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """``torch.dtype`` for a dtype name of the configs ("bfloat16", ...)."""
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


@dataclass(frozen=True)
class CompressedMeta:
    fmt: str
    shape: tuple
    n_elem: int
    sym_per_lane: int = 0
    out_dtype: str = "bfloat16"


@dataclass
class CompressedTensor:
    """A compressed fp8 weight; decodes on use."""

    arrays: dict  # name -> torch.Tensor
    meta: CompressedMeta

    @property
    def shape(self):  # so shape-inspecting model code keeps working
        return self.meta.shape

    @property
    def ndim(self):
        return len(self.meta.shape)

    def nbytes_compressed(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    def layer(self, i: int) -> "CompressedTensor":
        """Layer ``i`` of a stacked container (views of its tensors)."""
        return CompressedTensor({k: a[i] for k, a in self.arrays.items()},
                                self.meta)


def is_compressed(x: Any) -> bool:
    return isinstance(x, CompressedTensor)


def materialize(x, dtype=None):
    """Decode a CompressedTensor to a dense tensor (cast for tensors)."""
    if not is_compressed(x):
        return x if dtype is None else x.to(torch_dtype(dtype))
    m = x.meta
    a = x.arrays
    if m.fmt != FORMAT_TPU:
        raise ValueError(f"unknown format {m.fmt}")
    # the decode writes the dtype itself: no cast follows it
    w = ops.decode_ecf8(a["payload"], a["signmant"], a["lj_limit"],
                        a["first_lj"], a["offset"], a["perm"],
                        sym_per_lane=m.sym_per_lane, n_elem=m.n_elem,
                        out_dtype=torch_dtype(dtype if dtype is not None
                                              else m.out_dtype))
    return w.reshape(m.shape)


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------

def compress_array(w8_bits: torch.Tensor, fmt: str = FORMAT_TPU,
                   out_dtype: str = "bfloat16",
                   sym_per_lane: int = tpu_format.DEFAULT_SYM_PER_LANE,
                   ) -> CompressedTensor:
    """Compress one fp8 tensor (uint8 bit view, any shape)."""
    if fmt != FORMAT_TPU:
        raise ValueError(f"format {fmt!r}: not yet ported (only 'tpu')")
    c = tpu_format.encode(w8_bits, sym_per_lane=sym_per_lane)
    arrays = {"payload": c.payload, "signmant": c.signmant,
              "lj_limit": c.lj_limit, "first_lj": c.first_lj,
              "offset": c.offset, "perm": c.perm}
    meta = CompressedMeta(fmt=fmt, shape=tuple(c.shape), n_elem=c.n_elem,
                          sym_per_lane=c.sym_per_lane, out_dtype=out_dtype)
    return CompressedTensor(arrays=arrays, meta=meta)


def compress_stacked(w8_bits_stack: torch.Tensor, fmt: str = FORMAT_TPU,
                     out_dtype: str = "bfloat16",
                     sym_per_lane: int = tpu_format.DEFAULT_SYM_PER_LANE,
                     ) -> CompressedTensor:
    """Compress a (layers, ...) stacked fp8 tensor layer-by-layer.

    Per-layer codebooks are kept; payload strides are padded to the
    per-stack max so the stack is rectangular (the padded bytes count in
    the report, as in the reference)."""
    per_layer = [compress_array(w8_bits_stack[i], fmt=fmt,
                                out_dtype=out_dtype,
                                sym_per_lane=sym_per_lane)
                 for i in range(w8_bits_stack.shape[0])]
    stride = max(ct.arrays["payload"].shape[1] for ct in per_layer)
    for ct in per_layer:
        p = ct.arrays["payload"]
        if p.shape[1] < stride:
            ct.arrays["payload"] = torch.nn.functional.pad(
                p, (0, 0, 0, stride - p.shape[1]))
    arrays = {k: torch.stack([ct.arrays[k] for ct in per_layer])
              for k in per_layer[0].arrays}
    return CompressedTensor(arrays=arrays, meta=per_layer[0].meta)


def _stacked(path) -> int:
    return int("units" in path or "layers" in path)


def _selected(path, x, min_elems: int) -> bool:
    """The reference's leaf-selection rule: a tensor whose per-layer
    element count reaches ``min_elems`` and that is at least 2-D per
    layer (norm scales and biases stay as they are)."""
    stacked = _stacked(path)
    n = x.numel()
    per_layer = n // x.shape[0] if (stacked and x.ndim) else n
    return per_layer >= min_elems and x.ndim >= 2 + stacked


def _map_tree(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def compress_tree(params, fmt: str = FORMAT_TPU, min_elems: int = 65536,
                  out_dtype: str = "bfloat16"):
    """Cast a parameter tree to fp8 and compress the large leaves.

    Leaves under a "units"/"layers" key are stacked over their leading
    (layer) dim.  Returns (compressed_tree, report dict) with the
    reference's byte counts."""
    report = {"raw_bytes": 0, "fp8_bytes": 0, "compressed_bytes": 0,
              "n_compressed": 0, "n_kept": 0}

    def visit(path, x):
        if not isinstance(x, torch.Tensor):
            report["n_kept"] += 1
            return x
        n = x.numel()
        report["raw_bytes"] += n * x.element_size()
        if not _selected(path, x, min_elems):
            report["n_kept"] += 1
            return x
        w8 = fp8.cast_to_fp8_bits(x)
        report["fp8_bytes"] += n
        if _stacked(path):
            ct = compress_stacked(w8, fmt=fmt, out_dtype=out_dtype)
        else:
            ct = compress_array(w8, fmt=fmt, out_dtype=out_dtype)
        report["compressed_bytes"] += ct.nbytes_compressed()
        report["n_compressed"] += 1
        return ct

    return _map_tree(visit, params), report


def fp8_cast_tree(params, min_elems: int = 65536):
    """The FP8 *baseline*: cast large weights to fp8, keep the rest.  The
    leaf selection matches :func:`compress_tree` exactly, so the two trees
    are bit-comparable."""
    def visit(path, x):
        if isinstance(x, torch.Tensor) and _selected(path, x, min_elems):
            return fp8.cast_to_fp8(x)
        return x
    return _map_tree(visit, params)

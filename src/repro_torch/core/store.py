"""Compressed parameter store (the paper's §3.3 tensor manager).

Parameters are a nested dict in which large weights are
``CompressedTensor`` leaves, in ECF8-TPU (``fmt="tpu"``, decoded by the
ECF8 decode kernel) or ECF8-FR (``fmt="fixedrate"``, decoded by
``fixedrate.decode_plain`` on the container's device); model code calls
:func:`materialize` at the point of use (``models/layers.py::mat``), so
only one decoded weight is alive at a time.  Stacked layer weights
(``params["units"]``) carry a leading layer dim in every child tensor;
:meth:`CompressedTensor.layer` slices one layer's container out (views,
no copy).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from . import fixedrate, fp8, tpu_format
from ..kernels import ops

FORMAT_NONE = "none"
FORMAT_TPU = "tpu"          # ECF8-TPU interleaved Huffman (uniform layout)
FORMAT_FIXEDRATE = "fixedrate"  # ECF8-FR 2-bit codes + escapes

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
    esc_capacity: int = 0
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
    out_dtype = torch_dtype(dtype if dtype is not None else m.out_dtype)
    # the decode writes the dtype itself: no cast follows it
    if m.fmt == FORMAT_TPU:
        w = ops.decode_ecf8(a["payload"], a["signmant"], a["lj_limit"],
                            a["first_lj"], a["offset"], a["perm"],
                            sym_per_lane=m.sym_per_lane, n_elem=m.n_elem,
                            out_dtype=out_dtype)
    elif m.fmt == FORMAT_FIXEDRATE:
        # plain PyTorch on the container's device, as the reference's
        # decode is jnp (no kernel of its own)
        w = fixedrate.decode_plain(a["codes"], a["escapes"], a["table"],
                                   a["signmant"], n_elem=m.n_elem,
                                   out_dtype=out_dtype)
    else:
        raise ValueError(f"unknown format {m.fmt}")
    return w.reshape(m.shape)


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------

def compress_array(w8_bits: torch.Tensor, fmt: str = FORMAT_TPU,
                   out_dtype: str = "bfloat16",
                   sym_per_lane: int = tpu_format.DEFAULT_SYM_PER_LANE,
                   ) -> CompressedTensor:
    """Compress one fp8 tensor (uint8 bit view, any shape)."""
    if fmt == FORMAT_TPU:
        c = tpu_format.encode(w8_bits, sym_per_lane=sym_per_lane)
        arrays = {"payload": c.payload, "signmant": c.signmant,
                  "lj_limit": c.lj_limit, "first_lj": c.first_lj,
                  "offset": c.offset, "perm": c.perm}
        meta = CompressedMeta(fmt=fmt, shape=tuple(c.shape),
                              n_elem=c.n_elem, sym_per_lane=c.sym_per_lane,
                              out_dtype=out_dtype)
    elif fmt == FORMAT_FIXEDRATE:
        c = fixedrate.encode(w8_bits)
        arrays = {"codes": c.codes, "escapes": c.escapes, "table": c.table,
                  "signmant": c.signmant}
        meta = CompressedMeta(fmt=fmt, shape=tuple(c.shape),
                              n_elem=c.n_elem, esc_capacity=c.esc_capacity,
                              out_dtype=out_dtype)
    else:
        raise ValueError(f"unknown format {fmt}")
    return CompressedTensor(arrays=arrays, meta=meta)


def compress_stacked(w8_bits_stack: torch.Tensor, fmt: str = FORMAT_TPU,
                     out_dtype: str = "bfloat16",
                     sym_per_lane: int = tpu_format.DEFAULT_SYM_PER_LANE,
                     ) -> CompressedTensor:
    """Compress a (layers, ...) stacked fp8 tensor layer-by-layer.

    Per-layer codebooks (tables) are kept; payload strides (escape
    arrays) are padded to the per-stack max so the stack is rectangular
    (the padded bytes count in the report, and ``meta`` is layer 0's, as
    in the reference)."""
    per_layer = [compress_array(w8_bits_stack[i], fmt=fmt,
                                out_dtype=out_dtype,
                                sym_per_lane=sym_per_lane)
                 for i in range(w8_bits_stack.shape[0])]
    name, axis = (("payload", 1) if fmt == FORMAT_TPU else ("escapes", 0))
    width = max(ct.arrays[name].shape[axis] for ct in per_layer)
    for ct in per_layer:
        a = ct.arrays[name]
        if a.shape[axis] < width:
            pad = [0, 0] * (a.ndim - 1 - axis) + [0, width - a.shape[axis]]
            ct.arrays[name] = torch.nn.functional.pad(a, pad)
    arrays = {k: torch.stack([ct.arrays[k] for ct in per_layer])
              for k in per_layer[0].arrays}
    return CompressedTensor(arrays=arrays, meta=per_layer[0].meta)


def _stacked(path) -> int:
    return int("units" in path or "layers" in path)


def _selected(path, shape, min_elems: int) -> bool:
    """The reference's leaf-selection rule: a tensor whose per-layer
    element count reaches ``min_elems`` and that is at least 2-D per
    layer (norm scales and biases stay as they are)."""
    stacked = _stacked(path)
    n = math.prod(shape)
    per_layer = n // shape[0] if (stacked and shape) else n
    return per_layer >= min_elems and len(shape) >= 2 + stacked


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
        if not _selected(path, x.shape, min_elems):
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
        if isinstance(x, torch.Tensor) and _selected(path, x.shape,
                                                     min_elems):
            return fp8.cast_to_fp8(x)
        return x
    return _map_tree(visit, params)


def build_trees(init, fmt: str = FORMAT_TPU, min_elems: int = 65536,
                out_dtype: str = "bfloat16", baseline: bool = True,
                place=None):
    """Both trees of a serve run, streamed from their f32 draws: the
    compression (``fmt``, or None for ``"none"``) and the fp8 baseline
    (or None unless ``baseline``).

    ``init(leaf)`` builds the f32 tree through a leaf hook that receives
    each leaf's draws one layer at a time (``models.model.init_params``'s
    ``leaf``).  Each layer of a selected leaf is cast to fp8 bits as it is
    drawn, so at most one layer's f32 draw of a stacked leaf is alive; the
    leaf's fp8 stack is then compressed layer by layer
    (:func:`compress_stacked`) and kept as the baseline's leaf or dropped.
    Bit-equal to ``compress_tree(init())`` and ``fp8_cast_tree(init())``,
    report included -> (compressed, baseline, report).

    ``place(path, shape)`` (``runtime.sharding.expert_cut`` of a rank)
    gives ``(dim, lo, hi)`` for a leaf of which this rank keeps only rows
    ``[lo, hi)`` along ``dim`` of its whole ``shape``, or None: each
    layer is still drawn whole (the weights stay ``init_params``'s), then
    cut, and the cut is cast and compressed as a container of its own
    (its own codebook a layer), whose decode is the cut of the whole
    leaf's fp8 bits.  Leaf selection reads the whole shape; the report
    counts what this rank keeps."""
    report = {"raw_bytes": 0, "fp8_bytes": 0, "compressed_bytes": 0,
              "n_compressed": 0, "n_kept": 0}
    base = {}

    def leaf(path, draws, n_layers):
        first = next(draws)
        shape = first.shape if n_layers is None else (n_layers, *first.shape)
        selected = _selected(path, shape, min_elems)
        cut = place(path, shape) if place is not None else None
        if cut is not None:
            dim, lo, hi = cut
            dim -= n_layers is not None      # the dim of one layer's draw
            whole = draws

            def draws_cut():
                yield first.narrow(dim, lo, hi - lo)
                for x in whole:
                    yield x.narrow(dim, lo, hi - lo)

            draws = draws_cut()
            first = next(draws)
            shape = first.shape if n_layers is None else (n_layers,
                                                          *first.shape)
        report["raw_bytes"] += math.prod(shape) * first.element_size()
        if not selected:
            report["n_kept"] += 1
            x = first if n_layers is None else torch.stack([first, *draws])
            if cut is not None and n_layers is None:
                x = x.clone()       # not a view of the whole draw
            base[path] = x
            return x
        bits = torch.empty(shape, dtype=torch.uint8, device=first.device)
        if n_layers is None:
            bits.copy_(fp8.cast_to_fp8_bits(first))
        else:
            bits[0] = fp8.cast_to_fp8_bits(first)
            del first
            for i, x in enumerate(draws, 1):
                bits[i] = fp8.cast_to_fp8_bits(x)
                del x
        report["fp8_bytes"] += bits.numel()
        if baseline:
            base[path] = bits.view(fp8.FP8_DTYPE)
        if fmt == "none":
            return None
        ct = (compress_array if n_layers is None else compress_stacked)(
            bits, fmt=fmt, out_dtype=out_dtype)
        report["compressed_bytes"] += ct.nbytes_compressed()
        report["n_compressed"] += 1
        return ct

    tree = init(leaf)
    base_tree = (_map_tree(lambda path, _: base[path], tree) if baseline
                 else None)
    if fmt == "none":
        return None, base_tree, None
    return tree, base_tree, report

"""Decoder-only LM for the attention patterns ``("attn",)`` (the dense
qwen3 family, the MLP types of granite and nemotron, the mixture-of-experts
family), ``("local", "attn")`` (gemma2: sliding-window layers between
global ones, post-block norms, softcaps) and ``("local", "local", "local",
"nope")`` (llama4: local layers between global ones that skip RoPE, the
``nope`` kind), and for the recurrent kinds ``rglru`` (recurrentgemma:
``("rglru", "rglru", "local")``), ``slstm`` and ``mlstm`` (xlstm:
``("slstm", "mlstm")``, no MLP), and for the encoder-decoder (whisper: an
encoder over precomputed frame embeddings, ``("attn",)`` decoder layers
with cross attention), built from ``ArchConfig``.  Plain functions over a
nested-dict parameter tree laid out as the reference's:

    {"embed": (V, d), "final_norm": (d,), ["unembed": (d, V),]
     "units": {"pos<j>": LAYER},
     "tail": {"layer<t>": LAYER},
     ["encoder": {"layers": {norm1, attn, norm2, mlp}  (stacked),
                  "final_norm": (d,), "pos_embed": (F, d)}]}

    LAYER = {"norm1",
             "attn": {wq, wk, wv, wo[, q_norm, k_norm]}  (attention kinds)
             | "rglru": {w_in, w_gate_in, conv_w, conv_b, w_a, b_a, w_x,
                         b_x, lam, w_out}                     ('rglru')
             | "cell": {w_up, w_q, w_k, w_v, w_if, b_if, w_down}  ('mlstm')
             | "cell": {w, r, b, w_out}                       ('slstm'),
             ["norm2", "mlp": {wi_gate, wi_up, wo} | {wi, wo}
              | "moe": {gate, wi_gate, wi_up, wo[, shared: {wi_gate,
              wi_up, wo}]},] ["post_norm1", "post_norm2"],
             ["norm_x", "cross": {wq, wk, wv, wo}]  (encoder-decoder)}

with one ``pos<j>`` for each position ``j`` of the config's pattern: layer
``i < n_units * unit`` is unit ``i // unit``, position ``i % unit``, and
every leaf under ``"units"`` is stacked over the ``n_layers // unit``
units.  The ``n_layers % unit`` layers left over are the tail, unstacked,
of kind ``cfg.layer_kind(n_units * unit + t)``.  A layer has the FFN
block (``norm2`` and the MLP or MoE) unless the config has ``d_ff = 0``
and no experts (xlstm's cells carry their own projections).  Each weight
keeps the ``(in, out)`` layout (``x @ W``), so that its ECF8 container
bytes equal the reference's.  The unit loop replaces the reference's
``lax.scan``; KV pools, rings and recurrent states are updated in place.

The cache mirrors it: ``"units"/"pos<j>"`` stacked over the units (batch
at axis 1), ``"tail"/"layer<t>"`` unstacked (batch at axis 0).  A
``local`` layer's cache is a ring of ``W = min(local_window, max_len)``
positions a slot (position ``t`` at ring slot ``t % W``), beside the page
pools of the ``attn`` and ``nope`` layers in a paged cache (a ``nope``
layer is an ``attn`` layer without RoPE: it caches and pages the same);
a recurrent layer's is its state (``models.recurrent``: RG-LRU ``h``,
``conv``; mLSTM ``C``, ``n``, ``m``; sLSTM ``h``, ``c``, ``n``, ``m``,
all f32).  An encoder-decoder's cache also holds ``"units"/"cross"``:
each decoder layer's cross-attention ``{k, v}`` of ``(batch, n_kv, F,
hd)`` over the encoder's ``F`` frames, stacked over the units and
written once, at prefill.

Entry points:
  forward(params, cfg, tokens[, frames, mesh, remat, constrain, gather])
                                          -> (logits, aux)  [differentiable]
  loss_fn(params, cfg, tokens, labels[, frames, mesh, remat, aux_weight,
          constrain, gather])             -> (loss, {"nll", "aux"})
  encode_frames(params, cfg, frames, dtype) -> encoder output (B, F, d)
  prefill(params, cfg, tokens, max_len[, frames, mesh, rows])
                                          -> (last-pos logits, cache)
  prefill_chunk(params, cfg, tokens, cache, slot, n_valid)
                                          -> (logits, cache)   [paged cache]
  verify_chunk(params, cfg, tokens, cache, slot, n_valid)
                                          -> (all logits, cache) [paged]
  decode_step(params, cfg, token, cache[, mesh, rows])
                                          -> (logits, cache)
                                          [paged or contiguous cache]

On a mesh of ranks (``mesh=``, a ``("data", "model")`` DeviceMesh,
``launch/mesh.py``) the private entry points route as the reference's:
a prefill's flash attention splits its query rows over ``model``
(``flash_attention.flash_attention_sharded``); a paged decode step runs
this rank's batch shard's slots on its local pools
(``decode_sharded.paged_decode_attention_sharded``) and returns their
logits alone, rows ``[d * B / n_data, (d + 1) * B / n_data)``; a prefill
chunk runs on the ranks of its slot's batch shard and returns None logits
elsewhere (``decode_sharded.paged_prefill_chunk_sharded``).  A rank's
contiguous cache (``prefill(..., rows="shard")``, the step factories') holds
its batch shard's rows; each self-attention row whose whole length the
model axis divides (:func:`seq_split`, the reference's condition) holds
the model rank's sequence slice and decodes through
``decode_sharded.decode_attention_update_sharded``, every other row, the
cross K/V and the recurrent states whole.
Weights are replicated, except a mixture-of-experts layer's experts on a
model axis: each rank holds its ``E / M`` (``runtime.sharding.
expert_cut``) and the layer exchanges dispatch rows over ``model``
(``models/moe.py``).  A prefill or a chunk routes its rows as one group
(the engine runs it on the slot's data group alone); a split paged decode
step routes each data group's rows (over the whole batch without a model
axis); the replicated steps route the whole batch as the mesh's data
groups would.  Training on a mesh (:func:`forward`, :func:`loss_fn` with
``mesh``; every decoder-only stack: attention, experts, recurrent mixers
and local windows) runs a rank's batch shard on its shards of the
weights, each gathered whole where a layer uses it (an expert leaf over
``data`` only: the rank's ``E / M`` experts), the sequence split over
``model`` or the attention's query rows; its MoE layers route each data
group's rows (``rows="shard"``), and under the sequence split its
recurrent mixers and its local windows read the whole sequence, gathered
over ``model``; an encoder runs whole on every model rank, on its
group's frames.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.store import is_compressed, torch_dtype
from ..device import resolve
from ..kernels import ops
from ..kvcache import paged as paged_kv
from ..runtime import collectives
from ..runtime.sharding import axis_size, batch_index, n_batch_shards
from . import decode_sharded as DS
from . import recurrent as rec
from .flash_attention import flash_attention_sharded
from .layers import (F32, apply_rope, blockwise_attention, decode_attention,
                     get_attention_impl, local_attention, mat, mlp_apply,
                     mlp_init, rms_norm)
from .moe import moe_apply, moe_init

ATTN_KINDS = ("attn", "local", "nope")
REC_KINDS = ("rglru", "slstm", "mlstm")
SUPPORTED_KINDS = ATTN_KINDS + REC_KINDS
MLP_TYPES = ("swiglu", "gelu", "geglu", "sqrelu")


def _tail_kinds(cfg: ArchConfig) -> list:
    """Kinds of the ``n_layers % unit`` tail layers, in order."""
    first = (cfg.n_layers // cfg.unit) * cfg.unit
    return [cfg.layer_kind(i) for i in range(first, cfg.n_layers)]


def _has_ffn(cfg: ArchConfig, kind: str) -> bool:
    """Whether a layer of ``kind`` has the FFN block (the reference's rule:
    an MLP where ``d_ff > 0``, a MoE where there are experts, none in an
    sLSTM / mLSTM layer without ``d_ff``)."""
    if kind in ("slstm", "mlstm") and cfg.d_ff == 0:
        return False
    return cfg.d_ff > 0 or cfg.n_experts > 0


def check_supported(cfg: ArchConfig) -> None:
    """Raise for architectures the port's model functions do not run (the
    serving engine refuses an encoder-decoder besides:
    ``serving.config.EngineConfig.validate``)."""
    if (not set(cfg.pattern) <= set(SUPPORTED_KINDS)
            or (cfg.encoder_decoder and cfg.pattern != ("attn",))
            or cfg.mlp_type not in MLP_TYPES
            or any(k in paged_kv.PAGED_KINDS for k in _tail_kinds(cfg))):
        raise NotImplementedError(
            f"{cfg.name}: not yet ported (the port runs the 'attn', "
            f"'local', 'nope', 'rglru', 'slstm' and 'mlstm' kinds with no "
            f"paged layer in the tail, an encoder-decoder over ('attn',) "
            f"decoder layers: dense MLPs {MLP_TYPES} and "
            f"mixture-of-experts)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

class _Draws:
    """The leaf maker of :func:`init_params`: ``new(name, shape, scale)``
    draws ``normal(shape) * scale`` (zeros when ``scale`` is None;
    ``uniform=(lo, hi)`` draws ``U(lo, hi)`` instead) once a unit,
    ``n_layers`` times (the unit count; None: once, unstacked), from the
    shared generator, and hands the draws to ``leaf``; ``sub(name)`` is the
    maker of a sub-tree."""

    def __init__(self, gen, dtype, leaf, n_layers, path=()):
        self.gen, self.dtype, self.leaf = gen, dtype, leaf
        self.n_layers, self.path = n_layers, path

    def sub(self, name: str) -> "_Draws":
        return _Draws(self.gen, self.dtype, self.leaf, self.n_layers,
                      self.path + (name,))

    def __call__(self, name: str, shape: tuple, scale=None, uniform=None):
        gen, dtype = self.gen, self.dtype

        def draws():
            for _ in range(self.n_layers or 1):
                if gen is None:              # shapes alone: no draw
                    yield torch.empty(shape, dtype=dtype, device="meta")
                elif uniform is not None:
                    lo, hi = uniform
                    yield torch.rand(shape, generator=gen, dtype=dtype,
                                     device=gen.device).mul_(hi - lo).add_(lo)
                elif scale is None:
                    yield torch.zeros(shape, dtype=dtype, device=gen.device)
                else:
                    yield torch.randn(shape, generator=gen, dtype=dtype,
                                      device=gen.device).mul_(scale)

        return self.leaf(self.path + (name,), draws(), self.n_layers)


def _stack(path, draws, n_layers):
    """The default leaf: the layers' draws stacked (one draw unstacked)."""
    xs = list(draws)
    return xs[0] if n_layers is None else torch.stack(xs)


def _attn_init(new, cfg: ArchConfig):
    d, hd = cfg.d_model, cfg.hd
    s = d ** -0.5
    p = {
        "wq": new("wq", (d, cfg.n_heads * hd), s),
        "wk": new("wk", (d, cfg.n_kv_heads * hd), s),
        "wv": new("wv", (d, cfg.n_kv_heads * hd), s),
        "wo": new("wo", (cfg.n_heads * hd, d), s),
    }
    if cfg.qk_norm:
        p["q_norm"] = new("q_norm", (hd,))
        p["k_norm"] = new("k_norm", (hd,))
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda",
                dtype=torch.float32, leaf=None):
    """Random weights with the reference's distributions (``normal *
    fan_in**-0.5``, norm scales zero), drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the draws differ from
    ``jax.random``; parity tests convert the reference's own weights with
    ``repro_torch.convert``).

    A stacked leaf is drawn one unit at a time, the leaves of pattern
    position 0 first.  ``leaf(path, draws, n_layers)`` builds each leaf
    from its draws (an iterator of ``dtype`` tensors, one a unit,
    ``n_layers`` the unit count, None for an unstacked leaf) and must
    consume them before it returns; the default stacks them into f32
    masters.  ``core.store.build_trees`` casts and compresses each unit's
    draw as it comes instead, so a caller never holds more than one unit's
    f32 draw of a stacked leaf, and both see the same weights.

    ``device="meta"`` draws nothing: the leaves are shapes alone (what
    ``runtime.sharding.param_pspecs`` reads to place a tree no rank holds
    whole)."""
    check_supported(cfg)
    dev = resolve(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    leaf = leaf or _stack
    top = _Draws(gen, dtype, leaf, None)
    d, V = cfg.d_model, cfg.vocab_size
    params = {"embed": top("embed", (V, d), d ** -0.5),
              "final_norm": top("final_norm", (d,))}
    if not cfg.tie_embeddings:
        params["unembed"] = top("unembed", (d, V), d ** -0.5)
    n_units = cfg.n_layers // cfg.unit
    params["units"] = {
        f"pos{j}": _layer_init(_Draws(gen, dtype, leaf, n_units,
                                      ("units", f"pos{j}")), cfg, kind)
        for j, kind in enumerate(cfg.pattern)}
    params["tail"] = {
        f"layer{t}": _layer_init(_Draws(gen, dtype, leaf, None,
                                        ("tail", f"layer{t}")), cfg, kind)
        for t, kind in enumerate(_tail_kinds(cfg))}
    if cfg.encoder_decoder:
        enc = top.sub("encoder")
        layers = _Draws(gen, dtype, leaf, cfg.n_encoder_layers,
                        ("encoder", "layers"))
        params["encoder"] = {
            "layers": {"norm1": layers("norm1", (d,)),
                       "attn": _attn_init(layers.sub("attn"), cfg),
                       "norm2": layers("norm2", (d,)),
                       "mlp": mlp_init(layers.sub("mlp"), d, cfg.d_ff,
                                       cfg.mlp_type)},
            "final_norm": enc("final_norm", (d,)),
            "pos_embed": enc("pos_embed", (cfg.encoder_frames, d), 0.02)}
    return params


def _layer_init(new, cfg: ArchConfig, kind: str):
    """One layer's (or one pattern position's stacked) leaves, drawn in the
    order norm1, the mixer, norm2, the FFN, the post norms, and in an
    encoder-decoder's decoder the cross attention's norm and weights."""
    d = cfg.d_model
    layer = {"norm1": new("norm1", (d,))}
    if kind in ATTN_KINDS:
        layer["attn"] = _attn_init(new.sub("attn"), cfg)
    elif kind == "rglru":
        layer["rglru"] = rec.rglru_init(new.sub("rglru"), d, d)
    elif kind == "slstm":
        layer["cell"] = rec.slstm_init(new.sub("cell"), d, cfg.n_heads)
    else:
        layer["cell"] = rec.mlstm_init(new.sub("cell"), d, cfg.n_heads)
    ffn = _has_ffn(cfg, kind)
    if ffn:
        layer["norm2"] = new("norm2", (d,))
        if cfg.n_experts:
            layer["moe"] = moe_init(new.sub("moe"), d, cfg.n_experts,
                                    cfg.moe_d_ff, cfg.n_shared_experts,
                                    cfg.moe_d_ff)
        else:
            layer["mlp"] = mlp_init(new.sub("mlp"), d, cfg.d_ff,
                                    cfg.mlp_type)
    if cfg.post_norms:
        layer["post_norm1"] = new("post_norm1", (d,))
        if ffn:
            layer["post_norm2"] = new("post_norm2", (d,))
    if cfg.encoder_decoder:
        layer["norm_x"] = new("norm_x", (d,))
        layer["cross"] = _attn_init(new.sub("cross"), cfg)
    return layer


def _layer(tree, u: int):
    """Unit ``u`` of stacked unit parameters or caches (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, u) for k, v in tree.items()}
    return tree.layer(u) if is_compressed(tree) else tree[u]


# --------------------------------------------------------------------------
# sub-blocks
# --------------------------------------------------------------------------

def _qkv(p, x, cfg: ArchConfig, dtype, rope: bool, positions):
    """positions: (T,) shared, or (B, T) per-slot (serving engine); RoPE
    is applied unless ``rope`` is False (a ``nope`` layer)."""
    B, T, _ = x.shape
    hd = cfg.hd
    q = (x @ mat(p["wq"], dtype)).reshape(B, T, cfg.n_heads, hd)
    k = (x @ mat(p["wk"], dtype)).reshape(B, T, cfg.n_kv_heads, hd)
    v = (x @ mat(p["wv"], dtype)).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if rope:
        pos_b = (positions[None, None, :] if positions.ndim == 1
                 else positions[:, None, :])
        q = apply_rope(q, pos_b, cfg.rope_theta)
        k = apply_rope(k, pos_b, cfg.rope_theta)
    return q, k, v


def _attn_out(p, o, dtype):
    B, H, T, hd = o.shape
    o = o.transpose(1, 2).reshape(B, T, H * hd)
    return o @ mat(p["wo"], dtype)


def _self_attention_full(p, x, cfg: ArchConfig, kind: str, dtype,
                         mesh=None, q_base=None):
    """Full-sequence causal self attention (prefill): the flash kernel, or
    for a ``local`` layer whose window is shorter than the sequence,
    :func:`local_attention` (the reference's condition); with
    ``layers.set_attention_impl("blockwise")`` the plain
    :func:`blockwise_attention` (a ``local`` layer always
    :func:`local_attention`), as the reference's naive baseline. On a mesh
    the flash kernel's query rows split over ``model``; ``q_base``
    (training's sequence split) says that ``x`` holds positions ``[q_base,
    q_base + T)`` of a sequence of ``T * M`` the ``M`` model ranks split.
    The condition is then taken on the whole sequence, as the reference
    takes it, and a local layer's k / v are gathered whole over ``model``
    (their backward sums each rank's partial cotangent and keeps its rows)
    for the rank's rows of :func:`local_attention`."""
    T = x.shape[1]
    positions = (q_base or 0) + torch.arange(T, device=x.device)
    q, k, v = (t.contiguous() for t in _qkv(p, x, cfg, dtype,
                                            kind != "nope", positions))
    whole = T if q_base is None else T * axis_size(mesh, "model")
    flash = get_attention_impl() == "flash"
    if kind == "local" and (cfg.local_window < whole or not flash):
        if q_base is not None:
            k = collectives.RowGather.apply(k, mesh, "model", 2, True)
            v = collectives.RowGather.apply(v, mesh, "model", 2, True)
        o = local_attention(q, k, v, window=cfg.local_window,
                            attn_softcap=cfg.attn_softcap, q_base=q_base)
    elif not flash:
        if q_base is not None:
            k = collectives.RowGather.apply(k, mesh, "model", 2, True)
            v = collectives.RowGather.apply(v, mesh, "model", 2, True)
        o = blockwise_attention(q, k, v, causal=True, q_offset=q_base or 0,
                                attn_softcap=cfg.attn_softcap)
    elif mesh is not None:
        o = flash_attention_sharded(q, k, v, mesh,
                                    attn_softcap=cfg.attn_softcap,
                                    q_base=q_base)
    else:
        o = ops.flash_attention(q, k, v, True, cfg.attn_softcap)
    return _attn_out(p, o, dtype), (k, v)


def _self_attention_decode(p, x, cfg: ArchConfig, kind: str, dtype, pools,
                           cur_len, page_table, mesh=None):
    """One-token decode through the paged cache: the new K/V is written
    into each slot's tail page (in place), each slot's history gathered
    back, and the token attends over ``cur_len + 1`` positions.

    ``pools`` is (k_pool, v_pool, k_cold, v_cold), the cold entries being
    :func:`kvcache.paged.cold_leaves` tuples or None: cold pages are
    decoded by the page-decode kernel, once for K and once for V.
    ``page_table`` comes clamped to the garbage page (:func:`_decode_step`):
    a swap sentinel (negative id) can only sit in a vacated slot's row,
    whose write lands on the garbage page as the reference's does.  Such a
    row's output is never read by its slot, but a mixture-of-experts layer
    routes it with the live rows, so it must be the reference's own.  On a
    mesh the rows are this rank's batch shard's and ``pools`` its local
    rows (:func:`decode_sharded.paged_decode_attention_sharded`)."""
    q, k, v = _qkv(p, x, cfg, dtype, kind != "nope", cur_len[:, None])
    if mesh is not None:
        o = DS.paged_decode_attention_sharded(q, k, v, pools, page_table,
                                              cur_len, mesh,
                                              softcap=cfg.attn_softcap)
        return _attn_out(p, o, dtype)
    k_pool, v_pool, k_cold, v_cold = pools
    paged_kv.page_write(k_pool, page_table, cur_len, k)
    paged_kv.page_write(v_pool, page_table, cur_len, v)
    k_hist = paged_kv.page_gather(k_pool, page_table, k_cold)
    v_hist = paged_kv.page_gather(v_pool, page_table, v_cold)
    o = decode_attention(q, k_hist, v_hist, kv_len=cur_len + 1,
                         attn_softcap=cfg.attn_softcap)
    return _attn_out(p, o, dtype)


def _self_attention_decode_contiguous(p, x, cfg: ArchConfig, kind: str,
                                      dtype, kc, vc, cur_len, mesh=None,
                                      whole: int | None = None):
    """One-token decode through a contiguous cache row, ``kc`` / ``vc``
    (B, n_kv, S, hd), written in place.

    A global layer's row is the monolithic cache's: each slot's new K/V
    lands at its own ``cur_len``, clamped to ``S - 1`` as the reference's
    ``dynamic_update_slice`` clamps it (a vacated slot keeps stepping past
    the end of its row, and its outputs are never read), and the token
    attends over ``cur_len + 1`` positions.  A ``local`` layer's row is
    its ring of ``W = S`` positions: the write lands at
    ``cur_len % W`` and the token attends over ``min(cur_len + 1, W)``
    slots, every one of them once the ring has wrapped.

    ``mesh`` (a model axis, one shared timeline, a 0-d ``cur_len``; the
    row's whole length ``whole`` divides by the axis, :func:`seq_split`):
    the rank's ``kc`` / ``vc`` are its sequence slice of ``whole /
    n_model`` positions, decoded by
    :func:`decode_sharded.decode_attention_update_sharded`."""
    if mesh is not None:
        S = whole
        q, k, v = _qkv(p, x, cfg, dtype, kind != "nope", cur_len[None])
        ring = kind == "local"
        o = DS.decode_attention_update_sharded(
            q, kc, vc, k, v, (cur_len + 1).clamp(max=S) if ring
            else cur_len + 1, cur_len % S if ring else cur_len, mesh,
            softcap=cfg.attn_softcap)
        return _attn_out(p, o, dtype)
    B, S = x.shape[0], kc.shape[2]
    ring = kind == "local"
    q, k, v = _qkv(p, x, cfg, dtype, kind != "nope", cur_len[:, None])
    pos = (cur_len % S if ring else cur_len.clamp(max=S - 1)).long()
    rows = torch.arange(B, device=x.device)
    kc[rows, :, pos] = k[:, :, 0].to(kc.dtype)
    vc[rows, :, pos] = v[:, :, 0].to(vc.dtype)
    kv_len = (cur_len + 1).clamp(max=S) if ring else cur_len + 1
    o = decode_attention(q, kc, vc, kv_len=kv_len,
                         attn_softcap=cfg.attn_softcap)
    return _attn_out(p, o, dtype)


def _self_attention_chunk(p, x, cfg: ArchConfig, kind: str, dtype, pools,
                          row, start, n_valid: int, path: str = "gather",
                          mesh=None, slot: int = 0, n_slots: int = 1):
    """One prefill chunk of a single slot through the paged cache.

    x: (1, C, d), a chunk of the slot's prompt padded to the engine's chunk
    size; ``row`` is the slot's page-table row, ``start`` its timeline (a
    0-d tensor: no host sync), ``n_valid`` the count of real tokens.  The
    chunk's K/V is written into the slot's pages (in place), the slot's
    whole history (earlier chunks included, cold pages decoded by the
    page-decode kernel) is gathered back, and the chunk attends causally
    over it from ``q_offset=start``.  ``pools`` is as in
    :func:`_self_attention_decode`; ``path`` tags the page-decode launches
    of its cold pages (``kvcache.kernels.run``).  On a mesh with batch
    shards ``pools`` are the rank's local rows and the chunk goes through
    :func:`decode_sharded.paged_prefill_chunk_sharded`."""
    C = x.shape[1]
    positions = start + torch.arange(C, device=x.device)
    q, k, v = _qkv(p, x, cfg, dtype, kind != "nope", positions)
    if mesh is not None:
        o = DS.paged_prefill_chunk_sharded(
            q, k, v, pools, row, slot, positions, n_valid, mesh,
            n_slots=n_slots, softcap=cfg.attn_softcap)
        return _attn_out(p, o, dtype)
    k_pool, v_pool, k_cold, v_cold = pools
    paged_kv.page_write_chunk(k_pool, row, positions, k, n_valid)
    paged_kv.page_write_chunk(v_pool, row, positions, v, n_valid)
    row = row.clamp(min=paged_kv.GARBAGE_PAGE)[None]
    k_hist = paged_kv.page_gather(k_pool, row, k_cold, path=path)
    v_hist = paged_kv.page_gather(v_pool, row, v_cold, path=path)
    o = blockwise_attention(q, k_hist, v_hist, causal=True, q_offset=start,
                            kv_len=start + n_valid,
                            attn_softcap=cfg.attn_softcap)
    return _attn_out(p, o, dtype)


def _cross_q(p, x, cfg: ArchConfig, dtype):
    """Cross-attention queries of ``x`` (B, T, d) -> (B, Hq, T, hd)."""
    B, T, _ = x.shape
    q = (x @ mat(p["wq"], dtype)).reshape(B, T, cfg.n_heads, cfg.hd)
    return q.transpose(1, 2)


def _cross_kv(p, ctx, cfg: ArchConfig, dtype):
    """Cross-attention K and V of the encoder output ``ctx`` (B, F, d) ->
    two contiguous (B, n_kv, F, hd): the reference's ``_make_cross_kv`` of
    one decoder layer, which its ``_cross_attention`` also computes."""
    B = ctx.shape[0]

    def proj(name):
        y = (ctx @ mat(p[name], dtype)).reshape(B, -1, cfg.n_kv_heads,
                                                 cfg.hd)
        return y.transpose(1, 2).contiguous()

    return proj("wk"), proj("wv")


def _cross_attention(p, x, kv, cfg: ArchConfig, dtype):
    """Full-sequence cross attention of ``x`` (B, T, d) over the encoder's
    K/V: the flash kernel, non-causal (the reference runs the flash
    forward's jnp twin, ``blockwise_attention(causal=False)``)."""
    q = _cross_q(p, x, cfg, dtype).contiguous()
    return _attn_out(p, ops.flash_attention(q, kv[0], kv[1], False, 0.0),
                     dtype)


def _cross_attention_decode(p, x, kv, cfg: ArchConfig, dtype):
    """One-token cross attention over the cached encoder K/V (the
    reference's ``decode_attention`` over all ``F`` frames).  The K/V
    projections are not run: the cache holds them."""
    o = decode_attention(_cross_q(p, x, cfg, dtype), kv[0], kv[1],
                         kv_len=kv[0].shape[2])
    return _attn_out(p, o, dtype)


def _ffn(p, x, cfg: ArchConfig, dtype, aux=None, ep=None):
    """The layer's feed-forward block: the MoE layer or the dense MLP.  The
    MoE's load-balancing loss is appended to ``aux`` (a list) where the
    caller keeps one (:func:`forward`), else dropped, as the reference's
    serve path drops it.  ``ep``: (mesh, rows) or (mesh, rows, seq) of the
    MoE layer on a mesh (``models.moe``'s ``mesh``, ``rows`` and ``seq``),
    None off one."""
    if "moe" in p:
        mesh, rows, seq = (ep + (None,))[:3] if ep is not None else (
            None, "all", None)
        y, a = moe_apply(p["moe"], x, cfg, mesh=mesh, rows=rows, seq=seq,
                         dtype=dtype)
        if aux is not None:
            aux.append(a)
        return y
    return mlp_apply(p["mlp"], x, cfg.mlp_type, dtype)


def _whole(x, mesh, cols):
    """The residual stream whole over ``model`` where a norm reads it: under
    the ``d_model`` cut (``cols``, the rank's columns from
    ``constrain.cols``) the ranks' columns gathered (``collectives.
    RowGather``, whose backward keeps the rank's columns of a cotangent
    every model rank holds whole and alike), else ``x`` itself."""
    if cols is None:
        return x
    return collectives.RowGather.apply(x.contiguous(), mesh, "model", 2,
                                       False)


def _own(o, mesh, cols):
    """The rank's columns of a block's output ``o`` (whole and alike on
    every model rank) under the ``d_model`` cut (``collectives.SplitRows``,
    whose backward gathers the cotangent whole), else ``o`` itself."""
    if cols is None:
        return o
    return collectives.SplitRows.apply(o, mesh, "model", 2)


def _residual(p, x, o, cfg: ArchConfig, dtype, cross=None, aux=None,
              ep=None, mesh=None, cols=None):
    """The layer's residual adds around the mixer output ``o``: ``x +
    post_norm1(o)``, then, in an encoder-decoder's decoder, ``+
    cross(norm_x(x))`` (``cross`` the layer's cross attention), then ``+
    post_norm2(ffn(norm2(x)))`` where the layer has an FFN, the post norms
    where the config has them (gemma2).  ``cols``: under the ``d_model``
    cut ``x`` holds the rank's columns, each norm reads it gathered whole
    (:func:`_whole`) and each block's output is added as the rank's
    columns (:func:`_own`): the reference's constraint after the mixer's
    and the FFN's adds, and the same cut after the cross attention's."""
    if cfg.post_norms:
        o = rms_norm(o, p["post_norm1"])
    x = x + _own(o, mesh, cols)
    if cross is not None:
        x = x + _own(cross(rms_norm(_whole(x, mesh, cols), p["norm_x"])),
                     mesh, cols)
    if "mlp" not in p and "moe" not in p:
        return x
    o2 = _ffn(p, rms_norm(_whole(x, mesh, cols), p["norm2"]), cfg, dtype,
              aux, ep)
    if cfg.post_norms:
        o2 = rms_norm(o2, p["post_norm2"])
    return x + _own(o2, mesh, cols)


def _layer_apply_full(p, x, cfg: ArchConfig, kind: str, dtype,
                      cross_kv=None, aux=None, mesh=None, q_base=None,
                      ep=None, cols=None):
    """Full-sequence layer (prefill, forward).  Returns (x, (k, v)) for an
    attention layer, (x, final state) for a recurrent one; an mLSTM runs
    at the reference's ``chunk = min(128, T)``, so ``T`` must be at most
    128 or a multiple of it.  ``cross_kv``: the layer's cross-attention
    K/V (:func:`_cross_kv`) in an encoder-decoder's decoder.  On a mesh a
    MoE layer routes the rows as one group (``rows="own"``) unless ``ep``
    (:func:`_ffn`'s) says otherwise.  ``q_base``:
    :func:`_self_attention_full`'s; a recurrent mixer then runs on the
    whole sequence, its normed input gathered over ``model`` (the
    gather's backward sums each rank's partial cotangent and keeps its
    rows), and keeps the rank's positions: the reference's scan order and
    mLSTM chunks, its parameters' gradients partials over the rank's
    positions that sum over ``model`` (the final state is the whole
    sequence's).  ``cols``: :func:`_residual`'s ``d_model`` cut of ``x``,
    gathered whole for ``norm1``; the layer's work is then the whole
    stream's, as with the stream whole over ``model``."""
    h = rms_norm(_whole(x, mesh, cols), p["norm1"])
    if kind in ATTN_KINDS:
        o, st = _self_attention_full(p["attn"], h, cfg, kind, dtype, mesh,
                                     q_base)
    else:
        t = h.shape[1]
        if q_base is not None:
            h = collectives.RowGather.apply(h.contiguous(), mesh, "model", 1,
                                            True)
        o, st = _mixer_full(p, h, cfg, kind, dtype)
        if q_base is not None:
            o = o.narrow(1, q_base, t)
    cross = None
    if cross_kv is not None:
        def cross(hx):
            return _cross_attention(p["cross"], hx, cross_kv, cfg, dtype)
    if ep is None and mesh is not None:
        ep = (mesh, "own")
    return _residual(p, x, o, cfg, dtype, cross, aux, ep, mesh, cols), st


def _mixer_full(p, h, cfg: ArchConfig, kind: str, dtype):
    """A recurrent layer's mixer over the whole of ``h`` (B, T, d) ->
    (output, final state)."""
    if kind == "rglru":
        return rec.rglru_apply(p["rglru"], h, dtype=dtype)
    if kind == "slstm":
        return rec.slstm_apply(p["cell"], h, cfg.n_heads, dtype=dtype)
    return rec.mlstm_apply(p["cell"], h, cfg.n_heads, dtype=dtype,
                           chunk=min(128, h.shape[1]))


def _layer_apply_step(p, x, cfg: ArchConfig, kind: str, dtype, state,
                      ep=None):
    """One-token decode through a recurrent layer; ``state`` (views of the
    layer's cache leaves) is advanced in place.  ``ep``: :func:`_ffn`'s."""
    h = rms_norm(x, p["norm1"])[:, 0]
    if kind == "rglru":
        o, new = rec.rglru_step(p["rglru"], h, state, dtype=dtype)
    elif kind == "slstm":
        o, new = rec.slstm_step(p["cell"], h, state, cfg.n_heads,
                                dtype=dtype)
    else:
        o, new = rec.mlstm_step(p["cell"], h, state, cfg.n_heads,
                                dtype=dtype)
    for name, leaf in state.items():
        leaf.copy_(new[name])
    return _residual(p, x, o[:, None], cfg, dtype, ep=ep)


def _layer_apply_decode(p, x, cfg: ArchConfig, kind: str, dtype, pools,
                        cur_len, page_table, cross_kv=None, mesh=None,
                        whole: int | None = None, ep=None):
    """Decode layer; ``page_table`` None means ``pools`` is this layer's
    contiguous (k, v): the monolithic cache's row, or a ``local`` layer's
    ring.  ``cross_kv``: the layer's cached cross-attention K/V in an
    encoder-decoder's decoder.  ``mesh``: the paged step's mesh, or with
    ``whole`` (one timeline, a 0-d ``cur_len``) the sequence-sharded
    contiguous step's, ``whole`` the row's length before the cut.
    ``ep``: :func:`_ffn`'s."""
    h = rms_norm(x, p["norm1"])
    if page_table is None:
        o = _self_attention_decode_contiguous(
            p["attn"], h, cfg, kind, dtype, *pools, cur_len,
            None if whole is None else mesh, whole)
    else:
        o = _self_attention_decode(p["attn"], h, cfg, kind, dtype, pools,
                                   cur_len, page_table, mesh)
    cross = None
    if cross_kv is not None:
        def cross(hx):
            return _cross_attention_decode(p["cross"], hx, cross_kv, cfg,
                                           dtype)
    return _residual(p, x, o, cfg, dtype, cross, ep=ep)


def _layer_apply_chunk(p, x, cfg: ArchConfig, kind: str, dtype, pools, row,
                       start, n_valid: int, path: str, mesh=None,
                       slot: int = 0, n_slots: int = 1):
    """Chunk-mode layer: the decode layer's residual structure at T = C.
    Pages only: a ``local`` layer is refused, as the reference refuses it
    (the engine falls back to whole-prompt prefill for such stacks)."""
    if kind not in paged_kv.PAGED_KINDS:
        raise ValueError(
            f"chunked prefill only pages 'attn'/'nope' layers, got {kind}")
    h = rms_norm(x, p["norm1"])
    o = _self_attention_chunk(p["attn"], h, cfg, kind, dtype, pools, row,
                              start, n_valid, path, mesh, slot, n_slots)
    return _residual(p, x, o, cfg, dtype,
                     ep=None if mesh is None else (mesh, "own"))


# --------------------------------------------------------------------------
# encoder (whisper)
# --------------------------------------------------------------------------

def encode_frames(params, cfg: ArchConfig, frames, dtype, gather=None):
    """frames: (B, F, d) precomputed frontend embeddings (the reference's
    stub frontend) -> the encoder output (B, F, d): ``frames +
    pos_embed``, then each encoder layer's non-causal self attention (no
    RoPE; the flash kernel, where the reference runs its jnp twin) and
    MLP, then the final RMS norm.  ``gather``: :func:`forward`'s on a
    training mesh, each leaf gathered whole where its layer runs (the
    encoder is not checkpointed, as the reference's is not, so the
    gathered leaves live until the backward)."""
    enc = params["encoder"]
    if gather is None:
        def leaf(name):
            return enc[name]

        def layer(u):
            return _layer(enc["layers"], u)
    else:
        def leaf(name):
            return gather(("encoder", name), enc[name], None)

        def layer(u):
            return _gathered(enc["layers"], ("encoder", "layers"), u, gather)

    x = frames.to(dtype) + mat(leaf("pos_embed"), dtype)[None]
    for u in range(cfg.n_encoder_layers):
        p = layer(u)
        q, k, v = (t.contiguous() for t in _qkv(
            p["attn"], rms_norm(x, p["norm1"]), cfg, dtype, False, None))
        x = x + _attn_out(p["attn"], ops.flash_attention(q, k, v, False,
                                                         0.0), dtype)
        x = x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"]), cfg.mlp_type,
                          dtype)
    return rms_norm(x, leaf("final_norm"))


def _context(params, cfg: ArchConfig, frames, dtype, gather=None):
    """The encoder output an encoder-decoder's decoder attends to (None for
    a decoder-only model); ``gather``: :func:`encode_frames`'."""
    if not cfg.encoder_decoder:
        return None
    if frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass frames "
                         f"(B, {cfg.encoder_frames}, {cfg.d_model})")
    return encode_frames(params, cfg, frames, dtype, gather)


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

def _embed(params, cfg: ArchConfig, tokens, dtype):
    x = mat(params["embed"], dtype)[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dtype,
                             device=x.device)
    return x


def _unembed(params, cfg: ArchConfig, x, dtype):
    x = rms_norm(x, params["final_norm"])
    if cfg.tie_embeddings:
        logits = x @ mat(params["embed"], dtype).T
    else:
        logits = x @ mat(params["unembed"], dtype)
    logits = logits.to(F32)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _stack_layers(cfg: ArchConfig):
    """(section, key, unit or None, kind) of every layer, in order: each
    unit's pattern positions, then the tail layers (unstacked)."""
    n_units = cfg.n_layers // cfg.unit
    for u in range(n_units):
        for j, kind in enumerate(cfg.pattern):
            yield "units", f"pos{j}", u, kind
    for t, kind in enumerate(_tail_kinds(cfg)):
        yield "tail", f"layer{t}", None, kind


def cache_groups(cfg: ArchConfig):
    """(section, key, kind) of every cache group: the pattern positions
    (stacked over the units), then the tail layers (an encoder-decoder's
    ``units/cross`` leaves are not a group: only a prefill writes them)."""
    for j, kind in enumerate(cfg.pattern):
        yield "units", f"pos{j}", kind
    for t, kind in enumerate(_tail_kinds(cfg)):
        yield "tail", f"layer{t}", kind


def _at(tree: dict, section: str, key: str, u):
    """A layer's parameters or cache leaves: unit ``u`` of a stacked group
    (views), or a tail layer's own."""
    sub = tree[section][key]
    return sub if u is None else _layer(sub, u)


def row_len(cfg: ArchConfig, kind: str, max_len: int) -> int:
    """The positions of a contiguous self-attention cache row of a layer of
    ``kind``: ``max_len`` for a global layer, the ring's for a ``local``
    one."""
    return paged_kv.ring_len(cfg, max_len) if kind == "local" else max_len


def seq_split(cfg: ArchConfig, kind: str, max_len: int, mesh) -> bool:
    """Whether a contiguous self-attention row of a layer of ``kind`` is cut
    over ``model`` (each model rank holding ``S / M`` of its ``S``
    positions), where the reference's decode takes its sequence-sharded
    route (``src/repro/models/model.py:243-244``): an attention layer, a
    model axis of ``M > 1`` and ``M`` dividing the row's whole length
    (:func:`row_len`), which the rank's leaf cannot tell by its shape."""
    n = axis_size(mesh, "model")
    return (kind in ATTN_KINDS and n > 1
            and row_len(cfg, kind, max_len) % n == 0)


def group_cache(cfg: ArchConfig, kind: str, lead: tuple, batch: int,
                max_len: int, dtype, device, mesh=None) -> dict:
    """The contiguous cache leaves of one group, ``lead`` dims first
    (``(n_units,)`` for a pattern position, ``()`` for a tail layer):
    ``{k, v}`` of ``(batch, n_kv, S, hd)`` with ``S = max_len`` for a
    global layer and the ring length for a ``local`` one (``S / M`` on a
    model axis that cuts it, :func:`seq_split`), or a recurrent layer's
    zero state (``models.recurrent``)."""
    if kind in ATTN_KINDS:
        S = row_len(cfg, kind, max_len)
        if seq_split(cfg, kind, max_len, mesh):
            S //= axis_size(mesh, "model")
        s = lead + (batch, cfg.n_kv_heads, S, cfg.hd)
        return {"k": torch.zeros(s, dtype=dtype, device=device),
                "v": torch.zeros(s, dtype=dtype, device=device)}
    if kind == "rglru":
        st = rec.rglru_init_state(batch, cfg.d_model, device)
    elif kind == "slstm":
        st = rec.slstm_init_state(batch, cfg.n_heads, cfg.d_model, device)
    else:
        st = rec.mlstm_init_state(batch, cfg.n_heads, cfg.d_model, device)
    return {n: x.expand(lead + x.shape).clone() for n, x in st.items()}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
               device="cuda", per_slot: bool = False, mesh=None):
    """The contiguous cache (:func:`group_cache` for every group):
    ``units/pos<j>/...`` with a leading unit axis, ``tail/layer<t>/...``
    without, and an encoder-decoder's ``units/cross/{k, v}`` of ``(n_units,
    batch, n_kv, encoder_frames, hd)``.  ``per_slot=True`` makes
    ``cur_len`` a (batch,) vector, every slot on its own timeline (the
    engine's monolithic cache); else it is one shared 0-d length (a
    prefill's).  ``mesh``: a rank's cache on it (:func:`prefill`'s
    ``rows="shard"``): each row :func:`seq_split` cuts holds the rank's
    positions, and ``max_len``, a host 0-d tensor, records the length
    before the cut for the decode step."""
    dev = resolve(device)
    n_units = cfg.n_layers // cfg.unit
    cache = {"units": {}, "tail": {}}
    for section, key, kind in cache_groups(cfg):
        lead = (n_units,) if section == "units" else ()
        cache[section][key] = group_cache(cfg, kind, lead, batch, max_len,
                                          dtype, dev, mesh)
    if cfg.encoder_decoder:
        s = (n_units, batch, cfg.n_kv_heads, cfg.encoder_frames, cfg.hd)
        cache["units"]["cross"] = {
            "k": torch.zeros(s, dtype=dtype, device=dev),
            "v": torch.zeros(s, dtype=dtype, device=dev)}
    cache["cur_len"] = (torch.zeros((batch,), dtype=torch.int32, device=dev)
                        if per_slot
                        else torch.zeros((), dtype=torch.int32, device=dev))
    if mesh is not None:
        cache["max_len"] = torch.tensor(max_len)
    return cache


def _fill(dst, got, kind: str, W: int, lo: int = 0):
    """Write a prefill's K (or V), (B, n_kv, T, hd), into its cache row
    ``dst`` (B, n_kv, s, hd), in place: the row's positions ``[lo, lo +
    s)`` of its whole ``W`` (``lo`` past 0 on a model rank that holds a
    slice).  A global row holds the prompt from position 0; a ``local``
    ring that the prompt fills (``T >= W``) its last ``W`` positions,
    rolled by ``T % W`` so position ``t`` sits at ring slot ``t % W``."""
    T = got.shape[2]
    if kind == "local" and T >= W:
        got = torch.roll(got[:, :, T - W:], T % W, dims=2)
    elif T > W:
        raise ValueError(f"a prompt of {T} positions does not fit a cache "
                         f"row of {W}")
    n = max(0, min(got.shape[2], lo + dst.shape[2]) - lo)
    dst[:, :, :n] = got[:, :, lo:lo + n]


def _prefill(params, cfg: ArchConfig, tokens, max_len: int | None = None,
             frames=None, mesh=None, rows: str = "own"):
    """Process a prompt, build its cache -> (last-pos logits (B, 1, V),
    cache with global K/V zero-padded to ``max_len``, every ``local``
    layer's ring of ``min(local_window, max_len)`` positions filled and
    every recurrent layer's final state).  An encoder-decoder takes
    ``frames`` (B, F, d): it encodes them, and each decoder layer's cross
    K/V, computed once, serves its cross attention here and is kept in
    the cache's ``units/cross`` leaves for the decode steps.

    ``mesh``: the flash attention's query rows split over its ``model``
    axis (every rank of the calling group gets the whole output; the
    encoder and the cross attention run whole on each).  ``rows`` says
    what ``tokens`` hold: ``"own"`` a batch the calling data group alone
    computes (the engine's fragment: its MoE layers route its rows as one
    group, its cache is whole); ``"shard"`` this rank's data group's rows
    of a batch split over the batch axes (``runtime.steps.
    make_prefill_step``: the MoE layers route as the split decode step
    does, and the cache is the rank's, :func:`init_cache`'s ``mesh``:
    each row :func:`seq_split` cuts holds the model rank's ``S / M``
    positions)."""
    check_supported(cfg)
    dtype = torch_dtype(cfg.dtype)
    B, T = tokens.shape
    max_len = max_len or T
    cut = mesh if rows == "shard" else None
    cache = init_cache(cfg, B, max_len, dtype, tokens.device, mesh=cut)
    x = _embed(params, cfg, tokens, dtype)
    ctx = _context(params, cfg, frames, dtype)
    ep = None if mesh is None else (mesh, rows)
    for section, key, u, kind in _stack_layers(cfg):
        p = _at(params, section, key, u)
        kv = None if ctx is None else _cross_kv(p["cross"], ctx, cfg, dtype)
        x, st = _layer_apply_full(p, x, cfg, kind, dtype, kv, mesh=mesh,
                                  ep=ep)
        if kv is not None:
            cache["units"]["cross"]["k"][u] = kv[0]
            cache["units"]["cross"]["v"][u] = kv[1]
        c = _at(cache, section, key, u)
        if kind in ATTN_KINDS:
            W = row_len(cfg, kind, max_len)
            lo = (mesh.get_local_rank("model") * c["k"].shape[2]
                  if seq_split(cfg, kind, max_len, cut) else 0)
            _fill(c["k"], st[0], kind, W, lo)
            _fill(c["v"], st[1], kind, W, lo)
        else:
            for name, leaf in c.items():
                leaf.copy_(st[name])
    logits = _unembed(params, cfg, x[:, -1:], dtype)
    cache["cur_len"] = torch.full((), T, dtype=torch.int32,
                                  device=tokens.device)
    return logits, cache


def _gathered(tree, path, u, gather):
    """A layer's leaves (unit ``u``'s of a stacked group, or an unstacked
    one's), each through ``gather(path, shard, u)``."""
    if isinstance(tree, dict):
        return {k: _gathered(v, path + (k,), u, gather)
                for k, v in tree.items()}
    return gather(path, tree, u)


def forward(params, cfg: ArchConfig, tokens, frames=None, mesh=None,
            remat: bool = False, constrain=None, gather=None):
    """The full-sequence forward (the reference's training forward) ->
    (logits (B, T, V) f32, aux): ``aux`` the summed load-balancing loss of
    the MoE layers (0 without experts), summed a unit at a time as the
    reference's scan sums it.  Differentiable: the attention goes through
    ``ops.flash_attention``'s custom backward wherever an input requires a
    gradient.  ``remat`` recomputes each unit's activations in the
    backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of its scan body: the unit is the remat boundary;
    the tail layers and the encoder are not checkpointed, as there).  An
    encoder-decoder takes ``frames`` (B, F, d).

    On a mesh of ranks (``mesh``; every stack): ``tokens`` (and
    ``frames``) are this rank's batch shard's rows and ``params`` its
    shards of the leaves (``runtime.sharding.local_shard``);
    ``gather(path, shard, u)``
    returns a leaf whole where a layer uses it (unit ``u``'s of a stacked
    leaf; ``runtime.collectives.LeafGather``), inside the unit, so that
    remat gathers it again in the recompute.  ``constrain``
    (``runtime.sharding.make_constrainer``) cuts the stream after the
    embedding: under the sequence split the rank runs positions ``[s, s +
    t)`` of its rows (the flash attention with ``q_base = s`` against k / v
    gathered over ``model``) and returns their logits (B, t, V); else the
    stream stays whole over ``model`` and the flash attention splits its
    query rows (:func:`flash_attention_sharded`).  A MoE layer routes each
    data group's rows (``rows="shard"``), under the sequence split over
    the group's whole sequence, gathered over ``model`` and cut back to
    the rank's positions after it (``models.moe``'s ``seq``); a recurrent
    mixer and a local window past the whole sequence read it likewise
    (:func:`_layer_apply_full`, :func:`_self_attention_full`).  Under the
    ``d_model`` cut (``constrain.cols``) the stream between blocks, and so
    each remat unit's saved input, holds the rank's ``d / M`` columns;
    every norm reads it gathered whole and each block's output is added as
    the rank's columns (:func:`_residual`), so the blocks run as with the
    stream whole and the logits are the whole stream's.  An
    encoder runs whole on every model rank, on its group's frames, its
    leaves gathered (:func:`encode_frames`): under the sequence split each
    rank's cross attention takes its decoder positions as queries over
    all the frames, and the encoder's gradients are partials that sum
    over ``model`` as the decoder's do."""
    check_supported(cfg)
    dtype = torch_dtype(cfg.dtype)
    if gather is None:
        def top(name):
            return params[name]

        def unit_params(section, key, u):
            return _at(params, section, key, u)
    else:
        def top(name):
            return gather((name,), params[name], None)

        def unit_params(section, key, u):
            return _gathered(params[section][key], (section, key), u, gather)

    embed = top("embed")
    x = _embed({"embed": embed}, cfg, tokens, dtype)
    cut = cols = None
    if constrain is not None:
        cut = constrain.rows(x.shape[1])
        cols = constrain.cols(x.shape[2])
        x = _own(constrain(x), mesh, cols)
    q_base = None if cut is None else cut[0]
    ep = None if mesh is None else (mesh, "shard", cut)
    ctx = _context(params, cfg, frames, dtype, gather)

    def layer(p, x, kind, aux):
        kv = None if ctx is None else _cross_kv(p["cross"], ctx, cfg, dtype)
        return _layer_apply_full(p, x, cfg, kind, dtype, kv, aux, mesh,
                                 q_base, ep, cols)[0]

    def unit_body(x, u):
        aux = []
        for j, kind in enumerate(cfg.pattern):
            x = layer(unit_params("units", f"pos{j}", u), x, kind, aux)
        return x, _total(aux, x.device)

    total = torch.zeros((), dtype=F32, device=x.device)
    for u in range(cfg.n_layers // cfg.unit):
        if remat:
            # no random op runs in a unit: its RNG state need not be
            # kept (nor read: the dry run traces the card's path on a
            # build without one)
            x, a = checkpoint(unit_body, x, u, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = unit_body(x, u)
        total = total + a
    for t, kind in enumerate(_tail_kinds(cfg)):
        aux = []
        x = layer(unit_params("tail", f"layer{t}", None), x, kind, aux)
        total = total + _total(aux, x.device)
    head = {"final_norm": top("final_norm"), "embed": embed}
    if not cfg.tie_embeddings:
        head["unembed"] = top("unembed")
    return _unembed(head, cfg, _whole(x, mesh, cols), dtype), total


def _total(aux: list, device):
    """The f32 sum of a list of MoE losses, in order (0 for none)."""
    total = torch.zeros((), dtype=F32, device=device)
    for a in aux:
        total = total + a
    return total


def _check_trainable(params) -> None:
    """Raise for a tree that holds a ``CompressedTensor``: training runs on
    dense weights (the reference does not train from ECF8 either)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif is_compressed(tree):
            raise TypeError(
                f"cannot train from a compressed weight ({'/'.join(path)}, "
                f"{tree.meta.fmt}): pass dense tensors (core.store."
                f"materialize decodes one)")

    walk(params, ())


def _loss_fn(params, cfg: ArchConfig, tokens, labels, frames=None,
             mesh=None, remat: bool = False, aux_weight: float = 0.01,
             constrain=None, gather=None):
    """The reference's ``loss_fn``: the mean next-token NLL of the f32
    logits' log-softmax plus ``aux_weight`` x the MoE loss -> (loss,
    {"nll", "aux"}).  A tree holding compressed weights is refused.

    On a mesh (:func:`forward`'s ``mesh``, ``constrain`` and ``gather``;
    ``tokens`` / ``labels`` this rank's rows): the reference's loss on the
    same mesh, the same on every rank.  Each rank sums the NLL of the
    positions it ran over the global count, and takes its share of the MoE
    loss: the ranks over which the sum runs (those that ran other rows or
    positions) each hold a data group's aux (the reference's mean over the
    groups on a model axis) or, without one, the whole batch's, every rank
    alike, so each adds it over their number.  The sum
    (``runtime.collectives.SumForward``, whose backward hands each rank's
    part the loss's own cotangent) is the NLL and the aux, and the loss is
    ``nll + aux_weight * aux`` as without a mesh."""
    _check_trainable(params)
    logits, aux = forward(params, cfg, tokens, frames=frames, mesh=mesh,
                          remat=remat, constrain=constrain, gather=gather)
    if mesh is not None:
        from ..runtime.collectives import SumForward
        from ..runtime.sharding import grad_axes
        cut = None if constrain is None else constrain.rows(
            labels.shape[1])
        if cut is not None:
            labels = labels.narrow(1, cut[0], cut[1])
        parts = n_batch_shards(mesh) * (1 if cut is None else
                                        axis_size(mesh, "model"))
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.take_along_dim(logp, labels[..., None].long(),
                                    dim=-1)[..., 0]
        part = torch.stack([nll.sum() / (nll.numel() * parts), aux / parts])
        nll_aux = SumForward.apply(part, mesh,
                                   grad_axes(mesh, cut is not None))
        loss = nll_aux[0] + aux_weight * nll_aux[1]
        return loss, {"nll": nll_aux[0], "aux": nll_aux[1]}
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0]
    loss = nll.mean() + aux_weight * aux
    return loss, {"nll": nll.mean(), "aux": aux}


def _layer_pools(leaves: dict, u):
    """A layer's attention cache: the page pools and cold leaves of unit
    ``u`` (paged), else its contiguous (k, v) row or ring (of unit ``u``,
    or a tail layer's own when ``u`` is None)."""
    if "k_pool" in leaves:
        return (leaves["k_pool"][u], leaves["v_pool"][u],
                paged_kv.cold_leaves(leaves, "k", u),
                paged_kv.cold_leaves(leaves, "v", u))
    if u is None:
        return leaves["k"], leaves["v"]
    return leaves["k"][u], leaves["v"][u]


def _decode_step(params, cfg: ArchConfig, token, cache, mesh=None,
                 rows: str = "shard"):
    """token: (B, 1) int -> (logits (B, 1, V), cache).  ``cache`` is a
    paged cache (``kvcache.paged.PagedKVCache.init_cache``) or a contiguous
    one (:func:`init_cache`, ``per_slot`` or a prefill's shared length,
    with an encoder-decoder's cross K/V, which the step reads);
    its K/V and recurrent states are written in place and ``cur_len``
    advances by one.  A paged cache's ``local`` and recurrent layers keep
    their rings and states beside the pools.  Cold-pool leaves, where a
    paged cache carries them, are decoded in every paged layer (the engine
    leaves them out while no page is cold).

    ``mesh``: on a paged cache with per-slot timelines (a rank's cache of
    ``PagedKVCache(n_shards=..., shard=...)``: full page table, timelines
    and rings, local pools), only this rank's batch shard's rows are run
    and their logits returned, (B / n_data, 1, V); every timeline still
    advances.  A contiguous cache's rows are all run: ``rows`` says
    whether they are this rank's data group's rows of a batch split over
    the batch axes (``"shard"``: a rank's cache of ``prefill(...,
    rows="shard")``, the engine's monolithic cache split over the data
    groups) or the whole batch on every rank (``"all"``), which its MoE
    layers route accordingly (``models.moe``).  A rank's cache with one
    shared timeline on a model axis holds, in each row that
    :func:`seq_split` cuts, its sequence slice, decoded by
    ``decode_sharded.decode_attention_update_sharded`` (the cut is read
    off the cache's ``max_len``, not off the leaf's shape); every other
    row, the cross K/V and the recurrent states are whole on each rank."""
    dtype = torch_dtype(cfg.dtype)
    B = token.shape[0]
    cur_len = cache["cur_len"]
    page_table = cache.get("page_table")
    sel = slice(None)
    paged_mesh = DS.paged_shardable(page_table, cur_len, mesh)
    if paged_mesh:
        b_loc = B // n_batch_shards(mesh)
        lo = batch_index(mesh) * b_loc
        sel = slice(lo, lo + b_loc)
    shared = (mesh is not None and page_table is None and cur_len.ndim == 0
              and axis_size(mesh, "model") > 1)
    if shared and "max_len" not in cache:
        raise ValueError(
            "a contiguous cache with one timeline on a model axis must "
            "carry its max_len (prefill(..., rows='shard') writes it): a "
            "rank's row cannot tell by its shape whether it was cut")
    max_len = int(cache["max_len"]) if shared else None
    lens = cur_len.expand(B) if cur_len.ndim == 0 else cur_len
    lens = lens[sel]
    if page_table is not None:
        page_table = page_table[sel].clamp(min=paged_kv.GARBAGE_PAGE)
    cross = cache["units"].get("cross")
    # the MoE layers' rows: a data group's (a split paged step, a rank's
    # contiguous cache) or the whole batch, the same on every rank
    ep = None if mesh is None else (
        mesh, "shard" if paged_mesh or page_table is None and rows ==
        "shard" else "all")
    x = _embed(params, cfg, token[sel], dtype)
    for section, key, u, kind in _stack_layers(cfg):
        p = _at(params, section, key, u)
        leaves = cache[section][key]
        if kind in REC_KINDS:
            state = _at(cache, section, key, u)
            x = _layer_apply_step(p, x, cfg, kind, dtype,
                                  {n: v[sel] for n, v in state.items()},
                                  ep)
            continue
        pools = _layer_pools(leaves, u)
        whole = None
        if "k_pool" not in leaves:
            pools = tuple(t[sel] for t in pools)
            if shared and seq_split(cfg, kind, max_len, mesh):
                whole = row_len(cfg, kind, max_len)
        x = _layer_apply_decode(
            p, x, cfg, kind, dtype, pools,
            cur_len if whole is not None else lens,
            page_table if "k_pool" in leaves else None,
            None if cross is None else (cross["k"][u][sel],
                                        cross["v"][u][sel]),
            mesh=mesh if paged_mesh or whole is not None else None,
            whole=whole, ep=ep)
    logits = _unembed(params, cfg, x, dtype)
    cache["cur_len"] = cur_len + 1
    return logits, cache


def step_overwrites(cfg: ArchConfig, cache) -> list:
    """What the next :func:`decode_step` on the contiguous, per-slot
    ``cache`` overwrites that rolling its timeline back does not restore:
    the ring slot ``cur_len % W`` of every ``local`` layer (it held the
    position ``W`` back, still inside the window) and the whole state of
    every recurrent layer.  A global layer needs nothing: its write lands
    at or past ``cur_len``, which ``kv_len`` masks until the next write
    there.  -> [(leaf, copy, ring slots (B,) or None, batch axis)], empty
    for an attention-only stack; :func:`undo_step` puts a slot's row back.
    """
    out = []
    for section, key, kind in cache_groups(cfg):
        if kind in paged_kv.PAGED_KINDS:
            continue
        axis = 1 if section == "units" else 0
        for leaf in cache[section][key].values():
            if kind != "local":
                out.append((leaf, leaf.clone(), None, axis))
                continue
            pos = (cache["cur_len"] % leaf.shape[-2]).long()
            rows = torch.arange(pos.shape[0], device=pos.device)
            # (B, [U,] n_kv, hd): each row's slot, batch first
            copy = leaf[:, rows, :, pos] if axis else leaf[rows, :, pos]
            out.append((leaf, copy, pos, axis))
    return out


def undo_step(saved: list, slot: int) -> None:
    """Put ``slot``'s row of a :func:`step_overwrites` record back, in
    place.  Undoing the steps of a window newest first restores the cache
    as it was before the oldest of them."""
    for leaf, copy, pos, axis in saved:
        row = leaf.select(axis, slot)
        if pos is None:
            row.copy_(copy.select(axis, slot))
        else:
            row.index_copy_(row.ndim - 2, pos[slot:slot + 1],
                            copy[slot].unsqueeze(-2))


def _chunk_stack(params, cfg: ArchConfig, tokens, cache, slot: int,
                 n_valid: int, path: str = "gather", mesh=None):
    """Embed a chunk, run every layer in chunk mode, advance the slot's
    timeline by ``n_valid`` (in place) -> the residual stream (1, C, d).
    ``path`` tags the page-decode launches of cold pages.  On a mesh with
    batch shards a rank off the slot's shard only advances the timeline
    and returns None."""
    dtype = torch_dtype(cfg.dtype)
    cur_len = cache["cur_len"]
    start = cur_len[slot].clone()
    n_slots = cache["page_table"].shape[0]
    if not DS.chunk_shardable(mesh):
        mesh = None
    elif slot // (n_slots // n_batch_shards(mesh)) != batch_index(mesh):
        cur_len[slot] = start + n_valid
        return None
    row = cache["page_table"][slot]
    x = _embed(params, cfg, tokens, dtype)
    for section, key, u, kind in _stack_layers(cfg):
        leaves = cache[section][key]
        pools = _layer_pools(leaves, u) if "k_pool" in leaves else None
        x = _layer_apply_chunk(_at(params, section, key, u), x, cfg, kind,
                               dtype, pools, row, start, n_valid, path,
                               mesh, slot, n_slots)
    cur_len[slot] = start + n_valid
    return x


def _prefill_chunk(params, cfg: ArchConfig, tokens, cache, slot: int,
                   n_valid: int, mesh=None):
    """Process one fixed-size prompt chunk for ``slot`` of a paged cache.

    tokens: (1, C) int, a chunk of the prompt padded to the engine's chunk
    size; ``n_valid`` counts its real tokens; the chunk starts at
    ``cache["cur_len"][slot]``.  K/V is appended straight into the slot's
    pages across chunk boundaries; the final chunk's last-position logits
    are where the request's first token is sampled from.  Returns (logits
    (1, 1, V) at position ``n_valid - 1`` of the chunk, cache with
    ``cur_len[slot] += n_valid``); the pools and ``cur_len`` are updated in
    place.  On a mesh the logits are None on a rank off the slot's batch
    shard (:func:`_chunk_stack`)."""
    check_supported(cfg)
    x = _chunk_stack(params, cfg, tokens, cache, slot, n_valid, mesh=mesh)
    if x is None:
        return None, cache
    last = x[:, max(n_valid - 1, 0):max(n_valid, 1)]
    return _unembed(params, cfg, last, torch_dtype(cfg.dtype)), cache


def _verify_chunk(params, cfg: ArchConfig, tokens, cache, slot: int,
                  n_valid: int, mesh=None):
    """The speculative-decoding verify forward: :func:`prefill_chunk`'s
    chunk program, unembedding **every** chunk row.

    tokens: (1, C), the slot's last emitted token then the draft's
    proposals, padded to the engine's verify width ``spec_k + 1``.  Returns
    (logits (1, C, V), cache): row ``i`` conditions on the cache prefix
    and ``tokens[:, :i + 1]``, the target distribution proposal ``i + 1``
    is accepted against, and row ``n_valid - 1`` scores the bonus token.
    K/V of all ``n_valid`` tokens lands in the slot's pages and
    ``cur_len[slot]`` advances by ``n_valid`` (in place); the engine rolls
    the rejected suffix back (``PagedKVCache.rollback``).  Cold pages of
    the history are decoded with the page-decode launches tagged
    ``'verify'``; on a mesh, None logits off the slot's batch shard."""
    check_supported(cfg)
    x = _chunk_stack(params, cfg, tokens, cache, slot, n_valid, "verify",
                     mesh=mesh)
    if x is None:
        return None, cache
    return _unembed(params, cfg, x, torch_dtype(cfg.dtype)), cache


# The entry points are defined under private names and bound to the public
# ones: tools/lint's jit-discipline pass resolves a called name across
# files only when a single file under src/ defines it, and the reference's
# jitted serve steps reach their model through ``M.prefill`` /
# ``M.decode_step`` / ``M.prefill_chunk`` / ``M.verify_chunk``, its train
# step through ``M.loss_fn``.
prefill = _prefill
prefill_chunk = _prefill_chunk
verify_chunk = _verify_chunk
decode_step = _decode_step
loss_fn = _loss_fn

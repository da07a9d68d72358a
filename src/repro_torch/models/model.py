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
  forward(params, cfg, tokens[, frames, remat])
                                          -> (logits, aux)  [differentiable]
  loss_fn(params, cfg, tokens, labels[, frames, remat, aux_weight])
                                          -> (loss, {"nll", "aux"})
  encode_frames(params, cfg, frames, dtype) -> encoder output (B, F, d)
  prefill(params, cfg, tokens, max_len[, frames])
                                          -> (last-pos logits, cache)
  prefill_chunk(params, cfg, tokens, cache, slot, n_valid)
                                          -> (logits, cache)   [paged cache]
  verify_chunk(params, cfg, tokens, cache, slot, n_valid)
                                          -> (all logits, cache) [paged]
  decode_step(params, cfg, token, cache)  -> (logits, cache)
                                          [paged or contiguous cache]
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
from . import recurrent as rec
from .layers import (F32, apply_rope, blockwise_attention, decode_attention,
                     local_attention, mat, mlp_apply, mlp_init, rms_norm)
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
                if uniform is not None:
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
    f32 draw of a stacked leaf, and both see the same weights."""
    check_supported(cfg)
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
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


def _self_attention_full(p, x, cfg: ArchConfig, kind: str, dtype):
    """Full-sequence causal self attention (prefill): the flash kernel, or
    for a ``local`` layer whose window is shorter than the prompt,
    :func:`local_attention` (the reference's condition)."""
    T = x.shape[1]
    positions = torch.arange(T, device=x.device)
    q, k, v = (t.contiguous() for t in _qkv(p, x, cfg, dtype,
                                            kind != "nope", positions))
    if kind == "local" and cfg.local_window < T:
        o = local_attention(q, k, v, window=cfg.local_window,
                            attn_softcap=cfg.attn_softcap)
    else:
        o = ops.flash_attention(q, k, v, True, cfg.attn_softcap)
    return _attn_out(p, o, dtype), (k, v)


def _self_attention_decode(p, x, cfg: ArchConfig, kind: str, dtype, pools,
                           cur_len, page_table):
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
    routes it with the live rows, so it must be the reference's own."""
    q, k, v = _qkv(p, x, cfg, dtype, kind != "nope", cur_len[:, None])
    k_pool, v_pool, k_cold, v_cold = pools
    paged_kv.page_write(k_pool, page_table, cur_len, k)
    paged_kv.page_write(v_pool, page_table, cur_len, v)
    k_hist = paged_kv.page_gather(k_pool, page_table, k_cold)
    v_hist = paged_kv.page_gather(v_pool, page_table, v_cold)
    o = decode_attention(q, k_hist, v_hist, kv_len=cur_len + 1,
                         attn_softcap=cfg.attn_softcap)
    return _attn_out(p, o, dtype)


def _self_attention_decode_contiguous(p, x, cfg: ArchConfig, kind: str,
                                      dtype, kc, vc, cur_len):
    """One-token decode through a contiguous cache row, ``kc`` / ``vc``
    (B, n_kv, S, hd), written in place.

    A global layer's row is the monolithic cache's: each slot's new K/V
    lands at its own ``cur_len``, clamped to ``S - 1`` as the reference's
    ``dynamic_update_slice`` clamps it (a vacated slot keeps stepping past
    the end of its row, and its outputs are never read), and the token
    attends over ``cur_len + 1`` positions.  A ``local`` layer's row is
    its ring of ``W = S`` positions: the write lands at
    ``cur_len % W`` and the token attends over ``min(cur_len + 1, W)``
    slots, every one of them once the ring has wrapped."""
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
                          row, start, n_valid: int, path: str = "gather"):
    """One prefill chunk of a single slot through the paged cache.

    x: (1, C, d), a chunk of the slot's prompt padded to the engine's chunk
    size; ``row`` is the slot's page-table row, ``start`` its timeline (a
    0-d tensor: no host sync), ``n_valid`` the count of real tokens.  The
    chunk's K/V is written into the slot's pages (in place), the slot's
    whole history (earlier chunks included, cold pages decoded by the
    page-decode kernel) is gathered back, and the chunk attends causally
    over it from ``q_offset=start``.  ``pools`` is as in
    :func:`_self_attention_decode`; ``path`` tags the page-decode launches
    of its cold pages (``kvcache.kernels.run``)."""
    C = x.shape[1]
    positions = start + torch.arange(C, device=x.device)
    q, k, v = _qkv(p, x, cfg, dtype, kind != "nope", positions)
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


def _ffn(p, x, cfg: ArchConfig, dtype, aux=None):
    """The layer's feed-forward block: the MoE layer or the dense MLP.  The
    MoE's load-balancing loss is appended to ``aux`` (a list) where the
    caller keeps one (:func:`forward`), else dropped, as the reference's
    serve path drops it."""
    if "moe" in p:
        y, a = moe_apply(p["moe"], x, cfg, dtype=dtype)
        if aux is not None:
            aux.append(a)
        return y
    return mlp_apply(p["mlp"], x, cfg.mlp_type, dtype)


def _residual(p, x, o, cfg: ArchConfig, dtype, cross=None, aux=None):
    """The layer's residual adds around the mixer output ``o``: ``x +
    post_norm1(o)``, then, in an encoder-decoder's decoder, ``+
    cross(norm_x(x))`` (``cross`` the layer's cross attention), then ``+
    post_norm2(ffn(norm2(x)))`` where the layer has an FFN, the post norms
    where the config has them (gemma2)."""
    if cfg.post_norms:
        o = rms_norm(o, p["post_norm1"])
    x = x + o
    if cross is not None:
        x = x + cross(rms_norm(x, p["norm_x"]))
    if "mlp" not in p and "moe" not in p:
        return x
    o2 = _ffn(p, rms_norm(x, p["norm2"]), cfg, dtype, aux)
    if cfg.post_norms:
        o2 = rms_norm(o2, p["post_norm2"])
    return x + o2


def _layer_apply_full(p, x, cfg: ArchConfig, kind: str, dtype,
                      cross_kv=None, aux=None):
    """Full-sequence layer (prefill, forward).  Returns (x, (k, v)) for an
    attention layer, (x, final state) for a recurrent one; an mLSTM runs
    at the reference's ``chunk = min(128, T)``, so ``T`` must be at most
    128 or a multiple of it.  ``cross_kv``: the layer's cross-attention
    K/V (:func:`_cross_kv`) in an encoder-decoder's decoder."""
    h = rms_norm(x, p["norm1"])
    if kind in ATTN_KINDS:
        o, st = _self_attention_full(p["attn"], h, cfg, kind, dtype)
    elif kind == "rglru":
        o, st = rec.rglru_apply(p["rglru"], h, dtype=dtype)
    elif kind == "slstm":
        o, st = rec.slstm_apply(p["cell"], h, cfg.n_heads, dtype=dtype)
    else:
        o, st = rec.mlstm_apply(p["cell"], h, cfg.n_heads, dtype=dtype,
                                chunk=min(128, h.shape[1]))
    cross = None
    if cross_kv is not None:
        def cross(hx):
            return _cross_attention(p["cross"], hx, cross_kv, cfg, dtype)
    return _residual(p, x, o, cfg, dtype, cross, aux), st


def _layer_apply_step(p, x, cfg: ArchConfig, kind: str, dtype, state):
    """One-token decode through a recurrent layer; ``state`` (views of the
    layer's cache leaves) is advanced in place."""
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
    return _residual(p, x, o[:, None], cfg, dtype)


def _layer_apply_decode(p, x, cfg: ArchConfig, kind: str, dtype, pools,
                        cur_len, page_table, cross_kv=None):
    """Decode layer; ``page_table`` None means ``pools`` is this layer's
    contiguous (k, v): the monolithic cache's row, or a ``local`` layer's
    ring.  ``cross_kv``: the layer's cached cross-attention K/V in an
    encoder-decoder's decoder."""
    h = rms_norm(x, p["norm1"])
    if page_table is None:
        o = _self_attention_decode_contiguous(p["attn"], h, cfg, kind,
                                              dtype, *pools, cur_len)
    else:
        o = _self_attention_decode(p["attn"], h, cfg, kind, dtype, pools,
                                   cur_len, page_table)
    cross = None
    if cross_kv is not None:
        def cross(hx):
            return _cross_attention_decode(p["cross"], hx, cross_kv, cfg,
                                           dtype)
    return _residual(p, x, o, cfg, dtype, cross)


def _layer_apply_chunk(p, x, cfg: ArchConfig, kind: str, dtype, pools, row,
                       start, n_valid: int, path: str):
    """Chunk-mode layer: the decode layer's residual structure at T = C.
    Pages only: a ``local`` layer is refused, as the reference refuses it
    (the engine falls back to whole-prompt prefill for such stacks)."""
    if kind not in paged_kv.PAGED_KINDS:
        raise ValueError(
            f"chunked prefill only pages 'attn'/'nope' layers, got {kind}")
    h = rms_norm(x, p["norm1"])
    o = _self_attention_chunk(p["attn"], h, cfg, kind, dtype, pools, row,
                              start, n_valid, path)
    return _residual(p, x, o, cfg, dtype)


# --------------------------------------------------------------------------
# encoder (whisper)
# --------------------------------------------------------------------------

def encode_frames(params, cfg: ArchConfig, frames, dtype):
    """frames: (B, F, d) precomputed frontend embeddings (the reference's
    stub frontend) -> the encoder output (B, F, d): ``frames +
    pos_embed``, then each encoder layer's non-causal self attention (no
    RoPE; the flash kernel, where the reference runs its jnp twin) and
    MLP, then the final RMS norm."""
    enc = params["encoder"]
    x = frames.to(dtype) + mat(enc["pos_embed"], dtype)[None]
    for u in range(cfg.n_encoder_layers):
        p = _layer(enc["layers"], u)
        q, k, v = (t.contiguous() for t in _qkv(
            p["attn"], rms_norm(x, p["norm1"]), cfg, dtype, False, None))
        x = x + _attn_out(p["attn"], ops.flash_attention(q, k, v, False,
                                                         0.0), dtype)
        x = x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"]), cfg.mlp_type,
                          dtype)
    return rms_norm(x, enc["final_norm"])


def _context(params, cfg: ArchConfig, frames, dtype):
    """The encoder output an encoder-decoder's decoder attends to (None for
    a decoder-only model)."""
    if not cfg.encoder_decoder:
        return None
    if frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass frames "
                         f"(B, {cfg.encoder_frames}, {cfg.d_model})")
    return encode_frames(params, cfg, frames, dtype)


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


def group_cache(cfg: ArchConfig, kind: str, lead: tuple, batch: int,
                max_len: int, dtype, device) -> dict:
    """The contiguous cache leaves of one group, ``lead`` dims first
    (``(n_units,)`` for a pattern position, ``()`` for a tail layer):
    ``{k, v}`` of ``(batch, n_kv, S, hd)`` with ``S = max_len`` for a
    global layer and the ring length for a ``local`` one, or a recurrent
    layer's zero state (``models.recurrent``)."""
    if kind in ATTN_KINDS:
        S = paged_kv.ring_len(cfg, max_len) if kind == "local" else max_len
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
               device="cuda", per_slot: bool = False):
    """The contiguous cache (:func:`group_cache` for every group):
    ``units/pos<j>/...`` with a leading unit axis, ``tail/layer<t>/...``
    without, and an encoder-decoder's ``units/cross/{k, v}`` of ``(n_units,
    batch, n_kv, encoder_frames, hd)``.  ``per_slot=True`` makes
    ``cur_len`` a (batch,) vector, every slot on its own timeline (the
    engine's monolithic cache); else it is one shared 0-d length (a
    prefill's)."""
    dev = resolve(device)
    n_units = cfg.n_layers // cfg.unit
    cache = {"units": {}, "tail": {}}
    for section, key, kind in cache_groups(cfg):
        lead = (n_units,) if section == "units" else ()
        cache[section][key] = group_cache(cfg, kind, lead, batch, max_len,
                                          dtype, dev)
    if cfg.encoder_decoder:
        s = (n_units, batch, cfg.n_kv_heads, cfg.encoder_frames, cfg.hd)
        cache["units"]["cross"] = {
            "k": torch.zeros(s, dtype=dtype, device=dev),
            "v": torch.zeros(s, dtype=dtype, device=dev)}
    cache["cur_len"] = (torch.zeros((batch,), dtype=torch.int32, device=dev)
                        if per_slot
                        else torch.zeros((), dtype=torch.int32, device=dev))
    return cache


def _fill(dst, got, kind: str):
    """Write a prefill's K (or V), (B, n_kv, T, hd), into its cache row
    ``dst`` (B, n_kv, S, hd), in place: from position 0, or for a ``local``
    ring that the prompt fills (``T >= W``) its last ``W`` positions,
    rolled by ``T % W`` so position ``t`` sits at ring slot ``t % W``."""
    T, W = got.shape[2], dst.shape[2]
    if kind == "local" and T >= W:
        dst.copy_(torch.roll(got[:, :, T - W:], T % W, dims=2))
    else:
        dst[:, :, :T] = got


def _prefill(params, cfg: ArchConfig, tokens, max_len: int | None = None,
             frames=None):
    """Process a prompt, build its cache -> (last-pos logits (B, 1, V),
    cache with global K/V zero-padded to ``max_len``, every ``local``
    layer's ring of ``min(local_window, max_len)`` positions filled and
    every recurrent layer's final state).  An encoder-decoder takes
    ``frames`` (B, F, d): it encodes them, and each decoder layer's cross
    K/V, computed once, serves its cross attention here and is kept in
    the cache's ``units/cross`` leaves for the decode steps."""
    check_supported(cfg)
    dtype = torch_dtype(cfg.dtype)
    B, T = tokens.shape
    max_len = max_len or T
    cache = init_cache(cfg, B, max_len, dtype, tokens.device)
    x = _embed(params, cfg, tokens, dtype)
    ctx = _context(params, cfg, frames, dtype)
    for section, key, u, kind in _stack_layers(cfg):
        p = _at(params, section, key, u)
        kv = None if ctx is None else _cross_kv(p["cross"], ctx, cfg, dtype)
        x, st = _layer_apply_full(p, x, cfg, kind, dtype, kv)
        if kv is not None:
            cache["units"]["cross"]["k"][u] = kv[0]
            cache["units"]["cross"]["v"][u] = kv[1]
        c = _at(cache, section, key, u)
        if kind in ATTN_KINDS:
            _fill(c["k"], st[0], kind)
            _fill(c["v"], st[1], kind)
        else:
            for name, leaf in c.items():
                leaf.copy_(st[name])
    logits = _unembed(params, cfg, x[:, -1:], dtype)
    cache["cur_len"] = torch.full((), T, dtype=torch.int32,
                                  device=tokens.device)
    return logits, cache


def forward(params, cfg: ArchConfig, tokens, frames=None, remat: bool = False):
    """The full-sequence forward (the reference's training forward) ->
    (logits (B, T, V) f32, aux): ``aux`` the summed load-balancing loss of
    the MoE layers (0 without experts), summed a unit at a time as the
    reference's scan sums it.  Differentiable: the attention goes through
    ``ops.flash_attention``'s custom backward wherever an input requires a
    gradient.  ``remat`` recomputes each unit's activations in the
    backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of its scan body: the unit is the remat boundary;
    the tail layers and the encoder are not checkpointed, as there).  An
    encoder-decoder takes ``frames`` (B, F, d)."""
    check_supported(cfg)
    dtype = torch_dtype(cfg.dtype)
    x = _embed(params, cfg, tokens, dtype)
    ctx = _context(params, cfg, frames, dtype)

    def layer(p, x, kind, aux):
        kv = None if ctx is None else _cross_kv(p["cross"], ctx, cfg, dtype)
        return _layer_apply_full(p, x, cfg, kind, dtype, kv, aux)[0]

    def unit_body(x, u):
        aux = []
        for j, kind in enumerate(cfg.pattern):
            x = layer(_layer(params["units"][f"pos{j}"], u), x, kind, aux)
        return x, _total(aux, x.device)

    total = torch.zeros((), dtype=F32, device=x.device)
    for u in range(cfg.n_layers // cfg.unit):
        if remat:
            x, a = checkpoint(unit_body, x, u, use_reentrant=False)
        else:
            x, a = unit_body(x, u)
        total = total + a
    for t, kind in enumerate(_tail_kinds(cfg)):
        aux = []
        x = layer(params["tail"][f"layer{t}"], x, kind, aux)
        total = total + _total(aux, x.device)
    return _unembed(params, cfg, x, dtype), total


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
             remat: bool = False, aux_weight: float = 0.01):
    """The reference's ``loss_fn``: the mean next-token NLL of the f32
    logits' log-softmax plus ``aux_weight`` x the MoE loss -> (loss,
    {"nll", "aux"}).  A tree holding compressed weights is refused."""
    _check_trainable(params)
    logits, aux = forward(params, cfg, tokens, frames=frames, remat=remat)
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


def _decode_step(params, cfg: ArchConfig, token, cache):
    """token: (B, 1) int -> (logits (B, 1, V), cache).  ``cache`` is a
    paged cache (``kvcache.paged.PagedKVCache.init_cache``) or a contiguous
    one (:func:`init_cache`, ``per_slot`` or a prefill's shared length,
    with an encoder-decoder's cross K/V, which the step reads);
    its K/V and recurrent states are written in place and ``cur_len``
    advances by one.  A paged cache's ``local`` and recurrent layers keep
    their rings and states beside the pools.  Cold-pool leaves, where a
    paged cache carries them, are decoded in every paged layer (the engine
    leaves them out while no page is cold)."""
    dtype = torch_dtype(cfg.dtype)
    B = token.shape[0]
    cur_len = cache["cur_len"]
    page_table = cache.get("page_table")
    lens = cur_len.expand(B) if cur_len.ndim == 0 else cur_len
    if page_table is not None:
        page_table = page_table.clamp(min=paged_kv.GARBAGE_PAGE)
    cross = cache["units"].get("cross")
    x = _embed(params, cfg, token, dtype)
    for section, key, u, kind in _stack_layers(cfg):
        p = _at(params, section, key, u)
        leaves = cache[section][key]
        if kind in REC_KINDS:
            x = _layer_apply_step(p, x, cfg, kind, dtype,
                                  _at(cache, section, key, u))
        else:
            x = _layer_apply_decode(
                p, x, cfg, kind, dtype, _layer_pools(leaves, u), lens,
                page_table if "k_pool" in leaves else None,
                None if cross is None else (cross["k"][u], cross["v"][u]))
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
                 n_valid: int, path: str = "gather"):
    """Embed a chunk, run every layer in chunk mode, advance the slot's
    timeline by ``n_valid`` (in place) -> the residual stream (1, C, d).
    ``path`` tags the page-decode launches of cold pages."""
    dtype = torch_dtype(cfg.dtype)
    cur_len = cache["cur_len"]
    start = cur_len[slot].clone()
    row = cache["page_table"][slot]
    x = _embed(params, cfg, tokens, dtype)
    for section, key, u, kind in _stack_layers(cfg):
        leaves = cache[section][key]
        pools = _layer_pools(leaves, u) if "k_pool" in leaves else None
        x = _layer_apply_chunk(_at(params, section, key, u), x, cfg, kind,
                               dtype, pools, row, start, n_valid, path)
    cur_len[slot] = start + n_valid
    return x


def _prefill_chunk(params, cfg: ArchConfig, tokens, cache, slot: int,
                   n_valid: int):
    """Process one fixed-size prompt chunk for ``slot`` of a paged cache.

    tokens: (1, C) int, a chunk of the prompt padded to the engine's chunk
    size; ``n_valid`` counts its real tokens; the chunk starts at
    ``cache["cur_len"][slot]``.  K/V is appended straight into the slot's
    pages across chunk boundaries; the final chunk's last-position logits
    are where the request's first token is sampled from.  Returns (logits
    (1, 1, V) at position ``n_valid - 1`` of the chunk, cache with
    ``cur_len[slot] += n_valid``); the pools and ``cur_len`` are updated in
    place."""
    check_supported(cfg)
    x = _chunk_stack(params, cfg, tokens, cache, slot, n_valid)
    last = x[:, max(n_valid - 1, 0):max(n_valid, 1)]
    return _unembed(params, cfg, last, torch_dtype(cfg.dtype)), cache


def _verify_chunk(params, cfg: ArchConfig, tokens, cache, slot: int,
                  n_valid: int):
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
    ``'verify'``."""
    check_supported(cfg)
    x = _chunk_stack(params, cfg, tokens, cache, slot, n_valid, "verify")
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

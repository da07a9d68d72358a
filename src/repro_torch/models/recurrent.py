"""Recurrent sequence mixers: RG-LRU (RecurrentGemma / Griffin), sLSTM and
mLSTM (xLSTM), the reference's ``models/recurrent.py`` as plain PyTorch
functions.  Each mixer exposes:

  *_init(new, ...)                       -> params
  *_apply(params, x, ...)                -> (y, final_state)   # full sequence
  *_step(params, x_t, state, ...)        -> (y_t, state)       # decode
  *_init_state(batch, ..., device)       -> the zero state of one layer

The reference computes all three outside Pallas, and so does the port, on
the CPU and on the card alike: RG-LRU's linear recurrence
``h_t = a_t * h_{t-1} + b_t`` runs in f32 as a log-depth scan over T
(``ceil(log2 T)`` elementwise passes, the counterpart of
``associative_scan``); mLSTM runs its chunkwise-parallel form (intra-chunk
products, an inter-chunk state loop, ``torch.cummax`` for the running
maximum), held against the sequential :func:`mlstm_seq_ref`; sLSTM is a
loop over T, as the reference's ``lax.scan``.

Every weight goes through :func:`layers.mat`, so an ECF8 tree decodes each
one where it is used.  The reference reads these weights with ``.astype``,
which a compressed leaf does not have; its ECF8 trees cannot run these
layers, and the port's parity oracle for an ECF8 tree is the reference on
the fp8 tree, which decodes to the same bits.  Gates and states are f32;
``softplus`` is ``logaddexp(x, 0)`` and ``log_sigmoid`` its negation at
``-x``, as JAX defines them; the mLSTM and sLSTM stabilisers start at
``-1e30``; RG-LRU's ``conv`` state holds the compute dtype's values in an
f32 leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .flash_attention import scale_in_dtype
from .layers import F32, mat

RGLRU_C = 8.0
CONV_WIDTH = 4
M_INIT = -1e30          # the stabilisers' starting value


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _log_sigmoid(x):
    return -_softplus(-x)


# --------------------------------------------------------------------------
# RG-LRU (Griffin)
# --------------------------------------------------------------------------

def _rglru_init(new, d_model: int, d_rnn: int):
    """The reference's leaves and distributions (``normal * d_model**-0.5``,
    ``conv_w`` at 0.1, biases zero, ``lam ~ U(2, 6)``)."""
    s = d_model ** -0.5
    return {
        "w_in": new("w_in", (d_model, d_rnn), s),
        "w_gate_in": new("w_gate_in", (d_model, d_rnn), s),
        "conv_w": new("conv_w", (CONV_WIDTH, d_rnn), 0.1),
        "conv_b": new("conv_b", (d_rnn,)),
        "w_a": new("w_a", (d_rnn, d_rnn), s),
        "b_a": new("b_a", (d_rnn,)),
        "w_x": new("w_x", (d_rnn, d_rnn), s),
        "b_x": new("b_x", (d_rnn,)),
        "lam": new("lam", (d_rnn,), uniform=(2.0, 6.0)),
        "w_out": new("w_out", (d_rnn, d_model), s),
    }


def _rglru_coeffs(params, u, dtype):
    """u: (..., d_rnn) post-conv inputs -> (a, b) with h = a * h_prev + b."""
    r = torch.sigmoid((u @ mat(params["w_a"], dtype)
                       + mat(params["b_a"], dtype)).to(F32))
    i = torch.sigmoid((u @ mat(params["w_x"], dtype)
                       + mat(params["b_x"], dtype)).to(F32))
    log_a = -RGLRU_C * _softplus(mat(params["lam"], F32)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (
        i * u.to(F32))
    return a, b


def _causal_conv(params, x, conv_state=None):
    """Depthwise causal conv, width 4.  x: (B, T, d) -> (out, the last 3
    inputs, in x's dtype)."""
    w = mat(params["conv_w"], x.dtype)          # (W, d)
    if conv_state is None:
        pad = torch.zeros((x.shape[0], CONV_WIDTH - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    T = x.shape[1]
    out = 0
    for j in range(CONV_WIDTH):
        out = out + xp[:, j:j + T, :] * w[CONV_WIDTH - 1 - j]
    out = out + mat(params["conv_b"], x.dtype)
    return out, xp[:, -(CONV_WIDTH - 1):, :]


def _linear_scan(a, b):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` (h_{-1} = 0) along
    axis 1 of (B, T, d) f32 tensors, in ``ceil(log2 T)`` passes: pass ``s``
    combines each element with the one ``2**s`` before it."""
    T = a.shape[1]
    off = 1
    while off < T:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        a = torch.cat([a[:, :off], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :off], a_cur * b_prev + b_cur], dim=1)
        off *= 2
    return b


def _rglru_apply(params, x, *, dtype, h0=None, conv_state=None):
    """Full-sequence RG-LRU block.  x: (B, T, d_model)."""
    gate = F.gelu((x @ mat(params["w_gate_in"], dtype)).to(F32),
                  approximate="tanh")
    u = x @ mat(params["w_in"], dtype)
    u, conv_state = _causal_conv(params, u, conv_state)
    a, b = _rglru_coeffs(params, u, dtype)
    if h0 is not None:
        # fold the carried state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    y = (h * gate).to(dtype) @ mat(params["w_out"], dtype)
    return y.to(x.dtype), {"h": h[:, -1], "conv": conv_state}


def _rglru_step(params, x_t, state, *, dtype):
    """Single decode step.  x_t: (B, d_model)."""
    gate = F.gelu((x_t @ mat(params["w_gate_in"], dtype)).to(F32),
                  approximate="tanh")
    u = x_t @ mat(params["w_in"], dtype)
    u, conv_state = _causal_conv(params, u[:, None, :], state["conv"])
    a, b = _rglru_coeffs(params, u[:, 0], dtype)
    h = a * state["h"] + b
    y = (h * gate).to(dtype) @ mat(params["w_out"], dtype)
    return y.to(x_t.dtype), {"h": h, "conv": conv_state}


def _rglru_init_state(batch: int, d_rnn: int, device=None):
    return {"h": torch.zeros((batch, d_rnn), dtype=F32, device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, d_rnn), dtype=F32,
                                device=device)}


# --------------------------------------------------------------------------
# mLSTM (xLSTM): matrix memory with exponential gating
# --------------------------------------------------------------------------

def _mlstm_init(new, d_model: int, n_heads: int):
    s = d_model ** -0.5
    d_in = 2 * d_model  # up-projection factor 2 (xLSTM block)
    return {
        "w_up": new("w_up", (d_model, 2 * d_in), s),
        "w_q": new("w_q", (d_in, d_in), s),
        "w_k": new("w_k", (d_in, d_in), s),
        "w_v": new("w_v", (d_in, d_in), s),
        "w_if": new("w_if", (d_in, 2 * n_heads), s),
        "b_if": new("b_if", (2 * n_heads,)),
        "w_down": new("w_down", (d_in, d_model), s),
    }


def _mlstm_qkvg(params, x, n_heads: int, dtype):
    up = x @ mat(params["w_up"], dtype)
    u, z = torch.chunk(up, 2, dim=-1)         # value path, gate path
    B, T, d_in = u.shape
    dh = d_in // n_heads

    def heads(w):
        return (u @ mat(w, dtype)).reshape(B, T, n_heads, dh).transpose(1, 2)

    q = scale_in_dtype(heads(params["w_q"]), dh ** -0.5)
    k = scale_in_dtype(heads(params["w_k"]), dh ** -0.5)
    v = heads(params["w_v"])
    gates = (u @ mat(params["w_if"], dtype)
             + mat(params["b_if"], dtype)).to(F32)
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)   # (B, T, H)
    i_pre = i_pre.transpose(1, 2)                  # (B, H, T)
    f_pre = _log_sigmoid(f_pre.transpose(1, 2))
    return q, k, v, i_pre, f_pre, z


def mlstm_seq_ref(params, x, n_heads: int, *, dtype):
    """Sequential reference (the oracle of the chunkwise path)."""
    q, k, v, i_pre, f_pre, z = _mlstm_qkvg(params, x, n_heads, dtype)
    B, H, T, dh = q.shape
    C = torch.zeros((B, H, dh, dh), dtype=F32, device=x.device)
    n = torch.zeros((B, H, dh), dtype=F32, device=x.device)
    m = torch.full((B, H), M_INIT, dtype=F32, device=x.device)
    hs = []
    for t in range(T):
        it, ft = i_pre[:, :, t], f_pre[:, :, t]
        m_new = torch.maximum(ft + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(ft + m - m_new)
        kt = k[:, :, t].to(F32)
        vt = v[:, :, t].to(F32)
        qt = q[:, :, t].to(F32)
        C = f_s[..., None, None] * C + i_s[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])
        n = f_s[..., None] * n + i_s[..., None] * kt
        num = torch.einsum("bhde,bhe->bhd", C, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, qt)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return _mlstm_out(params, torch.stack(hs, dim=2), z, x, dtype)


def _mlstm_out(params, hs, z, x, dtype):
    B, H, T, dh = hs.shape
    h = hs.transpose(1, 2).reshape(B, T, H * dh).to(dtype)
    y = (h * F.silu(z.to(F32)).to(dtype)) @ mat(params["w_down"], dtype)
    return y.to(x.dtype)


def _mlstm_apply(params, x, n_heads: int, *, dtype, chunk: int = 128,
                 state=None):
    """Chunkwise-parallel mLSTM.  x: (B, T, d_model); T must be a multiple
    of ``min(chunk, T)``, as the reference requires (no padding)."""
    q, k, v, i_pre, f_pre, z = _mlstm_qkvg(params, x, n_heads, dtype)
    B, H, T, dh = q.shape
    C = min(chunk, T)
    if T % C:
        raise ValueError(f"T={T} must be a multiple of chunk={C}")
    nC = T // C
    qf, kf, vf = q.to(F32), k.to(F32), v.to(F32)
    if state is None:
        C_st = torch.zeros((B, H, dh, dh), dtype=F32, device=x.device)
        n_st = torch.zeros((B, H, dh), dtype=F32, device=x.device)
        m_st = torch.full((B, H), M_INIT, dtype=F32, device=x.device)
    else:
        C_st, n_st, m_st = state["C"], state["n"], state["m"]
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))
    hs = []
    for c in range(nC):
        # Unrolling the stabilised recurrence gives
        #   C_t = sum_{s<=t} exp(F_t - F_s + i_s - m_t) v_s k_s^T
        # with F the inclusive cumsum of log-forget; along s the varying
        # part is g_s = i_s - F_s, so the row stabiliser is
        #   m_t = F_t + max(m_prev, max_{s<=t} g_s).
        sl = slice(c * C, (c + 1) * C)
        qb, kb, vb = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl]
        ib, fb = i_pre[:, :, sl], f_pre[:, :, sl]
        Fcum = torch.cumsum(fb, dim=-1)                 # (B, H, C)
        g = ib - Fcum
        g_run = torch.cummax(g, dim=-1).values
        mx_row = torch.maximum(m_st[..., None], g_run)
        m_row = Fcum + mx_row
        # the state's contribution, scaled exp(m_st + F_t - m_row)
        st_scale = torch.exp(m_st[..., None] - mx_row)
        num_state = torch.einsum("bhde,bhce->bhcd", C_st, qb) \
            * st_scale[..., None]
        den_state = torch.einsum("bhd,bhcd->bhc", n_st, qb) * st_scale
        # intra-chunk: D[t, s] = F_t + g_s - m_row[t] (s <= t)
        D = Fcum[..., :, None] + g[..., None, :] - m_row[..., :, None]
        W = torch.exp(torch.where(tri, D, M_INIT))
        scores = torch.einsum("bhcd,bhsd->bhcs", qb, kb) * W
        num = num_state + torch.einsum("bhcs,bhsd->bhcd", scores, vb)
        den = den_state + scores.sum(dim=-1)
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_row))[..., None])
        # chunk-end state, stabilised at m_new = F_end + mx_end
        mx_end = torch.maximum(m_st, g_run[..., -1])
        m_new = Fcum[..., -1] + mx_end
        s_state = torch.exp(m_st - mx_end)
        s_in = torch.exp(g - mx_end[..., None])         # (B, H, C)
        C_st = s_state[..., None, None] * C_st + torch.einsum(
            "bhsd,bhse,bhs->bhde", vb, kb, s_in)
        n_st = s_state[..., None] * n_st + torch.einsum(
            "bhsd,bhs->bhd", kb, s_in)
        m_st = m_new
    hs = torch.cat(hs, dim=2) if nC > 1 else hs[0]
    y = _mlstm_out(params, hs, z, x, dtype)
    return y, {"C": C_st, "n": n_st, "m": m_st}


def _mlstm_step(params, x_t, state, n_heads: int, *, dtype):
    """Single decode step.  x_t: (B, d_model)."""
    y, new_state = _mlstm_apply(params, x_t[:, None, :], n_heads,
                                dtype=dtype, chunk=1, state=state)
    return y[:, 0], new_state


def _mlstm_init_state(batch: int, n_heads: int, d_model: int, device=None):
    dh = (2 * d_model) // n_heads
    return {"C": torch.zeros((batch, n_heads, dh, dh), dtype=F32,
                             device=device),
            "n": torch.zeros((batch, n_heads, dh), dtype=F32, device=device),
            "m": torch.full((batch, n_heads), M_INIT, dtype=F32,
                            device=device)}


# --------------------------------------------------------------------------
# sLSTM (xLSTM): scalar memory, state-dependent gating (sequential)
# --------------------------------------------------------------------------

def _slstm_init(new, d_model: int, n_heads: int):
    s = d_model ** -0.5
    dh = d_model // n_heads
    return {
        "w": new("w", (d_model, 4 * d_model), s),
        "r": new("r", (n_heads, dh, 4 * dh), s),
        "b": new("b", (4 * d_model,)),
        "w_out": new("w_out", (d_model, d_model), s),
    }


def _slstm_cell(r, wx_t, state, n_heads: int):
    """wx_t: (B, 4 * d) the precomputed input projection; ``r`` the
    recurrent weight materialised in f32 (once a layer call); state: dict
    of (B, H, dh)."""
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    B = wx_t.shape[0]
    dh = h.shape[-1]
    rec = torch.einsum("bhd,hde->bhe", h, r)             # (B, H, 4 dh)
    pre = wx_t.reshape(B, n_heads, 4 * dh).to(F32) + rec
    i_pre, f_pre, z_pre, o_pre = torch.chunk(pre, 4, dim=-1)
    f_log = _log_sigmoid(f_pre)
    m_new = torch.maximum(f_log + m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(f_log + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z_pre)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1.0)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def _slstm_apply(params, x, n_heads: int, *, dtype, state=None):
    """x: (B, T, d_model) -> (y, state).  A loop over T."""
    B, T, d = x.shape
    if state is None:
        state = _slstm_init_state(B, n_heads, d, x.device)
    wx = x @ mat(params["w"], dtype) + mat(params["b"], dtype)
    r = mat(params["r"], F32)
    hs = []
    for t in range(T):
        state = _slstm_cell(r, wx[:, t], state, n_heads)
        hs.append(state["h"])
    # (B, T, H, dh) -> (B, T, d)
    h = torch.stack(hs, dim=1).reshape(B, T, d).to(dtype)
    y = h @ mat(params["w_out"], dtype)
    return y.to(x.dtype), state


def _slstm_step(params, x_t, state, n_heads: int, *, dtype):
    wx = x_t @ mat(params["w"], dtype) + mat(params["b"], dtype)
    state = _slstm_cell(mat(params["r"], F32), wx, state, n_heads)
    B, d = x_t.shape
    y = state["h"].reshape(B, d).to(dtype) @ mat(params["w_out"], dtype)
    return y.to(x_t.dtype), state


def _slstm_init_state(batch: int, n_heads: int, d_model: int, device=None):
    dh = d_model // n_heads
    shape = (batch, n_heads, dh)
    return {"h": torch.zeros(shape, dtype=F32, device=device),
            "c": torch.zeros(shape, dtype=F32, device=device),
            "n": torch.zeros(shape, dtype=F32, device=device),
            "m": torch.full(shape, M_INIT, dtype=F32, device=device)}


# The functions the reference's ``models/model.py`` calls across files are
# defined under private names and bound to the public ones here, as
# ``models/model.py`` binds its entry points: tools/lint's jit-discipline
# pass resolves a called name across files only when a single file under
# src/ defines it.
rglru_init = _rglru_init
rglru_apply = _rglru_apply
rglru_step = _rglru_step
rglru_init_state = _rglru_init_state
mlstm_init = _mlstm_init
mlstm_apply = _mlstm_apply
mlstm_step = _mlstm_step
mlstm_init_state = _mlstm_init_state
slstm_init = _slstm_init
slstm_apply = _slstm_apply
slstm_step = _slstm_step
slstm_init_state = _slstm_init_state

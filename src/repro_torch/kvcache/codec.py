"""Lossless ECF8 page codec: exponent-plane entropy coding for K/V pages.

A copy of the reference's ``kvcache/codec.py`` format, byte for byte:

  * each element is split into an **exponent symbol** (4 bits for fp8,
    8 bits for bf16/f32) and a raw **sign+mantissa plane** (packed
    nibbles / 1 byte / 3 bytes per element);
  * the exponent plane is canonical-Huffman coded per page
    (``core.huffman.Codebook``, package-merge length-limited) into 128
    interleaved lane streams, element ``i`` on lane ``i % 128``;
  * round-trips are bit-exact for *any* bit content (NaNs included):
    encode/decode only ever touch integer bit views.

Layout per page: payload ``(stride, 128)`` uint8 (byte j of all lanes is
one contiguous row), every lane carries ``ceil(n_elem / 128)`` symbols,
short pages are padded with the page's modal symbol.

:func:`encode_page` runs in numpy on the host.  :func:`decode_pages_plain`
is the plain PyTorch version of the page decode (the reference's
``decode_pages_jnp``): the CPU path of ``kernels.ops.decode_pages`` and the
comparison for the CUDA kernel ``csrc/kv_page_decode.cu``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.huffman import Codebook, _concat_aranges

LANES = 128
MIN_STRIDE = 4          # decode window preloads 4 bytes
EXP4_MAX_LEN = 8        # fp8: 16 symbols, single-byte peek
EXP8_MAX_LEN = 12       # bf16/f32: 256 symbols, 12-bit peek (<= 16)

# dtype name -> (exponent bits, sign+mantissa bytes per element * 2)
# sm bytes are stored as numerator/2 so fp8's packed nibble (half a byte
# per element) stays integral.
_PLANES = {
    "float8_e4m3fn": (4, 1),
    "bfloat16": (8, 2),
    "float32": (8, 6),
}
# page dtype name -> unsigned bit view (numpy) / same-width torch view
_BITVIEW = {"float8_e4m3fn": np.uint8, "bfloat16": np.uint16,
            "float32": np.uint32}
TORCH_BITS = {"float8_e4m3fn": torch.uint8, "bfloat16": torch.int16,
              "float32": torch.int32}
TORCH_DTYPES = {"float8_e4m3fn": torch.float8_e4m3fn,
                "bfloat16": torch.bfloat16, "float32": torch.float32}


def plane_spec(dtype_name: str) -> tuple[int, int, int]:
    """(exp_bits, max_code_len, sm_halfbytes_per_elem) for a cache dtype."""
    if dtype_name not in _PLANES:
        raise ValueError(f"unsupported page dtype {dtype_name!r}; "
                         f"supported: {sorted(_PLANES)}")
    exp_bits, sm_half = _PLANES[dtype_name]
    max_len = EXP4_MAX_LEN if exp_bits == 4 else EXP8_MAX_LEN
    return exp_bits, max_len, sm_half


def dtype_name(dtype: torch.dtype) -> str:
    """The page-codec name of a torch dtype (``torch.bfloat16`` ->
    ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def sm_bytes(dtype_name: str, n_elem: int) -> int:
    """Raw sign+mantissa plane bytes for ``n_elem`` elements."""
    _, _, sm_half = plane_spec(dtype_name)
    return (n_elem * sm_half + 1) // 2


def sym_per_lane(n_elem: int) -> int:
    """Symbols each of the 128 lane streams carries for an
    ``n_elem``-element page (``ceil(n_elem / LANES)``; short pages are
    padded to this with the page's modal symbol)."""
    return -(-n_elem // LANES)


# --------------------------------------------------------------------------
# bit-plane split / assemble (host numpy, pure integer ops)
# --------------------------------------------------------------------------

def page_bits(values) -> tuple[np.ndarray, str]:
    """(flat unsigned bit view on the host, page dtype name) of a page.

    Takes a torch tensor (any device) of fp8 / bf16 / f32, or a numpy
    array of float32, a raw uint8 fp8 bit view, or any 1- or 2-byte
    float type named ``float8_e4m3fn`` / ``bfloat16``."""
    if isinstance(values, torch.Tensor):
        name = dtype_name(values.dtype)
        name = "float8_e4m3fn" if name == "uint8" else name
        plane_spec(name)
        bits = (values.detach().contiguous().view(TORCH_BITS[name]).cpu()
                .numpy().view(_BITVIEW[name]))
    else:
        values = np.asarray(values)
        name = str(values.dtype)
        name = "float8_e4m3fn" if name == "uint8" else name
        plane_spec(name)
        bits = values.view(_BITVIEW[name])
    return bits.reshape(-1), name


def split_planes(bits: np.ndarray,
                 dtype_name: str) -> tuple[np.ndarray, np.ndarray]:
    """Split a page's bit view into (exponent symbols, raw sign+mantissa
    bytes)."""
    if dtype_name == "float8_e4m3fn":
        exp = (bits >> 3) & np.uint8(0x0F)
        nib = ((bits >> 4) & np.uint8(0x08)) | (bits & np.uint8(0x07))
        if nib.shape[0] % 2:
            nib = np.concatenate([nib, np.zeros(1, np.uint8)])
        pairs = nib.reshape(-1, 2)
        sm = (pairs[:, 0] << 4) | (pairs[:, 1] & np.uint8(0x0F))
        return exp.astype(np.int64), sm
    if dtype_name == "bfloat16":
        exp = (bits >> 7) & np.uint16(0xFF)
        sm = (((bits >> 8) & np.uint16(0x80)) | (bits & np.uint16(0x7F)))
        return exp.astype(np.int64), sm.astype(np.uint8)
    if dtype_name == "float32":
        exp = (bits >> 23) & np.uint32(0xFF)
        sm24 = (((bits >> 8) & np.uint32(0x800000))
                | (bits & np.uint32(0x7FFFFF)))
        smb = np.stack([(sm24 >> 16) & 0xFF, (sm24 >> 8) & 0xFF,
                        sm24 & 0xFF], axis=-1).astype(np.uint8).reshape(-1)
        return exp.astype(np.int64), smb
    raise ValueError(f"unsupported page dtype {dtype_name!r}")


def assemble_planes(exp: np.ndarray, sm: np.ndarray, dtype_name: str,
                    n_elem: int) -> np.ndarray:
    """Inverse of :func:`split_planes` -> raw bit view (uint8/16/32)."""
    exp = np.asarray(exp, dtype=np.uint32)[:n_elem]
    if dtype_name == "float8_e4m3fn":
        nib = np.stack([(sm >> 4) & 0x0F, sm & 0x0F],
                       axis=-1).reshape(-1)[:n_elem]
        return (((nib & 0x08) << 4) | ((exp.astype(np.uint8) & 0x0F) << 3)
                | (nib & 0x07)).astype(np.uint8)
    if dtype_name == "bfloat16":
        sm = sm.astype(np.uint16)[:n_elem]
        u = ((sm & 0x80) << 8) | (exp.astype(np.uint16) << 7) | (sm & 0x7F)
        return u.astype(np.uint16)
    if dtype_name == "float32":
        b = sm.reshape(-1, 3).astype(np.uint32)[:n_elem]
        sm24 = (b[:, 0] << 16) | (b[:, 1] << 8) | b[:, 2]
        u = ((sm24 & 0x800000) << 8) | (exp << 23) | (sm24 & 0x7FFFFF)
        return u.astype(np.uint32)
    raise ValueError(dtype_name)


# --------------------------------------------------------------------------
# encode (host)
# --------------------------------------------------------------------------

@dataclass
class CompressedPage:
    """One entropy-coded cache page (host-side numpy arrays)."""

    payload: np.ndarray    # (stride, LANES) uint8 interleaved lane streams
    signmant: np.ndarray   # raw sign+mantissa plane, uint8
    lj_limit: np.ndarray   # (max_len,) int32 canonical decode tables
    first_lj: np.ndarray   # (max_len,) int32
    offset: np.ndarray     # (max_len,) int32
    perm: np.ndarray       # (n_symbols,) int32 canonical-order symbols
    n_elem: int
    n_active: int          # symbols with nonzero frequency
    dtype_name: str
    shape: tuple

    @property
    def stride(self) -> int:
        return self.payload.shape[0]

    def nbytes(self) -> int:
        """True (ragged) compressed bytes, codebook included.

        A canonical codebook serializes as the active-symbol list in
        canonical order (1 byte each) plus a count per code length
        (2 bytes each); the int32 decode tables are derived from that on
        load, they are a decode-speed representation, not payload."""
        header = self.n_active + 2 * len(self.lj_limit)
        return self.payload.nbytes + self.signmant.nbytes + header

    def ratio(self) -> float:
        itemsize = np.dtype(_BITVIEW[self.dtype_name]).itemsize
        return self.nbytes() / max(self.n_elem * itemsize, 1)

    def tables(self) -> np.ndarray:
        """(3, max_len) int32 stack consumed by the decode paths."""
        return np.stack([self.lj_limit, self.first_lj, self.offset])


def encode_page(values) -> CompressedPage:
    """Compress one page losslessly (exponent plane entropy-coded).

    ``values``: a torch tensor or numpy array (:func:`page_bits`)."""
    orig_shape = tuple(values.shape)
    bits, dtype_name = page_bits(values)
    exp, sm = split_planes(bits, dtype_name)
    n = exp.shape[0]
    if n == 0:
        raise ValueError("empty page")
    exp_bits, max_len, _ = plane_spec(dtype_name)
    n_sym = 1 << exp_bits

    freqs = np.bincount(exp, minlength=n_sym)
    cb = Codebook.from_freqs(freqs, max_len=max_len)

    S = sym_per_lane(n)
    pad_sym = int(np.argmax(freqs))
    exp_p = np.concatenate(
        [exp, np.full(S * LANES - n, pad_sym, dtype=np.int64)])
    payload = _encode_lanes(exp_p.reshape(S, LANES), cb)
    return CompressedPage(
        payload=payload, signmant=sm,
        lj_limit=cb.lj_limit.astype(np.int32),
        first_lj=cb.first_lj.astype(np.int32),
        offset=cb.offset.astype(np.int32),
        perm=cb.sorted_syms.astype(np.int32),
        n_elem=n, n_active=int((freqs > 0).sum()),
        dtype_name=dtype_name, shape=orig_shape,
    )


def _encode_lanes(syms: np.ndarray, cb: Codebook) -> np.ndarray:
    """(S, LANES) symbols -> (stride, LANES) uint8 interleaved payload.

    Element ``i`` maps to lane ``i % LANES``, slot ``i // LANES`` — the
    layout of ``core.tpu_format`` with a single chunk per page."""
    S = syms.shape[0]
    codes_r = cb.codes[syms].T                        # (LANES, S)
    lens_r = cb.lengths[syms].T.astype(np.int64)      # (LANES, S)
    starts = np.cumsum(lens_r, axis=1) - lens_r
    lane_bits = starts[:, -1] + lens_r[:, -1]
    stride = max(int(-(-int(lane_bits.max()) // 8)), MIN_STRIDE)

    flat_lens = lens_r.reshape(-1)
    within = _concat_aranges(flat_lens)
    rep_rows = np.repeat(np.repeat(np.arange(LANES), S), flat_lens)
    bitpos = np.repeat(starts.reshape(-1), flat_lens) + within
    shift = np.repeat(flat_lens, flat_lens) - 1 - within
    bitvals = (np.repeat(codes_r.reshape(-1), flat_lens) >> shift) & 1
    bitmat = np.zeros((LANES, stride * 8), dtype=np.uint8)
    bitmat[rep_rows, bitpos] = bitvals.astype(np.uint8)

    weights = (1 << np.arange(7, -1, -1)).astype(np.uint16)
    bytemat = (bitmat.reshape(LANES, stride, 8).astype(np.uint16)
               * weights).sum(axis=2).astype(np.uint8)  # (LANES, stride)
    return bytemat.T.copy()


# --------------------------------------------------------------------------
# decode (host oracle)
# --------------------------------------------------------------------------

def decode_page(cp: CompressedPage) -> torch.Tensor:
    """Readable per-lane oracle -> original values (bit-exact), a CPU
    tensor of the page's dtype and shape (the reference's numpy decoder:
    each lane stream walked a ``max_len``-bit peek at a time)."""
    _, max_len, _ = plane_spec(cp.dtype_name)
    S = sym_per_lane(cp.n_elem)
    cb = Codebook(lengths=np.zeros(len(cp.perm), np.int32), codes=None,
                  max_len=max_len)  # type: ignore[arg-type]
    cb.sorted_syms = np.asarray(cp.perm)
    cb.lj_limit = np.asarray(cp.lj_limit, dtype=np.int64)
    cb.first_lj = np.asarray(cp.first_lj, dtype=np.int64)
    cb.offset = np.asarray(cp.offset, dtype=np.int64)

    stride = cp.stride
    syms = np.zeros((S, LANES), dtype=np.int64)
    for lane in range(LANES):
        stream = cp.payload[:, lane]
        bitpos = 0
        for s in range(S):
            peek = 0
            for b in range(max_len):
                p = bitpos + b
                bit = ((int(stream[p // 8]) >> (7 - p % 8)) & 1
                       if p // 8 < stride else 0)
                peek = (peek << 1) | bit
            sym, ln = cb.decode_peek(peek)
            syms[s, lane] = sym
            bitpos += ln
    exp = syms.reshape(-1)[: cp.n_elem]
    bits = assemble_planes(exp, cp.signmant, cp.dtype_name, cp.n_elem)
    t = torch.from_numpy(np.ascontiguousarray(bits).view(
        np.dtype(str(TORCH_BITS[cp.dtype_name]).removeprefix("torch."))))
    return t.view(TORCH_DTYPES[cp.dtype_name]).reshape(cp.shape)


# --------------------------------------------------------------------------
# decode: the plain PyTorch version of the page-decode kernel
# --------------------------------------------------------------------------

def decode_pages_plain(payload, signmant, tables, perm, *, n_elem: int,
                       dtype_name: str) -> torch.Tensor:
    """Decode N compressed pages -> (N, n_elem) values of ``dtype_name``.

    Args:
      payload:  (N, stride, LANES) uint8, zero-padded lane streams.
      signmant: (N, sm_bytes) uint8 raw sign+mantissa plane.
      tables:   (N, 3, max_len) int32 — lj_limit / first_lj / offset.
      perm:     (N, n_symbols) int32 canonical symbol permutation.

    The reference's ``_decode_indices_jnp`` then ``finish_pages_jnp``:
    per-lane 32-bit window (held in int64 and masked), ``max_len``-bit
    peek, the first length whose limit exceeds the peek (length 1 when
    none does, as ``argmax`` over all-False gives: the all-zero tables of
    a never-written cold slot), <= 2 refill bytes per round from
    ``min(byteptr, stride - 1)``, then the perm lookup with the index
    clamped into the table and the sign/mantissa fuse, in integer
    arithmetic viewed as the page type at the end."""
    N, stride, _ = payload.shape
    S = sym_per_lane(n_elem)
    L = tables.shape[-1]
    dev = payload.device
    p = payload[:, :4, :].to(torch.int64)
    win = (p[:, 0] << 24) | (p[:, 1] << 16) | (p[:, 2] << 8) | p[:, 3]
    byteptr = torch.full((N, LANES), 4, dtype=torch.int64, device=dev)
    bits_valid = torch.full_like(byteptr, 32)
    tab = tables.to(torch.int64)
    lj, fl_t, off_t = tab[:, 0], tab[:, 1], tab[:, 2]      # (N, L)
    outs = torch.empty((N, S, LANES), dtype=torch.int64, device=dev)
    for s in range(S):
        peek = win >> (32 - L)                              # (N, LANES)
        lt = (peek[..., None] < lj[:, None, :]).to(torch.uint8)
        length = torch.argmax(lt, dim=-1) + 1               # (N, LANES)
        fl = torch.gather(fl_t, 1, length - 1)
        off = torch.gather(off_t, 1, length - 1)
        outs[:, s] = off + ((peek - fl) >> (L - length))
        win = (win << length) & 0xFFFFFFFF
        bits_valid = bits_valid - length
        for _ in range(2):                                  # <= 2 bytes/round
            need = bits_valid <= 24
            safe_ptr = byteptr.clamp(max=stride - 1)
            nb = torch.gather(payload, 1, safe_ptr[:, None, :])[:, 0]
            shift = (24 - bits_valid).clamp(min=0)
            win = torch.where(need, win | (nb.to(torch.int64) << shift), win)
            byteptr = byteptr + need
            bits_valid = bits_valid + 8 * need
    idx = outs.reshape(N, -1).clamp(0, perm.shape[1] - 1)
    syms = torch.gather(perm.to(torch.int64), 1, idx)[:, :n_elem]
    return assemble_pages(syms, signmant, n_elem=n_elem,
                          dtype_name=dtype_name)


def decode_table(tables, perm, *, dtype_name: str) -> torch.Tensor:
    """The page-decode kernel's lookup table, in plain PyTorch: for every
    page and every ``max_len``-bit peek, ``(symbol << 5) | length`` by the
    rule of :func:`decode_pages_plain` (the first length whose limit
    exceeds the peek, 1 when none does; the index clamped into the perm),
    the symbol kept to its low 9 bits, all that :func:`assemble_pages`
    keeps of it -> (N, 1 << max_len) int32.  ``csrc/kv_page_decode.cu``
    builds the same table in shared memory, one read a symbol."""
    _, L, _ = plane_spec(dtype_name)
    tab = tables.to(torch.int64)
    peek = torch.arange(1 << L, dtype=torch.int64, device=tables.device)
    lt = (peek[None, :, None] < tab[:, 0, None, :]).to(torch.uint8)
    length = torch.argmax(lt, dim=-1) + 1                  # (N, 1 << L)
    fl = torch.gather(tab[:, 1], 1, length - 1)
    off = torch.gather(tab[:, 2], 1, length - 1)
    idx = (off + ((peek[None] - fl) >> (L - length))).clamp(
        0, perm.shape[1] - 1)
    sym = torch.gather(perm.to(torch.int64), 1, idx) & 0x1FF
    return ((sym << 5) | length).to(torch.int32)


def assemble_pages(syms, signmant, *, n_elem: int,
                   dtype_name: str) -> torch.Tensor:
    """(N, n_elem) exponent symbols + raw sm plane -> (N, n_elem) values
    (the reference's ``assemble_pages_jnp``, in int64 arithmetic)."""
    N = syms.shape[0]
    syms = syms.to(torch.int64)
    sm = signmant.to(torch.int64)
    if dtype_name == "float8_e4m3fn":
        nib = torch.stack([(sm >> 4) & 0x0F, sm & 0x0F],
                          dim=-1).reshape(N, -1)[:, :n_elem]
        u = ((nib & 0x08) << 4) | ((syms & 0x0F) << 3) | (nib & 0x07)
        return u.to(torch.uint8).view(torch.float8_e4m3fn)
    if dtype_name == "bfloat16":
        sm = sm[:, :n_elem]
        u = (((sm & 0x80) << 8) | (syms << 7) | (sm & 0x7F)) & 0xFFFF
        # two's-complement int16 of the 16 bits, then the bit view
        return (u - ((u & 0x8000) << 1)).to(torch.int16).view(torch.bfloat16)
    if dtype_name == "float32":
        b = sm.reshape(N, -1, 3)[:, :n_elem]
        sm24 = (b[..., 0] << 16) | (b[..., 1] << 8) | b[..., 2]
        u = (((sm24 & 0x800000) << 8) | (syms << 23)
             | (sm24 & 0x7FFFFF)) & 0xFFFFFFFF
        return (u - ((u & 0x80000000) << 1)).to(torch.int32).view(
            torch.float32)
    raise ValueError(dtype_name)

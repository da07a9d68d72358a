"""FP8 (float8_e4m3fn) bit-field helpers on ``uint8`` tensors.

Bit layout (IEEE-754-style, e4m3fn):  [s eeee mmm]
  bit 7      : sign
  bits 6..3  : 4-bit exponent field (biased by 7; field value 0 = subnormal)
  bits 2..0  : 3-bit mantissa

ECF8 splits each byte into the 4-bit exponent field (entropy-coded) and the
4-bit sign+mantissa nibble ``q = (s << 3) | m`` (stored packed, two per
byte).
"""
from __future__ import annotations

import torch

FP8_DTYPE = torch.float8_e4m3fn
EXP_BITS = 4
MANT_BITS = 3
EXP_BIAS = 7
N_EXP_SYMBOLS = 1 << EXP_BITS  # 16

_F32_MIN_NORMAL_FP8 = 0x3C800000  # bits of 2**-6, the smallest fp8 normal
_F32_LAST_ROUNDS_TO_MAX = 0x43E80000  # bits of 464.0: above it -> NaN
CAST_PIECE = 1 << 26  # elements cast per pass


def exponent_field(bits: torch.Tensor) -> torch.Tensor:
    """Extract the 4-bit exponent field (values 0..15)."""
    return (bits >> 3) & 0x0F


def signmant_nibble(bits: torch.Tensor) -> torch.Tensor:
    """Extract the 4-bit sign+mantissa nibble ``(s << 3) | m``."""
    return ((bits >> 4) & 0x08) | (bits & 0x07)


def assemble(exp_field: torch.Tensor, signmant: torch.Tensor) -> torch.Tensor:
    """Rebuild the fp8 byte from a 4-bit exponent field and 4-bit s+m nibble."""
    exp_field = exp_field.to(torch.uint8)
    signmant = signmant.to(torch.uint8)
    return (((signmant & 0x08) << 4) | ((exp_field & 0x0F) << 3)
            | (signmant & 0x07))


def pack_nibbles(nibbles: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit values two-per-byte (element 2i -> high nibble of byte i)."""
    nibbles = nibbles.to(torch.uint8)
    if nibbles.shape[0] % 2:
        nibbles = torch.cat([nibbles, nibbles.new_zeros(1)])
    pairs = nibbles.reshape(-1, 2)
    return (pairs[:, 0] << 4) | (pairs[:, 1] & 0x0F)


def unpack_nibbles(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`; returns ``n`` 4-bit values."""
    hi = (packed >> 4) & 0x0F
    lo = packed & 0x0F
    return torch.stack([hi, lo], dim=-1).reshape(-1)[:n]


def cast_to_fp8_bits(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even cast of a float tensor to e4m3fn bits (uint8).

    Written out on the float32 bit pattern so that it is bit-equal to
    ``jnp.astype(float8_e4m3fn)`` on every device: magnitudes above 464
    (which round past the largest finite value 448) and infinities become
    NaN, subnormals round to multiples of 2**-9, signed zeros keep their
    sign.  (PyTorch's own CPU cast saturates overflow to 448 instead.)
    Runs in pieces of ``CAST_PIECE`` elements to bound its temporaries."""
    flat = x.reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.uint8, device=x.device)
    for i in range(0, flat.numel(), CAST_PIECE):
        out[i:i + CAST_PIECE] = _cast_piece(flat[i:i + CAST_PIECE])
    return out.reshape(x.shape)


def _cast_piece(x: torch.Tensor) -> torch.Tensor:
    b = x.to(torch.float32).contiguous().view(torch.int32)
    sign = (b >> 24) & 0x80
    a = b & 0x7FFFFFFF
    # normal range: drop 20 mantissa bits with round-half-to-even, then
    # rebias the exponent from 127 to 7 (a mantissa carry bumps it)
    normal = ((a + ((a >> 20) & 1) + 0x7FFFF) >> 20) - (120 << 3)
    # subnormal range: the value in units of 2**-9, rounded half-to-even
    # (scaling by a power of two is exact); 8 units is the smallest normal
    sub = torch.round(x.to(torch.float32).abs() * 512.0).to(torch.int32)
    mag = torch.where(a < _F32_MIN_NORMAL_FP8, sub, normal)
    mag = torch.where(a > _F32_LAST_ROUNDS_TO_MAX,
                      torch.full_like(mag, 0x7F), mag)
    return (mag | sign).to(torch.uint8)


def cast_to_fp8(x: torch.Tensor) -> torch.Tensor:
    """:func:`cast_to_fp8_bits` viewed as ``torch.float8_e4m3fn``."""
    return cast_to_fp8_bits(x).view(FP8_DTYPE)

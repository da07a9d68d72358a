"""Quickstart of the PyTorch port: compress fp8 weights losslessly with
ECF8 and verify, decoding on the card.

  1. synthesize "trained-like" fp8 weights (alpha-stable law, paper
     §2.2.1; numpy, seed 0);
  2. measure exponent entropy against the paper's Theorem 2.1 bounds;
  3. encode the three containers on the host (paper-faithful / ECF8-TPU /
     ECF8-FR);
  4. decode each and check bit-exact round trips: ECF8-TPU through the
     hand-written decode kernel (``csrc/ecf8_decode.cu``) on the card, FR
     through ``fixedrate.decode_plain`` on the card, the paper container
     through both of its host decoders; then report bits a weight and the
     savings.

Usage:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the CPU (``--device cpu``) the decode runs the kernel's plain PyTorch
version.  The exit code is 0 when every round trip is bit-exact.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (fixedrate, paper_format, stats, theory,
                              tpu_format)
from repro_torch.device import resolve
from repro_torch.kernels import ops

SHAPE = (1024, 1024)
ALPHA = 1.9


def tpu_ragged_bytes(c, w_bits: np.ndarray) -> int:
    """The ECF8-TPU container's bytes in its ragged layout (each chunk at
    its own stride, with the chunk offsets), as the reference's
    ``TpuECF8.nbytes("ragged")`` counts them; the port keeps the uniform
    payload alone, so the per-chunk strides are recounted from the code
    lengths of the weight's exponents."""
    exps = (w_bits.reshape(-1).astype(np.int64) >> 3) & 0xF
    S, L = c.sym_per_lane, tpu_format.LANES
    C = c.payload.shape[0]
    pad = int(np.argmax(np.bincount(exps, minlength=16)))
    exps = np.concatenate([exps, np.full(C * S * L - exps.size, pad)])
    lens = c.lengths.cpu().numpy().astype(np.int64)[exps.reshape(C, S, L)]
    lane_bytes = (lens.sum(axis=1) + 7) // 8                     # (C, L)
    strides = np.maximum(lane_bytes.max(axis=1), tpu_format.MIN_STRIDE)
    tables = sum(t.numel() * t.element_size()
                 for t in (c.lj_limit, c.first_lj, c.offset, c.perm))
    return (int(strides.sum()) * L + (C + 1) * 4 + c.signmant.numel()
            + tables)


def tpu_uniform_bytes(c) -> int:
    """The ECF8-TPU container's bytes as the decode kernel reads them."""
    return sum(t.numel() * t.element_size()
               for t in (c.payload, c.signmant, c.lj_limit, c.first_lj,
                         c.offset, c.perm))


def decode_tpu(c, dev: torch.device) -> torch.Tensor:
    """ECF8-TPU -> uint8 fp8 bits on ``dev``: the decode kernel on the
    card, its plain version on the CPU (``kernels.ops.decode_ecf8``)."""
    a = [t.to(dev) for t in (c.payload, c.signmant, c.lj_limit, c.first_lj,
                             c.offset, c.perm)]
    return ops.decode_ecf8(*a, sym_per_lane=c.sym_per_lane,
                           n_elem=c.n_elem)


def decode_fr(c, dev: torch.device) -> torch.Tensor:
    """ECF8-FR -> uint8 fp8 bits on ``dev`` (``fixedrate.decode_plain``)."""
    return fixedrate.decode_plain(c.codes.to(dev), c.escapes.to(dev),
                                  c.table.to(dev), c.signmant.to(dev),
                                  n_elem=c.n_elem)


def report(w_bits: np.ndarray, dev: torch.device) -> dict:
    """Every container of ``w_bits`` (uint8 fp8 bits) encoded on the host,
    decoded (ECF8-TPU and FR on ``dev``) and checked bit-exact -> the
    printed figures: entropy, fitted alpha, bits a weight and savings."""
    s = stats.summarize_tensor(w_bits)
    lo, hi = theory.exponent_entropy_bounds(ALPHA)
    print(f"exponent entropy  : {s['entropy_bits']:.3f} bits "
          f"(paper reports 2-3; Thm 2.1 bounds for alpha={ALPHA}: "
          f"[{lo:.2f}, {hi:.2f}])")
    print(f"fitted alpha      : {s['alpha_hat']:.2f}")
    print(f"compression limit : {theory.compression_limit_bits(2.0):.2f} "
          f"bits/weight (the paper's FP4.67 floor at alpha=2)\n")
    n = w_bits.size
    flat = w_bits.reshape(-1)

    c_paper = paper_format.encode(w_bits)
    assert np.array_equal(paper_format.decode_sequential(c_paper)
                          .reshape(-1), flat)
    assert np.array_equal(paper_format.decode_blockparallel(c_paper)
                          .reshape(-1), flat)
    print(f"paper container   : {8 * c_paper.ratio:.3f} bits/weight "
          f"(lossless ✓, sequential and block-parallel decode ✓)")

    c_tpu = tpu_format.encode(torch.from_numpy(w_bits))
    got = decode_tpu(c_tpu, dev)
    assert np.array_equal(got.cpu().numpy(), flat)
    ragged, uniform = tpu_ragged_bytes(c_tpu, w_bits), tpu_uniform_bytes(
        c_tpu)
    print(f"ECF8-TPU (ragged) : {8 * (ragged / n):.3f} bits/weight "
          f"(lossless ✓, decode kernel on {dev.type} ✓)")
    print(f"ECF8-TPU (uniform): {8 * (uniform / n):.3f} bits/weight")

    c_fr = fixedrate.encode(torch.from_numpy(w_bits))
    assert np.array_equal(decode_fr(c_fr, dev).cpu().numpy(), flat)
    print(f"ECF8-FR           : {8 * c_fr.ratio:.3f} bits/weight "
          f"(lossless ✓, static-shape encode+decode ✓, "
          f"escape rate {c_fr.esc_count / c_fr.n_elem:.2%})")

    ideal = s["entropy_bits"] + 1 + 3  # H(E) + sign + mantissa
    out = dict(entropy_bits=s["entropy_bits"], alpha_hat=s["alpha_hat"],
               paper_bits=8 * c_paper.ratio,
               tpu_ragged_bits=8 * (ragged / n),
               tpu_uniform_bits=8 * (uniform / n), fr_bits=8 * c_fr.ratio,
               tpu_ragged_bytes=ragged, tpu_uniform_bytes=uniform,
               esc_count=c_fr.esc_count)
    out.update(saving_paper=100 * (1 - c_paper.ratio),
               saving_tpu=100 * (1 - ragged / n),
               saving_fr=100 * (1 - c_fr.ratio))
    print(f"\nentropy-coding floor for this tensor: {ideal:.3f} bits/weight "
          f"(H(E) + 4-bit sign/mantissa)")
    print(f"memory saving vs fp8: paper {out['saving_paper']:.1f}%  "
          f"tpu {out['saving_tpu']:.1f}%  fr {out['saving_fr']:.1f}%  "
          f"(paper Table 1 band: 9.8-26.9%)")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the decodes run (the card by default)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    print(f"=== ECF8 quickstart: {SHAPE} fp8 weights, alpha={ALPHA}, "
          f"decoding on {dev} ===\n")
    w_bits = stats.synthesize_fp8_weights(SHAPE, alpha=ALPHA, seed=0)
    return report(w_bits, dev)


if __name__ == "__main__":
    main()

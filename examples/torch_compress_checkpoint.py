"""Checkpoint-compression example of the PyTorch port: ECF8 on the
fault-tolerance path.

Saves an fp8 model checkpoint twice -- raw and ECF8-compressed -- with
``repro_torch.checkpoint``, then restores the compressed one onto the card
(each fp8 leaf decoded by the hand-written ECF8 decode kernel,
``csrc/ecf8_decode.cu``), proves every leaf bit-identical, and reports the
size difference.  At scale, restore bandwidth gates the time to resume; the
paper's compression ratio applies directly to it.

Usage:  PYTHONPATH=src python examples/torch_compress_checkpoint.py [--device cpu]

On the CPU the restore runs the kernel's plain PyTorch version.  The exit
code is 0 when the restore is bit-exact.
"""
import argparse
import dataclasses
import os
import tempfile
import zlib

import torch

from repro_torch.checkpoint import restore_tree, save_tree
from repro_torch.configs import get, smoke_variant
from repro_torch.core import stats
from repro_torch.device import resolve
from repro_torch.models import model as M


def checkpoint_config():
    """A ~20M-parameter qwen3 variant: big enough that per-tensor coding
    overheads (codebooks, lane padding) are amortized as in a real
    checkpoint (the reference example's config)."""
    return dataclasses.replace(
        smoke_variant(get("qwen3-8b")), name="qwen3-20m", d_model=768,
        n_heads=8, n_kv_heads=4, head_dim=96, d_ff=2048, vocab_size=8192,
        n_layers=4)


def fp8_trained_like(tree, dev: torch.device, path=()):
    """Every leaf of two or more dims replaced by fp8 weights with the
    paper's trained-weight statistics (alpha-stable, ``stats.
    synthesize_fp8_weights``, seeded by a CRC of the leaf's path), on
    ``dev``; the rest kept: the checkpoint the paper would compress."""
    if isinstance(tree, dict):
        return {k: fp8_trained_like(v, dev, path + (k,))
                for k, v in tree.items()}
    if tree.ndim < 2:
        return tree.to(dev)
    bits = stats.synthesize_fp8_weights(
        tuple(tree.shape), alpha=1.9,
        seed=zlib.crc32("/".join(path).encode()))
    return torch.from_numpy(bits).to(dev).view(torch.float8_e4m3fn)


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


def dir_bytes(d: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def round_trip(params, dev: torch.device, work: str) -> dict:
    """Save ``params`` raw and ECF8 under ``work``, restore the ECF8 one
    onto ``dev`` and check every leaf's bits -> the two sizes in bytes."""
    raw_dir, ecf_dir = os.path.join(work, "raw"), os.path.join(work, "ecf8")
    save_tree(params, raw_dir, step=0, compress="none")
    save_tree(params, ecf_dir, step=0, compress="ecf8")
    rb, eb = dir_bytes(raw_dir), dir_bytes(ecf_dir)
    print(f"raw fp8 checkpoint : {rb / 1e6:.2f} MB")
    print(f"ECF8 checkpoint    : {eb / 1e6:.2f} MB "
          f"(savings {100 * (1 - eb / rb):.1f}%)")
    restored, step = restore_tree(ecf_dir, params, device=dev)
    assert step == 0
    for (pa, a), (pb, b) in zip(leaves(params), leaves(restored)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape, pa
        assert torch.equal(a.contiguous().view(torch.uint8).cpu(),
                           b.contiguous().view(torch.uint8).cpu()), pa
    print("restore is bit-exact ✓")
    return dict(raw_bytes=rb, ecf8_bytes=eb)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the restore decodes (the card by default)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = checkpoint_config()
    params = fp8_trained_like(M.init_params(cfg, 0, device="cpu"), dev)
    with tempfile.TemporaryDirectory(prefix="ckpt_ecf8_") as work:
        return round_trip(params, dev, work)


if __name__ == "__main__":
    main()

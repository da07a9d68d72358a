"""End-to-end training example of the PyTorch port: a ~100M-parameter LM
for a few hundred steps, on the card.

Uses the port's whole training stack through ``repro_torch.launch.train``:
the config system, the synthetic data pipeline, AdamW + the cosine
schedule, remat, async checkpointing and the straggler monitor, with the
attention forward and backward in the hand-written flash kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``).  The loss falling from
~log(V) proves the whole substrate works.

Usage:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

On the CPU the kernels' plain PyTorch versions run (slowly: give it fewer
steps).  The run fails unless the loss falls by more than 0.5.
"""
import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch.configs import get
from repro_torch.configs.registry import _REGISTRY
from repro_torch.launch import train as T


def make_100m():
    """A ~100M-param dense LM (qwen3-family shape, scaled down), registered
    so that ``launch/train.py --arch`` finds it."""
    cfg = dataclasses.replace(
        get("qwen3-8b"), name="qwen3-100m", n_layers=8, d_model=512,
        n_heads=8, n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=8192,
        dtype="float32",
    )
    _REGISTRY[cfg.name] = cfg
    return cfg


def train(cfg, steps: int, batch: int, seq_len: int, ckpt_dir: str,
          device: str) -> list:
    """``steps`` steps of ``cfg`` through the port's trainer from scratch
    -> the losses."""
    return T.main([
        "--arch", cfg.name, "--steps", str(steps),
        "--batch", str(batch), "--seq-len", str(seq_len),
        "--lr", "1e-3", "--save-every", "100", "--log-every", "20",
        "--ckpt-dir", ckpt_dir, "--device", device,
    ])


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a fresh temporary directory (an existing "
                         "one triggers auto-resume, which is launch/train.py's "
                         "job; this example shows a from-scratch run)")
    ap.add_argument("--device", default="cuda",
                    help="where it trains (the card by default)")
    args = ap.parse_args(argv)
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_lm_")

    cfg = make_100m()
    n = cfg.param_count()
    print(f"=== training {cfg.name}: {n / 1e6:.0f}M params, "
          f"{args.steps} steps on {args.device} ===")
    losses = train(cfg, args.steps, args.batch, args.seq_len, args.ckpt_dir,
                   args.device)
    k = max(len(losses) // 10, 1)
    first, last = np.mean(losses[:k]), np.mean(losses[-k:])
    assert last < first - 0.5, (first, last)
    print(f"loss fell {first:.3f} -> {last:.3f}: training works ✓")
    return losses


if __name__ == "__main__":
    main()

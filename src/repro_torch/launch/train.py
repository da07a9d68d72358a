"""End-to-end trainer with fault tolerance, on the card (the reference's
``launch/train.py``).

  * auto-resume from the latest valid checkpoint (atomic, checksummed);
  * an async checkpoint every ``--save-every`` steps, drained at each save
    point, so periodic checkpoints are durability barriers;
  * preemption safety: SIGTERM / SIGINT end the loop with a final
    synchronous save;
  * straggler monitor: a slow-step alarm triggers an eager async save;
  * failure injection (``--fail-at-step``, ``os._exit(42)``) for the
    restart drill.

Weights are random, from ``--seed`` (``models.model.init_params``); the
data is the reference's synthetic stream (``data.pipeline``).  The step is
``runtime.steps.make_train_step`` (remat on, AdamW, cosine schedule).  It
runs on the card unless ``--device cpu``; a mesh (``--mesh host``) is not
ported yet.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --smoke --device cpu --steps 40 --ckpt-dir "$TMPDIR/ckpt"

Without ``--ckpt-dir`` checkpoints go to ``repro_ckpt`` under the
temporary directory (``$TMPDIR``); the trainer resumes from whatever it
finds there, so give each run its own directory.
"""
from __future__ import annotations

import argparse
import os
import signal
import tempfile
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get, smoke_variant
from ..core.store import torch_dtype
from ..data import DataConfig, SyntheticLMData
from ..device import resolve
from ..models import model as M
from ..optim.adamw import AdamWConfig, adamw_init
from ..runtime.monitor import StragglerMonitor
from ..runtime.steps import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-compress", default="none",
                    choices=["none", "ecf8"])
    ap.add_argument("--mesh", default="none", choices=["none", "host"])
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="simulate a hard failure (for the restart test)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise SystemExit(f"--mesh {args.mesh}: not yet ported (the port "
                         f"trains on one card)")

    cfg = get(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    dev = resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, seed=args.seed))

    params = M.init_params(cfg, args.seed, device=dev,
                           dtype=torch_dtype(cfg.dtype))
    opt_state = adamw_init(params)

    def state(step):
        return {"params": params, "opt": opt_state,
                "step": torch.tensor(step, dtype=torch.int32)}

    mgr = CheckpointManager(args.ckpt_dir, keep=3,
                            compress=args.ckpt_compress)
    restored, at = mgr.restore(state(0), device=dev)
    start_step = 0
    if restored is not None:
        params, opt_state = restored["params"], restored["opt"]
        start_step = int(restored["step"]) + 1
        print(f"[train] resumed from step {at} -> starting at {start_step}")

    step_fn = make_train_step(
        cfg, AdamWConfig(lr=args.lr), grad_accum=args.grad_accum,
        remat=True, warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps)

    # preemption safety: final synchronous checkpoint on SIGTERM/SIGINT
    preempted = {"flag": False}

    def _handler(signum, frame):
        preempted["flag"] = True
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _handler)

    mon = StragglerMonitor()
    losses = []
    i = start_step
    for i in range(start_step, args.steps):
        if args.fail_at_step == i:
            print(f"[train] simulating hard failure at step {i}",
                  flush=True)
            os._exit(42)  # no cleanup: models a machine loss
        batch = data.batch(i, dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch, i)
        loss = float(metrics["loss"])           # waits for the step
        stats = mon.observe(time.perf_counter() - t0, i)
        losses.append(loss)
        if stats.is_straggler:
            print(f"[train] straggler alarm at step {i}: "
                  f"{stats.seconds:.3f}s (z={stats.z:.1f}) — eager save")
            mgr.save_async(i, state(i))
        if i % args.log_every == 0:
            print(f"step {i:5d} loss {loss:.4f} lr {float(metrics['lr']):.2e}"
                  f" gnorm {float(metrics['grad_norm']):.3f}"
                  f" {stats.seconds * 1e3:.0f}ms", flush=True)
        if i and i % args.save_every == 0:
            mgr.save_async(i, state(i))
            # periodic saves are the durability boundary of the restart
            # contract: a machine loss anywhere in (i, i + save_every] must
            # resume from step i, so drain the write (and any queued eager
            # saves) before advancing; write errors surface here
            mgr.wait()
        if preempted["flag"]:
            print(f"[train] preemption signal at step {i}: final save")
            break

    mgr.wait()   # drain queued async writes before the final sync save
    mgr.save_sync(i, state(i))
    mgr.close()
    k = max(len(losses) // 10, 1)
    if len(losses) >= 2 * k:
        print(f"[train] loss first-{k}-avg {np.mean(losses[:k]):.4f} -> "
              f"last-{k}-avg {np.mean(losses[-k:]):.4f}")
    print(f"[train] done at step {i}; ewma step "
          f"{mon.ewma_seconds * 1e3:.0f}ms; alarms={len(mon.alarms)}")
    return losses


if __name__ == "__main__":
    main()

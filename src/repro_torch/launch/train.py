"""End-to-end trainer with fault tolerance, on the card (the reference's
``launch/train.py``).

  * auto-resume from the latest valid checkpoint (atomic, checksummed);
  * an async checkpoint every ``--save-every`` steps, drained at each save
    point, so periodic checkpoints are durability barriers;
  * preemption safety: SIGTERM / SIGINT end the loop with a final
    synchronous save;
  * straggler monitor: a slow-step alarm triggers an eager async save;
  * failure injection (``--fail-at-step``, ``os._exit(42)``) for the
    restart drill;
  * a mesh of ranks (``--mesh host --model-axis M``): ``D = ranks / M``
    batch shards of ``M`` model ranks, one process a rank
    (``launch/mesh.py``), the state placed by the rule table
    (``runtime.steps.init_sharded``), each rank drawing its rows
    (``sharded_batch``), checkpoints gathered to rank 0 and restored onto
    the rank's shards.

Weights are random, from ``--seed`` (``models.model.init_params``); the
data is the reference's synthetic stream (``data.pipeline``).  The step is
``runtime.steps.make_train_step`` (remat on, AdamW, cosine schedule).  It
runs on the card unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --smoke --device cpu --steps 40 --ckpt-dir "$TMPDIR/ckpt"
  # four gloo ranks on the CPU, a model axis of 2 (a 2x2 mesh)
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --mesh host --model-axis 2 --ranks 4 --steps 3 --batch 4 --seq-len 16
  # the mixture-of-experts stack, each model rank training E / M experts
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --arch moonshot-v1-16b-a3b --mesh host --model-axis 2 --ranks 2
  # a recurrent stack (sLSTM + mLSTM; recurrentgemma-2b's RG-LRU + local
  # window likewise), each mixer reading the sequence gathered over model
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --arch xlstm-350m --mesh host --model-axis 2 --ranks 4
  # every visible card a rank (NCCL), or the ranks torchrun started
  PYTHONPATH=src python -m repro_torch.launch.train --mesh host \\
      --model-axis 2

Without ``--ckpt-dir`` checkpoints go to ``repro_ckpt`` under the
temporary directory (``$TMPDIR``); the trainer resumes from whatever it
finds there, so give each run its own directory.  On a mesh rank 0 prints
the log and a closing ``mesh {data: D, model: M}`` line with the experts
a rank trains (``E / M``, for a MoE stack) and each rank's resident state
(parameters and moments, GiB).
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
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
from ..optim.adamw import AdamWConfig, adamw_init, iter_leaves
from ..runtime import collectives
from ..runtime.monitor import StragglerMonitor
from ..runtime.sharding import (P, batch_axes, n_batch_shards, named,
                                opt_pspecs)
from ..runtime.steps import init_sharded, make_train_step
from . import mesh as MESH


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of a --mesh host run started here (default:"
                         " every visible card; needed with --device cpu)")
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="simulate a hard failure (for the restart test)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap


def main(argv=None):
    """CLI entry point -> the losses of the steps run (rank 0's on a
    mesh)."""
    args = _parser().parse_args(argv)
    if args.mesh == "none":
        return _train(args, resolve(args.device))
    argv = sys.argv[1:] if argv is None else list(argv)
    if MESH.under_torchrun():
        return MESH.join(_train_rank, argv, device=args.device)
    n = args.ranks
    if torch.device(args.device).type == "cuda":
        visible = torch.cuda.device_count()
        n = n or visible
        if n > visible:
            raise SystemExit(f"--ranks {n}: {visible} cards visible (one "
                             f"rank a card; --device cpu runs the ranks on "
                             f"the CPU)")
    elif not n:
        raise SystemExit("--mesh host --device cpu: give --ranks N")
    if n % args.model_axis:
        raise SystemExit(f"{n} ranks do not split into model groups of "
                         f"{args.model_axis}")
    return MESH.spawn(_train_rank, n, argv, device=args.device)[0]


def _train_rank(rank, world, device, argv):
    """One rank of ``main --mesh host``: the trainer on this rank's device
    and its shards of the state."""
    args = _parser().parse_args(argv)
    backend = torch.distributed.get_backend()
    mesh = MESH.make_host_mesh(model=args.model_axis,
                               device_type="cuda" if backend == "nccl"
                               else "cpu")
    return _train(args, device, mesh, rank)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in iter_leaves(tree))


def _train(args, dev, mesh=None, rank: int = 0):
    def say(line):
        if rank == 0:
            print(line, flush=True)

    cfg = get(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, seed=args.seed))

    shardings = None
    if mesh is None:
        params = M.init_params(cfg, args.seed, device=dev,
                               dtype=torch_dtype(cfg.dtype))
    else:
        params, specs = init_sharded(cfg, args.seed, mesh, device=dev)
        shardings = named(mesh, {"params": specs, "opt": opt_pspecs(specs),
                                 "step": P()})
    opt_state = adamw_init(params)

    def state(step):
        return {"params": params, "opt": opt_state,
                "step": torch.tensor(step, dtype=torch.int32)}

    def batch_of(i):
        if mesh is None:
            return data.batch(i, dev)
        return data.sharded_batch(i, mesh, batch_axes(mesh), dev)

    mgr = CheckpointManager(args.ckpt_dir, keep=3,
                            compress=args.ckpt_compress)
    restored, at = mgr.restore(state(0), shardings, device=dev)
    start_step = 0
    if restored is not None:
        params, opt_state = restored["params"], restored["opt"]
        start_step = int(restored["step"]) + 1
        say(f"[train] resumed from step {at} -> starting at {start_step}")

    step_fn = make_train_step(
        cfg, AdamWConfig(lr=args.lr), mesh=mesh, grad_accum=args.grad_accum,
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
            say(f"[train] simulating hard failure at step {i}")
            os._exit(42)  # no cleanup: models a machine loss
        batch = batch_of(i)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch, i)
        loss = float(metrics["loss"])           # waits for the step
        stats = mon.observe(time.perf_counter() - t0, i)
        losses.append(loss)
        straggler, stop = stats.is_straggler, preempted["flag"]
        if mesh is not None:    # a save gathers: every rank acts as rank 0
            straggler, stop = collectives.broadcast_object(
                [straggler, stop], 0)
        if straggler:
            say(f"[train] straggler alarm at step {i}: "
                f"{stats.seconds:.3f}s (z={stats.z:.1f}) — eager save")
            mgr.save_async(i, state(i), shardings)
        if i % args.log_every == 0:
            say(f"step {i:5d} loss {loss:.4f} lr {float(metrics['lr']):.2e}"
                f" gnorm {float(metrics['grad_norm']):.3f}"
                f" {stats.seconds * 1e3:.0f}ms")
        if i and i % args.save_every == 0:
            mgr.save_async(i, state(i), shardings)
            # periodic saves are the durability boundary of the restart
            # contract: a machine loss anywhere in (i, i + save_every] must
            # resume from step i, so drain the write (and any queued eager
            # saves) before advancing; write errors surface here
            mgr.wait()
        if stop:
            say(f"[train] preemption signal at step {i}: final save")
            break

    mgr.wait()   # drain queued async writes before the final sync save
    mgr.save_sync(i, state(i), shardings)
    mgr.close()
    k = max(len(losses) // 10, 1)
    if len(losses) >= 2 * k:
        say(f"[train] loss first-{k}-avg {np.mean(losses[:k]):.4f} -> "
            f"last-{k}-avg {np.mean(losses[-k:]):.4f}")
    say(f"[train] done at step {i}; ewma step "
        f"{mon.ewma_seconds * 1e3:.0f}ms; alarms={len(mon.alarms)}")
    if mesh is not None:
        mine = torch.tensor([_tree_bytes(params) + _tree_bytes(opt_state)])
        got = collectives.gather_rows(mine, mesh).reshape(-1).tolist()
        experts = ""
        if cfg.n_experts:
            experts = (f", experts {cfg.n_experts // args.model_axis} of "
                       f"{cfg.n_experts} a rank")
        say(f"[train] mesh {{data: {n_batch_shards(mesh)}, model: "
            f"{args.model_axis}}}{experts}, resident state a rank "
            f"{[round(b / 2 ** 30, 4) for b in got]} GiB")
    return losses


if __name__ == "__main__":
    main()

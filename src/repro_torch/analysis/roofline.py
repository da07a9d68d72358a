"""Roofline terms of the dry run's artifact for one H100 (no card needed):
the reference's ``analysis/roofline.py``, its arithmetic line for line,
with the constants of the card this port runs on.

Hardware constants (``DEFAULT_HW``), NVIDIA H100 SXM5 80GB, data-sheet
figures (none was read on a card):
    peak compute  989 TFLOP/s (dense bf16 tensor cores)   H100 data sheet
    HBM bandwidth 3.35 TB/s (HBM3)                        H100 data sheet
    NVLink        450 GB/s each way a card (900 GB/s bidirectional, NVLink
                  4), for a group whose ranks all sit on one host of 8
                  NVLink-connected cards                  H100 data sheet
    network       50 GB/s each way a card (one 400 Gb/s ConnectX-7 port a
                  card), for a group that spans hosts     DGX H100 data sheet

Terms per (arch x shape x mesh), all in seconds-per-step:

    compute    = FLOPs_per_rank / peak
    memory     = bytes_per_rank / HBM_bw
    collective = sum over the rank's collectives of wire_bytes / link_bw

FLOPs and bytes are what ``analysis.op_cost`` counts over one rank's
traced step; a collective's wire bytes are ``hlo_parse``'s ring model
(all-gather its output, all-reduce twice its bytes, reduce-scatter and
all-to-all their operand; the ``(n - 1) / n`` of a ring taken as 1, as
there). The reference budgets one ICI link a chip for every collective;
the port takes each collective's group into account: a group of one rank
sends nothing, a group inside one host of 8 cards
(``op_cost.CARDS_PER_HOST``) moves its bytes over NVLink, and a group that
spans hosts over the network, whose per-card rate bounds the ring. A
collective recorded without its group (the reference's dict) is charged at
the network rate. With ``link_bw == net_bw`` the term is the reference's
``total / ici_bw``. MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE), D =
tokens processed per step; the ratio MODEL_FLOPS / FLOPs_total shows how
much traced compute is "useful" (catches remat recompute and redundancy;
~0.33 under full remat is expected for training: fwd+bwd+rematerialized
fwd).  N counts the embedding, which does no product: with an untied
embedding beside a few layers the ratio can pass 1 (``chip_smoke.py``
phase 27's qwen3-8b at 8 layers reads 1.05).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ArchConfig, ShapeConfig


@dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12        # bf16 FLOP/s a card
    hbm_bw: float = 3.35e12           # bytes/s a card
    link_bw: float = 450e9            # bytes/s a card inside a host
    net_bw: float = 50e9              # bytes/s a card across hosts


DEFAULT_HW = HW()


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6*N*D useful-FLOPs estimate (N = active params, D = tokens/step).

    train counts fwd+bwd (6ND); prefill counts fwd only (2ND); decode steps
    process batch*1 tokens (2ND per generated token)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    toks = shape.global_batch * 1
    return 2.0 * n * toks


def collective_seconds(coll: dict, hw: HW = DEFAULT_HW) -> float:
    """Seconds a rank's collectives take on their links: each op of
    ``coll["ops"]`` (``(op, wire_bytes, group_size[, one_host])``) over
    NVLink when its group stays on one host, over the network when it
    spans hosts (or says nothing of it), nothing for a group of one; a
    dict without ``ops`` is its ``total`` at the network rate."""
    ops = coll.get("ops")
    if ops is None:
        return float(coll.get("total", 0.0)) / hw.net_bw
    t = 0.0
    for op in ops:
        wire, group = float(op[1]), int(op[2])
        if group == 1:
            continue
        one_host = bool(op[3]) if len(op) > 3 else False
        t += wire / (hw.link_bw if one_host else hw.net_bw)
    return t


def roofline_terms(cost: dict, coll: dict, n_chips: int,
                   cfg: ArchConfig = None, shape: ShapeConfig = None,
                   hw: HW = DEFAULT_HW) -> dict:
    """Three roofline terms (+ diagnostics) from dry-run artifacts.

    ``cost``: ``{"flops", "bytes accessed"}`` a rank (``op_cost``).
    ``coll``: ``op_cost``'s collective dict a rank.
    """
    flops_chip = float(cost.get("flops", 0.0))
    bytes_chip = float(cost.get("bytes accessed", 0.0))
    coll_chip = float(coll.get("total", 0.0))

    t_compute = flops_chip / hw.peak_flops
    t_memory = bytes_chip / hw.hbm_bw
    t_coll = collective_seconds(coll, hw)
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    out = {
        **{f"t_{k}": v for k, v in terms.items()},
        "dominant": dominant,
        "flops_per_chip": flops_chip,
        "bytes_per_chip": bytes_chip,
        "collective_bytes_per_chip": coll_chip,
        "hlo_flops_total": flops_chip * n_chips,
        "n_chips": n_chips,
    }
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        out["model_flops"] = mf
        out["useful_flops_ratio"] = (
            mf / max(flops_chip * n_chips, 1.0))
        # roofline fraction: useful work over what the bound permits in the
        # dominated time (how close the step is to its own roofline)
        step_time = max(terms.values())
        out["step_time_bound"] = step_time
        out["mfu_bound"] = mf / (n_chips * hw.peak_flops * step_time) \
            if step_time > 0 else 0.0
    return out


def fmt_seconds(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.1f}us"

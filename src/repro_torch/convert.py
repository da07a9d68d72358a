"""Convert the reference's parameter tree into the port's.

``params_from_numpy`` takes the reference ``models.model.init_params``
tree with every leaf already turned into a numpy array (``np.asarray`` on
the JAX side; this module imports no JAX) and returns the same nested dict
of torch tensors on ``device``.  The layouts are the same by construction
(``(in, out)`` weights, stacked ``units``), so the port and the reference
run on identical weights in every parity test.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig
from .device import resolve
from .models.model import check_supported


def params_from_numpy(tree, cfg: ArchConfig, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    check_supported(cfg)
    dev = resolve(device)
    embed = tree["embed"]
    if tuple(embed.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {embed.shape} does not match {cfg.name} "
                         f"({cfg.vocab_size}, {cfg.d_model})")

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x)).to(dev)

    return convert(tree)

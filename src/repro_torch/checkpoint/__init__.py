"""The reference's fault-tolerant checkpointing (``manager``)."""
from .manager import CheckpointManager, restore_tree, save_tree  # noqa: F401

"""Cost analysis of traced steps (the reference's ``repro.analysis``):
``op_cost`` counts FLOPs, bytes and collectives over the operations a step
dispatches, ``roofline`` turns them into the three-term roofline of one
H100."""
from .op_cost import collective_bytes  # noqa: F401
from .roofline import roofline_terms, HW  # noqa: F401

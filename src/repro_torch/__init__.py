"""PyTorch / CUDA port of the ECF8 serving system, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its module
and public function names.  Plain tensor code is PyTorch; the two Pallas
TPU kernels on the serving path (ECF8 weight decode, flash-attention
forward) are hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` at
first use (``kernels/build.py``).  Entry points run on the card unless the
caller passes ``device="cpu"``, where every kernel is replaced by its plain
PyTorch version.
"""

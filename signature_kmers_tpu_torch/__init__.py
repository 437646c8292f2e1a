"""PyTorch/CUDA port of the signature k-mer framework for one NVIDIA H100.

Mirrors the JAX package's subpackage layout (core, io, golden, ops,
table, runtime, models, cli).  Imports torch, numpy and the standard
library only.  Device entry points default to ``device="cuda"``; a CUDA
tensor launches the hand-written kernel (csrc/*.cu) or raises, and only
a CPU tensor takes a kernel's plain PyTorch version.
"""

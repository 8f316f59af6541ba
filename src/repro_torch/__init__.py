"""PyTorch/CUDA port of the UELLM serving system.

Imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of the JAX
reference package ``repro``.  Entry points run on the card unless the caller
passes ``device="cpu"``; attention runs through hand-written CUDA kernels on
a CUDA tensor and through their plain PyTorch versions on a CPU tensor.
"""

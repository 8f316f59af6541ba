"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel's wrapper dispatches on the device of its inputs: a CPU tensor
goes to the plain version in ``ref.py`` beside it, a CUDA tensor launches the
kernel (built from ``csrc/`` by ``build.py``) or raises."""

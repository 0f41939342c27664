"""Hand-written CUDA kernels of the port, each beside its plain version.

One subpackage per kernel: ``ref.py`` (plain PyTorch, what runs on the
CPU), the wrapper that launches the CUDA source from ``../csrc`` on a
CUDA tensor, and ``ops.py`` (the operator bound to one graph).
"""

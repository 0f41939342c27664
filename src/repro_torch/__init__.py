"""PyTorch port of the graph-reordering system (`repro`), for CUDA GPUs.

The package mirrors `repro`'s layout module for module, so its relative
imports resolve the same way. Host code (reordering, probes, policy,
request plane) is numpy and is kept here as copies; the device path
(`algos`, `kernels`, `engine.backends`) is PyTorch, with the pull SpMV
of PageRank as a hand-written CUDA kernel (`kernels/csr_spmv`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(`device.resolve_device`). Nothing here imports JAX or `repro`.
"""

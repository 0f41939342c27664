"""Attention on (BH, S, d) queries and (BH / group, S, d) keys and values:
the flash kernel on the card, its plain version on the CPU.

The reference's wrapper (``src/repro/kernels/flash_attn/ops.py``) sends a
call to the plain XLA version whenever ``S % 256 != 0`` or it runs off the
TPU. Here the device alone decides, and the CUDA kernel takes any S, so a
call on the card always reaches the kernel. When autograd needs the
gradient of a call on the card (grad mode on and an input that requires
it), the call goes through `flash_attention_grad`, whose backward is the
flash backward kernels; on the CPU autograd runs through the plain version.
"""
from __future__ import annotations

import torch

from .flash_attn import flash_attention, flash_attention_grad


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              sm_scale: float | None = None, window: int = 0,
              causal: bool = True, prefix: int = 0) -> torch.Tensor:
    """`flash_attention` on contiguous operands: causal (with a
    bidirectional ``prefix`` and a sliding ``window``) or, with
    ``causal=False``, every key; differentiable on both devices."""
    fn = flash_attention
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        fn = flash_attention_grad
    return fn(q.contiguous(), k.contiguous(), v.contiguous(),
              sm_scale=sm_scale, window=window, causal=causal, prefix=prefix)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     sm_scale: float | None = None,
                     window: int = 0) -> torch.Tensor:
    return attention(q, k, v, sm_scale=sm_scale, window=window)

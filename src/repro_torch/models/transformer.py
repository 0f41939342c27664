"""Model trunk: the decoder/encoder stack of the ``attn`` family.

The PyTorch port of ``src/repro/models/transformer.py`` for the ``attn``
trunk (dense attention + MLP blocks). A `Transformer` holds the master
params in float32 as ``nn.ParameterDict``s, one `AttnBlock` per layer in
an ``nn.ModuleList``; a Python loop over the blocks takes the place of the
reference's ``lax.scan`` over stacked layer params.

Modes: prefill (`forward`: logits and the MoE auxiliary loss) and decode
(`decode_step`: one token against a KV cache). A block's FFN is the MLP,
or for an MoE config `moe.apply_moe` (the grouped-matmul kernel on the
card). Not ported yet: the ``rwkv`` and ``hybrid`` trunks (ROADMAP A8.3)
and training (``loss_fn``, ``chunked_xent``: A8.5).

Weights come from one of two places:

* `from_jax_params` takes the JAX package's param pytree (numpy leaves)
  and unstacks its ``(L, ...)`` layer leaves, so both packages can run
  the same weights (the tests do).
* `init_params` draws them on a ``torch.Generator``, from the same
  distributions as the reference's ``init_params`` (normal times the same
  scales, ones and zeros for norms). The values differ from JAX's for
  the same seed: the two generators are unrelated. A host without JAX
  (the card's) runs on these.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .config import ModelConfig
from .layers import (COMPUTE_DTYPE, apply_attention, apply_mlp, apply_norm,
                     bf16_scalar, embed_tokens, flash_eligible, init_attention,
                     init_attn_cache, init_embedding, init_mlp, init_norm,
                     lm_logits)
from .moe import apply_moe, init_moe


def trunk_kind(cfg: ModelConfig) -> str:
    if all(b == "rwkv" for b in cfg.block_pattern):
        return "rwkv"
    if any(b == "mamba" for b in cfg.block_pattern):
        return "hybrid"
    return "attn"


def _check_ported(cfg: ModelConfig) -> None:
    kind = trunk_kind(cfg)
    if kind != "attn":
        raise NotImplementedError(
            f"{cfg.name}: the {kind} trunk is not ported yet: ROADMAP A8.3")


def _params(tree: dict) -> nn.ParameterDict:
    """Frozen parameters; a nested dict (the MoE's ``shared``) becomes a
    nested ``ParameterDict``."""
    return nn.ParameterDict(
        {k: _params(v) if isinstance(v, dict)
         else nn.Parameter(v, requires_grad=False) for k, v in tree.items()})


class AttnBlock(nn.Module):
    """Pre-norm attention + MLP (or MoE) block with scaled residuals."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _params(params["norm1"])
        self.norm2 = _params(params["norm2"])
        self.attn = _params(params["attn"])
        self.ffn = _params(params["ffn"])

    def forward(self, x, positions, cache=None):
        """Returns (x, new_cache, aux_loss); aux is None without MoE (no
        device op for a dense decode step)."""
        cfg = self.cfg
        scale = bf16_scalar(cfg.residual_scale)
        h, new_c = apply_attention(self.attn, apply_norm(self.norm1, x, cfg),
                                   cfg, positions, cache)
        # the residual sum reaches norm2 before its bf16 rounding, as in the
        # reference's compiled block (XLA keeps the fused add in float32)
        x32 = x.float() + h * scale
        y = apply_norm(self.norm2, x32, cfg)
        aux = None
        if cfg.is_moe:
            f, aux = apply_moe(self.ffn, y, cfg)
        else:
            f = apply_mlp(self.ffn, y, cfg)
        return x32.to(COMPUTE_DTYPE) + f * scale, new_c, aux


class Transformer(nn.Module):
    """Embedding, ``num_layers`` `AttnBlock`s and the final norm; the LM
    head is the tied table or a separate ``head``."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embed = _params(params["embed"])
        self.layers = nn.ModuleList(AttnBlock(cfg, lp)
                                    for lp in params["layers"])
        self.final_norm = _params(params["final_norm"])
        if len(self.layers) != cfg.num_layers:
            raise ValueError(f"{len(self.layers)} layers for a "
                             f"{cfg.num_layers}-layer config")

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device


# =========================================================== initialization
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> Transformer:
    """Random weights drawn on ``generator``, which lives on ``device``,
    with the reference's distributions."""
    _check_ported(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"model on {dev}")
    layers = [{"norm1": init_norm(cfg, device=dev),
               "norm2": init_norm(cfg, device=dev),
               "attn": init_attention(generator, cfg),
               "ffn": (init_moe(generator, cfg) if cfg.is_moe
                       else init_mlp(generator, cfg))}
              for _ in range(cfg.num_layers)]
    return Transformer(cfg, {"embed": init_embedding(generator, cfg),
                             "layers": layers,
                             "final_norm": init_norm(cfg, device=dev)})


def from_jax_params(cfg: ModelConfig, tree: dict,
                    device: str | torch.device | None = None) -> Transformer:
    """The reference's param pytree, with ``np.asarray`` on each leaf, as
    a `Transformer` on ``device``: the ``(L, ...)`` layer leaves, nested
    ones (the MoE's ``shared``) too, are unstacked into one block each,
    and every leaf is copied."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def tree_map(fn, t):
        if isinstance(t, dict):
            return {k: tree_map(fn, v) for k, v in t.items()}
        return fn(t)

    layers = [tree_map(lambda a, i=i: put(np.asarray(a)[i]), tree["layers"])
              for i in range(cfg.num_layers)]
    return Transformer(cfg, {"embed": tree_map(put, tree["embed"]),
                             "layers": layers,
                             "final_norm": tree_map(put, tree["final_norm"])})


# ================================================================= caches
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: str | torch.device | None = None) -> dict:
    """``{"layers": {"k", "v": (L, B, T, KV, dh) bf16, "length": (L,)
    int32}, "pos": 0-d int32}``, the reference's layout, all zeros."""
    _check_ported(cfg)
    dev = resolve_device(device)
    one = init_attn_cache(cfg, batch, max_len, device=dev)
    layers = {k: v.expand(cfg.num_layers, *v.shape).clone()
              for k, v in one.items()}
    return {"layers": layers,
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


# ============================================================== public API
def embed_inputs(model: Transformer, batch: dict) -> torch.Tensor:
    """The trunk's (B, S, d) bf16 input: an encoder's ``embeds`` as they
    are; otherwise the embedded ``tokens``, after a prefix-LM's ``prefix``
    of embeddings."""
    cfg = model.cfg
    if cfg.input_mode == "embeddings":
        return batch["embeds"].to(COMPUTE_DTYPE)
    x = embed_tokens(model.embed, batch["tokens"], cfg)
    if cfg.prefix_tokens > 0:
        x = torch.cat([batch["prefix"].to(COMPUTE_DTYPE), x], dim=1)
    return x


def forward(model: Transformer, batch: dict, mesh=None):
    """Prefill forward. batch: tokens (B,S) and/or embeds/prefix
    (`embed_inputs`).

    Returns (logits (B,S,V) bf16, aux_loss summed over the layers). On
    the card each layer's attention is one flash-kernel launch with the
    config's mask (causal, sliding-window, prefix-LM or bidirectional),
    an MoE layer's experts three grouped-matmul launches and the token
    embedding one hot-slab launch; a config the kernel does not take
    raises before any work.
    """
    cfg = model.cfg
    if mesh is not None:
        raise NotImplementedError("sharded forward: ROADMAP A8.8")
    dev = model.device
    flash_eligible(cfg, dev)
    x = embed_inputs(model, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for block in model.layers:
        x, _, a = block(x, positions)
        if a is not None:
            aux = aux + a
    x = apply_norm(model.final_norm, x, cfg)
    return lm_logits(model.embed, x, cfg), aux


def decode_step(model: Transformer, cache: dict, tokens, mesh=None):
    """One decode step. tokens: (B, 1). Returns (logits (B,1,V), cache);
    the MoE auxiliary loss is dropped, as in the reference.

    The returned cache shares the K/V tensors of the one passed in, which
    are written in place; its ``length`` and ``pos`` are new tensors.
    """
    if mesh is not None:
        raise NotImplementedError("sharded decode: ROADMAP A8.8")
    cfg = model.cfg
    x = embed_tokens(model.embed, tokens, cfg)
    positions = cache["pos"][None].to(torch.int32)
    layers = cache["layers"]
    lengths = []
    for i, block in enumerate(model.layers):
        x, new_c, _ = block(x, positions, {"k": layers["k"][i],
                                           "v": layers["v"][i],
                                           "length": layers["length"][i]})
        lengths.append(new_c["length"])
    new_cache = {"layers": {"k": layers["k"], "v": layers["v"],
                            "length": torch.stack(lengths)},
                 "pos": cache["pos"] + positions.shape[-1]}
    x = apply_norm(model.final_norm, x, cfg)
    return lm_logits(model.embed, x, cfg), new_cache

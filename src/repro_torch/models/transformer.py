"""Model trunk: the decoder/encoder stack covering all 10 archs.

The PyTorch port of ``src/repro/models/transformer.py``. Three trunk
variants, chosen from the config (`trunk_kind`), share one entry point:

* ``attn``   — dense / MoE / VLM / audio stacks: one `AttnBlock` a layer
  (attention + MLP, or for an MoE config `moe.apply_moe`, the
  grouped-matmul kernel on the card);
* ``rwkv``   — RWKV6 stacks: one `RwkvBlock` a layer (time-mix +
  channel-mix, `models/rwkv6.py`);
* ``hybrid`` — Mamba2 stacks (`MambaBlock`, `models/mamba2.py`) with one
  *shared* `AttnBlock` applied before the Mamba block at every layer the
  config flags ``shared_attn`` (zamba2).

A `Transformer` holds the master params in float32 as
``nn.ParameterDict``s, its blocks in an ``nn.ModuleList``; a Python loop
over the blocks takes the place of the reference's ``lax.scan`` over
stacked layer params.

Modes: prefill (`forward`: logits and the MoE auxiliary loss), decode
(`decode_step`: one token against the cache: K/V for attention, the
token-shift and wkv states for RWKV, the conv and SSD states for Mamba2)
and training (`loss_fn`: next-token or frame-label cross-entropy through
`chunked_xent`, plus the MoE auxiliary loss). The parameters are frozen
(``requires_grad=False``) for serving; a train step
(``train/steps.py``) turns their gradients on for its own duration. While
autograd records and ``cfg.remat`` is set, each block runs under
``torch.utils.checkpoint`` (non-reentrant): only the block outputs are
kept and each block is replayed in the backward. Both of the reference's
``remat_policy`` values keep just that: its ``save_attn`` names the block
output, which is its scan carry, and ``full`` keeps the carry too.

Weights come from one of two places:

* `from_jax_params` takes the JAX package's param pytree (numpy leaves)
  and unstacks its ``(L, ...)`` layer leaves, so both packages can run
  the same weights (the tests do); `to_jax_params` is its inverse, the
  layout of the checkpoints (``ckpt/manager.py``).
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
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .config import ModelConfig
from .layers import (COMPUTE_DTYPE, apply_attention, apply_mlp, apply_norm,
                     bf16_scalar, embed_tokens, flash_eligible, init_attention,
                     init_attn_cache, init_embedding, init_mlp, init_norm,
                     lm_logits)
from .mamba2 import apply_mamba, init_mamba, init_mamba_cache
from .moe import apply_moe, init_moe
from .rwkv6 import (apply_rwkv_channelmix, apply_rwkv_timemix, init_rwkv,
                    init_rwkv_cache)


def trunk_kind(cfg: ModelConfig) -> str:
    if all(b == "rwkv" for b in cfg.block_pattern):
        return "rwkv"
    if any(b == "mamba" for b in cfg.block_pattern):
        return "hybrid"
    return "attn"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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


class RwkvBlock(nn.Module):
    """Pre-norm RWKV6 time-mix + channel-mix, plain residuals (the
    reference's ``_rwkv_block``)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _params(params["norm1"])
        self.norm2 = _params(params["norm2"])
        self.rwkv = _params(params["rwkv"])

    def forward(self, x, cache=None):
        """Returns (x, new_cache); new_cache holds new tensors in decode
        (``{"tm": ..., "cm": ...}``), None in prefill."""
        cfg = self.cfg
        h, n_tm = apply_rwkv_timemix(
            self.rwkv, apply_norm(self.norm1, x, cfg), cfg,
            None if cache is None else cache["tm"])
        # norm2 reads the residual sum before its bf16 rounding, as in
        # `AttnBlock` (the reference's compiled block)
        x32 = x.float() + h.float()
        f, n_cm = apply_rwkv_channelmix(
            self.rwkv, apply_norm(self.norm2, x32, cfg), cfg,
            None if cache is None else cache["cm"])
        return (x32.to(COMPUTE_DTYPE) + f,
                None if cache is None else {"tm": n_tm, "cm": n_cm})


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 mixer with a plain residual (the reference's
    ``_mamba_block``)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _params(params["norm1"])
        self.mamba = _params(params["mamba"])

    def forward(self, x, cache=None):
        h, new_c = apply_mamba(self.mamba, apply_norm(self.norm1, x, self.cfg),
                               self.cfg, cache)
        return x + h, new_c


_BLOCKS = {"attn": AttnBlock, "rwkv": RwkvBlock, "hybrid": MambaBlock}


class Transformer(nn.Module):
    """Embedding, ``num_layers`` blocks of the config's trunk (and a
    hybrid's one ``shared_attn`` `AttnBlock`) and the final norm; the LM
    head is the tied table or a separate ``head``."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _params(params["embed"])
        block = _BLOCKS[trunk_kind(cfg)]
        self.layers = nn.ModuleList(block(cfg, lp) for lp in params["layers"])
        self.shared_attn = (AttnBlock(cfg, params["shared_attn"])
                            if "shared_attn" in cfg.block_pattern else None)
        self.final_norm = _params(params["final_norm"])
        if len(self.layers) != cfg.num_layers:
            raise ValueError(f"{len(self.layers)} layers for a "
                             f"{cfg.num_layers}-layer config")

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def records_grad(self) -> bool:
        """Whether autograd records this model's ops: grad mode is on and a
        parameter requires its gradient (a train step's, not serving)."""
        return torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())


def _pd_tree(pd) -> dict:
    """A (nested) ``ParameterDict`` as a dict of its parameters."""
    return {k: _pd_tree(v) if isinstance(v, nn.ParameterDict) else v
            for k, v in pd.items()}


def _block_tree(block: nn.Module) -> dict:
    return {name: _pd_tree(child) for name, child in block.named_children()}


def param_tree(model: Transformer) -> dict:
    """The model's parameters (the tensors themselves) in the reference's
    tree, with ``"layers"`` a list of one dict a layer: the port's layout,
    which the optimizer (``train/optim.py``) walks."""
    tree = {"embed": _pd_tree(model.embed),
            "layers": [_block_tree(b) for b in model.layers],
            "final_norm": _pd_tree(model.final_norm)}
    if model.shared_attn is not None:
        tree["shared_attn"] = _block_tree(model.shared_attn)
    return tree


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later in-place updates cannot reach."""
    return t.detach().to("cpu", copy=True).numpy()


def _stack(items: list):
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return np.stack([_host(t) for t in items])


def stack_layers(tree: dict) -> dict:
    """A tree in the port's layout (`param_tree`, or optimizer moments
    shaped like it) as numpy in the reference's: ``"layers"`` stacked to
    ``(L, ...)``, every leaf a host copy."""
    out = {k: _tree_map(_host, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = _stack(tree["layers"])
    return out


def unstack_layers(tree: dict, num_layers: int,
                   device: str | torch.device) -> dict:
    """`stack_layers` reversed: float32 tensors on ``device``, the
    ``(L, ...)`` layer leaves split into a list of one dict a layer."""
    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    out = {k: _tree_map(put, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_tree_map(lambda a, i=i: put(np.asarray(a)[i]),
                               tree["layers"]) for i in range(num_layers)]
    return out


# =========================================================== initialization
def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str,
                dev: torch.device) -> dict:
    norm1 = init_norm(cfg, device=dev)
    if kind == "attn":
        return {"norm1": norm1, "norm2": init_norm(cfg, device=dev),
                "attn": init_attention(gen, cfg),
                "ffn": (init_moe(gen, cfg) if cfg.is_moe
                        else init_mlp(gen, cfg))}
    if kind == "rwkv":
        return {"norm1": norm1, "norm2": init_norm(cfg, device=dev),
                "rwkv": init_rwkv(gen, cfg)}
    return {"norm1": norm1, "mamba": init_mamba(gen, cfg)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> Transformer:
    """Random weights drawn on ``generator``, which lives on ``device``,
    with the reference's distributions, for any of the three trunks."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"model on {dev}")
    kind = trunk_kind(cfg)
    params = {"embed": init_embedding(generator, cfg),
              "layers": [_init_layer(generator, cfg, kind, dev)
                         for _ in range(cfg.num_layers)],
              "final_norm": init_norm(cfg, device=dev)}
    if "shared_attn" in cfg.block_pattern:
        params["shared_attn"] = {
            "norm1": init_norm(cfg, device=dev),
            "norm2": init_norm(cfg, device=dev),
            "attn": init_attention(generator, cfg),
            "ffn": init_mlp(generator, cfg)}
    return Transformer(cfg, params)


def from_jax_params(cfg: ModelConfig, tree: dict,
                    device: str | torch.device | None = None) -> Transformer:
    """The reference's param pytree, with ``np.asarray`` on each leaf, as
    a `Transformer` on ``device``: the ``(L, ...)`` layer leaves, nested
    ones (the MoE's ``shared``, RWKV's and Mamba2's) too, are unstacked
    into one block each, a hybrid's ``shared_attn`` (not stacked) is
    taken as it is, and every leaf is copied."""
    return Transformer(cfg, unstack_layers(tree, cfg.num_layers,
                                           resolve_device(device)))


def to_jax_params(model: Transformer) -> dict:
    """`from_jax_params` reversed: the reference's param pytree as numpy
    host copies, the layer leaves stacked to ``(L, ...)``."""
    return stack_layers(param_tree(model))


# ================================================================= caches
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: str | torch.device | None = None) -> dict:
    """The reference's layout, all zeros: ``{"layers": ..., "pos": 0-d
    int32}`` with the layer leaves stacked ``(L, B, ...)``:

    * ``attn``: ``{"k", "v": (L, B, T, KV, dh) bf16, "length": (L,) int32}``;
    * ``rwkv``: ``{"tm": {"shift": (L, B, d), "wkv": (L, B, H, dh, dh)},
      "cm": {"shift": (L, B, d)}}``, float32;
    * ``hybrid``: ``{"conv": (L, B, W-1, C) bf16, "ssd": (L, B, H, N, P)
      float32}``, and beside ``layers`` a ``"shared"`` attention cache
      whose leading dim counts the shared block's applications.
    """
    dev = resolve_device(device)
    kind = trunk_kind(cfg)
    if kind == "attn":
        one = init_attn_cache(cfg, batch, max_len, device=dev)
    elif kind == "rwkv":
        one = init_rwkv_cache(cfg, batch, device=dev)
    else:
        one = init_mamba_cache(cfg, batch, device=dev)

    def stacked(tree, n):
        return _tree_map(lambda v: v.expand(n, *v.shape).clone(), tree)

    cache = {"layers": stacked(one, cfg.num_layers),
             "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    napp = sum(b == "shared_attn" for b in cfg.block_pattern)
    if napp:
        cache["shared"] = stacked(
            init_attn_cache(cfg, batch, max_len, device=dev), napp)
    return cache


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


def _layer_cache(tree: dict, i: int) -> dict:
    """Entry ``i`` of a stacked cache tree (views: writes reach the
    stack)."""
    return _tree_map(lambda t: t[i], tree)


def _write(dst: dict, src: dict) -> None:
    """Copy a block's new decode state into its cache entry, in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write(dst[k], v)
        else:
            dst[k].copy_(v)


def _run_trunk(model: Transformer, x, positions, cache=None):
    """The blocks in order; at a hybrid's layer flagged ``shared_attn`` the
    shared `AttnBlock` runs before the Mamba block, on its own cache slot
    (the reference's ``app_idx``). Returns (x, aux, lengths,
    shared_lengths): aux the MoE loss summed over the layers (zero
    without MoE) and, in decode, each attention cache entry's new
    ``length``. A decode's K/V and recurrent states are written into
    ``cache`` in place."""
    cfg = model.cfg
    decode = cache is not None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    lengths, shared_lengths = [], []
    if cfg.remat and not decode and model.records_grad():
        def run(block, *args):   # keep the block's output only; replay it
            return checkpoint(block, *args, use_reentrant=False)
    else:
        def run(block, *args):
            return block(*args)
    for i, block in enumerate(model.layers):
        lc = _layer_cache(cache["layers"], i) if decode else None
        if cfg.block_pattern[i] == "shared_attn":
            sc = (_layer_cache(cache["shared"], len(shared_lengths))
                  if decode else None)
            x, new_sc, _ = run(model.shared_attn, x, positions, sc)
            if decode:
                shared_lengths.append(new_sc["length"])
        if isinstance(block, AttnBlock):
            x, new_c, a = run(block, x, positions, lc)
            if decode:
                lengths.append(new_c["length"])
            elif a is not None:
                aux = aux + a
        else:
            x, new_c = run(block, x, lc)
            if decode:
                _write(lc, new_c)
    return x, aux, lengths, shared_lengths


def forward(model: Transformer, batch: dict, mesh=None):
    """Prefill forward. batch: tokens (B,S) and/or embeds/prefix
    (`embed_inputs`).

    Returns (logits (B,S,V) bf16, aux_loss summed over the layers). On
    the card each attention layer (a hybrid's: each application of the
    shared block) is one flash-kernel launch with the config's mask
    (causal, sliding-window, prefix-LM or bidirectional), an MoE layer's
    experts three grouped-matmul launches and the token embedding one
    hot-slab launch; a config the kernel does not take raises before any
    work. The RWKV and Mamba2 layers' scans are plain torch (a Python
    loop over chunks for the carried state).
    """
    cfg = model.cfg
    if mesh is not None:
        raise NotImplementedError("sharded forward: ROADMAP A8.8")
    dev = model.device
    flash_eligible(cfg, dev)
    x = embed_inputs(model, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=dev)
    x, aux, _, _ = _run_trunk(model, x, positions)
    x = apply_norm(model.final_norm, x, cfg)
    return lm_logits(model.embed, x, cfg), aux


def decode_step(model: Transformer, cache: dict, tokens, mesh=None):
    """One decode step. tokens: (B, 1). Returns (logits (B,1,V), cache);
    the MoE auxiliary loss is dropped, as in the reference.

    The returned cache shares the tensors of the one passed in, which
    are written in place (K/V, and the RWKV and Mamba2 states); its
    ``length`` leaves and ``pos`` are new tensors.
    """
    if mesh is not None:
        raise NotImplementedError("sharded decode: ROADMAP A8.8")
    cfg = model.cfg
    x = embed_tokens(model.embed, tokens, cfg)
    positions = cache["pos"][None].to(torch.int32)
    x, _, lengths, shared_lengths = _run_trunk(model, x, positions, cache)
    layers = cache["layers"]
    if lengths:
        layers = dict(layers, length=torch.stack(lengths))
    new_cache = {"layers": layers,
                 "pos": cache["pos"] + positions.shape[-1]}
    if "shared" in cache:
        new_cache["shared"] = dict(cache["shared"],
                                   length=torch.stack(shared_lengths))
    x = apply_norm(model.final_norm, x, cfg)
    return lm_logits(model.embed, x, cfg), new_cache


# ---------------------------------------------------------------- loss
def chunked_xent(model: Transformer, x_final, targets, mask):
    """Memory-bounded softmax cross-entropy (the reference's): the sequence
    in chunks of ``cfg.loss_chunk`` (halved until it divides S), each
    chunk's float32 logits computed under a checkpoint, so the full
    (B, S, V) logits never live at once. Returns the mean loss over the
    mask plus the z-loss, ``1e-4·Σ lse²`` over the same mean."""
    cfg = model.cfg
    s = x_final.shape[1]
    c = min(cfg.loss_chunk, s)
    while s % c:
        c //= 2

    def body(xi, ti, mi):
        logits = lm_logits(model.embed, xi, cfg).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ti[..., None].long())[..., 0]
        return ((lse - gold) * mi).sum(), (torch.square(lse) * mi).sum()

    if model.records_grad():
        def run(*args):
            return checkpoint(body, *args, use_reentrant=False)
    else:
        run = body
    loss = zloss = torch.zeros((), dtype=torch.float32,
                               device=x_final.device)
    for i in range(0, s, c):
        part, z = run(x_final[:, i:i + c], targets[:, i:i + c],
                      mask[:, i:i + c])
        loss, zloss = loss + part, zloss + z
    denom = torch.clamp(mask.sum(), min=1.0)
    return loss / denom + 1e-4 * zloss / denom


def loss_fn(model: Transformer, batch: dict, mesh=None):
    """Next-token (or, for an encoder, frame-label) cross-entropy plus
    ``router_aux_coef`` times the MoE auxiliary loss. Returns (loss,
    {"ce", "aux"}), 0-d float32 tensors.

    A token model's targets are its tokens rolled one to the left with the
    last position masked (rolled rather than sliced, so S keeps its chunk
    size); a prefix-LM's prefix positions carry target 0 at weight 0. An
    embedding-fed model takes ``batch["targets"]``, shifted the same way
    unless it is an encoder (frame labels)."""
    if mesh is not None:
        raise NotImplementedError("sharded loss: ROADMAP A8.8")
    cfg = model.cfg
    dev = model.device
    flash_eligible(cfg, dev)
    x = embed_inputs(model, batch)
    if cfg.input_mode == "embeddings":
        targets = batch["targets"]
        mask = torch.ones(targets.shape, dtype=torch.float32, device=dev)
        shift = not cfg.is_encoder
    else:
        targets = batch["tokens"]
        mask = torch.ones(targets.shape, dtype=torch.float32, device=dev)
        if cfg.prefix_tokens > 0:
            pad = torch.zeros((x.shape[0], cfg.prefix_tokens),
                              dtype=targets.dtype, device=dev)
            targets = torch.cat([pad, targets], dim=1)
            mask = torch.cat([pad.float(), mask], dim=1)
        shift = True
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=dev)
    x, aux, _, _ = _run_trunk(model, x, positions)
    x = apply_norm(model.final_norm, x, cfg)
    if shift:
        targets = torch.roll(targets, -1, dims=1)
        mask = torch.roll(mask, -1, dims=1)
        mask[:, -1] = 0.0
    ce = chunked_xent(model, x, targets, mask)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux}

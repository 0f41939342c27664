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
from .layers import (COMPUTE_DTYPE, DP_AXES, MODEL, apply_attention,
                     apply_mlp, apply_norm, bf16_scalar, embed_tokens,
                     flash_eligible, init_attention, init_attn_cache,
                     init_embedding, init_mlp, init_norm, lm_logits,
                     split_over)
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


def attn_block(p, x, cfg: ModelConfig, positions, cache=None):
    """Pre-norm attention + MLP (or MoE) block with scaled residuals, on
    one device. ``p`` maps ``norm1``, ``norm2``, ``attn`` and ``ffn`` to
    their params. Returns (x, new_cache, aux_loss); aux is None without
    MoE (no device op for a dense decode step)."""
    scale = bf16_scalar(cfg.residual_scale)
    h, new_c = apply_attention(p["attn"], apply_norm(p["norm1"], x, cfg),
                               cfg, positions, cache)
    # the residual sum reaches norm2 before its bf16 rounding, as in the
    # reference's compiled block (XLA keeps the fused add in float32)
    x32 = x.float() + h * scale
    y = apply_norm(p["norm2"], x32, cfg)
    aux = None
    if cfg.is_moe:
        f, aux = apply_moe(p["ffn"], y, cfg)
    else:
        f = apply_mlp(p["ffn"], y, cfg)
    return x32.to(COMPUTE_DTYPE) + f * scale, new_c, aux


def rwkv_block(p, x, cfg: ModelConfig, cache=None):
    """Pre-norm RWKV6 time-mix + channel-mix, plain residuals (the
    reference's ``_rwkv_block``). Returns (x, new_cache); new_cache holds
    new tensors in decode (``{"tm": ..., "cm": ...}``), None in
    prefill."""
    h, n_tm = apply_rwkv_timemix(
        p["rwkv"], apply_norm(p["norm1"], x, cfg), cfg,
        None if cache is None else cache["tm"])
    # norm2 reads the residual sum before its bf16 rounding, as in
    # `attn_block` (the reference's compiled block)
    x32 = x.float() + h.float()
    f, n_cm = apply_rwkv_channelmix(
        p["rwkv"], apply_norm(p["norm2"], x32, cfg), cfg,
        None if cache is None else cache["cm"])
    return (x32.to(COMPUTE_DTYPE) + f,
            None if cache is None else {"tm": n_tm, "cm": n_cm})


def mamba_block(p, x, cfg: ModelConfig, cache=None):
    """Pre-norm Mamba2 mixer with a plain residual (the reference's
    ``_mamba_block``). Returns (x, new_cache)."""
    h, new_c = apply_mamba(p["mamba"], apply_norm(p["norm1"], x, cfg), cfg,
                           cache)
    return x + h, new_c


class _Block(nn.Module):
    """A block's ``ParameterDict``s, one a child, run by ``fn``."""

    fn = None
    names: tuple = ()

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        for name in self.names:
            setattr(self, name, _params(params[name]))

    def params(self) -> dict:
        return {name: getattr(self, name) for name in self.names}


class AttnBlock(_Block):
    """Pre-norm attention + MLP (or MoE) block (`attn_block`)."""

    names = ("norm1", "norm2", "attn", "ffn")

    def forward(self, x, positions, cache=None):
        return attn_block(self.params(), x, self.cfg, positions, cache)


class RwkvBlock(_Block):
    """RWKV6 time-mix + channel-mix (`rwkv_block`)."""

    names = ("norm1", "norm2", "rwkv")

    def forward(self, x, cache=None):
        return rwkv_block(self.params(), x, self.cfg, cache)


class MambaBlock(_Block):
    """Mamba2 mixer (`mamba_block`)."""

    names = ("norm1", "mamba")

    def forward(self, x, cache=None):
        return mamba_block(self.params(), x, self.cfg, cache)


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
    if _sharded(model, mesh):
        return _forward_sharded(model, batch)
    cfg = model.cfg
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
    if _sharded(model, mesh):
        return _decode_sharded(model, cache, tokens)
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
def _xent_terms(logits, ti, mi):
    """One chunk's summed cross-entropy and z-loss terms, the logits taken
    to float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ti[..., None].long())[..., 0]
    return ((lse - gold) * mi).sum(), (torch.square(lse) * mi).sum()


def _chunk(cfg: ModelConfig, s: int) -> int:
    """``cfg.loss_chunk``, halved until it divides S."""
    c = min(cfg.loss_chunk, s)
    while s % c:
        c //= 2
    return c


def chunked_xent(model: Transformer, x_final, targets, mask):
    """Memory-bounded softmax cross-entropy (the reference's): the sequence
    in chunks of ``cfg.loss_chunk`` (halved until it divides S), each
    chunk's float32 logits computed under a checkpoint, so the full
    (B, S, V) logits never live at once. Returns the mean loss over the
    mask plus the z-loss, ``1e-4·Σ lse²`` over the same mean."""
    cfg = model.cfg
    s = x_final.shape[1]
    c = _chunk(cfg, s)

    def body(xi, ti, mi):
        return _xent_terms(lm_logits(model.embed, xi, cfg), ti, mi)

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


def _targets(cfg: ModelConfig, batch: dict):
    """(targets, mask) of `loss_fn`: a token model's tokens rolled one to
    the left with the last position masked (a prefix-LM's prefix
    positions at target 0, weight 0); an embedding-fed model's
    ``targets``, shifted the same way unless it is an encoder."""
    if cfg.input_mode == "embeddings":
        targets = batch["targets"]
        dev = targets.device
        mask = torch.ones(targets.shape, dtype=torch.float32, device=dev)
        shift = not cfg.is_encoder
    else:
        targets = batch["tokens"]
        dev = targets.device
        mask = torch.ones(targets.shape, dtype=torch.float32, device=dev)
        if cfg.prefix_tokens > 0:
            pad = torch.zeros((targets.shape[0], cfg.prefix_tokens),
                              dtype=targets.dtype, device=dev)
            targets = torch.cat([pad, targets], dim=1)
            mask = torch.cat([pad.float(), mask], dim=1)
        shift = True
    if shift:
        targets = torch.roll(targets, -1, dims=1)
        mask = torch.roll(mask, -1, dims=1)
        mask[:, -1] = 0.0
    return targets, mask


def loss_fn(model: Transformer, batch: dict, mesh=None):
    """Next-token (or, for an encoder, frame-label) cross-entropy plus
    ``router_aux_coef`` times the MoE auxiliary loss. Returns (loss,
    {"ce", "aux"}), 0-d float32 tensors.

    A token model's targets are its tokens rolled one to the left with the
    last position masked (rolled rather than sliced, so S keeps its chunk
    size); a prefix-LM's prefix positions carry target 0 at weight 0. An
    embedding-fed model takes ``batch["targets"]``, shifted the same way
    unless it is an encoder (frame labels)."""
    if _sharded(model, mesh):
        return _loss_sharded(model, batch)
    cfg = model.cfg
    dev = model.device
    flash_eligible(cfg, dev)
    x = embed_inputs(model, batch)
    targets, mask = _targets(cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=dev)
    x, aux, _, _ = _run_trunk(model, x, positions)
    x = apply_norm(model.final_norm, x, cfg)
    ce = chunked_xent(model, x, targets, mask)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux}


# ============================================================ on a mesh
class ShardedModel:
    """A model's parameters laid out on a mesh: the port's tree
    (`param_tree`'s layout, ``"layers"`` a list of one dict a layer) with
    a `ShardedTensor` at each leaf, cut by ``param_specs(cfg, mesh,
    serve)``: FSDP over ``data`` (unless ``serve``), tensor-parallel over
    ``model``, replicated where a dim does not divide. `forward`,
    `decode_step`, `loss_fn` and the train step take it in place of a
    `Transformer`, and run on its mesh:

    * the batch is split over the data axes by rows (`_shard_batch`;
      every shard takes every row when they do not divide it);
    * each attention and MLP layer computes Megatron-style over
      ``model`` (``layers.apply_attention``, ``layers.apply_mlp``) and an
      MoE layer through the capacity dispatch (``moe.apply_moe``); the
      FSDP slices are all-gathered over ``data`` just before use, and
      autograd reduce-scatters their gradients back;
    * the RWKV and Mamba2 blocks run whole on every shard's rows, their
      params gathered whole and their cache slices gathered over
      ``model`` and written back (a replicated computation, whose
      gradients sum right over the replicas);
    * the embedding gathers the table whole (one copy a device) for the
      hot-slab lookup; the logits are vocab-parallel where the table (or
      head) splits its vocab over ``model``: each shard its slice,
      gathered onto the shard at ``model`` 0, which alone computes the
      loss of its data shard's rows (a replicated value counts once).
    """

    def __init__(self, cfg: ModelConfig, mesh, params: dict):
        self.cfg, self.mesh, self.params = cfg, mesh, params

    @classmethod
    def from_model(cls, model: Transformer, mesh, serve: bool = False):
        """``model``'s parameters cut onto ``mesh`` (copies)."""
        from ..launch.shardings import param_specs, shard_tree
        specs = param_specs(model.cfg, mesh, serve=serve)
        return cls(model.cfg, mesh,
                   shard_tree(param_tree(model), specs, mesh))

    @classmethod
    def from_stacked(cls, cfg: ModelConfig, tree: dict):
        """A tree in the reference's layout whose leaves are already
        `ShardedTensor`s (``CheckpointManager.restore(shardings=)``): the
        ``(L, ...)`` layer leaves become one view a layer."""
        from ..launch.shardings import layer_of
        params = {k: v for k, v in tree.items() if k != "layers"}
        params["layers"] = [layer_of(tree["layers"], i)
                            for i in range(cfg.num_layers)]
        return cls(cfg, params["final_norm"]["scale"].mesh, params)

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    def leaves(self) -> list:
        """The `ShardedTensor` leaves, in the optimizer's order."""
        from ..train.optim import _leaves
        return [st for _, st in _leaves(self.params)]

    def parameters(self):
        for st in self.leaves():
            yield from st.shards

    def records_grad(self) -> bool:
        return torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())

    def unshard(self, device=None) -> Transformer:
        """The whole model on one device (shard 0's by default)."""
        from ..launch.shardings import unshard_tree
        return Transformer(self.cfg, unshard_tree(self.params, device))


def _sharded(model, mesh) -> bool:
    """Whether an entry point runs on a mesh: a `ShardedModel` (on
    ``mesh``, when one is named) does; a `Transformer` with no mesh or a
    one-shard mesh (``make_host_mesh``) runs on its device; a
    `Transformer` with a larger mesh is refused."""
    if isinstance(model, ShardedModel):
        if mesh is not None and mesh != model.mesh:
            raise ValueError("the model is sharded on another mesh")
        return True
    if mesh is not None and mesh.size > 1:
        raise TypeError("a mesh of more than one shard takes a "
                        "ShardedModel (ShardedModel.from_model)")
    return False


def _local(tree, i: int):
    """Shard ``i``'s slices of a tree of `ShardedTensor`s."""
    if isinstance(tree, dict):
        return {k: _local(v, i) for k, v in tree.items()}
    return tree.shards[i]


def _gathered(tree, n: int, axes=None) -> list:
    """One tree a shard of its leaves gathered over ``axes``."""
    if isinstance(tree, dict):
        sub = {k: _gathered(v, n, axes) for k, v in tree.items()}
        return [{k: v[i] for k, v in sub.items()} for i in range(n)]
    return tree.gather(axes)


def _dp_index(mesh, i: int) -> tuple[int, int]:
    """(index, count) of shard ``i``'s data shard over the data axes."""
    r, n = 0, 1
    c = mesh.coords(i)
    for a in DP_AXES:
        if a in mesh.axis_names:
            r, n = r * mesh.shape[a] + c[a], n * mesh.shape[a]
    return r, n


def _shard_batch(x: torch.Tensor, mesh):
    """The rows of ``x`` each shard takes: its data shard's contiguous run
    when the data axes divide the batch, else every row (the
    reference's constraint onto the data axes, which it drops when they
    do not divide). Returns (one tensor a shard, whether split)."""
    ndp = _dp_index(mesh, 0)[1]
    split = ndp > 1 and x.shape[0] % ndp == 0
    per = x.shape[0] // ndp if split else x.shape[0]
    out, done = [], {}
    for i, dev in enumerate(mesh.devices):
        r = _dp_index(mesh, i)[0] if split else 0
        if (dev, r) not in done:
            done[(dev, r)] = x[r * per:(r + 1) * per].to(dev)
        out.append(done[(dev, r)])
    return out, split


def _heads(mesh) -> list[int]:
    """The shards at ``model`` 0, in data order: each holds its data
    shard's logits and loss."""
    idx = [i for i in range(mesh.size)
           if mesh.coords(i).get(MODEL, 0) == 0]
    return sorted(idx, key=lambda i: _dp_index(mesh, i)[0])


def _embed_rows(sm: ShardedModel, ids: list) -> list:
    """`embed_tokens` of each shard's ids from the table gathered whole:
    one lookup for the shards that share a device and their rows (the
    model replicas of a data shard, on one card)."""
    table = sm.params["embed"]["table"].gather()
    done: dict = {}
    out = []
    for i, t in enumerate(ids):
        key = (id(t), id(table[i]))
        if key not in done:
            done[key] = embed_tokens({"table": table[i]}, t, sm.cfg)
        out.append(done[key])
    return out


def _embed_sharded(sm: ShardedModel, batch: dict):
    """`embed_inputs` on each shard's rows. Returns (xs, split)."""
    cfg, mesh = sm.cfg, sm.mesh
    if cfg.input_mode == "embeddings":
        xs, split = _shard_batch(batch["embeds"], mesh)
        return [x.to(COMPUTE_DTYPE) for x in xs], split
    ids, split = _shard_batch(batch["tokens"], mesh)
    xs = _embed_rows(sm, ids)
    if cfg.prefix_tokens > 0:
        prefix, _ = _shard_batch(batch["prefix"], mesh)
        xs = [torch.cat([pr.to(COMPUTE_DTYPE), x], dim=1)
              for pr, x in zip(prefix, xs)]
    return xs, split


def _attn_block_sharded(p, xs, cfg: ModelConfig, positions, cache, mesh,
                        split_rows: bool):
    """`attn_block` on a mesh: the norms on every shard, attention and
    the MLP (or MoE) across ``model``."""
    n = mesh.size
    scale = bf16_scalar(cfg.residual_scale)
    h, new_c = apply_attention(
        p["attn"], [apply_norm(_local(p["norm1"], i), xs[i], cfg)
                    for i in range(n)], cfg, positions, cache, mesh=mesh)
    x32 = [xs[i].float() + h[i] * scale for i in range(n)]
    y = [apply_norm(_local(p["norm2"], i), x32[i], cfg) for i in range(n)]
    aux = None
    if cfg.is_moe:
        f, aux = apply_moe(p["ffn"], y, cfg, mesh, split_rows=split_rows)
    else:
        f = apply_mlp(p["ffn"], y, cfg, mesh=mesh)
    return [x32[i].to(COMPUTE_DTYPE) + f[i] * scale for i in range(n)], \
        new_c, aux


def _replicated_block(fn, p, xs, cfg: ModelConfig, cache, mesh):
    """A recurrent block (`rwkv_block`, `mamba_block`) on every shard's
    rows, its params gathered whole; in decode each shard's cache slice
    is gathered over ``model``, and the shard keeps its slice of the new
    state."""
    n = mesh.size
    full = _gathered(p, n)
    if cache is None:
        return [fn(full[i], xs[i], cfg)[0] for i in range(n)]
    caches = _gathered(cache, n, MODEL)
    outs = []
    for i in range(n):
        x, new_c = fn(full[i], xs[i], cfg, caches[i])
        _write_slice(cache, new_c, i)
        outs.append(x)
    return outs


def _write_slice(dst, src, i: int) -> None:
    """Shard ``i``'s slice of a whole-over-``model`` state, into its cache
    in place."""
    if isinstance(src, dict):
        for k, v in src.items():
            _write_slice(dst[k], v, i)
        return
    sl = tuple(slice(*dst.bounds(i, j)) if split_over(dst, j)
               else slice(None) for j in range(src.dim()))
    dst.shards[i].copy_(src[sl])


def _run_trunk_sharded(sm: ShardedModel, xs, positions, cache, split_rows):
    """`_run_trunk` on a mesh: xs one tensor a shard. Returns (xs, aux one
    a shard, lengths, shared_lengths)."""
    from ..launch.shardings import layer_of
    cfg, mesh = sm.cfg, sm.mesh
    decode = cache is not None
    aux = [torch.zeros((), dtype=torch.float32, device=d)
           for d in mesh.devices]
    lengths, shared_lengths = [], []
    if cfg.remat and not decode and sm.records_grad():
        def run(fn, *args):   # keep the block's output only; replay it
            return checkpoint(fn, *args, use_reentrant=False)
    else:
        def run(fn, *args):
            return fn(*args)
    kind = trunk_kind(cfg)
    for i, lp in enumerate(sm.params["layers"]):
        lc = layer_of(cache["layers"], i) if decode else None
        if cfg.block_pattern[i] == "shared_attn":
            sc = (layer_of(cache["shared"], len(shared_lengths))
                  if decode else None)
            xs, new_sc, _ = run(_attn_block_sharded, sm.params["shared_attn"],
                                xs, cfg, positions, sc, mesh, split_rows)
            if decode:
                shared_lengths.append(new_sc["length"])
        if kind == "attn":
            xs, new_c, a = run(_attn_block_sharded, lp, xs, cfg, positions,
                               lc, mesh, split_rows)
            if decode:
                lengths.append(new_c["length"])
            elif a is not None:
                aux = [x + y for x, y in zip(aux, a)]
        else:
            fn = rwkv_block if kind == "rwkv" else mamba_block
            xs = run(_replicated_block, fn, lp, xs, cfg, lc, mesh)
    return xs, aux, lengths, shared_lengths


def _logits_sharded(sm: ShardedModel, xs) -> dict:
    """The logits of each `_heads` shard's rows: vocab-parallel where the
    table (tied) or head splits its vocab over ``model``, each shard's
    slice gathered onto the shard at ``model`` 0; else computed there
    alone."""
    cfg, mesh = sm.cfg, sm.mesh
    name = "table" if cfg.tie_embeddings else "head"
    w = sm.params["embed"][name]
    wg = w.gather(DP_AXES)
    heads = _heads(mesh)
    if not split_over(w, 0 if cfg.tie_embeddings else 1):
        return {i: lm_logits({name: wg[i]}, xs[i], cfg) for i in heads}
    parts = [lm_logits({name: wg[i]}, xs[i], cfg) for i in range(mesh.size)]
    return {g[0]: torch.cat([parts[j].to(mesh.devices[g[0]]) for j in g],
                            dim=-1) for g in mesh.groups(MODEL)}


def _assemble(per: dict, mesh, split: bool) -> torch.Tensor:
    """The `_heads` shards' rows as one tensor on the mesh's home."""
    heads = _heads(mesh)
    if not split:
        return per[heads[0]].to(mesh.home)
    return torch.cat([per[i].to(mesh.home) for i in heads], dim=0)


def _forward_sharded(sm: ShardedModel, batch: dict):
    cfg, mesh = sm.cfg, sm.mesh
    flash_eligible(cfg, sm.device)
    xs, split = _embed_sharded(sm, batch)
    positions = torch.arange(xs[0].shape[1], dtype=torch.int32,
                             device=sm.device)
    xs, aux, _, _ = _run_trunk_sharded(sm, xs, positions, None, split)
    xs = [apply_norm(_local(sm.params["final_norm"], i), x, cfg)
          for i, x in enumerate(xs)]
    return _assemble(_logits_sharded(sm, xs), mesh, split), aux[0]


def _stack_lengths(lengths: list):
    """Per-layer ``length`` `ShardedTensor`s as one stacked (L,) one."""
    st = lengths[0]
    return type(st)([torch.stack([ln.shards[i] for ln in lengths])
                     for i in range(st.mesh.size)], (None,), st.mesh,
                    (len(lengths),))


def _decode_sharded(sm: ShardedModel, cache: dict, tokens):
    cfg, mesh = sm.cfg, sm.mesh
    ids, split = _shard_batch(tokens, mesh)
    xs = _embed_rows(sm, ids)
    pos = cache["pos"]
    positions = pos.shards[0][None].to(torch.int32)
    xs, _, lengths, shared_lengths = _run_trunk_sharded(
        sm, xs, positions, cache, split)
    layers = cache["layers"]
    if lengths:
        layers = dict(layers, length=_stack_lengths(lengths))
    new_pos = type(pos)([t + positions.shape[-1] for t in pos.shards],
                        pos.spec, mesh, pos.shape)
    new_cache = {"layers": layers, "pos": new_pos}
    if "shared" in cache:
        new_cache["shared"] = dict(cache["shared"],
                                   length=_stack_lengths(shared_lengths))
    xs = [apply_norm(_local(sm.params["final_norm"], i), x, cfg)
          for i, x in enumerate(xs)]
    return _assemble(_logits_sharded(sm, xs), mesh, split), new_cache


def _loss_sharded(sm: ShardedModel, batch: dict):
    """`loss_fn` on a mesh: each `_heads` shard sums its rows' terms chunk
    by chunk (`chunked_xent`'s chunks, each under a checkpoint while
    autograd records), the sums are added in data order on the home
    device and divided by the whole batch's mask."""
    cfg, mesh = sm.cfg, sm.mesh
    dev = sm.device
    flash_eligible(cfg, dev)
    xs, split = _embed_sharded(sm, batch)
    targets, mask = _targets(cfg, batch)
    ts, _ = _shard_batch(targets, mesh)
    ms, _ = _shard_batch(mask, mesh)
    positions = torch.arange(xs[0].shape[1], dtype=torch.int32, device=dev)
    xs, aux, _, _ = _run_trunk_sharded(sm, xs, positions, None, split)
    xs = [apply_norm(_local(sm.params["final_norm"], i), x, cfg)
          for i, x in enumerate(xs)]
    heads = _heads(mesh) if split else _heads(mesh)[:1]
    s = xs[0].shape[1]
    c = _chunk(cfg, s)

    def body(*chunks):
        logits = _logits_sharded(sm, list(chunks[:mesh.size]))
        out = ()
        for j, i in enumerate(heads):
            out += _xent_terms(logits[i], chunks[mesh.size + 2 * j],
                               chunks[mesh.size + 2 * j + 1])
        return out

    run = body
    if sm.records_grad():
        def run(*args):
            return checkpoint(body, *args, use_reentrant=False)
    sums = [torch.zeros((), dtype=torch.float32, device=mesh.devices[i])
            for i in heads for _ in range(2)]
    for a in range(0, s, c):
        args = [x[:, a:a + c] for x in xs]
        for i in heads:
            args += [ts[i][:, a:a + c], ms[i][:, a:a + c]]
        sums = [t + u for t, u in zip(sums, run(*args))]
    loss, zloss = sums[0].to(dev), sums[1].to(dev)
    for j in range(1, len(heads)):
        loss, zloss = loss + sums[2 * j].to(dev), zloss + sums[2 * j + 1].to(
            dev)
    denom = torch.clamp(mask.sum(), min=1.0).to(dev)
    ce = loss / denom + 1e-4 * zloss / denom
    a0 = aux[0]
    return ce + cfg.router_aux_coef * a0, {"ce": ce, "aux": a0}

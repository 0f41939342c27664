"""PyTorch port: training (the optimizer, the loss and its gradients, the
flash backward's plain version, the train step) agrees with the JAX
package.

Both packages run the same smoke configs on the same weights (the JAX
package's ``init_params`` pytree, carried across with `from_jax_params`)
and the same numpy inputs made from seeds. The tolerances, each with its
reason:

* optimizer functions on float32 trees: 1e-6 relative (the same float32
  formulas; sums taken in another order);
* ``chunked_xent`` on the same final hidden state: 1e-6 relative;
* ``loss_fn`` end to end: 1e-5 relative where the port's forward gives
  the reference's logits (qwen2.5-3b, minicpm-2b, paligemma-3b);
  hubert-xlarge's at 5e-5, since the port's layernorm sums in another
  order than XLA's and moves a bf16 unit of a normed input now and then,
  which the bidirectional attention spreads to every row
  (tests/test_torch_masks.py holds its forward at bf16 tolerance);
  rwkv6-3b's at 5e-4 (measured 1.5e-4): at 40 positions, not a multiple
  of the 16-token chunk, both packages take the token scan, whose float32
  sums run in another order and move a bf16 unit of the time-mix's
  output now and then; zamba2-1.2b's at 5e-5 (measured 2.1e-5), whose
  Mamba layers part from the reference's by a bf16 unit now and then;
* gradients: each leaf's relative L2 error within 5e-2 of ``jax.grad``'s:
  the backward's bf16 intermediates round at other places in XLA's
  autodiff and torch's autograd (measured worst: 2.4e-2, qwen2.5-3b's
  ``bk``, whose gradient sums the rounded ``dk`` over positions; with an
  MoE trunk, whose experts' gradients come through `ragged_dot`'s
  backward, 1.2e-2, smoke moonshot's router, and 1.0e-2, smoke
  mixtral's embedding; with the recurrent trunks 1.8e-2, smoke
  rwkv6-3b's ``u_bonus``, and 6.3e-3, smoke zamba2-1.2b's embedding;
  at their real groups of 16 and 9, 1.5e-2 and 2.4e-2, chatglm3-6b's
  and starcoder2-7b's ``bk``, qwen's leaf again);
* the flash backward's plain version: 1e-5 against ``jax.vjp`` of the
  reference's oracle and against torch autograd, in float32;
* a train step: loss and grad norm at 1e-2 relative, and every parameter
  within one AdamW step's reach (2·lr, plus the decay term) of the
  reference's, the bound a gradient of opposite sign gives; on average
  within 5% of it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.kernels.flash_attn.ref import (  # noqa: E402
    attention_ref as jax_attention)
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optim as JO  # noqa: E402
from repro.train import steps as JS  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attn as fa  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, attention_ref)
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

OPT_TOL = dict(rtol=1e-6, atol=1e-7)
GRAD_REL_L2 = 5e-2


def _pair(arch, layers=2, **replace):
    """(JAX config, port config, JAX params, port model) on one seed."""
    cfg_j = dataclasses.replace(jax_smoke(arch, layers=layers), **replace)
    cfg_t = dataclasses.replace(smoke_config(arch, layers=layers), **replace)
    params = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    model = TT.from_jax_params(cfg_t, jax.tree.map(np.asarray, params),
                               device="cpu")
    return cfg_j, cfg_t, params, model


def _bf16(a: np.ndarray):
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()


def _batch(cfg, b, s, seed):
    """(JAX batch, port batch) of ``s`` positions: frames and frame labels
    for an encoder, a prefix of embeddings and tokens for a prefix-LM,
    tokens otherwise."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        j, t = _bf16(rng.standard_normal((b, s, cfg.d_model)))
        labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        return ({"embeds": j, "targets": jnp.asarray(labels)},
                {"embeds": t, "targets": torch.from_numpy(labels)})
    tokens = rng.integers(0, cfg.vocab_size,
                          (b, s - cfg.prefix_tokens)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {
        "tokens": torch.from_numpy(tokens)}
    if cfg.prefix_tokens:
        jb["prefix"], tb["prefix"] = _bf16(rng.standard_normal(
            (b, cfg.prefix_tokens, cfg.d_model)))
    return jb, tb


def _leaf(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", k))]
    return tree


def _grads(model) -> dict:
    return TT.stack_layers(TS._grad_tree(TT.param_tree(model)))


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedule_lr_matches_the_reference(schedule):
    tc_j = JO.TrainConfig(learning_rate=3e-4, warmup_steps=10,
                          total_steps=100, schedule=schedule)
    tc_t = TO.TrainConfig(learning_rate=3e-4, warmup_steps=10,
                          total_steps=100, schedule=schedule)
    for step in (0, 1, 5, 10, 11, 50, 89, 90, 95, 99, 100, 120):
        got = TO.schedule_lr(tc_t, step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got),
                                   float(JO.schedule_lr(tc_j, step)),
                                   **OPT_TOL)


def test_schedules():
    """tests/test_substrate.py::test_schedules on the port."""
    tc = TO.TrainConfig(learning_rate=1.0, warmup_steps=10, total_steps=100,
                        schedule="cosine")
    assert float(TO.schedule_lr(tc, 0)) == 0.0
    assert abs(float(TO.schedule_lr(tc, 10)) - 1.0) < 1e-6
    assert float(TO.schedule_lr(tc, 100)) < 1e-6
    wsd = TO.TrainConfig(learning_rate=1.0, warmup_steps=10, total_steps=100,
                         schedule="wsd")
    assert abs(float(TO.schedule_lr(wsd, 50)) - 1.0) < 1e-6
    assert float(TO.schedule_lr(wsd, 99)) < 0.01


def test_grad_clip():
    """tests/test_substrate.py::test_grad_clip on the port, in place."""
    g = {"a": torch.tensor([3.0, 4.0])}
    clipped, norm = TO.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 5.0) < 1e-6
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    assert clipped["a"] is g["a"]


def _opt_trees(seed):
    """The same float32 params and gradients in the reference's layout
    (layer leaves stacked to (L, ...)) and the port's (a list of layers):
    stacked norm scales and biases of rank 1, a matrix, and an unstacked
    final norm."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        return rng.standard_normal(shape).astype(np.float32)

    ref = {"layers": {"norm1": {"scale": draw((3, 8))},
                      "attn": {"wq": draw((3, 8, 4)), "bq": draw((3, 4))}},
           "final_norm": {"scale": draw((8,))},
           "embed": {"table": draw((16, 8))}}

    def port(tree):
        out = {k: TO._map(lambda a: torch.from_numpy(a.copy()), v)
               for k, v in tree.items() if k != "layers"}
        out["layers"] = [TO._map(lambda a, i=i: torch.from_numpy(a[i].copy()),
                                 tree["layers"]) for i in range(3)]
        return out

    return ref, port


def test_adamw_update_matches_the_reference():
    """Four AdamW steps on the same trees, clipping on, decay 0.1: the
    port's params and moments equal the reference's at 1e-6. The layers'
    norm scales and biases (rank 1 in the port, 2 in the reference) decay
    as in the reference; the final norm does not."""
    tc_j = JO.TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                          weight_decay=0.1, grad_clip=1.0)
    tc_t = TO.TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                          weight_decay=0.1, grad_clip=1.0)
    ref, port = _opt_trees(0)
    params_j = jax.tree.map(jnp.asarray, ref)
    params_t = port(ref)
    opt_j = JO.init_opt_state(params_j)
    opt_t = TO.init_opt_state(params_t)
    for step in range(4):
        g, _ = _opt_trees(100 + step)
        params_j, opt_j, m_j = JO.adamw_update(
            params_j, jax.tree.map(jnp.asarray, g), opt_j, tc_j)
        params_t, opt_t, m_t = TO.adamw_update(params_t, port(g), opt_t,
                                               tc_t)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m_t[name]), float(m_j[name]),
                                       **OPT_TOL)
    assert int(opt_t["step"]) == int(opt_j["step"]) == 4
    for got, want in ((params_t, params_j), (opt_t["mu"], opt_j["mu"]),
                      (opt_t["nu"], opt_j["nu"])):
        stacked = TT.stack_layers(got)
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            np.testing.assert_allclose(_leaf(stacked, path), np.asarray(leaf),
                                       **OPT_TOL)


def test_weight_decay_follows_the_references_rank():
    """Decay with a zero gradient: every layer leaf (norm scales and
    biases too) and every matrix shrinks by lr·wd·p; the final norm
    stays."""
    ref, port = _opt_trees(1)
    params = port(ref)
    zeros = TO._map(torch.zeros_like, params)
    tc = TO.TrainConfig(learning_rate=1.0, warmup_steps=0, schedule="const",
                        weight_decay=0.5)
    before = TT.stack_layers(params)
    TO.adamw_update(params, zeros, TO.init_opt_state(params), tc)
    after = TT.stack_layers(params)
    for path in (("layers", "norm1", "scale"), ("layers", "attn", "bq"),
                 ("layers", "attn", "wq"), ("embed", "table")):
        np.testing.assert_allclose(_leaf(after, path),
                                   0.5 * _leaf(before, path), rtol=1e-6)
    np.testing.assert_array_equal(after["final_norm"]["scale"],
                                  before["final_norm"]["scale"])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "moonshot-v1-16b-a3b",
                                  "rwkv6-3b", "zamba2-1.2b"])
def test_decay_mask_is_the_references(arch):
    """`decays` on the port's tree picks the leaves the reference's rule
    (``p.ndim >= 2`` on its stacked tree, src/repro/train/optim.py) picks:
    RWKV's ``u_bonus``, ``mu_base``, ``w_base``, ``ln_scale``, Mamba2's
    ``a_log``, ``dt_bias``, ``d_skip``, ``norm_scale`` and every layer's
    norms decay; the final norm and zamba2's unstacked shared block's
    norms do not."""
    _, _, params, model = _pair(arch)
    want = {tuple(getattr(k, "key", k) for k in path): leaf.ndim >= 2
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    got = {}
    for path, leaf in TO._leaves(TT.param_tree(model)):
        ref = tuple(k for k in path if not isinstance(k, int))
        assert got.setdefault(ref, TO.decays(path, leaf)) == TO.decays(
            path, leaf), path
    assert got == want
    for name in {"rwkv6-3b": ("u_bonus", "mu_base", "w_base", "ln_scale"),
                 "zamba2-1.2b": ("a_log", "dt_bias", "d_skip",
                                 "norm_scale")}.get(arch, ()):
        block = "rwkv" if arch == "rwkv6-3b" else "mamba"
        assert got[("layers", block, name)], name
    if arch == "zamba2-1.2b":
        assert not got[("shared_attn", "norm1", "scale")]
    assert not got[("final_norm", "scale")]


def test_adamw_reduces_quadratic_loss():
    """tests/test_substrate.py::test_adamw_reduces_quadratic_loss."""
    tc = TO.TrainConfig(learning_rate=0.1, warmup_steps=0, total_steps=100,
                        schedule="const", weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = TO.init_opt_state(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = TO.adamw_update(params, grads, opt, tc)
    assert float(params["w"].abs().max()) < 1.0


def test_int8_compression_matches_the_reference():
    rng = np.random.default_rng(0)
    g = rng.standard_normal(1000).astype(np.float32)
    q_j, s_j = JO.compress_int8(jnp.asarray(g))
    q_t, s_t = TO.compress_int8(torch.from_numpy(g))
    assert q_t.dtype == torch.int8
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-7)
    np.testing.assert_array_equal(TO.decompress_int8(q_t, s_t).numpy(),
                                  np.asarray(JO.decompress_int8(q_j, s_j)))


def test_int8_compression_error_feedback():
    """tests/test_substrate.py::test_int8_compression_error_feedback."""
    g = torch.from_numpy(
        np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    q, s = TO.compress_int8(g)
    assert float((g - TO.decompress_int8(q, s)).abs().max()) <= float(s) + 1e-6
    acc = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(50):
        q, s = TO.compress_int8(g + acc)
        sent = TO.decompress_int8(q, s)
        acc = (g + acc) - sent
        total = total + sent
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=5e-3)


def test_ef_compressed_psum_is_not_ported():
    """`ef_compressed_psum` is ported now (the name is kept): over a
    2-way ``pod`` axis of CPU shards it sums each shard's int8-quantised
    gradient plus residual, halves it, and keeps each shard's new
    residual (tests/test_torch_mesh_moe.py holds it to the reference's
    inside ``shard_map``)."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2,), ("pod",), device="cpu")
    rng = np.random.default_rng(5)
    g = [torch.from_numpy(rng.standard_normal(9).astype(np.float32))
         for _ in range(2)]
    e = [torch.zeros(9) for _ in range(2)]
    mean, errs = TO.ef_compressed_psum({"w": g}, {"w": e}, "pod", mesh)
    sent = [TO.decompress_int8(*TO.compress_int8(x)) for x in g]
    for i in range(2):
        torch.testing.assert_close(mean["w"][i], (sent[0] + sent[1]) / 2)
        torch.testing.assert_close(errs["w"][i], g[i] - sent[i])


# -------------------------------------------------------------------- loss
LOSS_ARCHS = [("qwen2.5-3b", 1e-5), ("minicpm-2b", 1e-5),
              ("paligemma-3b", 1e-5), ("hubert-xlarge", 5e-5),
              ("rwkv6-3b", 5e-4), ("zamba2-1.2b", 5e-5),
              ("chatglm3-6b", 1e-5), ("starcoder2-7b", 1e-5)]


@pytest.mark.parametrize("arch,rtol", LOSS_ARCHS)
def test_loss_fn_matches_the_reference(arch, rtol):
    cfg_j, cfg_t, params, model = _pair(arch)
    jb, tb = _batch(cfg_t, 2, 40, seed=2)
    want, wm = JT.loss_fn(params, jb, cfg_j)
    got, gm = TT.loss_fn(model, tb)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), rtol=rtol)
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0


@pytest.mark.parametrize("arch,s", [("qwen2.5-3b", 40), ("paligemma-3b", 24),
                                    ("hubert-xlarge", 48)])
def test_chunked_xent_matches_the_reference(arch, s):
    """The same final hidden state (bf16 from a seed), targets and mask
    into both packages' ``chunked_xent``: loss_chunk 16 and S not a power
    of two, so the chunk halves until it divides S."""
    cfg_j, cfg_t, params, model = _pair(arch)
    rng = np.random.default_rng(4)
    xj, xt = _bf16(rng.standard_normal((2, s, cfg_t.d_model)))
    targets = rng.integers(0, cfg_t.vocab_size, (2, s)).astype(np.int32)
    mask = (rng.random((2, s)) < 0.8).astype(np.float32)
    want = JT.chunked_xent(params, xj, jnp.asarray(targets),
                           jnp.asarray(mask), cfg_j)
    got = TT.chunked_xent(model, xt, torch.from_numpy(targets),
                          torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_loss_fn_with_an_moe_adds_the_router_loss():
    """moonshot's smoke MoE: the loss is ce + router_aux_coef·aux, and
    both match the reference's (aux on the reference's routing)."""
    cfg_j, cfg_t, params, model = _pair("moonshot-v1-16b-a3b")
    jb, tb = _batch(cfg_t, 2, 16, seed=6)
    want, wm = JT.loss_fn(params, jb, cfg_j)
    got, gm = TT.loss_fn(model, tb)
    assert float(gm["aux"]) > 0
    np.testing.assert_allclose(
        float(got), float(gm["ce"]) + cfg_t.router_aux_coef * float(gm["aux"]),
        rtol=1e-6)
    np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]), rtol=1e-3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3)


# paligemma-3b at its own head dim, 256 (the smoke config's is 16), with
# its 4-row prefix: the width the card's d 256 backward kernels take;
# zamba2-1.2b at 3 layers with its shared block applied before the last
# two (the 2-layer smoke pattern applies it once), so that its gradient
# sums two applications; chatglm3-6b and starcoder2-7b at their real
# groups (the smoke config's 4 query heads over 1 kv head is a group of
# 4): 16 query heads over 1 kv head and 9 over 1, head dim 16
GRAD_REPLACE = {"paligemma-3b": dict(head_dim=256),
                "zamba2-1.2b": dict(num_layers=3, block_pattern=(
                    "mamba", "shared_attn", "shared_attn")),
                "chatglm3-6b": dict(num_heads=16, num_kv_heads=1),
                "starcoder2-7b": dict(num_heads=9, num_kv_heads=1)}


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm-2b",
                                  "moonshot-v1-16b-a3b", "mixtral-8x7b",
                                  "paligemma-3b", "rwkv6-3b",
                                  "zamba2-1.2b", "chatglm3-6b",
                                  "starcoder2-7b"])
def test_gradients_match_jax_grad(arch):
    """Autograd of the port's loss against ``jax.grad`` of the
    reference's, leaf by leaf, relative L2 error within `GRAD_REL_L2`,
    with remat on (the blocks and the loss chunks replayed) and off; the
    two give the same bits. chatglm3-6b's half rotary and q/k/v biases
    and starcoder2-7b's layernorm, biased tanh-GELU MLP and output bias
    are differentiated at their groups of 16 and 9. The recurrent trunks'
    decay path (rwkv6's ``dec_w1``, ``dec_w2``, ``w_base``; Mamba2's ``a_log``,
    ``dt_bias``) is where in-place writes in the chunked scans once
    raised without remat and, with it, gave wrong gradients silently
    (the replay's saved-tensor hooks skip autograd's version check);
    zamba2's shared attention block is one set of leaves whose gradient
    sums over its applications."""
    cfg_j, cfg_t, params, model = _pair(arch, **GRAD_REPLACE.get(arch, {}))
    jb, tb = _batch(cfg_t, 2, 32, seed=3)
    _, want = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, cfg_j)[0])(params)
    grads = []
    for remat in (True, False):
        m = TT.from_jax_params(dataclasses.replace(cfg_t, remat=remat),
                               jax.tree.map(np.asarray, params), "cpu")
        for p in m.parameters():
            p.requires_grad_(True)
        TT.loss_fn(m, tb)[0].backward()
        grads.append(_grads(m))
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            a = np.asarray(leaf, np.float64)
            b = _leaf(grads[-1], path).astype(np.float64)
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
            assert rel < GRAD_REL_L2, (remat, jax.tree_util.keystr(path),
                                       rel)
    for path, _ in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_array_equal(_leaf(grads[0], path),
                                      _leaf(grads[1], path))


def test_frozen_params_record_no_graph():
    """Serving keeps the parameters frozen: no graph, no remat."""
    _, cfg_t, _, model = _pair("qwen2.5-3b")
    _, tb = _batch(cfg_t, 1, 8, seed=0)
    assert not model.records_grad()
    logits, _ = TT.forward(model, tb)
    assert logits.grad_fn is None


# ------------------------------------------------ flash backward, plain
@pytest.mark.parametrize("window", [0, 8])
def test_attention_bwd_ref_matches_jax_vjp(window):
    """The plain backward against ``jax.vjp`` of the reference's oracle
    (src/repro/kernels/flash_attn/ref.py:7, causal with an optional
    window), float32, at 1e-5."""
    rng = np.random.default_rng(window)
    q, k, v, do = (rng.standard_normal((3, 40, 16)).astype(np.float32)
                   for _ in range(4))
    out, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, window=window),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    lse = attention_lse_ref(qt, kt, window=window)
    got = attention_bwd_ref(qt, kt, vt, torch.from_numpy(np.array(out)),
                            lse, dot, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mask", [dict(causal=True), dict(causal=True,
                                                            prefix=9),
                                  dict(causal=False)],
                         ids=["causal", "prefix", "bidirectional"])
def test_attention_bwd_ref_matches_autograd(mask):
    """Grouped kv (8 query rows on 2 kv rows), every mask: the plain
    backward against torch autograd through `attention_ref`, float32."""
    rng = np.random.default_rng(7)
    q, do = (torch.from_numpy(rng.standard_normal((8, 33, 16)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 33, 16)).astype(
        np.float32)).requires_grad_(True) for _ in range(2))
    q.requires_grad_(True)
    out = attention_ref(q, k, v, **mask)
    out.backward(do)
    lse = attention_lse_ref(q.detach(), k.detach(), **mask)
    got = attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                            out.detach(), lse, do, **mask)
    for g, w in zip(got, (q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_flash_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors `flash_attention_lse` and `flash_attention_bwd` are
    the plain versions and launch nothing; the grad entry refuses what the
    kernels do not take (float32) before any work, and at paligemma-3b's
    bf16 head dim 256 differentiates through the plain versions, launching
    nothing."""
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 20, 16)).astype(
        np.float32)) for _ in range(4))
    before = (fa.launches, dict(fa.launches_bwd))
    o, lse = fa.flash_attention_lse(q, k, v)
    torch.testing.assert_close(lse, attention_lse_ref(q, k))
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    for g, w in zip(got, attention_bwd_ref(q, k, v, o, lse, do)):
        torch.testing.assert_close(g, w)
    assert (fa.launches, fa.launches_bwd) == before
    with pytest.raises(NotImplementedError, match="A8.5c"):
        fa.flash_attention_grad(q, k, v)
    q, do = (torch.from_numpy(rng.standard_normal((8, 20, 256)).astype(
        np.float32)).bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 20, 256)).astype(
        np.float32)).bfloat16() for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention_grad(*leaves, prefix=6).backward(do)
    o, lse = fa.flash_attention_lse(q, k, v, prefix=6)
    for g, w in zip(leaves, attention_bwd_ref(q, k, v, o, lse, do,
                                              prefix=6)):
        torch.testing.assert_close(g.grad, w)
    assert (fa.launches, fa.launches_bwd) == before


# -------------------------------------------------------------- train step
def _step_pair(arch, tc_kw, b=4, s=16, **replace):
    cfg_j, cfg_t, params, model = _pair(arch, **replace)
    tokens = np.random.default_rng(1).integers(
        0, cfg_t.vocab_size, (b, s)).astype(np.int32)
    return cfg_j, cfg_t, params, model, tokens


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "chatglm3-6b",
                                  "starcoder2-7b"])
def test_train_step_matches_the_reference(arch):
    """One `make_train_step` step (two microbatches) against the
    reference's jitted step on the same weights and tokens; chatglm3-6b
    and starcoder2-7b at their real groups (`GRAD_REPLACE`)."""
    _step_against_the_reference(arch, **GRAD_REPLACE.get(arch, {}))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x7b"])
def test_moe_train_step_matches_the_reference(arch):
    """The same with an MoE trunk: the experts' gradients come through
    `ragged_dot`'s backward (`gmm` for dX, `tgmm` for dW) and the
    gather's fixed-order backward, the router's through the gates and
    the auxiliary loss."""
    _step_against_the_reference(arch)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_recurrent_train_step_matches_the_reference(arch):
    """The same with the recurrent trunks: the wkv and SSD scans'
    gradients through the chunked forms' closed form and carried states,
    and AdamW's decay on RWKV's and Mamba2's stacked leaves (``u_bonus``,
    ``mu_base``, ``a_log``, ``d_skip``, ``norm_scale``: rank 2 or more in
    the reference's layout) but not on zamba2's unstacked shared
    block's norms."""
    _step_against_the_reference(arch)


def _step_against_the_reference(arch, **replace):
    kw = dict(learning_rate=1e-3, warmup_steps=0, schedule="const",
              microbatch=2)
    cfg_j, cfg_t, params, model, tokens = _step_pair(arch, kw, **replace)
    step_j, _ = JS.make_train_step(cfg_j, JO.TrainConfig(**kw),
                                   make_host_mesh())
    p_j, o_j, m_j = step_j(params, JO.init_opt_state(params),
                           {"tokens": jnp.asarray(tokens)})
    step_t = TS.make_train_step(cfg_t, TO.TrainConfig(**kw))
    opt_t = TO.init_opt_state(TT.param_tree(model))
    model, opt_t, m_t = step_t(model, opt_t,
                               {"tokens": torch.from_numpy(tokens)})
    for name in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m_t[name]), float(m_j[name]),
                                   rtol=1e-2)
    assert float(m_t["lr"]) == pytest.approx(1e-3)
    assert int(opt_t["step"]) == 1
    assert not any(p.requires_grad or p.grad is not None
                   for p in model.parameters())
    got = TT.to_jax_params(model)
    reach = 2 * 1e-3 + 1e-6
    for path, leaf in jax.tree_util.tree_leaves_with_path(p_j):
        name = jax.tree_util.keystr(path)
        diff = np.abs(_leaf(got, path) - np.asarray(leaf))
        assert diff.max() <= reach * (1 + 0.1 * np.abs(leaf).max()), (
            name, diff.max())
        # the key bias's exact gradient is zero (it adds q·bk to every
        # logit of a row, which the softmax removes), so both packages
        # step it by rounding noise, which AdamW's first step scales to
        # ±lr: only the bound above holds for it
        if not name.endswith("['bk']"):
            assert diff.mean() < 0.05 * reach, name


def test_train_step_microbatch_equivalence():
    """tests/test_substrate.py::test_train_step_microbatch_equivalence on
    the port: gradient accumulation over 2 microbatches equals the
    full-batch step."""
    import copy
    cfg = smoke_config("qwen2.5-3b", layers=2)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    out = []
    for mb in (0, 2):
        tc = TO.TrainConfig(microbatch=mb, warmup_steps=0, schedule="const")
        m = copy.deepcopy(model)
        step = TS.make_train_step(cfg, tc)
        m, _, metrics = step(m, TO.init_opt_state(TT.param_tree(m)),
                             {"tokens": tokens})
        out.append((m, metrics))
    np.testing.assert_allclose(float(out[0][1]["loss"]),
                               float(out[1][1]["loss"]), rtol=2e-2)
    d = [float((a - b).abs().max()) for a, b in
         zip(out[0][0].parameters(), out[1][0].parameters())]
    assert max(d) < 2e-2


def test_train_step_refuses_a_mesh():
    """A mesh is a `core.dist.Mesh`; a `Transformer` on a mesh of more
    than one shard is refused at the step (tests/test_torch_mesh.py
    trains the sharded model)."""
    from repro_torch.launch.mesh import make_mesh
    cfg = smoke_config("qwen2.5-3b", layers=2)
    with pytest.raises(TypeError, match="Mesh"):
        TS.make_train_step(cfg, TO.TrainConfig(), mesh=object())
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    step = TS.make_train_step(cfg, TO.TrainConfig(), mesh)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(TypeError, match="ShardedModel"):
        step(model, TO.init_opt_state(TT.param_tree(model)),
             {"tokens": torch.zeros((2, 8), dtype=torch.int32)})


def test_forward_and_serve_wrappers():
    """`make_forward` and `make_serve_step` are the model's forward and
    decode step."""
    _, cfg_t, _, model = _pair("qwen2.5-3b")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg_t.vocab_size, (2, 6)).astype(np.int32))
    logits, _ = TS.make_forward(cfg_t)(model, {"tokens": tokens})
    assert torch.equal(logits, TT.forward(model, {"tokens": tokens})[0])
    cache = TT.init_cache(cfg_t, 2, 8, device="cpu")
    step = TS.make_serve_step(cfg_t, global_batch=2, max_len=8)
    out, cache = step(model, cache, tokens[:, :1])
    assert out.shape == (2, 1, cfg_t.vocab_size) and int(cache["pos"]) == 1

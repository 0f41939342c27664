"""PyTorch port: the prefix-LM and bidirectional attention masks, head dims
80 and 256, paligemma-3b and hubert-xlarge, and ``configs/shapes.py``
agree with the JAX package.

The masks are the port's ``layers._attn_mask`` (prefix-LM: rows below the
prefix see every key below it; non-causal: every key). The reference's
Pallas kernel is causal only, so the flash kernel's plain version
(`attention_ref`) is held here to the reference's own chunked path
(``repro.models.layers._sdpa_chunked``) with p rounded to bf16, at bf16
rounding, and with float32 PV to a float64 oracle at the reference flash
test's rtol 1e-3 / atol 2e-3. Inputs are made from seeds with numpy.
The models run the smoke configs on the JAX package's weights, carried
across with `from_jax_params`, at tests/test_torch_models.py's standards.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get  # noqa: E402
from repro.configs import shapes as JS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from repro_torch.configs import shapes as TS  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attn as fa  # noqa: E402
from repro_torch.kernels.flash_attn import ref as fa_ref  # noqa: E402
from repro_torch.kernels.flash_attn.ops import attention  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (Q_CHUNK,  # noqa: E402
                                               attention_ref)
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["paligemma-3b", "hubert-xlarge"]
F32_TOL = dict(rtol=1e-3, atol=2e-3)     # tests/test_kernels.py
BF16_FRAC = 2e-2                         # tests/test_torch_models.py
DECODE_TOL = dict(rtol=0.15, atol=0.15)  # tests/test_models.py


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want) -> None:
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=BF16_FRAC,
                               atol=BF16_FRAC * np.abs(want).max())


def _bf16(a: np.ndarray):
    """The same bf16 values in both frameworks."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()


def _pair(arch, layers=2, **replace):
    cfg_j = dataclasses.replace(jax_smoke(arch, layers=layers), **replace)
    cfg_t = dataclasses.replace(smoke_config(arch, layers=layers), **replace)
    params = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    model = TT.from_jax_params(cfg_t, jax.tree.map(np.asarray, params),
                               device="cpu")
    return cfg_j, cfg_t, params, model


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _batch(cfg, b, s, seed):
    """(JAX batch, port batch) of ``s`` positions from ``seed``: frames for
    an encoder, a prefix of embeddings and tokens for a prefix-LM."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        j, t = _bf16(rng.standard_normal((b, s, cfg.d_model)))
        return {"embeds": j}, {"embeds": t}
    tokens = rng.integers(0, cfg.vocab_size,
                          (b, s - cfg.prefix_tokens)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {
        "tokens": torch.from_numpy(tokens)}
    if cfg.prefix_tokens:
        jb["prefix"], tb["prefix"] = _bf16(rng.standard_normal(
            (b, cfg.prefix_tokens, cfg.d_model)))
    return jb, tb


def _heads(t, s, dh):
    """(B, S, heads, dh) -> (B·heads, S, dh), as `apply_attention` hands
    them to the kernel."""
    return t.transpose(1, 2).reshape(-1, s, dh)


def _oracle(q, k, v, *, causal=True, prefix=0, window=0) -> np.ndarray:
    """float64 attention on numpy (BH, S, d) q and (BH / g, S, d) k, v."""
    bh, s, d = q.shape
    g = bh // k.shape[0]
    k, v = np.repeat(k, g, 0).astype(np.float64), np.repeat(v, g, 0)
    logits = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k) / np.sqrt(d)
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask = (j <= i) | ((i < prefix) & (j < prefix))
        if window:
            mask &= (i - j) < window
    logits = np.where(mask, logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bqk,bkd->bqd", p, v.astype(np.float64))


# ---------------------------------------------------------- the plain version
@pytest.mark.parametrize("s", [20, 2 * Q_CHUNK])
@pytest.mark.parametrize("arch", ARCHS)
def test_masked_plain_version_matches_the_reference(arch, s):
    """Smoke paligemma (prefix 4, one kv head) and smoke hubert
    (bidirectional, 4 kv heads): `ops.attention` on bf16, whose plain
    version rounds p to bf16 before PV, against the reference's
    `_sdpa_chunked` on the same bf16 q, k, v, in one query chunk and in
    two, at bf16 rounding."""
    cfg_j, cfg_t = jax_smoke(arch, layers=1), smoke_config(arch, layers=1)
    h, kv, dh = cfg_t.num_heads, cfg_t.num_kv_heads, cfg_t.head_dim
    rng = np.random.default_rng(s + h)
    (jq, tq), (jk, tk), (jv, tv) = (
        _bf16(rng.standard_normal((1, s, n, dh))) for n in (h, kv, kv))
    pos = jnp.arange(s, dtype=jnp.int32)
    want = JL._sdpa_chunked(jq, jk, jv, pos, pos, cfg_j)
    launches = fa.launches
    got = attention(_heads(tq, s, dh), _heads(tk, s, dh), _heads(tv, s, dh),
                    causal=cfg_t.causal, prefix=cfg_t.prefix_tokens)
    assert fa.launches == launches   # the CPU runs the plain version
    got = got.reshape(1, h, s, dh).transpose(1, 2)
    assert got.dtype == torch.bfloat16
    _close(got, want)


@pytest.mark.parametrize("mask", [
    dict(), dict(prefix=300), dict(causal=False), dict(window=128, prefix=40),
    dict(causal=False, window=64, prefix=9)])
@pytest.mark.parametrize("d", [80, 256])
def test_float32_pv_matches_a_float64_oracle(d, mask):
    """On float32 the plain version is the kernel's arithmetic (float32
    PV): against a float64 oracle at the reference flash test's
    tolerance, at the two new head dims, S across a Q_CHUNK boundary, two
    query rows to a kv row. A non-causal call ignores window and prefix,
    as `_attn_mask` does."""
    s = Q_CHUNK + 76
    rng = np.random.default_rng(d + len(mask))
    q = rng.standard_normal((4, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, d)).astype(np.float32)
            for _ in range(2))
    causal = mask.get("causal", True)
    want = _oracle(q, k, v, **(mask if causal else dict(causal=False)))
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), **mask)
    assert got.dtype == torch.float32 and got.shape == (4, s, d)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("round_p", [False, True])
@pytest.mark.parametrize("mask", [
    dict(), dict(prefix=300), dict(causal=False), dict(window=128, prefix=40)])
def test_chunked_equals_unchunked(mask, round_p, monkeypatch):
    """Queries in chunks of Q_CHUNK give the bits of all queries at once
    (a chunk longer than S) and of chunks of 100: each row's logits,
    softmax and PV are its own."""
    s = 2 * Q_CHUNK + 52
    g = torch.Generator().manual_seed(s)
    q = torch.randn(4, s, 80, generator=g).bfloat16()
    k, v = (torch.randn(2, s, 80, generator=g).bfloat16() for _ in range(2))
    chunked = attention_ref(q, k, v, round_p=round_p, **mask)
    monkeypatch.setattr(fa_ref, "Q_CHUNK", 4 * s)
    assert torch.equal(attention_ref(q, k, v, round_p=round_p, **mask),
                       chunked)
    monkeypatch.setattr(fa_ref, "Q_CHUNK", 100)
    assert torch.equal(attention_ref(q, k, v, round_p=round_p, **mask),
                       chunked)


@pytest.mark.parametrize("window", [0, 5, 200])
@pytest.mark.parametrize("prefix", [0, 3, 64])
@pytest.mark.parametrize("s", [7, 130])
def test_visible_pairs_counts_the_mask(s, prefix, window):
    """`ref.visible_pairs`, the closed form that chip_smoke.py's flash
    bound counts (a window's pairs and a prefix's), equals the (row, key)
    pairs that `visible` and the reference's ``layers._attn_mask`` let
    through, causal and not."""
    pos = torch.arange(s)
    for causal in (True, False):
        want = int(fa_ref.visible(pos, pos, causal=causal, prefix=prefix,
                                  window=window).sum())
        cfg = dataclasses.replace(jax_smoke("mixtral-8x7b", layers=1),
                                  causal=causal, window=window,
                                  prefix_tokens=prefix)
        jpos = jnp.arange(s)
        assert int(JL._attn_mask(jpos, jpos, cfg).sum()) == want
        assert fa_ref.visible_pairs(s, causal=causal, prefix=prefix,
                                    window=window) == want


def test_wrapper_checks_the_mask_and_names_its_kind():
    """A negative window or prefix is refused; a device other than the CPU
    and CUDA is refused; each call counts under one of `fa.MASKS`."""
    m = torch.zeros(1, 8, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        fa.flash_attention(m, m, m, prefix=4)
    with pytest.raises(ValueError, match="must not be negative"):
        z = torch.zeros(1, 8, 64)
        fa.flash_attention(z, z, z, prefix=-1)
    assert fa.mask_kind(True, 0) == "causal"
    assert fa.mask_kind(True, 256) == "prefix"
    assert fa.mask_kind(False, 256) == "non_causal"


# ------------------------------------------------------------------ models
def test_forward_matches_the_reference(pair):
    """Prefill logits at bf16 tolerance and the same argmax at every
    position but a few (measured: all 80 agree in both)."""
    cfg_j, cfg_t, params, model = pair
    jb, tb = _batch(cfg_j, 2, 40, seed=5)
    want, _ = JT.forward(params, jb, cfg_j)
    got, aux = TT.forward(model, tb)
    assert got.shape == want.shape == (2, 40, cfg_t.vocab_size)
    assert got.dtype == torch.bfloat16 and float(aux) == 0.0
    _close(got, want)
    assert (_f32(got).argmax(-1) == _f32(want).argmax(-1)).mean() > 0.95


def test_paligemma_decode_matches_the_reference_and_forward():
    """Teacher-forced decode against the reference's and the port's own
    forward, as tests/test_models.py::test_decode_matches_forward runs
    it: a pure token stream (``prefix_tokens=0``; decode feeds tokens
    only), one kv head, head dim 16 in the smoke config."""
    cfg_j, cfg_t, params, model = _pair("paligemma-3b", prefix_tokens=0)
    b, s = 2, 12
    tokens = np.random.default_rng(3).integers(
        0, cfg_j.vocab_size, (b, s)).astype(np.int32)
    jc = JT.init_cache(cfg_j, b, max_len=16)
    tc = TT.init_cache(cfg_t, b, max_len=16, device="cpu")
    step = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, cfg_j))
    jd, td = [], []
    for i in range(s):
        lg, jc = step(params, jc, jnp.asarray(tokens[:, i:i + 1]))
        jd.append(_f32(lg[:, 0]))
        lg, tc = TT.decode_step(model, tc, torch.from_numpy(
            tokens[:, i:i + 1]))
        td.append(_f32(lg[:, 0]))
    jd, td = np.stack(jd, 1), np.stack(td, 1)
    np.testing.assert_allclose(td, jd, **DECODE_TOL)
    assert (td.argmax(-1) == jd.argmax(-1)).mean() > 0.95
    full, _ = TT.forward(model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(td, _f32(full), **DECODE_TOL)
    assert (td.argmax(-1) == _f32(full).argmax(-1)).mean() > 0.95


def test_paligemma_prefix_is_bidirectional():
    """tests/test_models.py::test_paligemma_prefix_is_bidirectional on the
    port: perturbing the last prefix position moves the first position's
    output; perturbing the last token moves no earlier position."""
    cfg = smoke_config("paligemma-3b", layers=2)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 12)).astype(
        np.int32))
    prefix = torch.from_numpy(rng.standard_normal(
        (1, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)).bfloat16()
    base, _ = TT.forward(model, {"tokens": tokens, "prefix": prefix})
    prefix2 = prefix.clone()
    prefix2[:, -1] += 10.0
    out, _ = TT.forward(model, {"tokens": tokens, "prefix": prefix2})
    assert float((out[:, 0].float() - base[:, 0].float()).abs().max()) > 0
    tokens2 = tokens.clone()
    tokens2[0, -1] = (tokens2[0, -1] + 7) % cfg.vocab_size
    out, _ = TT.forward(model, {"tokens": tokens2, "prefix": prefix})
    assert torch.equal(out[:, :-1], base[:, :-1])


def test_hubert_encoder_attends_bidirectionally():
    """tests/test_models.py::test_hubert_encoder_attends_bidirectionally
    on the port: perturbing the last frame moves the first output."""
    cfg = smoke_config("hubert-xlarge", layers=2)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    em = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32)).bfloat16()
    base, _ = TT.forward(model, {"embeds": em})
    em2 = em.clone()
    em2[:, -1] += 10.0
    out, _ = TT.forward(model, {"embeds": em2})
    assert float((out[:, 0].float() - base[:, 0].float()).abs().max()) > 0


def test_from_jax_params_copies_every_leaf(pair):
    """Every leaf of the reference's tree, each layer's slice of the
    stacked ones: paligemma's tied table (no head), hubert's layernorm
    biases, MLP biases and 504-way (smoke: 512) head."""
    cfg_j, _, params, model = pair
    tree = {"embed": model.embed, "final_norm": model.final_norm}
    for group, leaves in (("embed", params["embed"]),
                          ("final_norm", params["final_norm"])):
        assert set(tree[group]) == set(leaves)
        for name, leaf in leaves.items():
            np.testing.assert_array_equal(tree[group][name].numpy(),
                                          np.asarray(leaf))
    count = 0
    for i in range(cfg_j.num_layers):
        for group, leaves in params["layers"].items():
            block = getattr(model.layers[i], group)
            assert set(block) == set(leaves)
            for name, leaf in leaves.items():
                np.testing.assert_array_equal(block[name].numpy(),
                                              np.asarray(leaf[i]))
                count += 1
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert count == cfg_j.num_layers * len(jax.tree.leaves(
        params["layers"]))
    if cfg_j.tie_embeddings:
        assert "head" not in model.embed
    else:
        assert tuple(model.embed["head"].shape) == (cfg_j.d_model,
                                                    cfg_j.vocab_size)


# ------------------------------------------------------------------ shapes
def test_shapes_and_cells_are_the_references():
    assert list(TS.SHAPES) == list(JS.SHAPES)
    for name, shape in TS.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            JS.SHAPES[name])
        for arch in ARCH_IDS:
            assert TS.cell_supported(get_config(arch), shape) == \
                JS.cell_supported(jax_get(arch), JS.SHAPES[name])


def _leaves(tree, path=()):
    """{key path: (shape, dtype name)} of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(_leaves(sub, path + (key,)))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


@pytest.mark.parametrize("shape", list(JS.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_references(arch, shape):
    """Every input's shape and dtype, the decode cells' caches too (RWKV's
    and Mamba2's states, zamba2's shared attention cache, ``long_500k``
    included); the port's are meta tensors."""
    want = _leaves(JS.input_specs(jax_get(arch), JS.SHAPES[shape]))
    cfg, spec = get_config(arch), TS.SHAPES[shape]
    got = TS.input_specs(cfg, spec)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(got))
    assert _leaves(got) == want

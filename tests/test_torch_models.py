"""PyTorch port: the LM layers, the prefill forward, decode and the server
agree with the JAX package.

Both packages run ``smoke_config("minicpm-2b", layers=2)`` (and a few
other smoke configs for the layer functions) on the same weights: the
JAX package's ``init_params`` pytree, carried across with
`from_jax_params`. Inputs are made from seeds with numpy. On the CPU the
port's prefill attention is the flash kernel's plain version, which
rounds p to bf16 before PV as the reference's chunked XLA path does, and
matmuls round to bf16 in both; each test states its tolerance.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCH = "minicpm-2b"
# bf16 results: within 2% of each value or of the result's largest
# magnitude. bf16 keeps 8 bits (0.4%), and an intermediate that rounds one
# unit apart in the two frameworks (a float32 reduction summed in another
# order) is carried through sums of d_ff terms.
BF16_FRAC = 2e-2
# tests/test_models.py::test_decode_matches_forward
DECODE_TOL = dict(rtol=0.15, atol=0.15)


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


def _pair(arch=ARCH, layers=2, **replace):
    """(JAX config, port config, JAX params, port model) on one seed."""
    cfg_j = dataclasses.replace(jax_smoke(arch, layers=layers), **replace)
    cfg_t = dataclasses.replace(smoke_config(arch, layers=layers), **replace)
    params = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    model = TT.from_jax_params(cfg_t, jax.tree.map(np.asarray, params),
                               device="cpu")
    return cfg_j, cfg_t, params, model


@pytest.fixture(scope="module")
def minicpm():
    return _pair()


def _tokens(cfg, shape, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------------ configs
def test_configs_are_the_reference_configs():
    from repro.configs import ARCH_IDS as JAX_IDS
    from repro.configs import get_config as jax_get
    assert ARCH_IDS == JAX_IDS
    for arch in ARCH_IDS:
        assert (dataclasses.asdict(get_config(arch))
                == dataclasses.asdict(jax_get(arch)))
        assert (dataclasses.asdict(smoke_config(arch, layers=3))
                == dataclasses.asdict(jax_smoke(arch, layers=3)))
        assert get_config(arch).param_count() == jax_get(arch).param_count()


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm(norm_type):
    cfg_j, cfg_t, _, _ = _pair(norm_type=norm_type)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, cfg_j.d_model)).astype(np.float32)
    p = {"scale": rng.standard_normal(cfg_j.d_model).astype(np.float32),
         "bias": rng.standard_normal(cfg_j.d_model).astype(np.float32)}
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), cfg_j)
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), cfg_t)
    assert got.dtype == torch.bfloat16
    _close(got, want)


@pytest.mark.parametrize("arch", ["minicpm-2b", "chatglm3-6b"])
def test_rope(arch):
    """Full rotary (minicpm) and half rotary (chatglm3's 2-D RoPE), bf16
    input: the rotation runs in float32 and casts back to bf16."""
    cfg_j, cfg_t = jax_smoke(arch, layers=1), smoke_config(arch, layers=1)
    np.testing.assert_allclose(TL.rope_frequencies(cfg_t).numpy(),
                               np.asarray(JL.rope_frequencies(cfg_j)),
                               rtol=1e-6)
    x = np.random.default_rng(2).standard_normal(
        (2, 9, cfg_j.num_heads, cfg_j.head_dim))
    jx, tx = _bf16(x)
    pos = np.arange(3, 12, dtype=np.int32)
    want = JL.apply_rope(jx, jnp.asarray(pos), cfg_j)
    got = TL.apply_rope(tx, torch.from_numpy(pos), cfg_t)
    assert got.dtype == torch.bfloat16
    _close(got, want)


@pytest.mark.parametrize("arch,replace", [
    ("minicpm-2b", {}), ("minicpm-2b", {"window": 4}),
    ("paligemma-3b", {}), ("hubert-xlarge", {})])
def test_attn_mask(arch, replace):
    """Causal, sliding-window, prefix-LM and non-causal masks, with and
    without key validity: equal."""
    cfg_j = dataclasses.replace(jax_smoke(arch, layers=1), **replace)
    cfg_t = dataclasses.replace(smoke_config(arch, layers=1), **replace)
    qp, kp = np.arange(2, 10), np.arange(12)
    kv = np.arange(12) < 9
    for valid in (None, kv):
        want = JL._attn_mask(jnp.asarray(qp), jnp.asarray(kp), cfg_j,
                             None if valid is None else jnp.asarray(valid))
        got = TL._attn_mask(torch.from_numpy(qp), torch.from_numpy(kp), cfg_t,
                            None if valid is None else torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,s", [("minicpm-2b", 12), ("qwen2.5-3b", 12),
                                    ("minicpm-2b", 2048)])
def test_sdpa_chunked(arch, s):
    """MHA and GQA, one chunk and two query chunks of Q_CHUNK: bf16 PV in
    both, so the results agree to bf16 rounding."""
    cfg_j, cfg_t = jax_smoke(arch, layers=1), smoke_config(arch, layers=1)
    rng = np.random.default_rng(s)
    h, kv, dh = cfg_j.num_heads, cfg_j.num_kv_heads, cfg_j.head_dim
    q = rng.standard_normal((1, s, h, dh))
    k = rng.standard_normal((1, s, kv, dh))
    v = rng.standard_normal((1, s, kv, dh))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    pos = np.arange(s, dtype=np.int32)
    want = JL._sdpa_chunked(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                            cfg_j)
    got = TL._sdpa_chunked(tq, tk, tv, torch.from_numpy(pos),
                           torch.from_numpy(pos), cfg_t)
    _close(got, want)


@pytest.mark.parametrize("s", [12, 2048])
def test_sdpa_chunked_float32_pv_is_the_flash_oracle(s):
    """``round_p=False``, decode's attention on the card after a flash
    prefill, keeps PV in float32 as the reference's flash-attention
    oracle does: the two
    agree to the bf16 rounding of the result."""
    from repro.kernels.flash_attn.ref import attention_ref
    cfg_j, cfg_t = jax_smoke("minicpm-2b", layers=1), smoke_config(
        "minicpm-2b", layers=1)
    rng = np.random.default_rng(s)
    h, dh = cfg_j.num_heads, cfg_j.head_dim
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(rng.standard_normal((1, s, h, dh)))
                                    for _ in range(3))

    def heads(a):
        return a.transpose(0, 2, 1, 3).reshape(h, s, dh)

    want = attention_ref(heads(jq), heads(jk), heads(jv)).reshape(
        1, h, s, dh).transpose(0, 2, 1, 3)
    pos = torch.arange(s, dtype=torch.int32)
    got = TL._sdpa_chunked(tq, tk, tv, pos, pos, cfg_t, round_p=False)
    assert got.dtype == torch.bfloat16
    _close(got, want)


def _attn_params(params, layer=0):
    p = jax.tree.map(lambda a: a[layer], params["layers"]["attn"])
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2.5-3b", "chatglm3-6b",
                                  "starcoder2-7b"])
def test_apply_attention_prefill(arch):
    """minicpm (MHA), qwen2.5 (GQA, qkv bias), chatglm3 (half rotary, qkv
    bias) and starcoder2 (qkv and output biases) through `ops.attention`
    (the flash kernel's plain version; on the CPU it rounds p to bf16 as
    the reference's chunked path does)."""
    cfg_j, cfg_t, params, _ = _pair(arch)
    jp, tp = _attn_params(params)
    x = np.random.default_rng(4).standard_normal((2, 20, cfg_j.d_model))
    jx, tx = _bf16(x)
    pos = np.arange(20, dtype=np.int32)
    assert TL.flash_eligible(cfg_t, "cpu") is True
    want, _ = JL.apply_attention(jp, jx, cfg_j, jnp.asarray(pos))
    got, cache = TL.apply_attention(tp, tx, cfg_t, torch.from_numpy(pos))
    assert cache is None and got.dtype == torch.bfloat16
    _close(got, want)


@pytest.mark.parametrize("arch,steps,max_len", [
    ("minicpm-2b", 14, 8),     # the shared length passes T: clamped writes
    ("mixtral-8x7b", 12, 12),  # window 8: the ring buffer wraps
])
def test_apply_attention_decode_cache(arch, steps, max_len):
    """Token by token through one layer's cache, past its end: outputs and
    the cache contents agree, and ``length`` counts every step."""
    cfg_j, cfg_t = jax_smoke(arch, layers=1), smoke_config(arch, layers=1)
    params = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    jp, tp = _attn_params(params)
    jc = JL.init_attn_cache(cfg_j, 2, max_len)
    tc = TL.init_attn_cache(cfg_t, 2, max_len, device="cpu")
    assert tuple(tc["k"].shape) == jc["k"].shape
    x = np.random.default_rng(5).standard_normal((2, steps, cfg_j.d_model))
    jx, tx = _bf16(x)
    for i in range(steps):
        pos = np.array([i], np.int32)
        jo, jc = JL.apply_attention(jp, jx[:, i:i + 1], cfg_j,
                                    jnp.asarray(pos), jc)
        to, tc = TL.apply_attention(tp, tx[:, i:i + 1], cfg_t,
                                    torch.from_numpy(pos), tc)
        _close(to, jo)
    assert int(tc["length"]) == int(jc["length"]) == steps
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_dense_casts_to_bf16_and_adds_the_bias():
    rng = np.random.default_rng(9)
    x, w, b = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((3, 5, 16), (16, 24), (24,)))
    want = JL._dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = TL._dense(*map(torch.from_numpy, (x, w, b)))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("arch", ["minicpm-2b", "starcoder2-7b"])
def test_apply_mlp(arch):
    """SwiGLU (minicpm) and tanh-GELU with biases (starcoder2)."""
    cfg_j, cfg_t = jax_smoke(arch, layers=1), smoke_config(arch, layers=1)
    jp = JL.init_mlp(jax.random.PRNGKey(3), cfg_j)
    jp = {k: v + 0.1 for k, v in jp.items()}  # nonzero biases
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(6).standard_normal((2, 7, cfg_j.d_model))
    jx, tx = _bf16(x)
    _close(TL.apply_mlp(tp, tx, cfg_t), JL.apply_mlp(jp, jx, cfg_j))


@pytest.mark.parametrize("arch", ["minicpm-2b", "starcoder2-7b"])
def test_embed_and_logits(arch):
    """Tied (minicpm, emb_scale 12, hot vocabulary) and untied embeddings:
    the lookup is exact before the bf16 cast; the logits agree to bf16
    rounding."""
    cfg_j, cfg_t = jax_smoke(arch, layers=1), smoke_config(arch, layers=1)
    jp = JL.init_embedding(jax.random.PRNGKey(4), cfg_j)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    ids = _tokens(cfg_j, (3, 11))
    want = JL.embed_tokens(jp, jnp.asarray(ids), cfg_j)
    got = TL.embed_tokens(tp, torch.from_numpy(ids), cfg_t)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    jx, tx = _bf16(np.random.default_rng(7).standard_normal(
        (3, 11, cfg_j.d_model)))
    _close(TL.lm_logits(tp, tx, cfg_t), JL.lm_logits(jp, jx, cfg_j))


# -------------------------------------------------------------------- slice
def test_forward_matches_the_reference(minicpm):
    """Prefill logits at bf16 tolerance, and the same argmax at every
    position but a few (measured: all 80 agree)."""
    cfg_j, _, params, model = minicpm
    tokens = _tokens(cfg_j, (2, 40))
    want, jaux = JT.forward(params, {"tokens": jnp.asarray(tokens)}, cfg_j)
    got, aux = TT.forward(model, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert float(aux) == float(jaux) == 0.0
    _close(got, want)
    agree = (_f32(got).argmax(-1) == _f32(want).argmax(-1)).mean()
    assert agree > 0.95


def test_forward_gqa_matches_the_reference():
    """qwen2.5 (GQA, qkv bias, no hot vocabulary), 2 layers: the port's
    prefill attention is the flash kernel's plain version on the grouped
    k and v, which rounds p to bf16 as the reference's chunked path does,
    so layer 0's attention equals the reference's bit for bit; the logits
    meet minicpm's tolerance and argmax standard."""
    cfg_j, cfg_t, params, model = _pair("qwen2.5-3b")
    assert cfg_t.num_kv_heads < cfg_t.num_heads
    assert TL.flash_eligible(cfg_t, "cpu") is True
    jp, tp = _attn_params(params)
    x = np.random.default_rng(11).standard_normal((1, 24, cfg_j.d_model))
    jx, tx = _bf16(x)
    pos = np.arange(24, dtype=np.int32)
    want_attn, _ = JL.apply_attention(jp, jx, cfg_j, jnp.asarray(pos))
    got_attn, _ = TL.apply_attention(tp, tx, cfg_t, torch.from_numpy(pos))
    np.testing.assert_array_equal(_f32(got_attn), _f32(want_attn))
    tokens = _tokens(cfg_j, (1, 24), seed=2)
    want, _ = JT.forward(params, {"tokens": jnp.asarray(tokens)}, cfg_j)
    got, _ = TT.forward(model, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    agree = (_f32(got).argmax(-1) == _f32(want).argmax(-1)).mean()
    assert agree > 0.95


# the served configs that were never held whole on the CPU before: chatglm3
# (group 16 at full width, half rotary, q/k/v biases) and starcoder2 (group
# 9, layernorm, biased tanh-GELU MLP, output bias)
SERVED_ARCHS = ["chatglm3-6b", "starcoder2-7b"]


@pytest.mark.parametrize("arch,heads,kv", [("chatglm3-6b", 32, 2),
                                           ("starcoder2-7b", 36, 4)])
def test_apply_attention_at_the_served_head_counts(arch, heads, kv):
    """Layer 0's attention at the real head counts (32 over 2, group 16;
    36 over 4, group 9) on a narrow config (d 64, head dim 16): the flash
    kernel's plain version on the grouped k and v rounds p to bf16 as the
    reference's chunked path does, so the two agree bit for bit but where
    a float32 sum taken in another order (torch's einsum against XLA's)
    rounds to the next bf16 value: every element within one bf16 unit,
    at least 99.9% of them equal (measured: starcoder2 all 3,072;
    chatglm3 all but 2 of 3,072)."""
    cfg_j, cfg_t, params, _ = _pair(arch, layers=1, num_heads=heads,
                                    num_kv_heads=kv, head_dim=16)
    jp, tp = _attn_params(params)
    assert tp["wq"].shape[1] == heads * 16 and tp["wk"].shape[1] == kv * 16
    x = np.random.default_rng(heads + kv).standard_normal(
        (2, 24, cfg_j.d_model))
    jx, tx = _bf16(x)
    pos = np.arange(24, dtype=np.int32)
    want, _ = JL.apply_attention(jp, jx, cfg_j, jnp.asarray(pos))
    got, _ = TL.apply_attention(tp, tx, cfg_t, torch.from_numpy(pos))
    got, want = _f32(got), _f32(want)
    unit = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= unit).all()
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_forward_of_the_served_configs_matches_the_reference(arch):
    """The smoke config's whole prefill forward at minicpm's standard:
    logits at bf16 tolerance, the same argmax at more than 95% of the
    positions."""
    cfg_j, _, params, model = _pair(arch)
    tokens = _tokens(cfg_j, (2, 40), seed=4)
    want, _ = JT.forward(params, {"tokens": jnp.asarray(tokens)}, cfg_j)
    got, aux = TT.forward(model, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert float(aux) == 0.0
    _close(got, want)
    agree = (_f32(got).argmax(-1) == _f32(want).argmax(-1)).mean()
    assert agree > 0.95


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_decode_of_the_served_configs_matches_the_reference_and_forward(
        arch):
    """Teacher-forced decode through the cache, 12 steps, against the
    reference's `decode_step` and against the port's own forward, to
    test_decode_matches_forward's standard (rtol/atol 0.15, argmax
    agreement > 0.95)."""
    cfg_j, cfg_t, params, model = _pair(arch)
    b, s = 2, 12
    tokens = _tokens(cfg_j, (b, s), seed=5)
    jc = JT.init_cache(cfg_j, b, max_len=s)
    tc = TT.init_cache(cfg_t, b, max_len=s, device="cpu")
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


def test_decode_matches_the_reference_and_forward(minicpm):
    """Teacher-forced decode through the cache, 14 steps into a 12-slot
    cache (the last two writes clamp), against the reference's
    `decode_step` and against the port's own forward, to
    test_decode_matches_forward's standard (rtol/atol 0.15, argmax
    agreement > 0.95)."""
    cfg_j, cfg_t, params, model = minicpm
    b, s = 2, 14
    tokens = _tokens(cfg_j, (b, s), seed=3)
    jc = JT.init_cache(cfg_j, b, max_len=12)
    tc = TT.init_cache(cfg_t, b, max_len=12, device="cpu")
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
    assert int(tc["pos"]) == s
    np.testing.assert_array_equal(tc["layers"]["length"].numpy(),
                                  np.asarray(jc["layers"]["length"]))
    full, _ = TT.forward(model, {"tokens": torch.from_numpy(tokens)})
    n = 12  # positions before the cache filled up
    np.testing.assert_allclose(td[:, :n], _f32(full)[:, :n], **DECODE_TOL)
    assert (td[:, :n].argmax(-1) == _f32(full)[:, :n].argmax(-1)).mean() > 0.95


def test_serve_loop_matches_the_reference(minicpm):
    """The same 8 synthetic requests, 4 slots, greedy: the same completion
    order, the same token count for each request, and the greedy tokens
    agreeing on at least 90% of positions (measured: 192 of 192)."""
    cfg_j, cfg_t, params, model = minicpm
    want = JS.serve_loop(cfg_j, params, JS.synthetic_requests(
        8, cfg_j.vocab_size))
    got = TS.serve_loop(cfg_t, model, TS.synthetic_requests(
        8, cfg_t.vocab_size))
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [len(r.out) for r in got] == [len(r.out) for r in want]
    assert all(len(r.out) == r.max_new for r in got)
    assert all(r.t_done >= r.t_first >= r.t_enqueue for r in got)
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g.out, w.out))
    total = sum(len(r.out) for r in want)
    assert same >= 0.9 * total


def test_serve_loop_temperature_runs():
    """Temperature sampling on a seeded generator: every request completes
    with its token count, and the same seed gives the same tokens."""
    cfg = smoke_config(ARCH, layers=1)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    outs = []
    for _ in range(2):
        done = TS.serve_loop(cfg, model, TS.synthetic_requests(
            3, cfg.vocab_size, gen=(2, 5)), batch_slots=2, temperature=0.7,
            seed=5)
        assert sorted(r.rid for r in done) == [0, 1, 2]
        assert all(len(r.out) == r.max_new for r in done)
        outs.append([r.out for r in done])
    assert outs[0] == outs[1]


def test_serve_loop_counts_its_decode_steps(monkeypatch):
    """`decode_steps` grows by one for every decode step, prompt feeding
    included: prompt tokens plus one step per loop turn."""
    cfg = smoke_config(ARCH, layers=1)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []
    real = TS.decode_step
    monkeypatch.setattr(TS, "decode_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    reqs = TS.synthetic_requests(3, cfg.vocab_size, plen=(2, 4), gen=(2, 5))
    before = TS.decode_steps
    TS.serve_loop(cfg, model, reqs, batch_slots=2)
    assert TS.decode_steps - before == len(calls)
    assert len(calls) > sum(len(r.prompt) for r in reqs)


@pytest.mark.parametrize("layers", [1, 2])
def test_reset_slot_matches_the_reference(layers):
    """Only (L, B, ...) entries with L != 1 are zeroed, as the
    reference's test reads; ``length`` and ``pos`` stay."""
    cfg_j, cfg_t = jax_smoke(ARCH, layers=layers), smoke_config(
        ARCH, layers=layers)
    jc = JT.init_cache(cfg_j, 3, 4)
    fill = np.random.default_rng(8).standard_normal(
        jc["layers"]["k"].shape).astype(np.float32)
    jc["layers"]["k"] = jnp.asarray(fill, jnp.bfloat16)
    jc["layers"]["length"] = jc["layers"]["length"] + 3
    tc = TT.init_cache(cfg_t, 3, 4, device="cpu")
    tc["layers"]["k"].copy_(torch.from_numpy(_f32(jc["layers"]["k"])))
    tc["layers"]["length"] += 3
    want = JS._reset_slot(jc, 1, "any")
    got = TS._reset_slot(tc, 1, "any")
    for key in ("k", "v", "length"):
        np.testing.assert_array_equal(_f32(got["layers"][key]),
                                      _f32(want["layers"][key]))


# ------------------------------------------------------------ weights, init
def test_init_params_shapes_and_scales():
    """`init_params` gives the reference's tree of shapes, and the
    distributions it draws: normal at the same scales, ones for norms."""
    cfg = smoke_config(ARCH, layers=2)
    model = TT.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    want = jax.eval_shape(lambda: JT.init_params(
        jax_smoke(ARCH, layers=2), jax.random.PRNGKey(0)))
    assert tuple(model.embed["table"].shape) == want["embed"]["table"].shape
    for name, shape in want["layers"]["attn"].items():
        assert tuple(model.layers[1].attn[name].shape) == shape.shape[1:]
    for name, shape in want["layers"]["ffn"].items():
        assert tuple(model.layers[0].ffn[name].shape) == shape.shape[1:]
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in model.parameters())
    d, f = cfg.d_model, cfg.d_ff
    for t, scale in ((model.embed["table"], 0.02),
                     (model.layers[0].attn["wq"], d ** -0.5),
                     (model.layers[1].ffn["w_down"], f ** -0.5)):
        assert abs(float(t.std()) / scale - 1) < 0.1
        assert abs(float(t.mean())) < 0.1 * scale
    assert torch.equal(model.final_norm["scale"], torch.ones(d))
    again = TT.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(again.layers[1].attn["wo"], model.layers[1].attn["wo"])
    with pytest.raises(ValueError, match="generator is on cpu"):
        TT.init_params(cfg, torch.Generator(), "meta")


def test_from_jax_params_copies_every_leaf(minicpm):
    cfg_j, _, params, model = minicpm
    for i in range(cfg_j.num_layers):
        for group in ("attn", "ffn", "norm1", "norm2"):
            for name, leaf in params["layers"][group].items():
                np.testing.assert_array_equal(
                    getattr(model.layers[i], group)[name].numpy(),
                    np.asarray(leaf[i]))
    np.testing.assert_array_equal(model.embed["table"].numpy(),
                                  np.asarray(params["embed"]["table"]))


# ----------------------------------------------------------- what raises
@pytest.mark.parametrize("arch,what", [
    ("qwen2.5-3b", None), ("paligemma-3b", "prefix-LM"),
    ("hubert-xlarge", "non-causal"), ("mixtral-8x7b", None)])
def test_unported_attention_raises_on_the_card(arch, what):
    """On the card prefill attention is the kernel or nothing. The kernel
    now takes every attention family of the ``attn`` trunk, at full width
    as in the smoke config, on the card and on the CPU: grouped kv
    (``what`` None: qwen2.5-3b, and mixtral-8x7b with its sliding window),
    paligemma-3b's prefix-LM mask over one kv head at head dim 256, and
    hubert-xlarge's bidirectional encoder at head dim 80 (ROADMAP A8.9b,
    done). Only a head dim the kernel lacks still raises
    (`test_head_dim_the_kernel_lacks_raises_on_the_card`)."""
    for cfg in (smoke_config(arch, layers=1), get_config(arch)):
        if what is None:
            assert cfg.num_kv_heads < cfg.num_heads
        elif what == "prefix-LM":
            assert cfg.causal and cfg.prefix_tokens > 0
        else:
            assert not cfg.causal
        assert TL.flash_eligible(cfg, torch.device("cuda")) is True
        assert TL.flash_eligible(cfg, "cpu") is True
    assert get_config(arch).head_dim in TL.HEAD_DIMS
    assert TL.flash_eligible(smoke_config(ARCH, layers=1), "cuda") is True


@pytest.mark.parametrize("head_dim", [8, 48, 80])
def test_head_dim_the_kernel_lacks_raises_on_the_card(head_dim):
    """A causal MHA config whose head dim the kernel was not built for is
    refused at `flash_eligible`, before any work, naming A8.9b; on the CPU
    it takes the chunked path. Head dim 80 (hubert-xlarge's) is built now:
    it is taken on both devices, and the CPU runs the kernel's plain
    version."""
    cfg = dataclasses.replace(smoke_config(ARCH, layers=1),
                              head_dim=head_dim)
    if head_dim in TL.HEAD_DIMS:
        assert TL.flash_eligible(cfg, torch.device("cuda")) is True
        assert TL.flash_eligible(cfg, "cpu") is True
    else:
        with pytest.raises(NotImplementedError,
                           match=f"head dim {head_dim}.*ROADMAP A8.9b"):
            TL.flash_eligible(cfg, torch.device("cuda"))
        assert TL.flash_eligible(cfg, "cpu") is False
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits, _ = TT.forward(model, {"tokens": torch.arange(
        6, dtype=torch.int32).reshape(1, 6)})
    assert logits.shape == (1, 6, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch,row", [
    ("rwkv6-3b", "A8.3"), ("zamba2-1.2b", "A8.3")])
def test_unported_trunks_raise(arch, row):
    """The two trunks that raised until ROADMAP ``row`` was done now build:
    weights on the CPU, and caches on the CPU and on ``meta`` with the
    reference's leaves (tests/test_torch_ssm.py holds them to the
    reference)."""
    assert row == "A8.3"
    cfg_j, cfg = jax_smoke(arch, layers=2), smoke_config(arch, layers=2)
    kind = TT.trunk_kind(cfg)
    assert kind == {"rwkv6-3b": "rwkv", "zamba2-1.2b": "hybrid"}[arch]
    model = TT.init_params(cfg, torch.Generator(), "cpu")
    assert len(model.layers) == 2
    assert (model.shared_attn is not None) == (kind == "hybrid")
    want = jax.eval_shape(lambda: JT.init_cache(cfg_j, 1, 4))

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in leaves(sub, path + (key,)).items()}
        return {path: (tuple(tree.shape),
                       str(tree.dtype).removeprefix("torch."))}
    for dev in ("cpu", "meta"):
        got = TT.init_cache(cfg, 1, 4, device=dev)
        assert leaves(got) == leaves(want)


def test_mesh_raises(minicpm):
    """A `Transformer` handed a mesh of more than one shard is refused (it
    must be cut onto the mesh first, ``ShardedModel.from_model``); on the
    one-shard host mesh it runs as without a mesh
    (tests/test_torch_mesh.py holds the sharded model)."""
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    _, cfg_t, _, model = minicpm
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    with pytest.raises(TypeError, match="ShardedModel"):
        TT.forward(model, {"tokens": tokens}, mesh=mesh)
    with pytest.raises(TypeError, match="ShardedModel"):
        TT.decode_step(model, TT.init_cache(cfg_t, 1, 4, device="cpu"),
                       tokens[:, :1], mesh=mesh)
    host = make_host_mesh("cpu")
    assert torch.equal(TT.forward(model, {"tokens": tokens}, host)[0],
                       TT.forward(model, {"tokens": tokens})[0])


def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = smoke_config(ARCH, layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.from_jax_params(cfg, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.main(["--smoke", "--layers", "1"])


class _Parsed(Exception):
    pass


def _parsed_args(main, monkeypatch):
    """The namespace ``main([])`` parses, stopping it right there."""
    import argparse
    parse = argparse.ArgumentParser.parse_args

    def stop(self, *a, **kw):
        raise _Parsed(parse(self, *a, **kw))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as got:
        main([])
    monkeypatch.undo()
    return got.value.args[0]


def test_serve_main_defaults_are_the_references(monkeypatch):
    """`--arch` and every other option the reference parses default as
    there (qwen2.5-3b); the port adds only `--device`."""
    want = vars(_parsed_args(JS.main, monkeypatch))
    got = vars(_parsed_args(TS.main, monkeypatch))
    assert want["arch"] == "qwen2.5-3b"
    assert got.pop("device") is None
    assert got == want


def test_serve_main_default_arch_is_refused_on_the_card(monkeypatch):
    """The default (qwen2.5-3b, GQA) and paligemma-3b (prefix-LM, head dim
    256) are not refused on the card: `flash_eligible` takes them there
    (the run is stopped right after that check, since this host has no
    card to make weights on). hubert-xlarge, an encoder, is refused before
    any weights, as in the reference: it has no decode step."""
    class _Reached(Exception):
        pass

    eligible = TL.flash_eligible

    def checked(cfg, device):
        raise _Reached(cfg.name, str(device), eligible(cfg, device))
    monkeypatch.setattr(TS, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(TL, "flash_eligible", checked)
    with pytest.raises(_Reached) as got:
        TS.main(["--smoke", "--layers", "1"])
    assert got.value.args == ("qwen2.5-3b", "cuda", True)
    with pytest.raises(_Reached) as got:
        TS.main(["--arch", "paligemma-3b", "--smoke", "--layers", "1"])
    assert got.value.args == ("paligemma-3b", "cuda", True)
    monkeypatch.setattr(TL, "flash_eligible", eligible)
    monkeypatch.setattr(TT, "init_params", lambda *a, **kw: pytest.fail(
        "weights made before the config was refused"))
    with pytest.raises(SystemExit, match="encoder-only arch has no decode"):
        TS.main(["--arch", "hubert-xlarge", "--smoke", "--layers", "1"])


def test_serve_main_on_the_cpu(capsys):
    done = TS.main(["--smoke", "--layers", "1", "--requests", "3",
                    "--slots", "2", "--device", "cpu"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    out = capsys.readouterr().out
    assert "[serve] 3 requests" in out and "on cpu" in out
    assert "latency p50" in out

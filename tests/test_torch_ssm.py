"""PyTorch port: the RWKV6 and Mamba2 (hybrid) trunks agree with the JAX
package.

The scans (`_wkv_scan`, `_wkv_chunked`, `ssd_chunked`, `_causal_conv`) get
float32 inputs made from seeds with numpy; the layers and the models run
``smoke_config("rwkv6-3b")`` and ``smoke_config("zamba2-1.2b")`` on the
same weights, the JAX package's ``init_params`` pytree carried across with
`from_jax_params`. Tolerances, each with its reason:

* the float32 scans: rtol/atol 2e-4, tests/test_perf_paths.py:29-32's
  standard for the chunked wkv against the token scan (sums taken in
  another order and, chunked, in another form);
* bf16 layers and models: `test_torch_models._close` (2% of each value or
  of the result's largest magnitude), argmax agreement > 0.95 for logits;
* decode: tests/test_models.py::test_decode_matches_forward's rtol/atol
  0.15 and argmax agreement > 0.95.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.locality import applies_to as jax_applies_to  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models import rwkv6 as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.locality import applies_to  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.models import rwkv6 as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
# test_torch_models.py's standards (its docstring gives the reasons)
BF16_FRAC = 2e-2
DECODE_TOL = dict(rtol=0.15, atol=0.15)
TRUNKS = ["rwkv6-3b", "zamba2-1.2b"]


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


def _pair(arch, layers=2):
    """(JAX config, port config, JAX params, port model) on one seed."""
    cfg_j, cfg_t = jax_smoke(arch, layers=layers), smoke_config(
        arch, layers=layers)
    params = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    model = TT.from_jax_params(cfg_t, jax.tree.map(np.asarray, params),
                               device="cpu")
    return cfg_j, cfg_t, params, model


@pytest.fixture(scope="module", params=TRUNKS)
def pair(request):
    return _pair(request.param)


def _tokens(cfg, shape, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _both(*arrays):
    """Each numpy array as (jax array, torch tensor)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _leaves(tree, path=()):
    """{key path: (shape, dtype name)} of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(_leaves(sub, path + (key,)))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


# --------------------------------------------------------------- wkv scans
def _wkv_inputs(seed, b, t, h, dh=8, offset=-1.5):
    rng = np.random.default_rng(seed)

    def mk():
        return rng.standard_normal((b, t, h * dh)).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    logw = -np.exp(rng.standard_normal((b, t, h * dh)).astype(np.float32)
                   + offset)
    u = rng.standard_normal((h, dh)).astype(np.float32)
    return r, k, v, logw, u


@pytest.mark.parametrize("seed,t,b,h", [
    (0, 16, 1, 2), (1, 32, 2, 4), (2, 64, 1, 4), (3, 48, 2, 2)])
def test_wkv_scans_match_the_reference(seed, t, b, h):
    """`_wkv_scan` and `_wkv_chunked` against the reference's, and the
    port's chunked form against its token scan, outputs and final
    states."""
    dh = 8
    r, k, v, logw, u = _wkv_inputs(seed, b, t, h, dh)
    w = np.exp(logw)
    (jr, jk, jv, jlw, jw, ju), (tr, tk, tv, tlw, tw, tu) = _both(
        r, k, v, logw, w, u)
    jy, js = JR._wkv_scan(jr, jk, jv, jw, ju, h, dh)
    sy, ss = TR._wkv_scan(tr, tk, tv, tw, tu, h, dh)
    np.testing.assert_allclose(_f32(sy), _f32(jy), **SCAN_TOL)
    np.testing.assert_allclose(_f32(ss), _f32(js), **SCAN_TOL)
    jy, js = JR._wkv_chunked(jr, jk, jv, jlw, ju, h, dh)
    cy, cs = TR._wkv_chunked(tr, tk, tv, tlw, tu, h, dh)
    np.testing.assert_allclose(_f32(cy), _f32(jy), **SCAN_TOL)
    np.testing.assert_allclose(_f32(cs), _f32(js), **SCAN_TOL)
    np.testing.assert_allclose(_f32(cy), _f32(sy), **SCAN_TOL)
    np.testing.assert_allclose(_f32(cs), _f32(ss), **SCAN_TOL)


def test_wkv_chunked_groups_keep_the_bits(monkeypatch):
    """Groups of chunks (``WKV_GROUP_BYTES``, which bounds the decay
    tensor at long sequences) change nothing: one chunk a group gives the
    bits of all chunks in one group."""
    r, k, v, logw, u = (torch.from_numpy(a) for a in _wkv_inputs(4, 2, 80, 3))
    whole = TR._wkv_chunked(r, k, v, logw, u, 3, 8)
    monkeypatch.setattr(TR, "WKV_GROUP_BYTES", 1)
    split = TR._wkv_chunked(r, k, v, logw, u, 3, 8)
    assert torch.equal(whole[0], split[0]) and torch.equal(whole[1], split[1])


@pytest.mark.parametrize("offset", [-8.0, 3.0])
def test_wkv_chunked_extreme_decay_is_stable(offset):
    """tests/test_perf_paths.py's case: strong (w → 0) and weak (w → 1)
    decays stay finite, and equal the reference's."""
    b, t, h, dh = 1, 32, 2, 8
    rng = np.random.default_rng(0)
    r, k, v = (rng.standard_normal((b, t, h * dh)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(np.full((b, t, h * dh), offset, np.float32))
    u = np.zeros((h, dh), np.float32)
    (jr, jk, jv, jlw, ju), (tr, tk, tv, tlw, tu) = _both(r, k, v, logw, u)
    y, s = TR._wkv_chunked(tr, tk, tv, tlw, tu, h, dh)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    jy, js = JR._wkv_chunked(jr, jk, jv, jlw, ju, h, dh)
    np.testing.assert_allclose(_f32(y), _f32(jy), **SCAN_TOL)
    np.testing.assert_allclose(_f32(s), _f32(js), **SCAN_TOL)


def _rel_l2(got, want) -> float:
    a, b = np.asarray(want, np.float64), _f32(got).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _torch_grads(fn, tensors, cotangents):
    """Autograd of ``fn`` at ``tensors`` (leaves made here) against the
    outputs' ``cotangents``."""
    leaves = [t.clone().requires_grad_(True) for t in tensors]
    outs = fn(*leaves)
    torch.autograd.backward(outs, cotangents)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("seed,t,b,h", [(5, 64, 2, 3), (6, 48, 1, 2)])
def test_wkv_chunked_gradients_match_jax_vjp(monkeypatch, seed, t, b, h):
    """Autograd of `_wkv_chunked` (output and final state) against
    ``jax.vjp`` of the reference's (src/repro/models/rwkv6.py:92) for r,
    k, v, the log-decay and u, in float32, with one chunk a group
    (``WKV_GROUP_BYTES`` at 1): each gradient within 1e-4 relative L2
    (sums in another order and form, as `SCAN_TOL`'s; the decay's
    gradient comes through the exp, the masked exponent and the carried
    states, which in-place writes once broke)."""
    dh = 8
    monkeypatch.setattr(TR, "WKV_GROUP_BYTES", 1)
    r, k, v, logw, u = _wkv_inputs(seed, b, t, h, dh)
    rng = np.random.default_rng(seed + 100)
    dy = rng.standard_normal((b, t, h * dh)).astype(np.float32)
    ds = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    (jr, jk, jv, jlw, ju, jdy, jds), (tr, tk, tv, tlw, tu, tdy, tds) = \
        _both(r, k, v, logw, u, dy, ds)
    _, vjp = jax.vjp(lambda *a: JR._wkv_chunked(*a, h, dh),
                     jr, jk, jv, jlw, ju)
    want = vjp((jdy, jds))
    got = _torch_grads(lambda *a: TR._wkv_chunked(*a, h, dh),
                       (tr, tk, tv, tlw, tu), (tdy, tds))
    for name, g, w in zip(("r", "k", "v", "logw", "u"), got, want):
        assert _rel_l2(g, w) < 1e-4, (name, _rel_l2(g, w))


# --------------------------------------------------------------- ssd scans
def _ssd_inputs(seed, bs, t, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bs, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bs, t, h)))).astype(np.float32)
    b = rng.standard_normal((bs, t, n)).astype(np.float32)
    c = rng.standard_normal((bs, t, n)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    return x, dt, b, c, a_log


@pytest.mark.parametrize("s", [24, 29])
def test_ssd_chunked_matches_the_reference(monkeypatch, s):
    """Chunk 8 at a chunk multiple (24) and ragged (29, padded as
    `apply_mamba` pads: zero dt makes the padded steps the identity). In
    float32: both modules' final cast to bf16 is set to float32 for the
    comparison, so the scan itself is held at 2e-4; the bf16 results
    (the modules as they are) within one bf16 unit of their size."""
    chunk = 8
    pad = (-s) % chunk
    x, dt, b, c, a_log = _ssd_inputs(s, 2, s, 4, 8, 6)

    def padded(a):
        return np.concatenate(
            [a, np.zeros((a.shape[0], pad, *a.shape[2:]), a.dtype)], 1)
    args = [padded(a) for a in (x, dt, b, c)] + [a_log]
    (jx, jdt, jb, jc, ja), (tx, tdt, tb, tc, ta) = _both(*args)
    bf16 = (_f32(TM.ssd_chunked(tx, tdt, tb, tc, ta, chunk))[:, :s],
            _f32(JM.ssd_chunked(jx, jdt, jb, jc, ja, chunk))[:, :s])
    np.testing.assert_allclose(*bf16, rtol=2 ** -7, atol=2 ** -7)
    monkeypatch.setattr(JM, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TM, "COMPUTE_DTYPE", torch.float32)
    got = TM.ssd_chunked(tx, tdt, tb, tc, ta, chunk)
    want = JM.ssd_chunked(jx, jdt, jb, jc, ja, chunk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got)[:, :s], _f32(want)[:, :s],
                               **SCAN_TOL)


@pytest.mark.parametrize("seed,t", [(7, 32), (8, 48)])
def test_ssd_chunked_gradients_match_jax_vjp(monkeypatch, seed, t):
    """Autograd of `ssd_chunked` against ``jax.vjp`` of the reference's
    (src/repro/models/mamba2.py:60) for x, dt, b, c and ``a_log``, chunk
    8, both modules' final cast set to float32: each gradient within
    1e-4 relative L2 (as the wkv's)."""
    chunk = 8
    monkeypatch.setattr(JM, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TM, "COMPUTE_DTYPE", torch.float32)
    x, dt, b, c, a_log = _ssd_inputs(seed, 2, t, 4, 8, 6)
    dy = np.random.default_rng(seed + 100).standard_normal(
        x.shape).astype(np.float32)
    (jx, jdt, jb, jc, ja, jdy), (tx, tdt, tb, tc, ta, tdy) = _both(
        x, dt, b, c, a_log, dy)
    _, vjp = jax.vjp(lambda *a: JM.ssd_chunked(*a, chunk),
                     jx, jdt, jb, jc, ja)
    want = vjp(jdy)
    got = _torch_grads(lambda *a: TM.ssd_chunked(*a, chunk),
                       (tx, tdt, tb, tc, ta), tdy)
    for name, g, w in zip(("x", "dt", "b", "c", "a_log"), got, want):
        assert _rel_l2(g, w) < 1e-4, (name, _rel_l2(g, w))


@pytest.mark.parametrize("decode", [False, True])
def test_causal_conv_matches_the_reference(decode):
    """The shifted sum over a bf16 input with float32 taps (a float32
    result), in prefill and with a decode step's carried state."""
    rng = np.random.default_rng(7)
    s = 1 if decode else 11
    jx, tx = _bf16(rng.standard_normal((2, s, 12)))
    w = rng.standard_normal((4, 12)).astype(np.float32) * 0.2
    state = None
    if decode:
        js, ts = _bf16(rng.standard_normal((2, 3, 12)))
        state = (js, ts)
    want, wst = JM._causal_conv(jx, jnp.asarray(w),
                                None if state is None else state[0])
    got, gst = TM._causal_conv(tx, torch.from_numpy(w),
                               None if state is None else state[1])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **SCAN_TOL)
    np.testing.assert_array_equal(_f32(gst), _f32(wst))


# ------------------------------------------------------------------ layers
def _layer0(params, key):
    return jax.tree.map(lambda a: np.array(a[0]), params["layers"][key])


def _rwkv_layer(params, seed=2):
    """Layer 0's RWKV params with the zero-initialised mixes and bonus
    drawn instead, so every term of the layer is exercised."""
    p = _layer0(params, "rwkv")
    rng = np.random.default_rng(seed)
    for name in ("mu_base", "cm_mu"):
        p[name] = rng.uniform(0, 1, p[name].shape).astype(np.float32)
    p["u_bonus"] = (0.5 * rng.standard_normal(p["u_bonus"].shape)).astype(
        np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("s", [12, 32])
def test_rwkv_timemix_and_channelmix_prefill(s):
    """S 12 takes the token scan, S 32 the chunked form."""
    cfg_j, cfg_t, params, _ = _pair("rwkv6-3b")
    jp, tp = _rwkv_layer(params)
    jx, tx = _bf16(np.random.default_rng(s).standard_normal(
        (2, s, cfg_j.d_model)))
    got, cache = TR.apply_rwkv_timemix(tp, tx, cfg_t)
    assert got.dtype == torch.bfloat16 and cache is None
    _close(got, JR.apply_rwkv_timemix(jp, jx, cfg_j)[0])
    _close(TR.apply_rwkv_channelmix(tp, tx, cfg_t)[0],
           JR.apply_rwkv_channelmix(jp, jx, cfg_j)[0])


def test_rwkv_timemix_and_channelmix_decode():
    """One decode step against a carried shift and wkv state: the output
    and the new states."""
    cfg_j, cfg_t, params, _ = _pair("rwkv6-3b")
    jp, tp = _rwkv_layer(params)
    rng = np.random.default_rng(5)
    h, dh = TR.heads_of(cfg_t)
    jx, tx = _bf16(rng.standard_normal((2, 1, cfg_j.d_model)))
    shift = _f32(_bf16(rng.standard_normal((2, cfg_j.d_model)))[0])
    wkv = rng.standard_normal((2, h, dh, dh)).astype(np.float32)
    (jsh, jwkv), (tsh, twkv) = _both(shift, wkv)
    want, wc = JR.apply_rwkv_timemix(jp, jx, cfg_j, {"shift": jsh,
                                                     "wkv": jwkv})
    got, gc = TR.apply_rwkv_timemix(tp, tx, cfg_t, {"shift": tsh,
                                                    "wkv": twkv})
    _close(got, want)
    # float32, but k and v come out of bf16 products: the bf16 standard
    _close(gc["wkv"], wc["wkv"])
    np.testing.assert_array_equal(_f32(gc["shift"]), _f32(wc["shift"]))
    want, wc = JR.apply_rwkv_channelmix(jp, jx, cfg_j, {"shift": jsh})
    got, gc = TR.apply_rwkv_channelmix(tp, tx, cfg_t, {"shift": tsh})
    _close(got, want)
    np.testing.assert_array_equal(_f32(gc["shift"]), _f32(wc["shift"]))


def test_ddlerp_is_the_reference_bit_for_bit():
    """The five token-shift streams equal the reference's: its float32
    pre-mix is one fused multiply-add on the unrounded ``x_prev - x``,
    and the streams round each bf16 step."""
    cfg_j, cfg_t, params, _ = _pair("rwkv6-3b")
    jp, tp = _rwkv_layer(params)
    jx, tx = _bf16(np.random.default_rng(9).standard_normal(
        (2, 32, cfg_j.d_model)))
    jprev = jnp.pad(jx, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    want = jax.jit(JR._ddlerp)(jp, jx, jprev)
    got = TR._ddlerp(tp, tx, TR._shifted(tx, None))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_f32(g), _f32(w))


@pytest.mark.parametrize("s", [12, 32])
def test_apply_mamba_prefill(s):
    """S 12 pads to the smoke config's chunk of 8, S 32 is a multiple."""
    cfg_j, cfg_t, params, _ = _pair("zamba2-1.2b")
    p = _layer0(params, "mamba")
    p["dt_bias"] = np.random.default_rng(3).standard_normal(
        p["dt_bias"].shape).astype(np.float32)
    jx, tx = _bf16(np.random.default_rng(s).standard_normal(
        (2, s, cfg_j.d_model)))
    want, _ = JM.apply_mamba({k: jnp.asarray(v) for k, v in p.items()}, jx,
                             cfg_j)
    got, cache = TM.apply_mamba({k: torch.from_numpy(v)
                                 for k, v in p.items()}, tx, cfg_t)
    assert got.dtype == torch.bfloat16 and cache is None
    _close(got, want)


def test_apply_mamba_decode():
    cfg_j, cfg_t, params, _ = _pair("zamba2-1.2b")
    p = _layer0(params, "mamba")
    rng = np.random.default_rng(4)
    jx, tx = _bf16(rng.standard_normal((2, 1, cfg_j.d_model)))
    jconv, tconv = _bf16(rng.standard_normal(
        (2, cfg_j.conv_width - 1, cfg_j.d_inner + 2 * cfg_j.ssm_state)))
    ssd = rng.standard_normal((2, cfg_j.ssm_heads, cfg_j.ssm_state,
                               cfg_j.ssm_head_dim)).astype(np.float32)
    want, wc = JM.apply_mamba({k: jnp.asarray(v) for k, v in p.items()}, jx,
                              cfg_j, {"conv": jconv, "ssd": jnp.asarray(ssd)})
    got, gc = TM.apply_mamba({k: torch.from_numpy(v) for k, v in p.items()},
                             tx, cfg_t, {"conv": tconv,
                                         "ssd": torch.from_numpy(ssd)})
    _close(got, want)
    assert gc["conv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(gc["conv"]), _f32(wc["conv"]))
    _close(gc["ssd"], wc["ssd"])    # float32 from bf16 products


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("arch,layers", [
    ("rwkv6-3b", 2), ("zamba2-1.2b", 2), ("zamba2-1.2b", 7)])
def test_forward_matches_the_reference(arch, layers):
    """Prefill logits at bf16 tolerance, argmax agreement > 0.95. zamba2
    at 2 layers ends on the shared block (`smoke_config`'s rule); at 7 it
    applies the block mid-stack (layer 5 of 7). Measured: rwkv6 equals
    the reference bit for bit."""
    cfg_j, cfg_t, params, model = _pair(arch, layers)
    tokens = _tokens(cfg_j, (2, 32))
    want, jaux = JT.forward(params, {"tokens": jnp.asarray(tokens)}, cfg_j)
    got, aux = TT.forward(model, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert float(aux) == float(jaux) == 0.0
    _close(got, want)
    assert (_f32(got).argmax(-1) == _f32(want).argmax(-1)).mean() > 0.95


@pytest.mark.parametrize("s", [12, 32])
def test_decode_matches_the_reference_and_forward(pair, s):
    """Teacher-forced decode against the reference's `decode_step` and
    against the port's own forward: at S 12 the forward takes rwkv's token
    scan and zamba2's padded chunks, at S 32 the chunked forms. The final
    recurrent states are held to the reference's too."""
    cfg_j, cfg_t, params, model = pair
    tokens = _tokens(cfg_j, (2, s), seed=3)
    jc = JT.init_cache(cfg_j, 2, max_len=s)
    tc = TT.init_cache(cfg_t, 2, max_len=s, device="cpu")
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
    assert int(tc["pos"]) == int(jc["pos"]) == s
    want, got = jax.tree.map(np.asarray, jc), tc
    for path in _leaves(want):
        w, g = want, got
        for key in path:
            w, g = w[key], g[key]
        np.testing.assert_allclose(_f32(g), _f32(w), **DECODE_TOL)


def test_init_cache_is_the_references(pair):
    """Every leaf's shape and dtype, on the CPU and on ``meta``: rwkv's
    ``tm``/``cm`` states in float32, zamba2's bf16 conv and float32 SSD
    states and its shared attention cache. (The reference's decode leaves
    a bf16 token shift in its float32 slots; the port writes the same
    values into them.)"""
    cfg_j, cfg_t, _, _ = pair
    want = _leaves(jax.eval_shape(lambda: JT.init_cache(cfg_j, 3, 16)))
    for dev in ("cpu", "meta"):
        got = TT.init_cache(cfg_t, 3, 16, device=dev)
        assert _leaves(got) == want
        assert all(t.device.type == dev for t in jax.tree.leaves(got))


def test_reset_slot_matches_the_reference(pair):
    """Every (L, B, ...) leaf with L != 1, however nested, zeroed at the
    slot; ``length`` and ``pos`` stay."""
    cfg_j, cfg_t, _, _ = pair
    jc = JT.init_cache(cfg_j, 3, 4)
    rng = np.random.default_rng(8)
    filled = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a) + 3, jc)
    jc = jax.tree.map(lambda f, a: jnp.asarray(f, a.dtype), filled, jc)
    tc = TT.init_cache(cfg_t, 3, 4, device="cpu")
    for path in _leaves(tc):
        t, j = tc, jc
        for key in path:
            t, j = t[key], j[key]
        t.copy_(torch.tensor(_f32(j)))
    want = JS._reset_slot(jc, 1, "any")
    got = TS._reset_slot(tc, 1, "any")
    zeroed = 0
    for path in _leaves(want):
        w, g = want, got
        for key in path:
            w, g = w[key], g[key]
        np.testing.assert_array_equal(_f32(g), _f32(w))
        zeroed += g.dim() >= 2 and not g[:, 1].any()
    assert zeroed >= 2


def _bf16_unit(x):
    """The spacing of bfloat16 values at |x| (8 bits of significand)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _serve_schedule(requests, slots: int = 4):
    """`serve_loop`'s decode calls, in order: the request in each row and
    whether the call samples a token for it (tests/test_torch_moe.py's
    helper: the schedule depends only on the prompts' lengths and
    ``max_new``, never on the tokens)."""
    queue, active = list(requests)[::-1], [None] * slots
    remaining, calls = [0] * slots, []
    while queue or any(a is not None for a in active):
        for s in range(slots):
            if active[s] is None and queue:
                req = queue.pop()
                rows = [a.rid if a is not None else None for a in active]
                rows[s] = req.rid
                calls += [(rows, False)] * len(req.prompt)
                active[s], remaining[s] = req, req.max_new
        calls.append(([a.rid if a is not None else None for a in active],
                      True))
        for s in range(slots):
            if active[s] is not None:
                remaining[s] -= 1
                if remaining[s] <= 0:
                    active[s] = None
    return calls


def _reference_serve(monkeypatch, cfg_j, params, requests):
    """The reference's `serve_loop` on ``requests`` and, for each of its
    decode calls in order, each row's top logit's lead over the runner-up
    and its value."""
    tops, step = [], JT.decode_step

    def traced_step(p, cache, tokens, cfg, mesh=None):
        logits, cache = step(p, cache, tokens, cfg, mesh)
        top = jax.lax.top_k(logits[:, -1].astype(jnp.float32), 2)[0]
        jax.debug.callback(lambda g, t: tops.append((g, t)),
                           top[:, 0] - top[:, 1], top[:, 0], ordered=True)
        return logits, cache

    monkeypatch.setattr(JT, "decode_step", traced_step)
    done = JS.serve_loop(cfg_j, params, requests)
    jax.effects_barrier()
    return done, tops


def test_serve_loop_matches_the_reference(pair, monkeypatch):
    """The same 8 synthetic requests, 4 slots, greedy: the same completion
    order, token counts and first token of every request. Each request's
    tokens must then equal the reference's up to its first sampled step
    whose top logit leads the runner-up by less than two bf16 units, as
    tests/test_torch_moe.py holds the MoE's: the two frameworks' float32
    sums (the ddlerp's low-rank product, the wkv and SSD state products)
    differ by rounding, which moves a bf16 value by one unit now and then,
    and a greedy token forks for good at a near-tie (the reference's own
    logits tie exactly at some steps). Those tokens must be at least 40% of
    all (measured: 94 of 192 for rwkv6, 105 for zamba2; free-running, the
    port's greedy tokens equal the reference's at 192 and 167 of 192
    positions)."""
    cfg_j, cfg_t, params, model = pair
    want, tops = _reference_serve(monkeypatch, cfg_j, params,
                                  JS.synthetic_requests(8, cfg_j.vocab_size))
    got = TS.serve_loop(cfg_t, model, TS.synthetic_requests(
        8, cfg_t.vocab_size))
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [len(r.out) for r in got] == [len(r.out) for r in want]
    assert all(len(r.out) == r.max_new for r in got)
    assert [r.out[0] for r in got] == [r.out[0] for r in want]
    schedule = _serve_schedule(JS.synthetic_requests(8, cfg_j.vocab_size))
    assert len(schedule) == len(tops)
    held, tied = {r.rid: 0 for r in want}, set()
    for (rows, sampled), (lead, top) in zip(schedule, tops):
        for s, rid in enumerate(rows):
            if not sampled or rid is None or rid in tied:
                continue
            if lead[s] < 2 * _bf16_unit(top[s]):
                tied.add(rid)
            else:
                held[rid] += 1
    mine = {r.rid: r.out for r in got}
    for w in want:
        assert mine[w.rid][:held[w.rid]] == w.out[:held[w.rid]], w.rid
    assert sum(held.values()) >= 0.4 * sum(len(r.out) for r in want)


def test_from_jax_params_copies_every_leaf(pair):
    """Every stacked layer leaf (RWKV's and Mamba2's nested dicts) into
    its block, and zamba2's unstacked ``shared_attn`` into the shared
    block."""
    cfg_j, _, params, model = pair
    group = "rwkv" if cfg_j.block_pattern[0] == "rwkv" else "mamba"
    for i in range(cfg_j.num_layers):
        for name in params["layers"]:
            for key, leaf in params["layers"][name].items():
                np.testing.assert_array_equal(
                    getattr(model.layers[i], name)[key].numpy(),
                    np.asarray(leaf[i]))
    assert group in params["layers"]
    if "shared_attn" in params:
        for name, sub in params["shared_attn"].items():
            for key, leaf in sub.items():
                np.testing.assert_array_equal(
                    getattr(model.shared_attn, name)[key].numpy(),
                    np.asarray(leaf))
    else:
        assert model.shared_attn is None


def test_init_params_is_the_references_tree(pair):
    """`init_params` on a torch.Generator gives the reference's tree of
    shapes, with its deterministic leaves (``a_log``, ``w_base``) and the
    scales it draws at."""
    cfg_j, cfg_t, params, _ = pair
    model = TT.init_params(cfg_t, torch.Generator().manual_seed(1), "cpu")
    group = "rwkv" if cfg_t.block_pattern[0] == "rwkv" else "mamba"
    for key, leaf in params["layers"][group].items():
        got = getattr(model.layers[0], group)[key]
        assert tuple(got.shape) == leaf.shape[1:]
        if key in ("a_log", "w_base", "mu_base", "u_bonus", "d_skip"):
            np.testing.assert_allclose(got.numpy(), np.asarray(leaf[0]),
                                       rtol=1e-6)
    if group == "rwkv":
        w = model.layers[1].rwkv["wr"]
        assert abs(float(w.std()) * cfg_t.d_model ** 0.5 - 1) < 0.1
    else:
        w = model.layers[1].mamba["conv"]
        assert abs(float(w.std()) / 0.2 - 1) < 0.15
        assert tuple(model.shared_attn.ffn["w_in"].shape) == (
            cfg_t.d_model, cfg_t.d_ff)
    count = sum(p.numel() for p in model.parameters())
    assert count == sum(a.size for a in jax.tree.leaves(params))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applies_to_is_the_references(arch):
    assert applies_to(get_config(arch)) == jax_applies_to(jax_get(arch))
    cfg = smoke_config(arch, layers=2)
    assert applies_to(cfg) == jax_applies_to(jax_smoke(arch, layers=2))


def test_serve_main_runs_both_trunks_on_the_cpu(capsys):
    for arch in TRUNKS:
        done = TS.main(["--arch", arch, "--smoke", "--requests", "3",
                        "--slots", "2", "--device", "cpu"])
        assert sorted(r.rid for r in done) == [0, 1, 2]
        assert "[serve] 3 requests" in capsys.readouterr().out

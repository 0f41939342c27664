"""PyTorch port: the MoE layer and the MoE models agree with the JAX
package.

Both packages run the smoke moonshot-v1-16b-a3b (4 experts, top-2, one
shared expert) and smoke mixtral-8x7b (4 experts, top-2, GQA with a
sliding window) on the same weights: the JAX package's ``init_params``
pytree, carried across with `from_jax_params`. Inputs are made from seeds
with numpy. The port's prefill attention is the flash kernel's plain
version for both, and on the CPU it and the port's decode round p to bf16
before PV, as the reference's chunked path does in both.

Tolerances:
* routing on the same bf16 input: the same experts, gates and aux loss at
  rtol 1e-5 (float32 router, sums in another order);
* `apply_moe`: tests/test_models.py:133's rtol 0.1 / atol 0.02;
* whole models: the standards of tests/test_torch_models.py (logits
  within 2% of the largest, decode within rtol/atol 0.15, argmax agreement
  > 0.95), held at 95% of the positions or more. A top-k choice is
  discrete: where two experts' probabilities nearly tie, rounding that
  differs between the frameworks upstream picks the other expert for
  that token and moves its logits by O(1) (measured in smoke mixtral's
  forward: 5 positions of 80 while the port's CPU prefill kept PV in
  float32 and rounded silu and the residual scales its own way; none in
  moonshot's; none in either since the port rounds where the
  reference's compiled program does, and smoke mixtral's logits equal
  the reference's bit for bit).
  So the whole-model tests hold the free-running routing to part only
  where the router's margin is below ROUTE_TIE, at a root (a choice no
  earlier layer's parted choice at that position or before reaches),
  and the logits to the standard on a run that replays the other run's
  expert choices (`models.moe.RouteTape`), as chip_smoke.py holds the
  card to the CPU.
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
from repro.locality import moe as JLM  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm as gmm_mod  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.locality import moe as TLM  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["moonshot-v1-16b-a3b", "mixtral-8x7b"]
BF16_FRAC = 2e-2        # tests/test_torch_models.py
DECODE_TOL = dict(rtol=0.15, atol=0.15)
MOE_TOL = dict(rtol=0.1, atol=0.02)   # tests/test_models.py:133
MIN_POSITIONS = 0.95
ROUTE_TIE = 1e-3        # chip_smoke.py: a router margin rounding can cross


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _bf16(a: np.ndarray):
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()


def _positions_close(got, want, rtol, atol) -> float:
    """Share of positions (all axes but the last) whose every value is
    within ``atol + rtol * |want|``."""
    got, want = _f32(got), _f32(want)
    ok = np.abs(got - want) <= atol + rtol * np.abs(want)
    return float(ok.all(-1).mean())


def _argmax_agree(got, want) -> float:
    return float((_f32(got).argmax(-1) == _f32(want).argmax(-1)).mean())


def _argmax_agree_to_a_unit(got, want) -> float:
    """Share of positions where ``got``'s top token is ``want``'s or ties
    with it to within one bf16 unit of ``want``'s top logit: the argmax
    standard chip_smoke.py holds two roundings of a decode to (PERF.md
    §2), for logits that each framework rounds to bf16 after sums that
    differ upstream."""
    got, want = _f32(got), _f32(want)
    best = want.max(-1)
    picked = np.take_along_axis(want, got.argmax(-1)[..., None], -1)[..., 0]
    return float((best - picked <= _bf16_unit(best)).mean())


def _pair(arch, layers=2, **replace):
    cfg_j = dataclasses.replace(jax_smoke(arch, layers=layers), **replace)
    cfg_t = dataclasses.replace(smoke_config(arch, layers=layers), **replace)
    params = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    model = TT.from_jax_params(cfg_t, jax.tree.map(np.asarray, params),
                               device="cpu")
    return cfg_j, cfg_t, params, model


@pytest.fixture(scope="module", params=ARCHS)
def moe_pair(request):
    return _pair(request.param)


def _traced_routes(monkeypatch):
    """Patch the reference's `_route` to record each call's expert ids,
    sorted, in call order (``jax.debug.callback``, so jitted calls
    record too); returns the list they land in."""
    routes, route = [], JM._route

    def traced(p, x, cfg):
        experts, gates, aux = route(p, x, cfg)
        jax.debug.callback(lambda e: routes.append(np.sort(e, -1)),
                           experts, ordered=True)
        return experts, gates, aux
    monkeypatch.setattr(JM, "_route", traced)
    return routes


def _assert_parts_at_ties(want, got, margins, b):
    """``want`` and ``got``: (layers, b·s, k) expert ids of two runs in
    (b, s) row order; ``margins`` (layers, b·s) the router margins of
    ``got``. Every root where they part (no parted choice at an earlier
    layer at that position or before in its sequence) lies below
    ROUTE_TIE."""
    layers = want.shape[0]
    differ = (want != got).any(-1).reshape(layers, b, -1)
    upto = np.maximum.accumulate(differ, axis=2)
    below = (np.cumsum(upto, axis=0) - upto) > 0
    roots = differ & ~below
    assert (margins.reshape(layers, b, -1)[roots] < ROUTE_TIE).all(), (
        margins.reshape(layers, b, -1)[roots])


def _moe_params(arch, seed=0):
    cfg_j, cfg_t = jax_smoke(arch, layers=1), smoke_config(arch, layers=1)
    p = JM.init_moe(jax.random.PRNGKey(seed), cfg_j)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    return cfg_j, cfg_t, p, tp


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tokens", [16, 300])
def test_route_matches_the_reference(arch, tokens):
    cfg_j, cfg_t, p, tp = _moe_params(arch)
    jx, tx = _bf16(np.random.default_rng(tokens).standard_normal(
        (tokens, cfg_j.d_model)))
    je, jg, ja = JM._route(p, jx, cfg_j)
    te, tg, ta = TM._route(tp, tx, cfg_t)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def test_route_breaks_ties_to_the_lower_expert():
    """A zero router makes every probability equal: both pick experts 0
    and 1 (jax.lax.top_k puts the lower index first on ties)."""
    cfg_j, cfg_t, p, tp = _moe_params("mixtral-8x7b")
    p = dict(p, router=jnp.zeros_like(p["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(1).standard_normal((8, cfg_j.d_model))
    je, _, _ = JM._route(p, jnp.asarray(x, jnp.float32), cfg_j)
    te, tg, _ = TM._route(tp, torch.from_numpy(x).float(), cfg_t)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert (te.numpy() == [0, 1]).all()
    assert torch.allclose(tg, torch.full_like(tg, 0.5))


def test_aux_loss_balanced_routing():
    """Uniform router => aux ~ 1 (tests/test_models.py:149)."""
    cfg = smoke_config("mixtral-8x7b")
    d, e = cfg.d_model, cfg.num_experts
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (128, d)).astype(np.float32))
    _, _, aux = TM._route({"router": torch.zeros(d, e)}, x, cfg)
    assert abs(float(aux) - 1.0) < 0.05


# ---------------------------------------------------------------- the layer
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_apply_moe_matches_the_reference(arch, sort):
    cfg_j, cfg_t, p, tp = _moe_params(arch)
    cfg_j = dataclasses.replace(cfg_j, moe_locality_sort=sort)
    cfg_t = dataclasses.replace(cfg_t, moe_locality_sort=sort)
    jx, tx = _bf16(np.random.default_rng(3).standard_normal(
        (2, 16, cfg_j.d_model)))
    want, jaux = JM.apply_moe(p, jx, cfg_j)
    got, aux = TM.apply_moe(tp, tx, cfg_t)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_sorted_equals_unsorted_dispatch():
    """tests/test_models.py::test_moe_sorted_equals_unsorted_dispatch on
    the port."""
    cfg = smoke_config("mixtral-8x7b", layers=2)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = model.layers[0].ffn
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)).bfloat16()
    y1, a1 = TM.apply_moe(p, x, cfg)
    y2, a2 = TM.apply_moe(p, x, dataclasses.replace(
        cfg, moe_locality_sort=False))
    np.testing.assert_allclose(_f32(y1), _f32(y2), **MOE_TOL)
    np.testing.assert_allclose(float(a1), float(a2), rtol=1e-5)


@pytest.mark.parametrize("replica", [None, (0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("base,num_local", [(0, 4), (2, 2)])
def test_dispatch_local_matches_the_reference(replica, base, num_local):
    """The parking group (experts outside [base, base+num_local)) and the
    replica split; the replicas of one expert set add up to the whole."""
    cfg_j, cfg_t, p, tp = _moe_params("moonshot-v1-16b-a3b")
    jx, tx = _bf16(np.random.default_rng(5).standard_normal(
        (24, cfg_j.d_model)))
    je, jg, _ = JM._route(p, jx, cfg_j)
    te, tg, _ = TM._route(tp, tx, cfg_t)

    def experts(w):
        return w[base:base + num_local]
    want = JM._dispatch_local(jx, je, jg, *(experts(p[n]) for n in (
        "w_gate", "w_up", "w_down")), num_local, base, replica)
    got = TM._dispatch_local(tx, te, tg, *(experts(tp[n]) for n in (
        "w_gate", "w_up", "w_down")), num_local, base, replica)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **MOE_TOL)
    if replica is not None:
        reps = replica[1]
        parts = [TM._dispatch_local(tx, te, tg, *(experts(tp[n]) for n in (
            "w_gate", "w_up", "w_down")), num_local, base, (r, reps))
            for r in range(reps)]
        whole = TM._dispatch_local(tx, te, tg, *(experts(tp[n]) for n in (
            "w_gate", "w_up", "w_down")), num_local, base)
        np.testing.assert_allclose(_f32(sum(parts)), _f32(whole), **MOE_TOL)


def test_route_tape_records_and_replays():
    """`RouteTape` records each routing call's sorted experts and router
    margins; replaying a run's own choices gives its output again, and
    forced choices are gated by the run's own probabilities renormalised
    over them."""
    cfg_j, cfg_t, p, tp = _moe_params("moonshot-v1-16b-a3b")
    _, tx = _bf16(np.random.default_rng(5).standard_normal(
        (16, cfg_t.d_model)))
    k, e = cfg_t.experts_per_token, cfg_t.num_experts
    with TM.RouteTape() as tape:
        want, _ = TM.apply_moe(tp, tx[None], cfg_t)
    assert TM.tape is None and len(tape.experts) == 1
    experts, _, _ = TM._route(tp, tx, cfg_t)
    assert torch.equal(tape.experts[0], experts.sort(-1).values)
    probs = torch.softmax(tx.float() @ tp["router"], -1)
    top = probs.sort(-1, descending=True).values
    torch.testing.assert_close(tape.margins[0], top[:, k - 1] - top[:, k])
    with TM.RouteTape(tape.experts):
        again, _ = TM.apply_moe(tp, tx[None], cfg_t)
    torch.testing.assert_close(again, want)
    forced = torch.arange(e - k, e).expand(16, k)
    with TM.RouteTape([forced]):
        got, gates, _ = TM._route(tp, tx, cfg_t)
    assert torch.equal(got, forced)
    g = probs[:, e - k:]
    torch.testing.assert_close(gates, g / g.sum(-1, keepdim=True))


def test_apply_moe_refuses_a_mesh():
    """On a mesh `apply_moe` takes one tensor a shard: a whole tensor is
    refused (tests/test_torch_mesh_moe.py holds the sharded MoE)."""
    from repro_torch.launch.mesh import make_mesh
    _, cfg_t, _, tp = _moe_params("moonshot-v1-16b-a3b")
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    with pytest.raises(TypeError, match="one tensor a shard"):
        TM.apply_moe(tp, torch.zeros(1, 2, cfg_t.d_model), cfg_t,
                     mesh=mesh)


# ---------------------------------------------------------------- the model
def test_forward_and_aux_match_the_reference(moe_pair, monkeypatch):
    """Free-running, the logits meet the standard at MIN_POSITIONS of the
    positions and the routing parts only at near-ties; on the reference's
    expert choices the logits meet it too. The port's CPU prefill rounds p
    to bf16 before PV, as the reference's does."""
    cfg_j, _, params, model = moe_pair
    tokens = np.random.default_rng(1).integers(
        0, cfg_j.vocab_size, (2, 40)).astype(np.int32)
    routes = _traced_routes(monkeypatch)
    want, jaux = JT.forward(params, {"tokens": jnp.asarray(tokens)}, cfg_j)
    jax.effects_barrier()
    launches = gmm_mod.launches
    with TM.RouteTape() as tape:
        got, aux = TT.forward(model, {"tokens": torch.from_numpy(tokens)})
    assert gmm_mod.launches == launches   # the CPU runs the plain version
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _assert_parts_at_ties(np.stack(routes), torch.stack(tape.experts).numpy(),
                          torch.stack(tape.margins).numpy(), tokens.shape[0])
    with TM.RouteTape([torch.from_numpy(e).long() for e in routes]):
        forced, _ = TT.forward(model, {"tokens": torch.from_numpy(tokens)})
    atol = BF16_FRAC * float(np.abs(_f32(want)).max())
    assert _positions_close(got, want, BF16_FRAC, atol) >= MIN_POSITIONS
    assert _positions_close(forced, want, BF16_FRAC, atol) >= MIN_POSITIONS
    assert _argmax_agree(forced, want) > 0.95
    assert _argmax_agree(got, want) > 0.95
    # the layers' inputs differ by bf16 rounding, so their routing
    # statistics do too; one flipped assignment of the T·k = 160 moves the
    # aux by up to E/160 times a gap in probability (measured: 1.1e-4 in
    # moonshot, 1.2e-3 in mixtral, which flips one)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-2)


def test_decode_matches_the_reference_and_forward(moe_pair, monkeypatch):
    """Teacher-forced decode through the cache against the reference's
    `decode_step` and the port's own forward: free-running, the port's
    decode routing parts from either only at near-ties; on the other
    run's expert choices the logits meet the standard. Against the
    reference's decode a top token may change where the two leading
    logits lie within a bf16 unit, since the frameworks round other
    steps differently: there the argmax is held to within one unit
    (measured in smoke mixtral while the port's CPU decode kept PV in
    float32: 2 of 24 positions changed, leads of 1 and 2 units; against
    the port's own forward, the same arithmetic, none; since the port
    rounds where the reference does, none, and both smoke decodes equal
    the reference's bit for bit)."""
    cfg_j, cfg_t, params, model = moe_pair
    b, s, layers = 2, 12, cfg_t.num_layers
    tokens = np.random.default_rng(3).integers(
        0, cfg_j.vocab_size, (b, s)).astype(np.int32)
    routes = _traced_routes(monkeypatch)
    jc = JT.init_cache(cfg_j, b, max_len=s)
    step = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, cfg_j))
    jd = []
    for i in range(s):
        lg, jc = step(params, jc, jnp.asarray(tokens[:, i:i + 1]))
        jd.append(_f32(lg[:, 0]))
    jax.effects_barrier()
    jd = np.stack(jd, 1)

    def decode(replay=None):
        tc = TT.init_cache(cfg_t, b, max_len=s, device="cpu")
        out = []
        with TM.RouteTape(replay) as tape:
            for i in range(s):
                lg, tc = TT.decode_step(model, tc, torch.from_numpy(
                    tokens[:, i:i + 1]))
                out.append(_f32(lg[:, 0]))
        assert int(tc["pos"]) == s
        return np.stack(out, 1), tape

    def by_position(calls):   # (s·layers, b, k) step-major -> (layers, b·s, k)
        e = np.stack(calls).reshape(s, layers, b, -1)
        return e.transpose(1, 2, 0, 3).reshape(layers, b * s, -1)

    td, tape = decode()
    margins = torch.stack(tape.margins).numpy().reshape(s, layers, b)
    margins = margins.transpose(1, 2, 0).reshape(layers, b * s)
    got_routes = by_position([e.numpy() for e in tape.experts])
    _assert_parts_at_ties(by_position(routes), got_routes, margins, b)
    with TM.RouteTape() as fwd:
        full, _ = TT.forward(model, {"tokens": torch.from_numpy(tokens)})
    fwd_routes = torch.stack(fwd.experts).numpy()
    _assert_parts_at_ties(fwd_routes, got_routes, margins, b)

    on_ref, _ = decode([torch.from_numpy(e).long() for e in routes])
    per_step = fwd_routes.reshape(layers, b, s, -1)
    on_fwd, _ = decode([torch.from_numpy(per_step[layer, :, i]).long()
                        for i in range(s) for layer in range(layers)])
    assert _positions_close(on_ref, jd, **DECODE_TOL) >= MIN_POSITIONS
    assert _argmax_agree_to_a_unit(on_ref, jd) > 0.95
    assert _positions_close(on_fwd, full, **DECODE_TOL) >= MIN_POSITIONS
    assert _argmax_agree(on_fwd, full) > 0.95


def _reference_serve_trace(monkeypatch, cfg_j, params, requests):
    """The reference's `serve_loop` on ``requests``, and for each of its
    decode calls, in order: each layer's expert ids (layers, rows, k),
    sorted, and each row's top logit's lead over the runner-up and its
    value."""
    events = []
    route, step = JM._route, JT.decode_step

    def traced_route(p, x, cfg):
        experts, gates, aux = route(p, x, cfg)
        jax.debug.callback(lambda e: events.append(("route", np.sort(e, -1))),
                           experts, ordered=True)
        return experts, gates, aux

    def traced_step(p, cache, tokens, cfg, mesh=None):
        logits, cache = step(p, cache, tokens, cfg, mesh)
        top = jax.lax.top_k(logits[:, -1].astype(jnp.float32), 2)[0]
        jax.debug.callback(lambda g, t: events.append(("step", g, t)),
                           top[:, 0] - top[:, 1], top[:, 0], ordered=True)
        return logits, cache

    monkeypatch.setattr(JM, "_route", traced_route)
    monkeypatch.setattr(JT, "decode_step", traced_step)
    done = JS.serve_loop(cfg_j, params, requests)
    jax.effects_barrier()
    calls, routes = [], []
    for ev in events:
        if ev[0] == "route":
            routes.append(ev[1])
        else:
            calls.append((np.stack(routes), ev[1], ev[2]))
            routes = []
    return done, calls


def _serve_schedule(requests, slots: int = 4):
    """`serve_loop`'s decode calls, in order: the request in each row and
    whether the call samples a token for it. The schedule depends only on
    the prompts' lengths and ``max_new``, never on the tokens."""
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


def _bf16_unit(x):
    """The spacing of bfloat16 values at |x| (8 bits of significand)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def test_serve_loop_matches_the_reference(moe_pair, monkeypatch):
    """The same 8 synthetic requests, 4 slots, greedy.

    Free-running: the same completion order and token counts and the same
    first token for every request. A request's greedy tokens then fork
    for good at the first near-tie of the router or of the logits, in the
    reference too: with its weights moved by 1e-3 relative, it keeps 106
    (moonshot) and 147 (mixtral) of its own 192 tokens (measured on the
    CPU).

    Teacher-forced routing: the port's loop replays the reference's
    expert choices (`models.moe.RouteTape`), so only the logits can fork
    it. Every request's tokens must equal the reference's up to its first
    sampled step whose top logit leads the runner-up by less than two
    bf16 units (each framework rounds its logits to bf16 once, and their
    sums upstream differ by rounding), and those tokens must be at least
    a quarter of all (measured: 66 of 192 in moonshot, 83 in mixtral)."""
    cfg_j, cfg_t, params, model = moe_pair
    want, calls = _reference_serve_trace(
        monkeypatch, cfg_j, params,
        JS.synthetic_requests(8, cfg_j.vocab_size))
    got = TS.serve_loop(cfg_t, model, TS.synthetic_requests(
        8, cfg_t.vocab_size))
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [len(r.out) for r in got] == [len(r.out) for r in want]
    assert all(len(r.out) == r.max_new for r in got)
    assert [r.out[0] for r in got] == [r.out[0] for r in want]

    replay = [torch.from_numpy(experts[layer]).long() for experts, *_ in calls
              for layer in range(cfg_t.num_layers)]
    with TM.RouteTape(replay):
        forced = {r.rid: r.out for r in TS.serve_loop(
            cfg_t, model, TS.synthetic_requests(8, cfg_t.vocab_size))}
    schedule = _serve_schedule(JS.synthetic_requests(8, cfg_j.vocab_size))
    assert len(schedule) == len(calls)
    held, tied = {r.rid: 0 for r in want}, set()
    for (rows, sampled), (_, lead, top) in zip(schedule, calls):
        for s, rid in enumerate(rows):
            if not sampled or rid is None or rid in tied:
                continue
            if lead[s] < 2 * _bf16_unit(top[s]):
                tied.add(rid)
            else:
                held[rid] += 1
    for w in want:
        n = held[w.rid]
        assert forced[w.rid][:n] == w.out[:n], w.rid
    assert sum(held.values()) >= 0.25 * sum(len(r.out) for r in want)


def test_from_jax_params_copies_every_moe_leaf(moe_pair):
    cfg_j, _, params, model = moe_pair
    ffn = params["layers"]["ffn"]
    leaves = [(name, leaf) for name, leaf in ffn.items() if name != "shared"]
    leaves += [(("shared", name), leaf)
               for name, leaf in ffn.get("shared", {}).items()]
    assert {n for n, _ in leaves} >= {"router", "w_gate", "w_up", "w_down"}
    assert ("shared" in ffn) == (cfg_j.num_shared_experts > 0)
    for i in range(cfg_j.num_layers):
        mine = model.layers[i].ffn
        for name, leaf in leaves:
            got = (mine[name[0]][name[1]] if isinstance(name, tuple)
                   else mine[name])
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf[i]))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_moe_shapes_and_scales(arch):
    cfg = smoke_config(arch, layers=2)
    model = TT.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    want = jax.eval_shape(lambda: JT.init_params(
        jax_smoke(arch, layers=2), jax.random.PRNGKey(0)))
    got = {n: tuple(p.shape) for n, p in model.layers[1].ffn.named_parameters()}
    flat = jax.tree_util.tree_flatten_with_path(want["layers"]["ffn"])[0]
    assert got == {".".join(k.key for k in path): leaf.shape[1:]
                   for path, leaf in flat}
    d, f = cfg.d_model, cfg.d_ff
    ffn = model.layers[0].ffn
    for t, scale in ((ffn["router"], d ** -0.5), (ffn["w_gate"], d ** -0.5),
                     (ffn["w_down"], f ** -0.5)):
        n = t.numel()   # five standard errors of each estimate
        assert abs(float(t.std()) / scale - 1) < 5 / (2 * n) ** 0.5
        assert abs(float(t.mean())) < 5 * scale / n ** 0.5


def test_serve_main_runs_moonshot_on_the_cpu(capsys):
    done = TS.main(["--arch", "moonshot-v1-16b-a3b", "--smoke", "--layers",
                    "1", "--requests", "3", "--slots", "2", "--device",
                    "cpu"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out) == r.max_new for r in done)
    assert "on cpu" in capsys.readouterr().out


# --------------------------------------------------------- locality/moe.py
@pytest.mark.parametrize("pkg", [JLM, TLM], ids=["jax", "torch"])
def test_moe_dispatch_stats(pkg):
    """tests/test_substrate.py:103 on both packages, with equal results."""
    rng = np.random.default_rng(0)
    p = 1.0 / (1 + np.arange(16)) ** 1.2
    p /= p.sum()
    experts = rng.choice(16, size=(4096, 2), p=p)
    stats = pkg.dispatch_stats(experts, 16)
    assert stats["weight_stream_reduction"] > 10
    g = pkg.routing_graph(experts, 16)
    assert g.num_edges == 4096 * 2
    perm = pkg.expert_affinity_permutation(experts, 16)
    assert sorted(perm.tolist()) == list(range(16))
    base = pkg.cross_shard_traffic(experts, 16, 4)
    assert 1.0 <= base <= 2.0
    assert stats == JLM.dispatch_stats(experts, 16)
    np.testing.assert_array_equal(
        perm, JLM.expert_affinity_permutation(experts, 16))
    assert base == JLM.cross_shard_traffic(experts, 16, 4, None)

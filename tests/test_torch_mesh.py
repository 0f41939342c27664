"""PyTorch port: the LM on a (data, model) mesh agrees with the JAX
package's sharded run.

The reference's sharded paths run in ONE subprocess for this file, with
four forced host devices (`conftest.run_forced_four_devices`), on an
*Auto* mesh (``jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
axes)``): the reference's own ``launch.mesh.make_mesh`` builds Explicit
axes under jax 0.9.0, on which its ``_shard_batch`` raises (ROADMAP C,
"Reference caveats"). The child runs this file as a script
(`_reference_main`) and saves its outputs to an ``.npz``: for each arch of
`ARCHS` at each mesh of `SHAPES`, ``make_forward``'s logits and its
capacity dispatch's dropped rows, three ``make_serve_step`` decode steps,
one ``make_train_step`` step (two microbatches) and
``ef_compressed_psum`` inside ``shard_map`` over a 4-way ``pod`` axis.
The port runs the same weights (the reference's ``init_params`` pytree,
carried across with ``from_jax_params``) on the same numpy inputs on a
CPU mesh of four shards. The MoE archs' weights are skewed (`_skew`): a
direction shared by every embedding row that the router reads into
expert 0, so that expert 0's group passes its capacity and rows drop.

Tolerances, each from the existing model and train tests:

* prefill logits and the decode steps' logits: within 2% of each value or
  of the largest magnitude (``BF16_FRAC``, tests/test_torch_models.py);
  with an MoE trunk at 95% of the positions (``MIN_POSITIONS``,
  tests/test_torch_moe.py), since routing parts at near-ties;
* the dropped rows: the same (token, expert) pairs, call by call;
* a train step: loss and grad norm at 1e-2 relative; every parameter
  within one AdamW step's reach of the reference's (2·lr plus the decay
  term), on average within 5% of it (tests/test_torch_train.py);
* ``ef_compressed_psum``: 1e-6 relative (float32, summed in another
  order);
* on ``make_host_mesh()`` the port's results equal those without a mesh
  bit for bit.
"""
from __future__ import annotations

import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.launch import shardings as JSH  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optim as JO  # noqa: E402
from repro.train import steps as JS  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCH_IDS, smoke_config  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import shardings as TSH  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

ARCHS = ["qwen2.5-3b", "minicpm-2b", "zamba2-1.2b"]
MOE_ARCHS = ["moonshot-v1-16b-a3b", "mixtral-8x7b"]   # test_torch_mesh_moe
SHAPES = [(2, 2), (1, 4)]
AXES = ("data", "model")
# forward and train: 4 rows of 256 tokens; the train step in microbatches
# of 2 rows, so that one data shard of (2, 2) holds 256 tokens of a
# microbatch and the forward's 512
BATCH, SEQ, MICRO = 4, 256, 2
# decode: 3 steps into a 16-slot cache (qwen2.5-3b's 1 kv head does not
# divide model 2 or 4, 16 does: its cache is sequence-sharded)
CACHE_T, DECODE_STEPS = 16, 3
TRAIN = dict(learning_rate=1e-3, warmup_steps=0, schedule="const",
             microbatch=MICRO)
BF16_FRAC = 2e-2
DECODE_TOL = dict(rtol=0.15, atol=0.15)
MIN_POSITIONS = 0.95


def _key(arch, shape, what) -> str:
    return f"{arch}|{shape[0]}x{shape[1]}|{what}"


def _skew(params: dict, cfg) -> dict:
    """An MoE's weights with a shared direction in every embedding row and
    the router reading it into expert 0 (numpy, in the reference's
    layout)."""
    if not cfg.is_moe:
        return params
    v = np.full((cfg.d_model,), cfg.d_model ** -0.5, np.float32)
    params["embed"]["table"] = params["embed"]["table"] + 0.5 * v
    router = params["layers"]["ffn"]["router"]
    router[:, :, 0] += 8.0 * v
    params["layers"]["ffn"]["router"] = router
    return params


def _inputs(cfg):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size,
                         (BATCH, DECODE_STEPS)).astype(np.int32)
    return tokens, steps


def _jax_params(arch):
    cfg = jax_smoke(arch, layers=2)
    params = jax.tree.map(np.array, JT.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, _skew(params, cfg)


# ------------------------------------------------------- the reference side
def _record_drops(calls: list):
    """Wrap the reference's ``_dispatch_capacity`` to send each shard's
    dropped (token, expert) pairs to ``calls`` (its own computation of the
    reference's keep mask, by the reference's formula)."""
    from repro.models import moe as JM
    inner = JM._dispatch_capacity

    def wrapped(x_flat, experts, gates, w_gate, w_up, w_down, num_experts,
                capacity):
        t, k = experts.shape
        flat_e = experts.reshape(-1)
        order = jnp.argsort(flat_e)
        sorted_e = flat_e[order]
        counts = jnp.bincount(flat_e, length=num_experts)
        offsets = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                                   jnp.cumsum(counts)[:-1]])
        keep = jnp.arange(t * k) - offsets[sorted_e] < capacity

        def put(d, m, keep, tok, ex, chosen):
            keep = np.asarray(keep)
            pairs = np.stack([np.asarray(tok)[~keep],
                              np.asarray(ex)[~keep]], 1).astype(np.int64)
            calls.append((int(d), int(m), capacity,
                          pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))],
                          np.asarray(chosen)))
        jax.debug.callback(put, jax.lax.axis_index("data"),
                           jax.lax.axis_index("model"), keep, order // k,
                           sorted_e, experts)
        return inner(x_flat, experts, gates, w_gate, w_up, w_down,
                     num_experts, capacity)
    JM._dispatch_capacity = wrapped


def _reference_main(path: str, archs, with_ef: bool = False) -> None:
    """The reference's sharded runs of ``archs`` (and, ``with_ef``,
    ``ef_compressed_psum``), saved to ``path``."""
    out = {}
    calls: list = []
    _record_drops(calls)
    for arch in archs:
        cfg, params = _jax_params(arch)
        tokens, steps = _inputs(cfg)
        for shape in SHAPES:
            mesh = jax.sharding.Mesh(
                np.array(jax.devices()).reshape(shape), AXES)
            fwd, ps = JS.make_forward(cfg, mesh)
            served = jax.device_put(params, JSH.to_named(ps, mesh))
            calls.clear()
            logits, _ = fwd(served, {"tokens": jnp.asarray(tokens)})
            jax.effects_barrier()
            out[_key(arch, shape, "logits")] = np.asarray(logits, np.float32)
            by_shard: dict = {}
            for d, m, cap, pairs, chosen in calls:
                by_shard.setdefault((d, m), []).append((pairs, chosen))
                out[_key(arch, shape, "cap")] = np.int64(cap)
            for (d, m), lst in by_shard.items():
                for j, (pairs, chosen) in enumerate(lst):
                    out[_key(arch, shape, f"drop{d}{m}_{j}")] = pairs
                    out[_key(arch, shape, f"exp{d}{m}_{j}")] = chosen
            step, ps, cs = JS.make_serve_step(cfg, mesh, BATCH, CACHE_T)
            cache = jax.device_put(JT.init_cache(cfg, BATCH, CACHE_T),
                                   JSH.to_named(cs, mesh))
            for i in range(DECODE_STEPS):
                lg, cache = step(served, cache, jnp.asarray(steps[:, i:i + 1]))
                out[_key(arch, shape, f"dec{i}")] = np.asarray(lg, np.float32)
            tstep, ps = JS.make_train_step(cfg, JO.TrainConfig(**TRAIN), mesh)
            named = JSH.to_named(ps, mesh)
            p2, _, metrics = tstep(
                jax.device_put(params, named),
                jax.device_put(JO.init_opt_state(params),
                               JSH.to_named(JS.opt_state_specs(ps), mesh)),
                {"tokens": jnp.asarray(tokens)})
            for name in ("loss", "grad_norm"):
                out[_key(arch, shape, name)] = np.asarray(metrics[name])
            for kp, leaf in jax.tree_util.tree_leaves_with_path(p2):
                out[_key(arch, shape, "p" + jax.tree_util.keystr(kp))] = \
                    np.asarray(leaf)
    if with_ef:
        _reference_ef(out)
    np.savez(path, **out)


def _reference_ef(out: dict) -> None:
    """ef_compressed_psum inside shard_map over a 4-way pod axis."""
    g, e = _ef_inputs()
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("pod",))
    spec = jax.sharding.PartitionSpec("pod")
    mean, errs = jax.shard_map(
        lambda gg, ee: JO.ef_compressed_psum({"w": gg}, {"w": ee}, "pod"),
        mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec))(g, e)
    out["ef_mean"], out["ef_err"] = np.asarray(mean["w"]), np.asarray(
        errs["w"])


def _ef_inputs():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((4, 257)).astype(np.float32),
            (0.01 * rng.standard_normal((4, 257))).astype(np.float32))


def run_reference(script: str, tmp_path_factory) -> dict:
    """``script``'s reference side in one subprocess with four forced host
    devices; its outputs."""
    from conftest import run_forced_four_devices
    path = str(tmp_path_factory.mktemp("mesh") / "ref.npz")
    res = run_forced_four_devices([os.path.abspath(script), path],
                                  timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__, tmp_path_factory)


# ------------------------------------------------------------ the port side
def _cpu_mesh(shape):
    return TMESH.make_mesh(shape, AXES, device="cpu")


_MODELS: dict = {}


def _model(arch):
    if arch not in _MODELS:
        _, params = _jax_params(arch)
        _MODELS[arch] = TT.from_jax_params(smoke_config(arch, layers=2),
                                           params, device="cpu")
    return _MODELS[arch]


def _f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _share(got, want, rtol, atol) -> float:
    got, want = _f32(got), _f32(want)
    return float((np.abs(got - want) <= atol + rtol * np.abs(want)).mean())


def _hold(arch, got, want, **tol):
    """The standard: every value (an MoE: MIN_POSITIONS of them)."""
    rtol = tol.get("rtol", BF16_FRAC)
    atol = tol.get("atol", BF16_FRAC * float(np.abs(want).max()))
    need = MIN_POSITIONS if arch in MOE_ARCHS else 1.0
    assert _share(got, want, rtol, atol) >= need


CASES = [(a, s) for a in ARCHS for s in SHAPES]
IDS = [f"{a}-{s[0]}x{s[1]}" for a, s in CASES]


def forward_case(reference, arch, shape, replay=None):
    """``make_forward`` in the serving layout on the CPU mesh: (logits,
    the `DropTape` of its capacity dispatches)."""
    cfg = smoke_config(arch, layers=2)
    mesh = _cpu_mesh(shape)
    fwd = TS.make_forward(cfg, mesh)
    sm = TT.ShardedModel.from_model(_model(arch), mesh, serve=True)
    tokens, _ = _inputs(cfg)
    with TM.DropTape() as tape, TM.RouteTape(replay):
        logits, _ = fwd(sm, {"tokens": torch.from_numpy(tokens)})
    return logits, tape


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_forward_matches_the_sharded_reference(reference, arch, shape):
    """``make_forward`` in the serving layout: the logits."""
    logits, tape = forward_case(reference, arch, shape)
    _hold(arch, logits, reference[_key(arch, shape, "logits")])
    assert not tape.calls


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_decode_matches_the_sharded_reference(reference, arch, shape):
    """``make_serve_step`` over a cache laid out by ``cache_specs``: three
    steps, each step's logits (qwen2.5-3b's cache is sequence-sharded,
    minicpm-2b's is split by kv head)."""
    decode_case(reference, arch, shape)


def decode_case(reference, arch, shape):
    cfg = smoke_config(arch, layers=2)
    mesh = _cpu_mesh(shape)
    step = TS.make_serve_step(cfg, mesh, BATCH, CACHE_T)
    if arch == "qwen2.5-3b":
        assert step.cspecs["layers"]["k"][2] == "model"
    sm = TT.ShardedModel.from_model(_model(arch), mesh, serve=True)
    cache = TSH.shard_tree(TT.init_cache(cfg, BATCH, CACHE_T, device="cpu"),
                           step.cspecs, mesh)
    _, steps = _inputs(cfg)
    for i in range(DECODE_STEPS):
        logits, cache = step(sm, cache, torch.from_numpy(steps[:, i:i + 1]))
        _hold(arch, logits, reference[_key(arch, shape, f"dec{i}")],
              **DECODE_TOL)
    assert int(cache["pos"].shards[0]) == DECODE_STEPS


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_train_step_matches_the_sharded_reference(reference, arch, shape):
    """``make_train_step`` with FSDP over ``data`` and TP over ``model``:
    one step in two microbatches against the reference's; every shard's
    slice of the updated params equals the slice ``shard_tree`` cuts from
    the whole."""
    train_case(reference, arch, shape)


def train_case(reference, arch, shape):
    cfg = smoke_config(arch, layers=2)
    mesh = _cpu_mesh(shape)
    step = TS.make_train_step(cfg, TO.TrainConfig(**TRAIN), mesh)
    sm = TT.ShardedModel.from_model(_model(arch), mesh)
    opt = TSH.shard_tree(TO.init_opt_state(TT.param_tree(_model(arch))),
                         TS.opt_state_specs(step.pspecs), mesh)
    tokens, _ = _inputs(cfg)
    sm, opt, m = step(sm, opt, {"tokens": torch.from_numpy(tokens)})
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[name]),
                                   reference[_key(arch, shape, name)],
                                   rtol=1e-2)
    assert int(opt["step"].shards[-1]) == 1
    assert not any(p.requires_grad or p.grad is not None
                   for p in sm.parameters())
    whole = sm.unshard("cpu")
    got = TT.to_jax_params(whole)
    reach = 2 * 1e-3 + 1e-6
    prefix = _key(arch, shape, "p")
    for k, want in reference.items():
        if not k.startswith(prefix):
            continue
        node = got
        for part in k[len(prefix):].strip("[]").split("]["):
            node = node[part.strip("'")]
        diff = np.abs(node - want)
        assert diff.max() <= reach * (1 + 0.1 * np.abs(want).max()), k
        if not k.endswith("['bk']"):   # tests/test_torch_train.py
            assert diff.mean() < 0.05 * reach, k
    # storage follows the specs: each slice is the one shard_tree cuts
    again = TSH.shard_tree(TT.param_tree(whole), step.pspecs, mesh)
    for a, b in zip(sm.leaves(), TT.ShardedModel(cfg, mesh, again).leaves()):
        assert a.spec == b.spec
        for x, y in zip(a.shards, b.shards):
            assert torch.equal(x, y)


# ------------------------------------------------------------------- specs
def _shape_mesh(shape):
    axes = AXES if len(shape) == 2 else ("pod",) + AXES
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def _as_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


SPEC_SHAPES = [(1, 1), (2, 2), (1, 4), (16, 16), (2, 16, 16)]


@pytest.mark.parametrize("shape", SPEC_SHAPES,
                         ids=["x".join(map(str, s)) for s in SPEC_SHAPES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(arch, shape):
    """``param_specs`` (serving and training layouts), ``batch_specs`` and
    ``cache_specs`` at the production widths equal the reference's, on
    shape-only meshes (the reference's ``_axsize`` reads only
    ``mesh.shape`` and ``mesh.axis_names``)."""
    from repro.configs import get_config as jax_get
    from repro_torch.configs import get_config
    cfg_j, cfg_t = jax_get(arch), get_config(arch)
    mesh = _shape_mesh(shape)
    for serve in (False, True):
        assert TSH.param_specs(cfg_t, mesh, serve=serve) == _as_tuples(
            JSH.param_specs(cfg_j, mesh, serve=serve))
    for gb in (1, 32, 256):
        assert TSH.batch_specs(cfg_t, mesh, gb) == _as_tuples(
            JSH.batch_specs(cfg_j, mesh, gb))
        for t in (4096, 4097):
            assert TSH.cache_specs(cfg_t, mesh, gb, t) == _as_tuples(
                JSH.cache_specs(cfg_j, mesh, gb, t))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 1, 2)])
def test_shard_tree_round_trip(shape):
    """Each shard's slice is numpy's slice of the whole by its spec, and
    `unshard_tree` gives the whole back."""
    axes = AXES if len(shape) == 2 else ("pod",) + AXES
    mesh = TMESH.make_mesh(shape, axes, device="cpu")
    rng = np.random.default_rng(1)
    whole = {"a": rng.standard_normal((8, 12)).astype(np.float32),
             "b": {"c": rng.standard_normal((4, 8, 2)).astype(np.float32)},
             "d": np.float32(3.0)}
    specs = {"a": TSH.P("data", "model"), "b": {"c": TSH.P(None, ("pod",
             "data", "model"))}, "d": TSH.P()}
    tree = TSH.shard_tree(whole, specs, mesh)
    for i in range(mesh.size):
        c = mesh.coords(i)
        dd, mm, pp = c["data"], c["model"], c.get("pod", 0)
        nd, nm = mesh.shape["data"], mesh.shape["model"]
        a = whole["a"].reshape(nd, 8 // nd, nm, 12 // nm)[dd, :, mm]
        np.testing.assert_array_equal(tree["a"].shards[i].numpy(), a)
        j = (pp * nd + dd) * nm + mm
        b = np.split(whole["b"]["c"], mesh.size, axis=1)[j]
        np.testing.assert_array_equal(tree["b"]["c"].shards[i].numpy(), b)
    back = TSH.unshard_tree(tree)
    np.testing.assert_array_equal(back["a"].numpy(), whole["a"])
    np.testing.assert_array_equal(back["b"]["c"].numpy(), whole["b"]["c"])
    assert float(back["d"]) == 3.0


@pytest.mark.parametrize("target", [(1, 4), None])
def test_restore_reshards_a_save(tmp_path, target):
    """A checkpoint saved from a (2, 2) mesh restores onto (1, 4), each
    shard's slice the one ``shard_tree`` cuts, or onto no mesh."""
    arch = "qwen2.5-3b"
    cfg = smoke_config(arch, layers=2)
    stacked = TT.to_jax_params(_model(arch))
    src = _cpu_mesh((2, 2))
    saved = TSH.shard_tree(stacked, TSH.param_specs(cfg, src), src)
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(3, {"params": saved}, blocking=True)
    if target is None:
        step, tree = m.restore()
        for path, leaf in TO._leaves(stacked):
            node = tree["params"]
            for k in path:
                node = node[k]
            np.testing.assert_array_equal(node, leaf)
        return
    dst = _cpu_mesh(target)
    specs = TSH.param_specs(cfg, dst)
    step, tree = m.restore(shardings={"params": TSH.to_named(specs, dst)})
    assert step == 3
    want = TSH.shard_tree(stacked, specs, dst)
    for (_, a), (_, b) in zip(TO._leaves(tree["params"]),
                              TO._leaves(want)):
        assert a.mesh == dst and a.spec == b.spec
        for x, y in zip(a.shards, b.shards):
            assert torch.equal(x, y)
    sm = TT.ShardedModel.from_stacked(cfg, tree["params"])
    logits, _ = TT.forward(sm, {"tokens": torch.zeros((2, 8),
                                                      dtype=torch.int32)})
    assert logits.shape == (2, 8, cfg.vocab_size)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "moonshot-v1-16b-a3b",
                                  "zamba2-1.2b", "rwkv6-3b"])
def test_host_mesh_equals_no_mesh_bit_for_bit(arch):
    """``make_host_mesh()``: the forward, three decode steps and a train
    step of a `ShardedModel` on it equal the model's without a mesh, bit
    for bit; so does a `Transformer` handed the host mesh."""
    cfg = smoke_config(arch, layers=2)
    host = TMESH.make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    tokens, steps = _inputs(cfg)
    batch = {"tokens": torch.from_numpy(tokens[:, :64])}
    model = _model(arch)
    sm = TT.ShardedModel.from_model(model, host)
    want, _ = TT.forward(model, batch)
    assert torch.equal(TT.forward(sm, batch, host)[0], want)
    assert torch.equal(TT.forward(model, batch, host)[0], want)
    c0 = TT.init_cache(cfg, BATCH, CACHE_T, device="cpu")
    c1 = TSH.shard_tree(TT.init_cache(cfg, BATCH, CACHE_T, device="cpu"),
                        TSH.cache_specs(cfg, host, BATCH, CACHE_T), host)
    for i in range(DECODE_STEPS):
        t = torch.from_numpy(steps[:, i:i + 1])
        a, c0 = TT.decode_step(model, c0, t)
        b, c1 = TT.decode_step(sm, c1, t, host)
        assert torch.equal(a, b)
    tc = TO.TrainConfig(**TRAIN)
    m0 = TT.from_jax_params(cfg, TT.to_jax_params(model), device="cpu")
    _, _, r0 = TS.make_train_step(cfg, tc)(
        m0, TO.init_opt_state(TT.param_tree(m0)), batch)
    step = TS.make_train_step(cfg, tc, host)
    opt = TSH.shard_tree(TO.init_opt_state(TT.param_tree(model)),
                         TS.opt_state_specs(step.pspecs), host)
    sm, opt, r1 = step(sm, opt, batch)
    for name in ("loss", "grad_norm"):
        assert torch.equal(r0[name], r1[name])
    for a, b in zip(m0.parameters(), sm.unshard("cpu").parameters()):
        assert torch.equal(a, b)


def test_a_transformer_on_a_larger_mesh_is_refused():
    cfg = smoke_config("qwen2.5-3b", layers=2)
    mesh = _cpu_mesh((2, 2))
    with pytest.raises(TypeError, match="ShardedModel"):
        TT.forward(_model("qwen2.5-3b"), {"tokens": torch.zeros(
            (2, 4), dtype=torch.int32)}, mesh)
    with pytest.raises(RuntimeError, match="256 cards"):
        TMESH.make_production_mesh()
    big = TMESH.make_production_mesh(multi_pod=True, device="cpu")
    assert big.shape == {"pod": 2, "data": 16, "model": 16}
    assert TS.make_train_step(cfg, TO.TrainConfig(), mesh).pspecs == \
        TSH.param_specs(cfg, mesh)


if __name__ == "__main__":
    _reference_main(sys.argv[1], ARCHS)

"""PyTorch port: checkpoints, the prefetching loader, the vocab reorder of
the weights and the training driver, against the JAX package.

Checkpoints are one format in both packages: each restores the other's,
the port's weights through `from_jax_params` and `to_jax_params` (equal
bit for bit: the same float32 values are written and read). The loader
and ``token_histogram`` are the same numpy code as the reference's, so
their arrays must be equal. The driver passes tests/test_system.py's
loss-decreases and resume tests on the CPU at their tolerances (resume:
rtol 5e-3 / atol 5e-3; the first five steps of two runs: rtol 1e-5).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.ckpt.manager import CheckpointManager as JaxManager  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.data import pipeline as jp  # noqa: E402
from repro.locality import vocab as jv  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data import pipeline as tp  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402
from repro_torch.locality import vocab as tv  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402


def _tree_equal(got, want) -> None:
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _tree_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "moonshot-v1-16b-a3b",
                                  "zamba2-1.2b", "rwkv6-3b"])
def test_to_jax_params_inverts_from_jax_params(arch):
    """Every leaf back in the reference's layout, bit for bit: stacked
    layers, the MoE's nested ``shared``, a hybrid's ``shared_attn``."""
    cfg_j = jax_smoke(arch, layers=2)
    params = jax.tree.map(np.asarray, JT.init_params(cfg_j,
                                                     jax.random.PRNGKey(0)))
    model = TT.from_jax_params(smoke_config(arch, layers=2), params, "cpu")
    _tree_equal(TT.to_jax_params(model), params)


def _saved_pair(tmp_path):
    cfg = smoke_config("qwen2.5-3b", layers=2)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = TO.init_opt_state(TT.param_tree(model))
    opt["mu"]["layers"][1]["attn"]["wq"].fill_(0.5)
    opt["step"] += 3
    CheckpointManager(tmp_path, async_save=False).save(
        7, TR.train_state(model, opt), blocking=True)
    return cfg, model, opt


def test_port_checkpoint_restores_in_both_packages(tmp_path):
    """The port saves its model and AdamW state; the reference's manager
    restores it and `from_jax_params` of its params gives the same model;
    the port's own restore gives the same model and state."""
    cfg, model, opt = _saved_pair(tmp_path)
    step, tree = JaxManager(tmp_path).restore()
    assert step == 7 and int(tree["opt"]["step"]) == 3
    assert tree["opt"]["mu"]["layers"]["attn"]["wq"].shape[0] == 2
    np.testing.assert_array_equal(tree["opt"]["mu"]["layers"]["attn"]["wq"][1],
                                  0.5)
    _tree_equal(tree["params"], TT.to_jax_params(model))
    got = TT.from_jax_params(cfg, tree["params"], "cpu")
    for a, b in zip(got.parameters(), model.parameters()):
        assert torch.equal(a, b)
    step, state = CheckpointManager(tmp_path).restore()
    model2, opt2 = TR.load_state(cfg, state, "cpu")
    assert step == 7 and int(opt2["step"]) == 3
    assert opt2["step"].dtype == torch.int32
    for a, b in zip(model2.parameters(), model.parameters()):
        assert torch.equal(a, b)
    _tree_equal(TT.stack_layers(opt2["mu"]), TT.stack_layers(opt["mu"]))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference saves its params and optimizer state; the port's
    manager restores them onto a device and the model holds the same
    weights."""
    from repro.train.optim import init_opt_state
    cfg_j = jax_smoke("qwen2.5-3b", layers=2)
    params = JT.init_params(cfg_j, jax.random.PRNGKey(1))
    opt = init_opt_state(params)
    JaxManager(tmp_path, async_save=False).save(
        4, {"params": params, "opt": opt}, blocking=True)
    step, tree = CheckpointManager(tmp_path).restore(device="cpu")
    assert step == 4
    assert isinstance(tree["params"]["embed"]["table"], torch.Tensor)
    step, tree = CheckpointManager(tmp_path).restore()
    model, opt_t = TR.load_state(smoke_config("qwen2.5-3b", layers=2), tree,
                                 "cpu")
    _tree_equal(TT.to_jax_params(model), jax.tree.map(np.asarray, params))
    assert int(opt_t["step"]) == 0 and len(opt_t["mu"]["layers"]) == 2


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_recurrent_checkpoints_cross_packages(tmp_path, arch):
    """The recurrent trunks' trees (RWKV's and Mamba2's stacked leaves, a
    hybrid's unstacked ``shared_attn``) and their AdamW moments: the
    port's checkpoint restores in the reference's manager, and the
    reference's in the port, bit for bit."""
    from repro.train.optim import init_opt_state
    cfg = smoke_config(arch, layers=2)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = TO.init_opt_state(TT.param_tree(model))
    for leaf in TO._leaves(opt["nu"]):
        leaf[1].uniform_(0, 1, generator=torch.Generator().manual_seed(2))
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    CheckpointManager(port_dir, async_save=False).save(
        3, TR.train_state(model, opt), blocking=True)
    step, tree = JaxManager(port_dir).restore()
    assert step == 3
    _tree_equal(tree["params"], TT.to_jax_params(model))
    _tree_equal(tree["opt"]["nu"], TT.stack_layers(opt["nu"]))
    params = JT.init_params(jax_smoke(arch, layers=2), jax.random.PRNGKey(1))
    JaxManager(ref_dir, async_save=False).save(
        5, {"params": params, "opt": init_opt_state(params)}, blocking=True)
    step, state = CheckpointManager(ref_dir).restore()
    got, opt_t = TR.load_state(cfg, state, "cpu")
    assert step == 5 and int(opt_t["step"]) == 0
    _tree_equal(TT.to_jax_params(got), jax.tree.map(np.asarray, params))


def test_ckpt_roundtrip(tmp_path):
    """tests/test_substrate.py::test_ckpt_roundtrip on the port, tensors
    in."""
    m = CheckpointManager(tmp_path, keep=2, async_save=False)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"mu": torch.zeros((2, 3)),
                     "step": torch.tensor(5, dtype=torch.int32)}}
    m.save(3, state, blocking=True)
    step, got = m.restore()
    assert step == 3
    np.testing.assert_array_equal(got["params"]["w"],
                                  np.arange(6.0).reshape(2, 3))
    assert int(got["opt"]["step"]) == 5


def test_ckpt_keep_k_gc(tmp_path):
    m = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        m.save(s, {"x": torch.ones(3) * s}, blocking=True)
    assert m.all_steps() == [3, 4]


def test_ckpt_ignores_uncommitted(tmp_path):
    m = CheckpointManager(tmp_path, keep=3, async_save=False)
    m.save(1, {"x": torch.ones(2)}, blocking=True)
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000003").mkdir()
    assert m.all_steps() == [1]
    step, _ = m.restore()
    assert step == 1


def test_ckpt_async_snapshots_before_in_place_updates(tmp_path):
    """An async save holds the values at the call: an in-place update
    right after it does not reach the file."""
    m = CheckpointManager(tmp_path, keep=3, async_save=True)
    x = torch.full((4,), 7.0)
    m.save(7, {"x": x})
    x.fill_(-1.0)
    m.wait()
    step, got = m.restore()
    assert step == 7 and float(got["x"][0]) == 7.0


def test_ckpt_refuses_shardings(tmp_path):
    """``restore(shardings=)`` refuses a tree that is not the
    checkpoint's; a matching one cuts each leaf by its spec onto its mesh
    (tests/test_torch_mesh.py holds the elastic restore of a model)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import NamedSharding, P
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(1, {"w": torch.arange(8.0)}, blocking=True)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="not the checkpoint's"):
        m.restore(shardings={"v": NamedSharding(mesh, P("data"))})
    _, tree = m.restore(shardings={"w": NamedSharding(mesh, P("data"))})
    assert [t.tolist() for t in tree["w"].shards] == [
        [0, 1, 2, 3], [0, 1, 2, 3], [4, 5, 6, 7], [4, 5, 6, 7]]


# ------------------------------------------------------------------ loader
def test_loader_prefetch_and_restart():
    """tests/test_substrate.py::test_loader_prefetch_and_restart, and the
    batches equal the reference loader's."""
    dc = tp.DataConfig(vocab_size=256, seq_len=16, global_batch=2)
    l1 = tp.DataLoader(dc, start_step=0)
    b0, b1 = next(l1), next(l1)
    l1.close()
    l2 = tp.DataLoader(dc, start_step=1)
    b1b = next(l2)
    l2.close()
    assert b0["step"] == 0 and b1["step"] == 1
    assert np.array_equal(b1["tokens"], b1b["tokens"])
    ref = jp.DataLoader(jp.DataConfig(vocab_size=256, seq_len=16,
                                      global_batch=2))
    r0 = next(ref)
    ref.close()
    np.testing.assert_array_equal(b0["tokens"], r0["tokens"])


def test_loader_applies_vocab_reorder():
    dc = tp.DataConfig(vocab_size=256, seq_len=16, global_batch=2)
    counts = tp.token_histogram(dc, 1)
    np.testing.assert_array_equal(counts, jp.token_histogram(
        jp.DataConfig(vocab_size=256, seq_len=16, global_batch=2), 1))
    vr = tv.degree_permutation(counts, hot_fraction=0.1)
    want = jv.degree_permutation(counts, hot_fraction=0.1)
    np.testing.assert_array_equal(vr.perm, want.perm)
    np.testing.assert_array_equal(vr.inverse, want.inverse)
    assert (vr.hot_size, vr.scheme) == (want.hot_size, want.scheme)
    plain = tp.DataLoader(dc)
    mapped = tp.DataLoader(dc, vocab_reorder=vr)
    a, b = next(plain), next(mapped)
    plain.close()
    mapped.close()
    assert np.array_equal(vr.perm[a["tokens"]], b["tokens"])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "starcoder2-7b"])
def test_apply_to_params_matches_the_reference(arch):
    """The permuted table (and an untied head's columns) equal the
    reference's ``apply_to_params`` bit for bit, and the permuted model
    gives the logits permuted over the vocab (tests/test_substrate.py::
    test_vocab_reorder_apply_to_params_consistent)."""
    cfg_j = jax_smoke(arch, layers=2)
    cfg_t = smoke_config(arch, layers=2)
    params = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    model = TT.from_jax_params(cfg_t, jax.tree.map(np.asarray, params),
                               "cpu")
    counts = np.random.default_rng(0).integers(1, 100, cfg_t.vocab_size)
    vr = tv.degree_permutation(counts)
    tokens = np.random.default_rng(1).integers(
        0, cfg_t.vocab_size, (2, 8)).astype(np.int32)
    before, _ = TT.forward(model, {"tokens": torch.from_numpy(tokens)})
    assert vr.apply_to_params(model) is model
    want = jv.degree_permutation(counts).apply_to_params(params)
    _tree_equal(TT.to_jax_params(model)["embed"],
                jax.tree.map(np.asarray, want["embed"]))
    after, _ = TT.forward(model, {"tokens": torch.from_numpy(
        vr.map_tokens(tokens).astype(np.int32))})
    np.testing.assert_allclose(
        before.float().numpy(),
        after.float().numpy()[..., vr.perm], rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------------ driver
def _main(args, tmp_path):
    return TR.main(args + ["--ckpt-dir", str(tmp_path), "--device", "cpu"])


def test_train_loop_loss_decreases(tmp_path):
    """tests/test_system.py::test_train_loop_loss_decreases on the port."""
    losses = _main(["--arch", "qwen2.5-3b", "--steps", "25", "--smoke",
                    "--layers", "2", "--seq-len", "64", "--global-batch",
                    "4", "--ckpt-every", "0", "--lr", "1e-3",
                    "--log-every", "100"], tmp_path)
    assert len(losses) == 25
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_train_resume_continues(tmp_path):
    """tests/test_system.py::test_train_resume_continues on the port: run
    0-9, then 0-4, "crash", and resume 5-9 from the step-4 checkpoint."""
    import shutil
    args = ["--arch", "qwen2.5-3b", "--smoke", "--layers", "2",
            "--seq-len", "32", "--global-batch", "2", "--ckpt-every", "5",
            "--total-steps", "10", "--no-vocab-reorder", "--log-every",
            "100"]
    full = _main(["--steps", "10"] + args, tmp_path)
    shutil.rmtree(tmp_path)
    part = _main(["--steps", "5"] + args, tmp_path)
    cont = _main(["--steps", "10", "--resume"] + args, tmp_path)
    np.testing.assert_allclose(part[:5], full[:5], rtol=1e-5)
    np.testing.assert_allclose(cont, full[5:], rtol=5e-3, atol=5e-3)


def test_no_final_ckpt_keeps_only_the_periodic_saves(tmp_path):
    """``--no-final-ckpt``, the port's own flag: a run without periodic
    saves leaves no checkpoint, one with ``--ckpt-every 3`` only its step
    2, and ``--resume`` continues from that step as the uninterrupted run
    does (test_train_resume_continues's standard)."""
    args = ["--arch", "qwen2.5-3b", "--smoke", "--layers", "2",
            "--seq-len", "32", "--global-batch", "2", "--total-steps", "10",
            "--no-vocab-reorder", "--log-every", "100", "--no-final-ckpt"]
    full = _main(["--steps", "10", "--ckpt-every", "0"] + args, tmp_path)
    assert CheckpointManager(tmp_path).all_steps() == []
    part = _main(["--steps", "5", "--ckpt-every", "3"] + args, tmp_path)
    assert CheckpointManager(tmp_path).all_steps() == [2]
    cont = _main(["--steps", "10", "--resume", "--ckpt-every", "0"] + args,
                 tmp_path)
    assert CheckpointManager(tmp_path).all_steps() == [2]
    np.testing.assert_allclose(part, full[:5], rtol=1e-5)
    np.testing.assert_allclose(cont, full[3:], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_recurrent_train_resume_continues(tmp_path, arch):
    """`test_train_resume_continues` on the recurrent trunks (the
    sequence a multiple of both chunks, 16 and 8): the resumed steps
    repeat the uninterrupted run's."""
    import shutil
    args = ["--arch", arch, "--smoke", "--layers", "2", "--seq-len", "32",
            "--global-batch", "2", "--ckpt-every", "3", "--total-steps",
            "6", "--no-vocab-reorder", "--log-every", "100"]
    full = _main(["--steps", "6"] + args, tmp_path)
    shutil.rmtree(tmp_path)
    part = _main(["--steps", "3"] + args, tmp_path)
    cont = _main(["--steps", "6", "--resume"] + args, tmp_path)
    np.testing.assert_allclose(part[:3], full[:3], rtol=1e-5)
    np.testing.assert_allclose(cont, full[3:], rtol=5e-3, atol=5e-3)


def test_train_refuses_an_embedding_fed_arch(tmp_path):
    with pytest.raises(SystemExit, match="embedding-fed"):
        _main(["--arch", "hubert-xlarge", "--smoke", "--steps", "1"],
              tmp_path)

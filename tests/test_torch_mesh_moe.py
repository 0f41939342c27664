"""PyTorch port: the MoE LMs on a (data, model) mesh agree with the JAX
package's sharded run, through the TP-within-expert capacity dispatch.

The setting, the reference's subprocess and the tolerances are
tests/test_torch_mesh.py's (its helpers run here for moonshot-v1-16b-a3b
and mixtral-8x7b, in a subprocess of their own). The logits hold at 95%
of the positions, since routing parts at near-ties; the dropped rows are
held exactly on the reference's own expert choices (`RouteTape` replays
each shard's choices, call by call), so that a near-tie cannot move
them. ``ef_compressed_psum`` runs here against the reference's inside
``shard_map`` over a 4-way ``pod`` axis, at 1e-6 relative.
"""
from __future__ import annotations

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import (MOE_ARCHS, SHAPES, _cpu_mesh, _ef_inputs,  # noqa: E402
                             _hold, _key, _reference_main, decode_case,
                             forward_case, run_reference, train_case)
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402

CASES = [(a, s) for a in MOE_ARCHS for s in SHAPES]
IDS = [f"{a}-{s[0]}x{s[1]}" for a, s in CASES]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__, tmp_path_factory)


def _replay(reference, arch, shape):
    """The reference's expert choices, in the port's call order: layer by
    layer, shards in mesh order."""
    mesh = _cpu_mesh(shape)
    out = []
    for layer in range(smoke_config(arch, layers=2).num_layers):
        for i in range(mesh.size):
            c = mesh.coords(i)
            out.append(torch.from_numpy(reference[_key(
                arch, shape, f"exp{c['data']}{c['model']}_{layer}")]).long())
    return out


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_forward_matches_the_sharded_reference(reference, arch, shape):
    """Free-running, the logits meet the standard at 95% of the positions;
    one capacity dispatch a shard a layer, at the reference's
    capacity."""
    logits, tape = forward_case(reference, arch, shape)
    _hold(arch, logits, reference[_key(arch, shape, "logits")])
    cfg = smoke_config(arch, layers=2)
    assert len(tape.calls) == cfg.num_layers * _cpu_mesh(shape).size
    assert {c[0] for c in tape.calls} == {int(reference[
        _key(arch, shape, "cap")])}


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_capacity_drops_the_references_rows(reference, arch, shape):
    """On the reference's expert choices, each shard's dispatch drops the
    reference's (token, expert) pairs, call by call, and some rows do
    drop (the skewed router sends most tokens to expert 0)."""
    replay = _replay(reference, arch, shape)
    logits, tape = forward_case(reference, arch, shape, replay)
    _hold(arch, logits, reference[_key(arch, shape, "logits")])
    mesh = _cpu_mesh(shape)
    assert tape.totals()["dropped"] > 0
    for j, pairs in enumerate(tape.dropped()):
        layer, i = divmod(j, mesh.size)
        c = mesh.coords(i)
        np.testing.assert_array_equal(pairs, reference[_key(
            arch, shape, f"drop{c['data']}{c['model']}_{layer}")])


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_decode_matches_the_sharded_reference(reference, arch, shape):
    """Three decode steps (moonshot's cache split by kv head, mixtral's
    8-slot window ring whole on every model shard)."""
    decode_case(reference, arch, shape)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_train_step_matches_the_sharded_reference(reference, arch, shape):
    """One step in two microbatches (each microbatch's rows split over the
    data shards, so the rows that meet in a dispatch are the
    reference's)."""
    train_case(reference, arch, shape)


def test_ef_compressed_psum_matches_the_reference(reference):
    """Over a 4-way ``pod`` axis: the mean of the decompressed gradients
    and each shard's new residual."""
    g, e = _ef_inputs()
    mesh = TMESH.make_mesh((4,), ("pod",), device="cpu")
    mean, errs = TO.ef_compressed_psum(
        {"w": [torch.from_numpy(x) for x in g[:, None]]},
        {"w": [torch.from_numpy(x) for x in e[:, None]]}, "pod", mesh)
    np.testing.assert_allclose(np.concatenate([t.numpy() for t in mean["w"]]),
                               reference["ef_mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.concatenate([t.numpy() for t in errs["w"]]),
                               reference["ef_err"], rtol=1e-6, atol=1e-7)


if __name__ == "__main__":
    _reference_main(sys.argv[1], MOE_ARCHS, with_ef=True)

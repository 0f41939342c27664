"""PyTorch port: the MoE FFN's gradients agree with the JAX package.

The grouped matmul's backward (`ops.ragged_dot`, an autograd Function
whose dX is `gmm` on the transposed expert stack and whose dW is `tgmm`)
runs here through the kernels' plain versions, the path the card takes
with its kernels. The same numpy operands, made from seeds, go through
``jax.vjp`` of ``jax.lax.ragged_dot`` (what the reference's expert FFN
differentiates) and of the reference's ``_dispatch_local``, and through
the port. Tolerances, each with its reason:

* `ragged_dot`'s dX and dW in bf16: within one bf16 unit of the
  reference's value (both are float32 sums of exact bf16 products
  rounded once, and two sums taken in different orders may round to
  neighbouring values); in float32 at tests/test_kernels.py's rtol/atol
  1e-4 (the same products summed in another order);
* `tgmm_grouped_ref` against a per-row einsum oracle: float32 at 1e-4;
  its bf16 result is its float32 result rounded once, exactly;
* `_dispatch_local`'s gradients (x and the three float32 expert stacks)
  on the same routing: relative L2 within 1e-2 a leaf (w_up and w_down
  equal the reference's bit for bit; x and w_gate, which the silu's
  backward reaches, part by 3.8e-3 to 4.0e-3, since its bf16
  intermediates round at other places in XLA's autodiff and torch's
  autograd);
* the gather's backward (`moe._GatherRows`): bit for bit against the
  port's autograd of ``x_flat[tok]`` before it had its own backward and
  against the reference's scatter-add (each token's k rows added to zero
  one by one in bf16, in the order of the sort).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm as T  # noqa: E402
from repro_torch.kernels.moe_gmm.ops import ragged_dot  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import tgmm_grouped_ref  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_kernels.py:121
DISPATCH_REL_L2 = 1e-2


def _bf16(a: np.ndarray):
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()


def _within_one_bf16_unit(got: torch.Tensor, want) -> None:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(w), np.finfo(np.float32).tiny)
    unit = 2.0 ** (np.floor(np.log2(mag)) - 7)   # bf16: 8 significant bits
    assert np.all(np.abs(g - w) <= unit), float(np.abs(g - w).max())


def _offsets(sizes) -> torch.Tensor:
    return torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                        dtype=torch.int32)


# tests/test_torch_moe_gmm.py's `ragged_dot` cases
CASES = [
    ([3, 0, 5, 2], 10, 64, 128),        # the smoke widths, a zero group
    ([0, 0, 7, 0], 12, 64, 128),        # rows past the total: zeros
    ([17, 40, 1, 0, 6], 64, 128, 64),   # the smoke down projection
    ([0, 0, 0], 5, 16, 8),              # no rows in any group
    ([200, 0, 56], 256, 40, 24),        # K, N multiples of 8, not of 16
]


@pytest.mark.parametrize("sizes,m,k,n", CASES)
def test_ragged_dot_grads_match_jax_vjp(sizes, m, k, n):
    """dX and dW of `ragged_dot` against ``jax.vjp`` of
    ``jax.lax.ragged_dot`` on the same bf16 operands and cotangent (one
    bf16 unit), then in float32 (`TOL`). Rows past the groups' total get
    a zero dX; an empty group a zero dW."""
    rng = np.random.default_rng(sum(sizes) + m + 1)
    jx, tx = _bf16(rng.standard_normal((m, k)))
    jw, tw = _bf16(0.2 * rng.standard_normal((len(sizes), k, n)))
    jdy, tdy = _bf16(rng.standard_normal((m, n)))
    gs = jnp.asarray(np.array(sizes, np.int32))
    _, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, gs), jx, jw)
    want_dx, want_dw = vjp(jdy)
    assert want_dx.dtype == want_dw.dtype == jnp.bfloat16
    x, w = tx.requires_grad_(True), tw.requires_grad_(True)
    ragged_dot(x, w, torch.from_numpy(np.array(sizes))).backward(tdy)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    _within_one_bf16_unit(x.grad, want_dx)
    _within_one_bf16_unit(w.grad, want_dw)
    assert not x.grad[sum(sizes):].any()
    for e in np.flatnonzero(np.array(sizes) == 0):
        assert not w.grad[e].any()

    x32 = tx.detach().float().requires_grad_(True)
    w32 = tw.detach().float().requires_grad_(True)
    ragged_dot(x32, w32, torch.from_numpy(np.array(sizes))).backward(
        tdy.float())
    _, vjp32 = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, gs),
                       jx.astype(jnp.float32), jw.astype(jnp.float32))
    dx32, dw32 = vjp32(jdy.astype(jnp.float32))
    np.testing.assert_allclose(x32.grad.numpy(), np.asarray(dx32), **TOL)
    np.testing.assert_allclose(w32.grad.numpy(), np.asarray(dw32), **TOL)


def test_ragged_dot_grads_are_the_plain_versions():
    """The Function's backward is `gmm` of dY times each ``w[e]ᵀ`` (the
    stack read transposed, equal to a transposed copy's product) and
    `tgmm`, each rounded once to its operand's dtype; x alone or w alone
    may require a gradient; the CPU launches nothing."""
    rng = np.random.default_rng(11)
    sizes = [5, 0, 9, 2]
    _, x = _bf16(rng.standard_normal((20, 32)))
    _, w = _bf16(rng.standard_normal((4, 32, 16)))
    _, dy = _bf16(rng.standard_normal((20, 16)))
    offs = _offsets(sizes)
    before = dict(T.launches_by_variant)
    for need_x, need_w in ((True, True), (True, False), (False, True)):
        a = x.clone().requires_grad_(need_x)
        b = w.clone().requires_grad_(need_w)
        ragged_dot(a, b, torch.tensor(sizes)).backward(dy)
        if need_x:
            assert torch.equal(a.grad, T.gmm(
                dy, w, offs, out_dtype=torch.bfloat16, w_transposed=True))
            assert torch.equal(a.grad, T.gmm(
                dy, w.transpose(1, 2).contiguous(), offs,
                out_dtype=torch.bfloat16))
        else:
            assert a.grad is None
        if need_w:
            assert torch.equal(b.grad, tgmm_grouped_ref(
                x, dy, offs, torch.bfloat16))
        else:
            assert b.grad is None
    assert T.launches_by_variant == before


@pytest.mark.parametrize("offs,m", [
    ([0, 3, 3, 10], 10),                # an empty group
    ([0, 0, 7, 7], 12),                 # rows past the total: ignored
    ([0, 40, 64, 64, 64], 64),          # empty groups at the end
    ([0, 0, 0], 5),                     # no rows in any group
    ([0, 6, 30], 20),                   # offsets past M: clipped
    ([0, 136], 136),                    # one group holding every row
])
def test_tgmm_ref_matches_the_per_row_oracle(offs, m):
    """``out[e] = sum over group e's rows of x[i]ᵀ dy[i]`` against an
    einsum over a one-hot row-to-group map (the transposed counterpart of
    `gmm_ref`), float32 at `TOL`; bf16 operands give the float32 sum
    rounded once; `tgmm` on the CPU is the plain version."""
    rng = np.random.default_rng(m + len(offs))
    k, n, e = 24, 40, len(offs) - 1
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    o = torch.tensor(offs, dtype=torch.int32)
    clipped = np.minimum(np.array(offs), m)
    row_group = np.full(m, -1)
    for g in range(e):
        row_group[clipped[g]:clipped[g + 1]] = g
    onehot = torch.from_numpy((row_group[:, None] == np.arange(e)).astype(
        np.float32))
    want = torch.einsum("mk,mn,me->ekn", x, dy, onehot)
    got = tgmm_grouped_ref(x, dy, o)
    assert got.dtype == torch.float32 and got.shape == (e, k, n)
    torch.testing.assert_close(got, want, **TOL)
    for g in range(e):
        if clipped[g + 1] <= clipped[g]:
            assert not got[g].any()
    assert torch.equal(T.tgmm(x, dy, o), got)
    xb, db = x.bfloat16(), dy.bfloat16()
    half = tgmm_grouped_ref(xb, db, o, torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, tgmm_grouped_ref(xb, db, o).bfloat16())


# ------------------------------------------------------- _dispatch_local
def _moe_inputs(arch, t, seed):
    cfg_j, cfg_t = jax_smoke(arch, layers=1), smoke_config(arch, layers=1)
    p = JM.init_moe(jax.random.PRNGKey(seed), cfg_j)
    jx, tx = _bf16(np.random.default_rng(seed).standard_normal(
        (t, cfg_j.d_model)))
    experts, gates, _ = JM._route(p, jx, cfg_j)
    stacks = [np.asarray(p[n]) for n in ("w_gate", "w_up", "w_down")]
    return cfg_j, cfg_t, jx, tx, np.array(experts), np.array(gates), \
        stacks


@pytest.mark.parametrize("arch,t", [("moonshot-v1-16b-a3b", 24),
                                    ("moonshot-v1-16b-a3b", 97),
                                    ("mixtral-8x7b", 40)])
def test_dispatch_local_grads_match_jax(arch, t):
    """The gradients of `_dispatch_local` with respect to the tokens and
    the three float32 expert stacks against ``jax.vjp`` of the
    reference's, on the reference's routing and one bf16 cotangent:
    relative L2 within `DISPATCH_REL_L2` a leaf."""
    cfg_j, cfg_t, jx, tx, experts, gates, stacks = _moe_inputs(arch, t, 2)
    e = cfg_j.num_experts
    jdy, tdy = _bf16(np.random.default_rng(t).standard_normal(
        (t, cfg_j.d_model)))

    def ref(x, wg, wu, wd):
        return JM._dispatch_local(x, jnp.asarray(experts), jnp.asarray(gates),
                                  wg, wu, wd, e, 0)
    out, vjp = jax.vjp(ref, jx, *map(jnp.asarray, stacks))
    want = vjp(jdy.astype(out.dtype))
    leaves = [tx.clone().requires_grad_(True)] + [
        torch.from_numpy(s.copy()).requires_grad_(True) for s in stacks]
    y = TM._dispatch_local(leaves[0], torch.from_numpy(experts).long(),
                           torch.from_numpy(gates), *leaves[1:], e, 0)
    y.backward(tdy)
    for name, leaf, w in zip(("x", "w_gate", "w_up", "w_down"), leaves,
                             want):
        a = np.asarray(w, np.float64)
        b = leaf.grad.double().numpy()
        assert leaf.grad.dtype == leaf.dtype, name
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
        assert rel < DISPATCH_REL_L2, (name, rel)


@pytest.mark.parametrize("t,k,e", [(24, 2, 4), (97, 6, 64), (5, 6, 8)])
def test_gather_backward_keeps_the_cpu_bits(t, k, e):
    """`_GatherRows`'s backward (each token's k rows added to zero in the
    order of the sort, rounded in bf16 after each add) gives the bits of
    the port's autograd of ``x_flat[tok]`` before this backward existed
    (an accumulating index-put, in index order on the CPU), and those of
    the reference's gather transpose."""
    rng = np.random.default_rng(t * k + e)
    experts = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    flat = torch.from_numpy(experts.reshape(-1)).long()
    order = torch.argsort(flat, stable=True)
    tok = order // k
    _, jperm = torch.sort(flat.view(t, k), dim=1, stable=True)
    rank = torch.empty_like(jperm).scatter_(
        1, jperm, torch.arange(k).expand(t, k).contiguous())
    dest = tok * k + rank.reshape(-1)[order]
    jx, x = _bf16(rng.standard_normal((t, 32)))
    jg, g = _bf16(rng.standard_normal((t * k, 32)))

    a = x.clone().requires_grad_(True)
    TM._GatherRows.apply(a, tok, dest, k).backward(g)
    b = x.clone().requires_grad_(True)
    b[tok].backward(g)
    assert torch.equal(a.grad, b.grad)
    _, vjp = jax.vjp(lambda v: v[jnp.asarray(tok.numpy())], jx)
    want = np.asarray(vjp(jg)[0], np.float32)
    np.testing.assert_array_equal(a.grad.float().numpy(), want)
    # the forward is the plain gather
    assert torch.equal(TM._GatherRows.apply(x, tok, dest, k), x[tok])

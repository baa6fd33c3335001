"""The Cholesky factorization's VJP (``hopper/chol_vjp.py``) and the
exact oracle's closed-form gradient (``lmc/likelihood.py``
``ExactMLL``): the plain versions on the CPU against the JAX package's
autodiff, in float64.

- the plain VJP against ``jax.grad`` of a scalar function of
  ``jnp.linalg.cholesky`` at n in {1, 17, 64, 130}, L in either storage
  order, to 1e-12 of the largest magnitude (the same formula, rounded
  in another order: about eps times the factor's condition);
- ``chol_jittered``'s gradient against JAX's at every rung of both
  ladders, with and without equilibration (both outputs are symmetric,
  so compared entry by entry), to 1e-10 relative;
- ``exact_mll``'s value and closed-form gradient against ``jax.grad`` of
  ``runlmc_tpu.lmc.likelihood.exact_mll`` to 1e-10 relative, and NaN
  where JAX's is NaN (a K whose Cholesky fails);
- in float32, at a K of condition about 1e5, the closed form (an
  explicit float32 K^-1) no less accurate than the autograd route
  through torch's Cholesky backward: both from the same float32 K, held
  against JAX's float64 gradient, the closed form's error within 1.5
  times the route's (K's rounding times its condition dominates both;
  0.70-1.25 times on these seeds);
- a walk of the autograd graphs of ``exact_ski_mll`` and ``exact_mll``:
  no torch Cholesky backward (``LinalgCholeskyExBackward0``) is left.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import likelihood as jlk
from runlmc_tpu.lmc import woodbury as jwb
from runlmc_tpu_torch.hopper import chol_vjp as cv
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.lmc import likelihood as tlk
from runlmc_tpu_torch.lmc import woodbury as twb
from runlmc_tpu_torch.utils.carry import (
    from_reference_params,
    ravel_params,
    unravel_params,
)

KUU_LADDER = (1e-6, 1e-4, 1e-2)
C_LADDER = (0.0, 1e-6, 1e-3, 1e-1)
# lowest eigenvalues that make each rung the first to factor (as in
# tests/test_torch_chol_jitter.py)
RUNGS = {
    KUU_LADDER: {0: 0.5, 1: -5e-5, 2: -5e-3},
    C_LADDER: {0: 0.5, 1: -5e-7, 2: -5e-4, 3: -5e-2},
}


def _matrix(eig0, n=30, seed=0, graded=False):
    """Symmetric: one eigenvalue ``eig0``, the rest in [1, 2]; with
    ``graded``, D A D with D spread over four decades."""
    rng = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.concatenate([[eig0], np.linspace(1.0, 2.0, n - 1)])[:n]
    A = (U * eig) @ U.T
    if graded:
        d = np.exp(np.random.RandomState(seed + 5).uniform(-2, 2, n))
        A = d[:, None] * A * d[None, :]
    return A


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("order", ["row", "col"])
@pytest.mark.parametrize("n", [1, 17, 64, 130])
def test_plain_vjp_matches_jax(n, order):
    A = _matrix(0.5, n=n, seed=n, graded=True)
    W = np.random.RandomState(n + 1).standard_normal((n, n))

    def f(a):
        return jnp.sum(jnp.asarray(W) * jnp.linalg.cholesky(a))

    want = np.asarray(jax.grad(f)(jnp.asarray(A)))
    L = torch.linalg.cholesky(torch.as_tensor(A))
    L = L.contiguous() if order == "row" else L.mT.contiguous().mT
    got = cv.cholesky_backward(L, torch.tril(torch.as_tensor(W)))
    assert torch.equal(got, got.mT)
    _close(got, want, 1e-12)
    # the upper triangle of L-bar does not enter
    _close(cv.cholesky_backward(L, torch.as_tensor(W)), want, 1e-12)


def test_cholesky_ex_backward_is_the_hand_vjp():
    """CholeskyEx's forward is cholesky_ex's, bit for bit, factoring its
    input in place (a leaf that requires grad is refused, as for any
    in-place op), and its backward cholesky_backward's; info carries no
    gradient."""
    A = torch.as_tensor(_matrix(0.5, n=20, graded=True)).requires_grad_(True)
    with pytest.raises(RuntimeError):
        cv.cholesky_ex(A)
    M = A.clone()
    L, info = cv.cholesky_ex(M)
    L0, info0 = torch.linalg.cholesky_ex(A.detach())
    assert L is M
    assert torch.equal(L, L0) and torch.equal(info, info0)
    assert not info.requires_grad
    G = torch.randn(20, 20, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    (got,) = torch.autograd.grad(L, A, G)
    assert torch.equal(got, cv.cholesky_backward(L0, G))


def _jittered_cases():
    for ladder, rungs in RUNGS.items():
        for rung in rungs:
            yield ladder, rung


@pytest.mark.parametrize("equilibrate", [True, False])
@pytest.mark.parametrize("ladder,rung", list(_jittered_cases()))
def test_chol_jittered_gradient_matches_jax(ladder, rung, equilibrate):
    """The whole jittered factorization's gradient (K3's backward around
    the hand Cholesky VJP) against jax.grad of the reference, entry by
    entry: both are symmetric."""
    A = _matrix(RUNGS[ladder][rung], graded=equilibrate)
    w = np.random.RandomState(1).standard_normal(A.shape)

    def f_j(a):
        L = jwb.chol_jittered(a, scales=ladder, equilibrate=equilibrate)
        return jnp.sum(jnp.tril(jnp.asarray(w)) * L)

    want = np.asarray(jax.jit(jax.grad(f_j))(jnp.asarray(A)))
    At = torch.as_tensor(A).requires_grad_(True)
    L = twb.chol_jittered(At, scales=ladder, equilibrate=equilibrate)
    (got,) = torch.autograd.grad(
        torch.sum(torch.tril(torch.as_tensor(w)) * L), At)
    assert np.all(np.isfinite(got.numpy()))
    _close(got, want, 1e-10)


def _oracle_problem(seed=0, dup=False):
    """(JAX spec, port spec, X, oidx, y, raw params): 3 outputs on 1-D
    inputs, an lmc RBF of rank 2 and an indep Matern32; with ``dup``,
    every output's points coincide and the noise is negligible, so K
    is rank-deficient and its Cholesky fails."""
    rng = np.random.RandomState(seed)
    lens = (14, 11, 9)
    if dup:
        X = np.full((sum(lens), 1), 0.3)
    else:
        X = rng.uniform(0, 3, (sum(lens), 1))
    oidx = np.repeat(np.arange(3), lens).astype(np.int32)
    y = np.sin(2 * X[:, 0]) + 0.1 * rng.standard_normal(len(X))

    def mk(pkg):
        return pkg.LMCKernelSpec.create(
            D=3, lmc_kernels=[pkg.RBF()], lmc_ranks=[2],
            indep_gp=[pkg.Matern32(name="i")]).with_input_dim(1)

    sj, st = mk(R), mk(T)
    raw = jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)),
        sj.init_raw_params(seed=seed))
    if dup:
        raw = dict(raw)
        raw["noise"] = np.full_like(np.asarray(raw["noise"]), -200.0)
    return sj, st, X, oidx, y, raw


def _oracle_grads(sj, st, X, oidx, y, raw):
    def fj(p):
        return jlk.exact_mll(sj, p, jnp.asarray(X), jnp.asarray(oidx),
                             jnp.asarray(y))

    pj = jax.tree.map(jnp.asarray, raw)
    vj, gj = jax.value_and_grad(fj)(pj)
    gj, _ = ravel_pytree(gj)
    pt = from_reference_params(raw, torch.float64, "cpu")
    x = ravel_params(pt).requires_grad_(True)
    vt = tlk.exact_mll(st, unravel_params(x, pt), torch.as_tensor(X),
                       torch.as_tensor(oidx), torch.as_tensor(y))
    (gt,) = torch.autograd.grad(vt, x)
    return float(vj), np.asarray(gj), float(vt.detach()), gt.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_mll_closed_form_matches_jax(seed):
    vj, gj, vt, gt = _oracle_grads(*_oracle_problem(seed))
    np.testing.assert_allclose(vt, vj, rtol=1e-12)
    _close(gt, gj, 1e-10)


def test_exact_mll_nan_where_jax_is_nan():
    vj, gj, vt, gt = _oracle_grads(*_oracle_problem(dup=True))
    assert np.isnan(vj) and np.isnan(vt)
    assert np.array_equal(np.isnan(gt), np.isnan(gj))
    assert np.all(np.isnan(gj))


def _mll_autograd(spec, raw_params, X, oidx, y):
    """The exact MLL through torch's Cholesky backward: the route the
    closed form replaced, as the float32 yardstick."""
    from runlmc_tpu_torch.hopper.trsm import cho_solve

    L = tlk._chol_or_nan(tlk.exact_dense_K(spec, raw_params, X, oidx))
    alpha = cho_solve(L, y[None])[0]
    return -0.5 * (torch.dot(y, alpha)
                   + 2.0 * torch.sum(torch.log(torch.diagonal(L)))
                   + y.shape[0] * math.log(2 * math.pi))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exact_mll_float32_closed_form_as_accurate_as_autograd(seed):
    sj, st, X, oidx, y, raw = _oracle_problem(seed)
    raw = dict(raw)
    raw["noise"] = np.asarray(raw["noise"]) - 6.0  # K's condition ~1e5
    _, want, _, _ = _oracle_grads(sj, st, X, oidx, y, raw)

    def grad32(fn):
        pt = from_reference_params(raw, torch.float32, "cpu")
        x = ravel_params(pt).requires_grad_(True)
        v = fn(st, unravel_params(x, pt),
               torch.as_tensor(X, dtype=torch.float32),
               torch.as_tensor(oidx), torch.as_tensor(y, dtype=torch.float32))
        (g,) = torch.autograd.grad(v, x)
        return np.abs(g.double().numpy() - want).max() / np.abs(want).max()

    closed, route = grad32(tlk.exact_mll), grad32(_mll_autograd)
    assert 1e-5 < route < 1e-2  # the float32 rounding shows, and is bounded
    assert closed <= 1.5 * route


def _node_names(t):
    seen, names, stack = set(), set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def test_no_torch_cholesky_backward_on_the_exact_paths():
    """The autograd graphs of the exact SKI MLL (every factorization:
    K_UU and C) and of the exact oracle hold the hand VJP's node and the
    closed form's, and no LinalgCholeskyExBackward0."""
    rng = np.random.RandomState(3)
    Xs = [rng.uniform(0, 4, (n, 1)) for n in (26, 31)]
    y = np.concatenate([np.sin(3 * X[:, 0]) for X in Xs])
    st = T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()], lmc_ranks=[2],
                                indep_gp=[T.Matern32(name="i")]
                                ).with_input_dim(1)
    pt = from_reference_params(st.init_raw_params(seed=0), torch.float64,
                               "cpu")
    x = ravel_params(pt).requires_grad_(True)
    p = unravel_params(x, pt)
    grids, _ = tgrid.make_grids(st, Xs, m=[10])
    gd = tuple(g.to(torch.float64, "cpu") for g in grids)
    mll, _ = tlk.exact_ski_mll(st, p, gd, [len(X) for X in Xs],
                               torch.as_tensor(y))
    names = _node_names(mll)
    assert "CholeskyExBackward" in names
    assert "LinalgCholeskyExBackward0" not in names
    flat = tlk.flatten_data(Xs, [y[:26], y[26:]])
    oracle = tlk.exact_mll(st, p, torch.as_tensor(flat.X),
                           torch.as_tensor(flat.output_idx),
                           torch.as_tensor(flat.y))
    names = _node_names(oracle)
    assert "ExactMLLBackward" in names
    assert "LinalgCholeskyExBackward0" not in names

"""K5: ``trsm_lower``, ``cho_solve`` and ``ChoSolve``'s hand-written
backward — the port against ``jax.scipy.linalg`` and against torch's own
``cholesky_solve`` rule on the same numpy inputs, in float64 on the CPU
(where the wrappers run their plain versions and the backward formula is
the autograd function's own); then the exact likelihoods that run
through K5, and the wrapper's input checks."""

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu.lmc import likelihood as jlk
from runlmc_tpu_torch.hopper import trsm
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.lmc import likelihood as tlk
from runlmc_tpu_torch.lmc import woodbury as twb
from runlmc_tpu_torch.utils.carry import (
    _leaves,
    from_reference_params,
    ravel_params,
    unravel_params,
)

KS = [64, 200, 333]  # 333 is not a multiple of the kernel's 64-row block
# solves of a factor with condition number <= 10: the plain versions and
# LAPACK/XLA differ by rounding only
FWD_RTOL = 1e-12
GRAD_RTOL = 1e-10


def _factor(k, seed=0):
    """Lower Cholesky factor of a seeded SPD matrix with eigenvalues
    spread over [1, 10] (condition number 10)."""
    rng = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rng.standard_normal((k, k)))
    A = (U * np.linspace(1.0, 10.0, k)) @ U.T
    return np.linalg.cholesky((A + A.T) / 2)


def _rhs(c, k, seed=1):
    return np.random.RandomState(seed).standard_normal((c, k))


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("c", ["1", "16", "k"])
@pytest.mark.parametrize("k", KS)
def test_trsm_lower_matches_jax(k, c, trans):
    c = k if c == "k" else int(c)
    L, B = _factor(k), _rhs(c, k)
    want = jsl.solve_triangular(jnp.asarray(L), jnp.asarray(B.T), lower=True,
                                trans=1 if trans else 0).T
    before = dict(trsm.trsm_lower.launches)
    got = trsm.trsm_lower(torch.as_tensor(L), torch.as_tensor(B), trans=trans)
    _close(got.numpy(), want, FWD_RTOL)
    assert trsm.trsm_lower.launches == before  # the CPU launches nothing


@pytest.mark.parametrize("c", ["1", "16", "k"])
@pytest.mark.parametrize("k", KS)
def test_cho_solve_matches_jax(k, c):
    c = k if c == "k" else int(c)
    L, S = _factor(k), _rhs(c, k)
    want = jsl.cho_solve((jnp.asarray(L), True), jnp.asarray(S.T)).T
    for Lt in (torch.as_tensor(L), torch.as_tensor(L).mT.contiguous().mT):
        _close(trsm.cho_solve(Lt, torch.as_tensor(S)).numpy(), want,
               FWD_RTOL)


# the kernel's order on the CPU: up to LOOKAHEAD + 1 = 3 blocks (k <= 130)
# the chain alone, 300 (5 blocks) with helpers' lagged sums; 63, 65 and
# 130 end in a ragged block
SCHED_KS = [1, 63, 64, 65, 130, 300]
SCHED_RTOL = 1e-10


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("c", [1, 3, 16])
@pytest.mark.parametrize("k", SCHED_KS)
def test_trsm_lower_schedule_matches_jax(k, c, trans):
    L, B = _factor(k), _rhs(c, k)
    want = jsl.solve_triangular(jnp.asarray(L), jnp.asarray(B.T), lower=True,
                                trans=1 if trans else 0).T
    # the upper triangle is never read
    Lg = L + np.triu(np.full((k, k), 7.0), 1)
    got = trsm.trsm_lower_schedule(torch.as_tensor(Lg), torch.as_tensor(B),
                                   trans=trans)
    _close(got.numpy(), want, SCHED_RTOL)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("nblocks", [1, 2, 3, 4, 7])
def test_schedule_plan_splits_by_step_and_lookahead(nblocks, trans):
    """Each step takes every block solved before it once, in the order
    they were solved: the helpers' blocks, then the chain's last
    LOOKAHEAD."""
    plan = trsm.schedule_plan(nblocks, trans)
    order = [b for b, _, _ in plan]
    assert order == (list(range(nblocks))[::-1] if trans
                     else list(range(nblocks)))
    for s, (_, helper_blocks, chain_blocks) in enumerate(plan):
        assert helper_blocks + chain_blocks == order[:s]
        assert len(chain_blocks) == min(s, trsm.LOOKAHEAD)


def _grads(fn, L, S, G):
    Lt = torch.as_tensor(L).requires_grad_(True)
    St = torch.as_tensor(S).requires_grad_(True)
    return torch.autograd.grad(fn(Lt, St), (Lt, St), torch.as_tensor(G))


@pytest.mark.parametrize("c", [1, 16])
@pytest.mark.parametrize("k", KS)
def test_cho_solve_backward_matches_torch_cholesky_solve(k, c):
    L, S, G = _factor(k), _rhs(c, k), _rhs(c, k, seed=2)
    got = _grads(trsm.cho_solve, L, S, G)
    want = _grads(lambda L_, S_: torch.cholesky_solve(S_.mT, L_).mT, L, S, G)
    # the full (k, k) L-bar, as torch returns it, and S-bar
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), GRAD_RTOL)


@pytest.mark.parametrize("k", KS)
def test_cho_solve_backward_matches_jax_vjp(k):
    L, S, G = _factor(k), _rhs(16, k), _rhs(16, k, seed=2)
    _, vjp = jax.vjp(lambda L_, S_: jsl.cho_solve((L_, True), S_.T).T,
                     jnp.asarray(L), jnp.asarray(S))
    jL, jS = (np.asarray(a) for a in vjp(jnp.asarray(G)))
    gL, gS = _grads(trsm.cho_solve, L, S, G)
    _close(gS.numpy(), jS, GRAD_RTOL)
    # JAX's solves read only L's lower triangle, so its L-bar is the lower
    # triangle of the full one
    assert np.all(np.triu(jL, 1) == 0)
    _close(np.tril(gL.numpy()), jL, GRAD_RTOL)


def test_cho_solve_gradcheck():
    L = torch.as_tensor(_factor(12)).requires_grad_(True)
    S = torch.as_tensor(_rhs(3, 12)).requires_grad_(True)
    # the solve reads L's lower triangle: tril makes the finite
    # differences of the upper triangle agree with the full L-bar's
    assert torch.autograd.gradcheck(
        lambda L_, S_: trsm.cho_solve(torch.tril(L_), S_), (L, S))


def _spd_of(theta, W):
    return W @ W.T + torch.diag(torch.exp(theta))


@pytest.mark.parametrize("equilibrate", [True, False])
def test_full_lbar_through_chol_jittered(equilibrate):
    """The full L-bar, through cholesky_ex's backward in chol_jittered,
    gives the parameter gradient of the autograd route through
    torch.cholesky_solve."""
    rng = np.random.RandomState(4)
    theta0 = rng.standard_normal(40)
    W0 = rng.standard_normal((40, 6))
    S, G = _rhs(5, 40), _rhs(5, 40, seed=3)
    grads = []
    for solve in (trsm.cho_solve,
                  lambda L_, S_: torch.cholesky_solve(S_.mT, L_).mT):
        theta = torch.as_tensor(theta0).requires_grad_(True)
        W = torch.as_tensor(W0).requires_grad_(True)
        L = twb.chol_jittered(_spd_of(theta, W), equilibrate=equilibrate)
        X = solve(L, torch.as_tensor(S))
        grads.append(torch.autograd.grad(X, (theta, W), torch.as_tensor(G)))
    for g, w in zip(*grads):
        _close(g.numpy(), w.numpy(), 1e-12)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the plain solves that the K5 wrapper runs on the CPU."""
    calls = []
    plain = trsm.trsm_lower_plain

    def spy(L, B, trans=False):
        calls.append(trans)
        return plain(L, B, trans)

    monkeypatch.setattr(trsm, "trsm_lower_plain", spy)
    return calls


def _perturbed(raw, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)), raw
    )


def test_exact_ski_mll_runs_through_k5(plain_calls):
    """exact_ski_mll's value and gradient against JAX at the shape of the
    existing parity tests (tests/test_torch_likelihood.py and
    tests/test_torch_train.py), at their tolerances: the solve with C is
    K5's cho_solve, and its backward two more K5 solves."""
    rng = np.random.RandomState(3)
    Xs = [rng.uniform(0, 4, (n, 1)) for n in (26, 31)]
    y = np.concatenate([np.sin(3 * X[:, 0]) + 0.1 * rng.standard_normal(
        len(X)) for X in Xs])

    def mk(pkg):
        return pkg.LMCKernelSpec.create(
            D=2, lmc_kernels=[pkg.RBF()], lmc_ranks=[2],
            indep_gp=[pkg.Matern32(name="i")]).with_input_dim(1)

    sj, st = mk(R), mk(T)
    raw = _perturbed(sj.init_raw_params(seed=1), 2)
    lens = [len(X) for X in Xs]
    gj, _ = jgrid.make_grids(sj, Xs, m=[10])
    gt, _ = tgrid.make_grids(st, Xs, m=[10])
    want_v, want_g = jax.jit(jax.value_and_grad(
        lambda p: jlk.exact_ski_mll(sj, p, gj, lens, jnp.asarray(y))[0]))(
        jax.tree.map(jnp.asarray, raw))
    want_g = np.concatenate([np.asarray(w).ravel()
                             for w in jax.tree_util.tree_leaves(want_g)])
    pt = from_reference_params(raw, torch.float64, "cpu")
    leaves = [leaf.requires_grad_(True) for _, leaf in _leaves(pt)]
    mll, _ = tlk.exact_ski_mll(
        st, pt, tuple(gd.to(torch.float64, "cpu") for gd in gt), lens,
        torch.as_tensor(y))
    forward = len(plain_calls)
    got_g = np.concatenate([g.numpy().ravel() for g in
                            torch.autograd.grad(mll, leaves)])
    assert forward >= 2 and len(plain_calls) >= forward + 2
    np.testing.assert_allclose(mll.item(), float(want_v), rtol=1e-10)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-6,
                               atol=1e-6 * np.abs(want_g).max())


def test_exact_mll_runs_through_k5(plain_calls):
    """exact_mll's value and gradient against JAX at the shape of
    tests/test_torch_exact.py, at its tolerances: alpha is K5's cho_solve
    of one right-hand side (both triangles); the gradient is the closed
    form (likelihood.ExactMLL: K^-1 by cholesky_inverse), which solves
    nothing more with K5."""
    def mk(pkg):
        return pkg.LMCKernelSpec.create(
            D=3, lmc_kernels=[pkg.RBF(name="r", active_dims=(0,)),
                              pkg.Matern32(name="m", active_dims=(1,))],
            lmc_ranks=[1, 2], indep_gp=[pkg.IdentityKern()],
            indep_gp_index=[1]).with_input_dim(2)

    sj, st = mk(R), mk(T)
    raw = _perturbed(sj.init_raw_params(seed=0), 100)
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 2, (40, 2))
    oidx = np.sort(rng.randint(0, 3, 40)).astype(np.int32)
    y = np.sin(2 * X[:, 0]) * np.cos(X[:, 1]) + 0.1 * rng.randn(40)
    want_v, want_g = jax.jit(jax.value_and_grad(
        lambda p: jlk.exact_mll(sj, p, jnp.asarray(X), jnp.asarray(oidx),
                                jnp.asarray(y))))(
        jax.tree.map(jnp.asarray, raw))
    want_g = np.asarray(ravel_pytree(want_g)[0])
    params = from_reference_params(raw, torch.float64, "cpu")
    x = ravel_params(params).requires_grad_(True)
    got_v = tlk.exact_mll(st, unravel_params(x, params), torch.as_tensor(X),
                          torch.as_tensor(oidx), torch.as_tensor(y))
    assert plain_calls == [False, True]
    (got_g,) = torch.autograd.grad(got_v, x)
    assert plain_calls == [False, True]
    np.testing.assert_allclose(got_v.item(), float(want_v), rtol=1e-12)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-10,
                               atol=1e-10 * np.abs(want_g).max())


def test_input_checks():
    L = torch.as_tensor(_factor(8))
    B = torch.as_tensor(_rhs(3, 8))
    bad = [
        (L, B[:, :7]),                      # B's width is not k
        (L[:7], torch.as_tensor(_rhs(3, 8))),  # L is not square
        (L, B.float()),                     # dtypes differ
        (L.half(), B.half()),               # neither float32 nor float64
        (L, B.to("meta")),                  # devices differ
        (torch.as_tensor(_factor(16))[::2, ::2], B),  # L not contiguous
        (L, torch.as_tensor(_rhs(8, 3)).T),   # B not contiguous
        (L.clone().requires_grad_(True), B),  # trsm_lower has no backward
    ]
    for Lb, Bb in bad:
        with pytest.raises(ValueError):
            trsm.trsm_lower(Lb, Bb)
    # L in column-major storage is taken as it is
    _close(trsm.trsm_lower(L.mT.contiguous().mT, B).numpy(),
           trsm.trsm_lower(L, B).numpy(), 0.0)
    # k = 0 or c = 0: an empty (c, k) result
    assert trsm.trsm_lower(L, B[:0]).shape == (0, 8)
    assert trsm.cho_solve(L, B[:0]).shape == (0, 8)
    assert trsm.trsm_lower(L[:0, :0], B[:, :0]).shape == (3, 0)
    with torch.no_grad():  # allowed without grad mode
        trsm.trsm_lower(L.clone().requires_grad_(True), B)

"""The Cholesky VJP's solve (``hopper/chol_vjp.py`` ``chol_vjp_solve``,
A-bar = L^-T S L^-1) and the host work lists of its kernels
(``csrc/chol_vjp.cu``), on the CPU against the JAX package's autodiff:

- the plain version, through ``cholesky_backward``, against ``jax.grad``
  of a scalar function of ``jnp.linalg.cholesky`` at n in {1, 63, 64,
  65, 130, 200}, L row-major and column-major, in float64 to 1e-12 of
  the largest magnitude (the same formula rounded in another order),
  and exactly symmetric;
- a blocked float64 emulation of the solve kernels' schedule: the items
  of ``solve_work`` in ticket order, each reading only tiles that items
  before it published (stage 0: L_II^T Y_I = S_I - sum_J L_JI^T Y_J;
  stage 1 on X's lower block triangle only: L_II^T X_IK = Y_KI^T -
  sum_J L_JI^T X_JK), each 64 x 64 block solved right-looking with
  reciprocal pivots, the result written entry and mirror from one value;
  against the same ``jax.grad`` at those n, to 1e-12, exactly symmetric;
- the work lists: every lower tile pair of the tri kernel once, deepest
  inner range first; every solve item once, after every item it reads;
- the float64 schedule (all of X, A-bar = 1/2 (X + X^T) written by the
  block above the diagonal) against ``jax.grad``, and the fault it
  repairs: in a 2-step exact chunk at ``exact_precision='model'`` (the
  card test's), the mirrored lower triangle of the float32 schedule
  strays past the card-vs-CPU bound of 1e-8 on the nearly singular
  float64 K_UU factor, the float64 schedule stays within it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runlmc_tpu_torch.hopper import chol_vjp as cv

NS = [1, 63, 64, 65, 130, 200]
TILE = cv.TILE


def _matrix(n, seed):
    """Graded D A D, A's eigenvalues 0.5 and [1, 2], D over four decades."""
    rng = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.concatenate([[0.5], np.linspace(1.0, 2.0, n - 1)])[:n]
    d = np.exp(np.random.RandomState(seed + 5).uniform(-2, 2, n))
    return d[:, None] * ((U * eig) @ U.T) * d[None, :]


def _case(n):
    """(L, L-bar, jax.grad of sum(L-bar * cholesky(A)))."""
    A = _matrix(n, n)
    W = np.tril(np.random.RandomState(n + 1).standard_normal((n, n)))

    def f(a):
        return jnp.sum(jnp.asarray(W) * jnp.linalg.cholesky(a))

    want = np.asarray(jax.grad(f)(jnp.asarray(A)))
    L = torch.linalg.cholesky(torch.as_tensor(A))
    return L, torch.as_tensor(W), want


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("order", ["row", "col"])
@pytest.mark.parametrize("n", NS)
def test_plain_solve_matches_jax(n, order):
    L, W, want = _case(n)
    L = L.contiguous() if order == "row" else L.mT.contiguous().mT
    got = cv.chol_vjp_solve(L, cv.chol_vjp(L, W))
    assert torch.equal(got, got.mT)
    assert torch.equal(got, cv.cholesky_backward(L, W))
    _close(got.numpy(), want, 1e-12)


def _tile(M, J, I):
    return M[J * TILE:(J + 1) * TILE, I * TILE:(I + 1) * TILE]


def _solve_block(D, R, r):
    """L_D^-T R as the solve kernel's block substitution does it: rows k
    descending, y_k = R_k (1 / D_kk), then R_m -= D_km y_k for m < k;
    rows past r stay zero."""
    R = R.copy()
    Y = np.zeros_like(R)
    for k in range(r - 1, -1, -1):
        Y[k] = R[k] * (1.0 / D[k, k])
        R[:k] -= np.outer(D[k, :k], Y[k])
    return Y


def _emulate_solve(L, S, full=False):
    """A-bar by the solve kernels' blocks and item order (``full``: the
    float64 schedule); a tile read before an earlier item published it
    raises KeyError."""
    n = L.shape[0]
    nb = -(-n // TILE)
    Lz = np.zeros((nb * TILE, nb * TILE))
    Lz[:n, :n] = np.tril(L)
    Sz = np.zeros_like(Lz)
    Sz[:n, :n] = S
    Y, Z = {}, {}
    out = np.full((n, n), np.nan)
    for stage, i, c in cv.solve_work(n, full):
        acc = _tile(Sz, i, c) if stage == 0 else Y[(c, i)].T
        for j in range(nb - 1, i, -1):
            acc = acc - _tile(Lz, j, i).T @ (Y[(j, c)] if stage == 0
                                             else Z[(j, c)])
        acc = _solve_block(_tile(Lz, i, i), acc, min(TILE, n - i * TILE))
        if stage == 0:
            Y[(i, c)] = acc
            continue
        if i > c or full:
            Z[(i, c)] = acc
        if full and i > c:
            continue  # the block (c, i) writes the pair
        other = Z[(c, i)] if full else None
        for r in range(min(TILE, n - i * TILE)):
            for k in range(min(TILE, n - c * TILE)):
                if i == c and k > r:
                    continue
                v = acc[r, k]
                if full:
                    v = 0.5 * (v + other[k, r])
                out[i * TILE + r, c * TILE + k] = v
                out[c * TILE + k, i * TILE + r] = v
    return out


@pytest.mark.parametrize("n", NS)
def test_blocked_schedule_matches_jax(n):
    L, W, want = _case(n)
    S = cv.chol_vjp_plain(L, W).numpy()
    got = _emulate_solve(L.numpy(), S)
    assert not np.isnan(got).any()  # every entry written
    assert np.array_equal(got, got.T)
    _close(got, want, 1e-12)


@pytest.mark.parametrize("n", NS)
def test_blocked_float64_schedule_matches_jax(n):
    L, W, want = _case(n)
    S = cv.chol_vjp_plain(L, W).numpy()
    got = _emulate_solve(L.numpy(), S, full=True)
    assert not np.isnan(got).any()
    assert np.array_equal(got, got.T)
    _close(got, want, 1e-12)


def _chunk(solve):
    """The card test's 2-step exact chunk at exact_precision='model' on
    the CPU, the VJP's solve by ``solve`` (numpy L, S -> A-bar)."""
    import runlmc_tpu_torch as T

    rng = np.random.RandomState(1)
    Xs = [np.sort(rng.uniform(0, 5, 40)) for _ in range(2)]
    Ys = [np.sin(X) + 0.1 * rng.randn(40) for X in Xs]
    spec = T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()], lmc_ranks=[1])
    m = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[20],
                           objective="exact", exact_precision="model",
                           device="cpu")
    x0 = m.param_array + 0.1 * np.cos(np.arange(m.n_params))
    z = np.zeros_like(x0)
    plain = cv.chol_vjp_solve_plain
    conds = []

    def hooked(L, S):
        if solve is None:
            return plain(L, S)
        Ln = L.numpy()
        conds.append(np.linalg.cond(Ln @ Ln.T))
        return torch.as_tensor(solve(Ln, S.numpy()))

    cv.chol_vjp_solve_plain = hooked
    try:
        return m._chunk(x0, z, z, z, T.AdaDelta(), n_steps=2), conds
    finally:
        cv.chol_vjp_solve_plain = plain


def _within(got, want):
    """The card test's bound on each output: rtol 1e-8, atol 1e-10 of
    the output's largest magnitude (at least 1e-10)."""
    return all(np.allclose(a, b, rtol=1e-8,
                           atol=1e-10 * max(np.abs(b).max(), 1.0))
               for a, b in zip(got, want))


def test_float64_chunk_needs_the_symmetrized_solve():
    """The fault of the card test ``test_training_chunk_matches_cpu``:
    the solve kernel's float32 schedule (X's lower block triangle,
    mirrored) in the float64 chunk strays past the bound on the nearly
    singular K_UU factor, the float64 schedule (1/2 (X + X^T)) meets
    it, as the plain version does."""
    want, _ = _chunk(None)
    lower, conds = _chunk(_emulate_solve)
    assert max(conds) > 1e12  # the nearly singular factor
    assert not _within(lower, want)
    full, _ = _chunk(lambda L, S: _emulate_solve(L, S, full=True))
    assert _within(full, want)


@pytest.mark.parametrize("n", [1, 64, 65, 200])
def test_float64_solve_work_covers_all_of_x(n):
    nb = -(-n // TILE)
    items = [tuple(t) for t in cv.solve_work(n, full=True).tolist()]
    want = {(s, i, c) for s in (0, 1) for i in range(nb) for c in range(nb)}
    assert len(items) == len(want) and set(items) == want
    pos = {t: p for p, t in enumerate(items)}
    for p, (stage, i, c) in enumerate(items):
        reads = [(stage, j, c) for j in range(i + 1, nb)]
        if stage == 1:
            reads.append((0, c, i))
            if i < c:
                reads.append((1, c, i))
        assert all(pos[r] < p for r in reads), (stage, i, c)


@pytest.mark.parametrize("n", [1, 64, 65, 3094])
def test_tri_work_covers_each_pair_once_deepest_first(n):
    nb = -(-n // TILE)
    work = cv.tri_work(n)
    assert work.dtype == np.int32 and work.shape[1] == 2
    pairs = [tuple(p) for p in work.tolist()]
    assert sorted(pairs) == [(a, b) for a in range(nb) for b in range(a + 1)]
    depth = [n - TILE * a for a, _ in pairs]
    assert depth == sorted(depth, reverse=True)


@pytest.mark.parametrize("n", [1, 64, 65, 200, 4205])
def test_solve_work_covers_each_item_after_what_it_reads(n):
    nb = -(-n // TILE)
    work = cv.solve_work(n)
    assert work.dtype == np.int32 and work.shape[1] == 3
    items = [tuple(t) for t in work.tolist()]
    want = {(0, i, c) for i in range(nb) for c in range(nb)}
    want |= {(1, i, k) for i in range(nb) for k in range(i + 1)}
    assert len(items) == len(want) and set(items) == want
    pos = {t: p for p, t in enumerate(items)}
    for p, (stage, i, c) in enumerate(items):
        reads = [(stage, j, c) for j in range(i + 1, nb)]
        if stage == 1:
            reads.append((0, c, i))
        assert all(pos[r] < p for r in reads), (stage, i, c)


def test_wrappers_raise_on_what_they_cannot_take():
    L = torch.eye(8, dtype=torch.float64)
    with pytest.raises(ValueError):
        cv.chol_vjp_solve(L, L.float())
    with pytest.raises(ValueError):
        cv.chol_vjp_solve(L[:, :4], L[:, :4])
    with pytest.raises(ValueError):
        cv.chol_vjp_solve(L.half(), L.half())
    with pytest.raises(ValueError):
        cv.chol_vjp(L, L, route=2)

"""Batched MINRES and kernel K12's plain version: the port against the
JAX package (runlmc_tpu/ops/solvers.py) on the same seeded numpy
systems, in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runlmc_tpu.ops import solvers as jsol
from runlmc_tpu_torch.hopper import minres as tminres
from runlmc_tpu_torch.ops import solvers as tsol


def _system(n=60, seed=0, cond=30.0):
    """A seeded SPD matrix with eigenvalues log-spaced over ``cond`` (a
    mild spread: Lanczos then keeps its vectors orthogonal, and the two
    packages' different summation orders stay at float64 rounding
    instead of growing over the iterations) and
    a right-hand-side batch with a zero row and a row that is already
    within the tolerance."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.logspace(0, np.log10(cond), n)) @ Q.T
    b = rng.standard_normal((5, n))
    b[1] = 0.0
    b[3] *= 1e-9
    return A, b


def _mv(A, lib):
    if lib == "jax":
        Aj = jnp.asarray(A)
        return lambda v: v @ Aj.T
    At = torch.as_tensor(A)
    return lambda v: v @ At.T


@pytest.mark.parametrize("k", [1, 2, 7, 25])
def test_minres_cycle_matches_jax(k):
    """k iterations of one cycle: the port's K12 pass (its plain version
    here) against the JAX while-loop body."""
    A, b = _system(seed=k)
    tol = 1e-8
    xj, ij = jsol._minres_cycle(_mv(A, "jax"), jnp.asarray(b), tol, k)
    xt, it = tsol._minres_cycle(_mv(A, "torch"), torch.as_tensor(b),
                                torch.full((1,), tol, dtype=torch.float64), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(xj)).max())


@pytest.mark.parametrize("cycle,cond", [(100, 4.0), (8, 4.0), (8, 10.0),
                                        (30, 10.0)])
def test_batched_minres_matches_jax(cycle, cond):
    A, b = _system(seed=3, cond=cond)
    tol = 1e-8
    rj = jsol.batched_minres(_mv(A, "jax"), jnp.asarray(b), tol=tol,
                             cycle=cycle)
    rt = tsol.batched_minres(_mv(A, "torch"), torch.as_tensor(b), tol=tol,
                             cycle=cycle)
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-10,
                               atol=1e-10 * np.abs(xj).max())
    np.testing.assert_allclose(rt.error.numpy(), np.asarray(rj.error),
                               rtol=1e-6, atol=1e-14)
    # the zero row and the already-converged row cost nothing
    assert rt.iterations[1] == 0 and rt.iterations[3] == 0
    assert bool(rt.converged.all())


def test_batched_minres_mixed_precision_matches_jax():
    """float32 inner cycles with float64 true-residual refinement."""
    A, b = _system(seed=5, cond=10.0)
    tol = 1e-7
    Aj32 = jnp.asarray(A, jnp.float32)
    At32 = torch.as_tensor(A, dtype=torch.float32)
    rj = jsol.batched_minres(_mv(A, "jax"), jnp.asarray(b), tol=tol,
                             cycle=20, inner_matvec=lambda v: v @ Aj32.T,
                             inner_dtype=jnp.float32)
    rt = tsol.batched_minres(_mv(A, "torch"), torch.as_tensor(b), tol=tol,
                             cycle=20, inner_matvec=lambda v: v @ At32.T,
                             inner_dtype=torch.float32)
    assert bool(rt.converged.all()) and bool(np.all(rj.converged))
    x = np.linalg.solve(A, b.T).T
    np.testing.assert_allclose(rt.x.numpy(), x, rtol=1e-6,
                               atol=1e-6 * np.abs(x).max())
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))


def test_minres_update_plain_respects_the_mask():
    """An inactive row keeps every vector and scalar; ``w`` is scratch."""
    g = torch.Generator().manual_seed(1)
    B, n = 4, 30
    vecs = [torch.randn(B, n, generator=g, dtype=torch.float64)
            for _ in range(6)]
    scal = [torch.rand(B, generator=g, dtype=torch.float64) + 0.1
            for _ in range(6)]
    active = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    iters = torch.zeros(B, dtype=torch.int32)
    before = [t.clone() for t in vecs[1:] + scal]
    tminres.minres_update(*vecs, *scal, active, iters,
                          torch.full((1,), 1e-12, dtype=torch.float64))
    for a, b in zip(vecs[1:] + scal, before):
        assert torch.equal(a[1], b[1]) and torch.equal(a[3], b[3])
        assert not torch.equal(a[0], b[0])
    assert iters.tolist() == [1, 0, 1, 0]
    assert active.tolist() == [1, 0, 1, 0]


@pytest.mark.parametrize("method", ["minres", "cg"])
def test_solve_dispatch_matches_jax(method):
    A, b = _system(seed=7, cond=4.0)
    rj = jsol.solve(_mv(A, "jax"), jnp.asarray(b[0]), method=method,
                    tol=1e-8)
    rt = tsol.solve(_mv(A, "torch"), torch.as_tensor(b[0]), method=method,
                    tol=1e-8)
    assert rt.x.shape == (1, b.shape[1])
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(rj.x)).max())
    with pytest.raises(ValueError, match="unknown method"):
        tsol.solve(_mv(A, "torch"), torch.as_tensor(b[0]), method="gmres")

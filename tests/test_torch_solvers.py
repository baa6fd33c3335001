"""Batched CG with refinement cycles (kernel K6's plain passes inside):
the port against the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runlmc_tpu.ops.solvers import batched_cg as j_cg
from runlmc_tpu_torch.hopper import cg as k6
from runlmc_tpu_torch.ops.solvers import batched_cg as t_cg


def _system(n=48, seed=0):
    rng = np.random.RandomState(seed)
    M = rng.standard_normal((n, n))
    A = M @ M.T / n + np.diag(np.logspace(-2, 1, n))
    b = rng.standard_normal((5, n))
    b[1] = 0.0  # never active
    b[3] *= 1e-12  # converged from the start at tol 1e-8
    return A, b


def _run(A, b, jacobi=False, mixed=False, **kw):
    Aj = jnp.asarray(A)
    At = torch.as_tensor(A)
    d = np.diag(A).copy()
    jkw, tkw = dict(kw), dict(kw)
    if jacobi:
        jkw["precond"] = lambda r: r / jnp.asarray(d)
        tkw["precond"] = lambda r: r / torch.as_tensor(d, dtype=r.dtype)
    if mixed:
        jkw["inner_matvec"] = lambda v: v @ Aj.astype(jnp.float32).T
        jkw["inner_dtype"] = jnp.float32
        tkw["inner_matvec"] = lambda v: v @ At.float().T
        tkw["inner_dtype"] = torch.float32
    rj = j_cg(lambda v: v @ Aj.T, jnp.asarray(b), **jkw)
    rt = t_cg(lambda v: v @ At.T, torch.as_tensor(b), **tkw)
    return rj, rt


@pytest.mark.parametrize("mode", ["plain", "jacobi", "mixed"])
def test_batched_cg_matches(mode):
    A, b = _system()
    rj, rt = _run(A, b, jacobi=mode == "jacobi", mixed=mode == "mixed",
                  tol=1e-8, maxiter=400, cycle=25)
    err_j, err_t = np.asarray(rj.error), rt.error.numpy()
    assert np.all(err_j < 1e-8) and np.all(err_t < 1e-8)
    np.testing.assert_array_equal(np.asarray(rj.converged),
                                  rt.converged.numpy())
    xj = np.asarray(rj.x)
    # both certified to 1e-8 absolute residual on a system whose
    # smallest eigenvalue is about 1e-2
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0, atol=1e-5)
    it_j, it_t = np.asarray(rj.iterations), rt.iterations.numpy()
    assert it_t[1] == it_j[1] == 0 and it_t[3] == it_j[3] == 0
    if mode == "mixed":
        # float32 inner cycles round differently in the two packages
        assert np.abs(it_t - it_j).max() <= 3
    else:
        # the same float64 arithmetic
        np.testing.assert_array_equal(it_t, it_j)


def test_cg_passes_respect_the_mask():
    rng = np.random.RandomState(4)
    B, n = 4, 10
    p, Ap, x, r = (torch.as_tensor(rng.standard_normal((B, n)))
                   for _ in range(4))
    Ap = p * 2.0 + 0.01 * Ap
    rz = torch.as_tensor(rng.uniform(0.5, 1.5, B))
    active = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    x0, r0, p0, rz0 = x.clone(), r.clone(), p.clone(), rz.clone()
    pAp, rnorm = k6.cg_update_xr(p, Ap, x, r, rz, active)
    for row in (1, 3):
        assert torch.equal(x[row], x0[row]) and torch.equal(r[row], r0[row])
    alpha = rz0[0] / torch.dot(p0[0], Ap[0])
    torch.testing.assert_close(x[0], x0[0] + alpha * p0[0])
    z = r * 0.5
    iters = torch.zeros(B, dtype=torch.int32)
    tol = torch.full((1,), 1e-30, dtype=torch.float64)
    k6.cg_update_p(r, z, p, rz, active, iters, pAp, rnorm, tol)
    assert torch.equal(p[1], p0[1]) and rz[1] == rz0[1]
    assert iters.tolist() == [1, 0, 1, 0]
    assert active.tolist() == [1, 0, 1, 0]

"""The Woodbury engine: jittered Cholesky scale selection, the factored
solve, matvec and log-determinant, and Woodbury-preconditioned CG — the
port against the JAX package on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu.lmc import woodbury as jwb
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.lmc import woodbury as twb
from runlmc_tpu_torch.utils.carry import from_reference_params


def _indefinite(n=30, seed=0):
    """A symmetric matrix with one eigenvalue of -5e-5 and the rest in
    [1, 2], on a diagonal near 1.5: a jitter of 1e-6 relative to the
    diagonal leaves it indefinite, 1e-4 makes it definite."""
    rng = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.concatenate([[-5e-5], np.linspace(1.0, 2.0, n - 1)])
    return (U * eig) @ U.T


def _spd(n=30, seed=1):
    rng = np.random.RandomState(seed)
    M = rng.standard_normal((n, n))
    return M @ M.T + n * np.diag(rng.uniform(0.5, 5.0, n))


@pytest.mark.parametrize("equilibrate", [True, False])
@pytest.mark.parametrize("which", ["spd", "needs_second_scale"])
def test_chol_jittered_picks_the_same_scale(equilibrate, which):
    A = _spd() if which == "spd" else _indefinite()
    if which == "needs_second_scale":
        # the first scale fails in both forms of the matrix
        s = 1.0 / np.sqrt(np.abs(np.diag(A)))
        first = (A * s[:, None] * s[None, :] + 1e-6 * np.eye(len(A))
                 if equilibrate else
                 A + 1e-6 * abs(np.mean(np.diag(A))) * np.eye(len(A)))
        with pytest.raises(np.linalg.LinAlgError):
            np.linalg.cholesky(first)
    Lj = np.asarray(jwb.chol_jittered(jnp.asarray(A),
                                      equilibrate=equilibrate))
    Lt = twb.chol_jittered(torch.as_tensor(A), equilibrate=equilibrate)
    assert np.all(np.isfinite(Lj))
    # the same scale gives the same factor to rounding; a different one
    # moves the factor by about the jitter (>= 1e-6 relative)
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=1e-9,
                               atol=1e-10 * np.abs(Lj).max())


def _two_group_problem():
    """Two active-dim groups (cross blocks of C) on a 2-D input."""
    rng = np.random.RandomState(8)
    Xs = [rng.uniform(0, 1, (n, 2)) for n in (30, 24)]

    def mk(pkg):
        return pkg.LMCKernelSpec.create(
            D=2, lmc_kernels=[pkg.RBF(name="a", active_dims=(0,))],
            lmc_ranks=[1],
            indep_gp=[pkg.Matern32(name="b", active_dims=(1,)),
                      pkg.RBF(name="c", active_dims=(1,))],
        ).with_input_dim(2)

    sj, st = mk(R), mk(T)
    raw = jax.tree.map(
        lambda a: np.asarray(a) + 0.1, sj.init_raw_params(seed=2)
    )
    return sj, st, Xs, raw


def _factors(dtype=np.float64, **kw):
    sj, st, Xs, raw = _two_group_problem()
    lens = [len(X) for X in Xs]
    gj, _ = jgrid.make_grids(sj, Xs, m=[7, 6])
    gt, _ = tgrid.make_grids(st, Xs, m=[7, 6])
    assert len(gj) == 2
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    pj = jax.tree.map(lambda a: jnp.asarray(a, dtype), raw)
    gj = jax.tree.map(
        lambda a: jnp.asarray(a, dtype) if np.asarray(a).dtype.kind == "f"
        else jnp.asarray(a), gj)
    Kj = jgrid.build_kski(sj, pj, gj, lens)
    wj = jwb.build_device_woodbury(Kj.groups, sj.noise(pj), Kj.noise_n,
                                   tuple(gd.WtW for gd in gj), **kw)
    pt = from_reference_params(raw, tdt, "cpu")
    gt = tuple(gd.to(tdt, "cpu") for gd in gt)
    Kt = tgrid.build_kski(st, pt, gt, lens)
    wt = twb.build_device_woodbury(Kt.groups, st.noise(pt), Kt.noise_n,
                                   gt, **kw)
    return Kj, wj, Kt, wt, sum(lens)


def test_device_woodbury_solve_matvec_logdet():
    Kj, wj, Kt, wt, n = _factors()
    b = np.random.RandomState(0).standard_normal((3, n))
    np.testing.assert_allclose(float(wt.logdet), float(wj.logdet),
                               rtol=1e-11)
    sol_j = np.asarray(wj.solve(jnp.asarray(b)))
    np.testing.assert_allclose(wt.solve(torch.as_tensor(b)).numpy(), sol_j,
                               rtol=1e-9, atol=1e-10 * np.abs(sol_j).max())
    mv_j = np.asarray(wj.matvec(jnp.asarray(b)))
    np.testing.assert_allclose(wt.matvec(torch.as_tensor(b)).numpy(), mv_j,
                               rtol=1e-11, atol=1e-12 * np.abs(mv_j).max())


def test_woodbury_pcg_matches():
    """f32 factor as the preconditioner of an f64 solve with f32 inner
    cycles, as the prediction path runs it."""
    Kj, _, Kt, _, n = _factors()
    Kj32, wj32, Kt32, wt32, _ = _factors(np.float32)
    b = np.random.RandomState(1).standard_normal((4, n))
    b[2] = 0.0  # a row that is never active
    rj = jwb.woodbury_pcg(
        Kj.matvec, wj32, jnp.asarray(b), tol=1e-9, maxiter=200,
        inner_matvec=Kj32.matvec,
    )
    rt = twb.woodbury_pcg(
        Kt.matvec, wt32, torch.as_tensor(b), tol=1e-9, maxiter=200,
        inner_matvec=Kt32.matvec,
    )
    assert np.all(np.asarray(rj.error) < 1e-9)
    assert np.all(rt.error.numpy() < 1e-9)
    xj = np.asarray(rj.x)
    # both solutions are certified to 1e-9 absolute residual
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-7,
                               atol=1e-8 * np.abs(xj).max())
    assert rt.iterations.numpy()[2] == 0
    assert np.abs(rt.iterations.numpy() - np.asarray(rj.iterations)).max() \
        <= 1

"""Kernel K7's plain cross-covariance, the exact SKI marginal likelihood
value and the float32 factorization residual: the port against the JAX
package on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu.lmc import likelihood as jlk
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.lmc import likelihood as tlk
from runlmc_tpu_torch.utils.carry import from_reference_params


def _all_kinds(pkg):
    """Every kernel kind, over split active dims of a 2-D input."""
    return pkg.LMCKernelSpec.create(
        D=3,
        lmc_kernels=[pkg.RBF(name="r", active_dims=(0,)),
                     pkg.Matern32(name="m", active_dims=(1,))],
        lmc_ranks=[1, 2],
        slfm_kernels=[pkg.StdPeriodic(name="p", period=1.7)],
        indep_gp=[pkg.IdentityKern(),
                  pkg.Scaled(inner=pkg.RBF(name="s", active_dims=(1,)),
                             scale=1.5),
                  pkg.Scaled(inner=pkg.Matern32(name="f"),
                             trainable_scale=False, scale=0.7)],
        indep_gp_index=[0, 1, 2],
    ).with_input_dim(2)


def _perturbed(raw, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)), raw
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_kernel_plain_matches_all_kinds(seed):
    sj, st = _all_kinds(R), _all_kinds(T)
    raw = _perturbed(sj.init_raw_params(seed=seed), seed)
    rng = np.random.RandomState(seed)
    Xa = rng.uniform(0, 2, (23, 2))
    Xb = np.concatenate([Xa[:6], rng.uniform(0, 2, (17, 2))])  # r = 0 hits
    oa = rng.randint(0, 3, 23).astype(np.int32)
    ob = np.concatenate([oa[:6], rng.randint(0, 3, 17)]).astype(np.int32)
    want = np.asarray(jlk.cross_kernel(
        sj, jax.tree.map(jnp.asarray, raw), jnp.asarray(Xa),
        jnp.asarray(oa), jnp.asarray(Xb), jnp.asarray(ob),
    ))
    got = tlk.cross_kernel(
        st, from_reference_params(raw, torch.float64, "cpu"),
        torch.as_tensor(Xa), torch.as_tensor(oa), torch.as_tensor(Xb),
        torch.as_tensor(ob),
    ).numpy()
    # the same elementwise formulas; sums over q in another order
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-14 * np.abs(want).max())


def _ski_problem(dtype_seed=3):
    rng = np.random.RandomState(dtype_seed)
    Xs = [rng.uniform(0, 4, n).reshape(-1, 1) for n in (26, 31)]
    ys = [np.sin(X[:, 0]) + 0.1 * rng.standard_normal(len(X)) for X in Xs]

    def mk(pkg):
        return pkg.LMCKernelSpec.create(
            D=2, lmc_kernels=[pkg.RBF()], lmc_ranks=[2],
            indep_gp=[pkg.Matern32(name="i")],
        ).with_input_dim(1)

    sj, st = mk(R), mk(T)
    raw = _perturbed(sj.init_raw_params(seed=1), 2)
    return sj, st, Xs, np.concatenate(ys), raw


@pytest.mark.parametrize("dtype,rtol", [
    # float64: same factorization, same jitter scale; rounding only
    (np.float64, 1e-10),
    # float32: the factors round differently in each package
    (np.float32, 1e-4),
])
def test_exact_ski_mll_value(dtype, rtol):
    sj, st, Xs, y, raw = _ski_problem()
    lens = [len(X) for X in Xs]
    gj, _ = jgrid.make_grids(sj, Xs, m=[10])
    gt, _ = tgrid.make_grids(st, Xs, m=[10])
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    mj, auxj = jlk.exact_ski_mll(
        sj, jax.tree.map(lambda a: jnp.asarray(a, dtype), raw),
        jax.tree.map(lambda a: jnp.asarray(a, dtype)
                     if np.asarray(a).dtype.kind == "f" else jnp.asarray(a),
                     gj),
        lens, jnp.asarray(y, dtype),
    )
    mt, auxt = tlk.exact_ski_mll(
        st, from_reference_params(raw, tdt, "cpu"),
        tuple(gd.to(tdt, "cpu") for gd in gt), lens,
        torch.as_tensor(y, dtype=tdt),
    )
    np.testing.assert_allclose(float(mt), float(mj), rtol=rtol)
    np.testing.assert_allclose(auxt.alpha.numpy(), np.asarray(auxj.alpha),
                               rtol=rtol * 100,
                               atol=rtol * 100 * np.abs(auxj.alpha).max())
    assert float(auxt.solve_error) < 1e-3


def test_f32_factorization_residual():
    sj, st, Xs, y, raw = _ski_problem()
    lens = [len(X) for X in Xs]
    gj, _ = jgrid.make_grids(sj, Xs, m=[10])
    gt, _ = tgrid.make_grids(st, Xs, m=[10])
    rj = float(jlk.f32_factorization_residual(
        sj, jax.tree.map(jnp.asarray, raw), jgrid.to_dense_f32(gj), lens,
        jnp.asarray(y),
    ))
    placed = tuple(gd.to(torch.float64, "cpu") for gd in gt)
    rt = float(tlk.f32_factorization_residual(
        st, from_reference_params(raw, torch.float64, "cpu"),
        tgrid.to_dense_f32(placed), lens, torch.as_tensor(y),
    ))
    # a float32 rounding-level residual: the two packages round in
    # different places, so they agree in magnitude, not in digits
    assert 0 < rt < 1e-4 and 0 < rj < 1e-4
    assert rt / rj < 30 and rj / rt < 30

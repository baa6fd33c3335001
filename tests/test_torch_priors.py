"""Priors: each prior's log-density, ``Gamma.from_EV``, the domain check,
and ``set_prior`` in the exact and stochastic objectives and the exact
oracle — the port against the JAX package, in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu import priors as jpriors
from runlmc_tpu.lmc import likelihood as jlk
from runlmc_tpu_torch import priors as tpriors
from runlmc_tpu_torch.params import IDENTITY, POSITIVE

X = np.array([0.05, 0.3, 1.0, 2.5, 7.0])


@pytest.mark.parametrize("name,args", [
    ("Gaussian", (0.3, 2.0)), ("Gamma", (2.0, 10.0)),
    ("InverseGamma", (3.0, 0.5)), ("HalfLaplace", (0.7,)),
])
def test_lnpdf_matches_jax(name, args):
    want = np.asarray(getattr(jpriors, name)(*args).lnpdf(jnp.asarray(X)))
    got = getattr(T, name)(*args).lnpdf(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_gamma_from_ev_and_gaussian_variance():
    g = T.Gamma.from_EV(2.0, 0.5)
    assert g == tpriors.Gamma(a=8.0, b=4.0)
    assert g == T.Gamma(**jpriors.Gamma.from_EV(2.0, 0.5).__dict__)
    x = torch.linspace(0.01, 10.0, 20001, dtype=torch.float64)
    pdf = torch.exp(g.lnpdf(x))
    mean = float(torch.trapezoid(x * pdf, x))
    var = float(torch.trapezoid((x - mean) ** 2 * pdf, x))
    assert abs(mean - 2.0) < 1e-4 and abs(var - 0.5) < 1e-3
    with pytest.raises(ValueError, match="positive"):
        T.Gaussian(0.0, 0.0)


def test_check_domain():
    tpriors.check_domain(T.Gamma(2.0, 1.0), POSITIVE)
    tpriors.check_domain(T.Gaussian(0.0, 1.0), IDENTITY)
    with pytest.raises(ValueError, match="positive parameter domain"):
        tpriors.check_domain(T.HalfLaplace(1.0), IDENTITY)
    Xs = [np.linspace(0, 1, 12), np.linspace(0, 1, 10)]
    Ys = [np.sin(4 * x) for x in Xs]
    spec = T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()], lmc_ranks=[1])
    m = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[8],
                           device="cpu")
    with pytest.raises(ValueError, match="positive parameter domain"):
        m.set_prior(("coreg_vecs", "q0"), T.Gamma(2.0, 1.0))
    with pytest.raises(KeyError):
        m.set_prior(("bogus",), T.Gaussian(0.0, 1.0))


PRIORS = (
    (("noise",), "Gamma", (2.0, 10.0)),
    (("kernels", "q0", "inv_lengthscale"), "InverseGamma", (3.0, 2.0)),
    (("coreg_vecs", "q0"), "Gaussian", (0.1, 0.5)),
    (("coreg_diags", "q0"), "HalfLaplace", (2.0,)),
)


def _pair(objective, priors=PRIORS, **kw):
    rng = np.random.RandomState(8)
    Xs = [np.sort(rng.uniform(0, 4, n)) for n in (30, 27)]
    Ys = [np.sin(2 * x + d) + 0.1 * rng.standard_normal(len(x))
          for d, x in enumerate(Xs)]
    mk = (lambda pkg: pkg.LMCKernelSpec.create(
        D=2, lmc_kernels=[pkg.RBF(name="k")], lmc_ranks=[1]))
    kw = dict(dict(m=[16], objective=objective, seed=4, tolerance=1e-10),
              **kw)
    mj = R.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(R), **kw)
    mt = T.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(T), device="cpu",
                            **kw)
    for path, name, args in priors:
        mj.set_prior(path, getattr(jpriors, name)(*args))
        mt.set_prior(path, getattr(T, name)(*args))
    p0 = mj.param_array + 0.1 * np.cos(np.arange(mj.n_params))
    mj.param_array = p0
    mt.param_array = p0
    return mj, mt


def _grads(mj, mt, x):
    gj, _ = mj._jit_grad(jnp.asarray(x), jax.random.PRNGKey(0), mj.grid_data,
                         mj.precond_data32, mj.inner_data32, mj.y)
    gt, _ = mt._exact_grad(torch.as_tensor(np.array(x)))
    return gt.numpy(), np.asarray(gj)


def test_prior_in_exact_objective_and_oracle_matches_jax():
    """The prior's share of the exact objective's gradient (with minus
    without, at the same parameters: the factorized MLL's rounding
    cancels) to 1e-10; the whole gradient to 1e-8, where the two
    packages' float64 Woodbury factorizations round apart (about 2e-9 on
    this problem with or without priors); the exact oracle with priors
    to 1e-10; a 3-step training chunk."""
    bj, bt = _pair("exact", exact_precision="model", priors=())
    mj, mt = _pair("exact", exact_precision="model")
    x = mj.param_array
    gt, gj = _grads(mj, mt, x)
    ht, hj = _grads(bj, bt, x)
    np.testing.assert_allclose(gt - ht, gj - hj, rtol=1e-10,
                               atol=1e-10 * np.abs(gj - hj).max())
    assert np.abs(gj - hj).max() > 1e-3  # the prior moves the gradient
    np.testing.assert_allclose(gt, gj, rtol=1e-8,
                               atol=1e-8 * np.abs(gj).max())
    vj, ej = mj.exact_log_likelihood_and_grad()
    vt, et = mt.exact_log_likelihood_and_grad()
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    np.testing.assert_allclose(et, ej, rtol=1e-10,
                               atol=1e-10 * np.abs(ej).max())
    ij = mj.optimize(R.AdaDelta(max_it=3))
    it = mt.optimize(T.AdaDelta(max_it=3))
    assert it["n_iter"] == ij["n_iter"] == 3
    np.testing.assert_allclose(mt.param_array, mj.param_array, rtol=1e-8)


def test_prior_in_stochastic_objective_matches_jax():
    mj, mt = _pair("stochastic", grid_mode="fft")
    x = mj.param_array
    key = jax.random.PRNGKey(3)
    gj, _ = mj._jit_grad(jnp.asarray(x), key, mj.grid_data,
                         mj.precond_data32, mj.inner_data32, mj.y)
    probes = torch.as_tensor(np.asarray(jlk.rademacher_probes(
        key, mj.n_probes, len(mt.data.y), jnp.float64)))
    gt, _ = mt._stochastic_grad(torch.as_tensor(x), probes)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-8,
                               atol=1e-8 * np.abs(gj).max())

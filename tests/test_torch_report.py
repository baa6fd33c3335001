"""Reporting on InterpolatedLLGP: the log-likelihood in every definition,
``ski_log_likelihood``, ``normal_quadratic``, the exact oracle's value
and gradient, ``metrics=True`` training, the 'exact' and 'precompute'
prediction modes and ``warm_rescue`` — the port against the JAX package
with carried parameters, on the same numpy inputs, in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import runlmc_tpu as R
import runlmc_tpu_torch as T

TOL = 1e-10


def _spec(pkg):
    return pkg.LMCKernelSpec.create(
        D=3, lmc_kernels=[pkg.RBF(name="k")], lmc_ranks=[2],
        indep_gp=[pkg.Matern32(name="i")], indep_gp_index=[1])


def _split_spec(pkg):
    return pkg.LMCKernelSpec.create(
        D=3, lmc_kernels=[pkg.RBF(name="a", active_dims=(0,))],
        lmc_ranks=[1], indep_gp=[pkg.Matern32(name="b", active_dims=(1,))],
        indep_gp_index=[2])


def _data(P=1, seed=11):
    rng = np.random.RandomState(seed)
    Xs = [np.sort(rng.uniform(0, 4, (n, P)), axis=0) for n in (30, 26, 28)]
    Ys = [np.sin(2 * X[:, 0] + d) + 0.1 * rng.standard_normal(len(X))
          for d, X in enumerate(Xs)]
    tXs = [rng.uniform(0, 4, (n, P)) for n in (6, 0, 5)]
    return Xs, Ys, tXs


def _pair(mode="dense", spec=_spec, P=1, m=(16,), **kw):
    Xs, Ys, tXs = _data(P)
    kw = dict(dict(m=list(m), grid_mode=mode, tolerance=TOL, seed=2), **kw)
    mj = R.InterpolatedLLGP(Xs, Ys, functional_kernel=spec(R), **kw)
    mt = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec(T), device="cpu",
                            **kw)
    p0 = mj.param_array + 0.1 * np.cos(np.arange(mj.n_params))
    mj.param_array = p0
    mt.param_array = p0
    return mj, mt, tXs


def _jax_probes(n_probes, n):
    z = jax.random.bernoulli(jax.random.PRNGKey(0), 0.5, (n_probes, n))
    return np.array(z.astype(jnp.float64) * 2.0 - 1.0)


@pytest.fixture(scope="module")
def pairs():
    """One dense and one fft model pair, shared by the tests that only
    read them (their prediction mode is set per test)."""
    return {"dense": _pair("dense"), "fft": _pair("fft")}


@pytest.mark.parametrize("mode,rtol", [("dense", 1e-10), ("fft", 1e-8)])
def test_log_likelihoods_match_jax(pairs, mode, rtol):
    mj, mt, _ = pairs[mode]
    mt.slq_probes = _jax_probes  # JAX's SLQ probes (fft mode)
    for name in ("normal_quadratic", "log_det_K", "ski_log_det",
                 "ski_log_likelihood"):
        np.testing.assert_allclose(getattr(mt, name)(), getattr(mj, name)(),
                                   rtol=rtol, err_msg=name)
    for exact in (None, True, False):
        np.testing.assert_allclose(mt.log_likelihood(exact),
                                   mj.log_likelihood(exact), rtol=rtol,
                                   err_msg=str(exact))
    vj, gj = mj.exact_log_likelihood_and_grad()
    vt, gt = mt.exact_log_likelihood_and_grad()
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    np.testing.assert_allclose(gt, gj, rtol=1e-10,
                               atol=1e-10 * np.abs(gj).max())


def test_log_likelihood_default_switches_past_the_cutoff(pairs, caplog,
                                                        monkeypatch):
    mj, mt, _ = pairs["dense"]
    for m in (mj, mt):
        monkeypatch.setattr(m, "LARGE_N_EXACT_REPORT", 10)
    with caplog.at_level("WARNING"):
        got = mt.log_likelihood()
    assert "SKI" in caplog.text and "Woodbury" in caplog.text
    np.testing.assert_allclose(got, mt.log_likelihood(exact=False),
                               rtol=1e-14)
    np.testing.assert_allclose(got, mj.log_likelihood(), rtol=1e-10)


def test_metrics_training_matches_jax():
    """Three steps of exact-objective training with metrics on, at
    exact_precision='model': the step-by-step path, every Metrics list
    and the parameters as in the JAX package."""
    mj, mt, _ = _pair("dense", objective="exact", exact_precision="model",
                      metrics=True)
    ij = mj.optimize(R.AdaDelta(max_it=3))
    it = mt.optimize(T.AdaDelta(max_it=3))
    assert it["n_iter"] == ij["n_iter"] == 3
    for name in ("iterations", "solv_error", "grad_norms", "grad_error",
                 "log_likely"):
        got = np.asarray(getattr(mt.metrics, name))
        want = np.asarray(getattr(mj.metrics, name))
        assert got.shape == want.shape == (3,), name
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_allclose(mt.param_array, mj.param_array, rtol=1e-8)
    assert "rng_key" in it["state"]


@pytest.mark.parametrize("prediction", ["exact", "precompute"])
@pytest.mark.parametrize("mode", ["dense", "fft"])
def test_prediction_modes_match_jax(pairs, monkeypatch, prediction, mode):
    mj, mt, tXs = pairs[mode]
    for m in (mj, mt):
        monkeypatch.setattr(m, "prediction", prediction)
    mu_j, var_j = mj.predict(tXs)
    mu_t, var_t = mt.predict(tXs)
    for a, b in zip(mu_t + var_t, mu_j + var_j):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)
    if prediction == "precompute":
        assert mt.prediction_report["precompute-nu"]["residual"] <= TOL
        assert mt.prediction_report["precompute-nu"]["rhs"] == \
            mt.grid_data[0].interp.ncols


def test_precompute_raises_on_split_kernels():
    """As in the JAX package (interpolated_llgp.py:2242-2246)."""
    Xs, Ys, tXs = _data(P=2)
    mt = T.InterpolatedLLGP(Xs, Ys, functional_kernel=_split_spec(T),
                            m=[6, 5], prediction="precompute", device="cpu")
    assert len(mt.grid_data) == 2
    with pytest.raises(ValueError, match="split kernels"):
        mt.predict(tXs)
    with pytest.raises(ValueError, match="unrecognized"):
        T.InterpolatedLLGP(Xs, Ys, functional_kernel=_split_spec(T),
                           m=[6, 5], prediction="bogus", device="cpu")


def test_warm_rescue_leaves_the_model_as_it_was():
    Xs, Ys, tXs = _data()
    mt = T.InterpolatedLLGP(Xs, Ys, functional_kernel=_spec(T), m=[16],
                            grid_mode="fft", objective="stochastic",
                            device="cpu")
    mt.predict(tXs)
    before = mt.param_array.copy()
    report = {k: dict(v) for k, v in mt.prediction_report.items()}
    mt.warm_rescue()
    np.testing.assert_array_equal(mt.param_array, before)
    assert mt.prediction_report == report
    mt.warm_rescue(ladder=False)
    assert mt.prediction_report == report

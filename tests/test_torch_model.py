"""The whole prediction slice at small size: a JAX ``InterpolatedLLGP``
and the port's, built on the same data, with the JAX model's
``param_array`` carried across, predict the same means, variances and
quantiles."""

import numpy as np
import pytest

import runlmc_tpu as R
import runlmc_tpu_torch as T

TOLERANCE = 1e-8
# both solves are certified to an absolute residual of 1e-8; their
# iterates differ by rounding, far inside this
PREDICT_RTOL = 1e-6


def _problem(kind):
    rng = np.random.RandomState(21)
    if kind == "1d_lmc":
        # D=3, n=90, m=16, RBF of rank 2
        Xs = [np.sort(rng.uniform(0, 6, 30)) for _ in range(3)]
        Ys = [np.sin(X + d) + 0.3 * d + 0.05 * rng.randn(30)
              for d, X in enumerate(Xs)]
        tXs = [np.linspace(0.5, 5.5, 7), np.array([]),
               np.linspace(1, 2, 4)]

        def mk(pkg):
            return pkg.LMCKernelSpec.create(D=3, lmc_kernels=[pkg.RBF()],
                                            lmc_ranks=[2])

        return Xs, Ys, tXs, mk, [16]
    if kind == "2d_split":
        # two active-dim groups: W-block applies per group, cross blocks
        # in the Woodbury capacitance, one test interpolant per group
        Xs = [rng.uniform(0, 1, (35, 2)) for _ in range(2)]
        Ys = [np.sin(4 * X[:, 0]) + np.cos(3 * X[:, 1]) * (d + 1)
              + 0.05 * rng.randn(35) for d, X in enumerate(Xs)]
        tXs = [rng.uniform(0.1, 0.9, (4, 2)), rng.uniform(0.1, 0.9, (6, 2))]

        def mk(pkg):
            return pkg.LMCKernelSpec.create(
                D=2, lmc_kernels=[pkg.RBF(name="x", active_dims=(0,))],
                lmc_ranks=[1],
                indep_gp=[pkg.Matern32(name="y", active_dims=(1,)),
                          pkg.RBF(name="z", active_dims=(1,))],
            )

        return Xs, Ys, tXs, mk, [9, 7]
    # D=2, P=2, m=[8, 8], slfm + indep
    Xs = [rng.uniform(0, 1, (40, 2)) for _ in range(2)]
    Ys = [np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + d
          + 0.05 * rng.randn(40) for d, X in enumerate(Xs)]
    tXs = [rng.uniform(0.1, 0.9, (6, 2)), rng.uniform(0.1, 0.9, (5, 2))]

    def mk(pkg):
        return pkg.LMCKernelSpec.create(
            D=2, slfm_kernels=[pkg.RBF(name="s")],
            indep_gp=[pkg.RBF(name="a"), pkg.Matern32(name="b")],
        )

    return Xs, Ys, tXs, mk, [8, 8]


@pytest.fixture(params=["1d_lmc", "2d_slfm_indep", "2d_split"],
                scope="module")
def pair(request):
    Xs, Ys, tXs, mk, m = _problem(request.param)
    mj = R.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(R), m=m,
                            tolerance=TOLERANCE)
    mt = T.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(T), m=m,
                            tolerance=TOLERANCE, device="cpu")
    params = mj.param_array
    params = params + 0.1 * np.cos(np.arange(len(params)))
    mj.param_array = params
    mt.param_array = mj.param_array
    return mj, mt, tXs


def test_same_objective_and_parameters(pair):
    mj, mt, _ = pair
    assert mt.objective == mj.objective
    np.testing.assert_array_equal(mt.param_array, mj.param_array)
    assert mt.n_params == mj.n_params


def test_predict_matches(pair):
    mj, mt, tXs = pair
    mu_j, var_j = mj.predict(tXs)
    mu_t, var_t = mt.predict(tXs)
    for a, b in zip(mu_t, mu_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=PREDICT_RTOL, atol=1e-10)
    for a, b in zip(var_t, var_j):
        np.testing.assert_allclose(a, b, rtol=PREDICT_RTOL, atol=1e-10)
    for rep in (mj.prediction_report, mt.prediction_report):
        r = rep["explained-variance"]
        assert r["residual"] <= TOLERANCE
        assert set(r) == {"residual", "iterations", "escalated", "rhs"}
    assert mt.prediction_report["explained-variance"]["rhs"] == \
        1 + sum(len(X) for X in tXs)


def test_predict_quantiles_match(pair):
    mj, mt, tXs = pair
    for a, b in zip(mt.predict_quantiles(tXs, (10, 50, 90)),
                    mj.predict_quantiles(tXs, (10, 50, 90))):
        np.testing.assert_allclose(a, b, rtol=PREDICT_RTOL, atol=1e-10)


def test_predict_without_test_points(pair):
    mj, mt, tXs = pair
    empty = [np.zeros((0,) + np.shape(X)[1:]) for X in tXs]
    mt.param_array = mt.param_array  # drop the cached solves
    mu, var = mt.predict(empty)
    assert all(len(a) == 0 for a in mu + var)
    assert mt.prediction_report["alpha"]["residual"] <= TOLERANCE


@pytest.mark.parametrize("normalize", [True, False])
def test_constant_output_rejected_even_unnormalized(normalize):
    # Reference quirk, matched on purpose: _validate_io rejects a
    # constant output even when normalize=False, where nothing would
    # z-score it (runlmc_tpu/models/multigp.py:73-77).
    Xs = [np.linspace(0, 1, 10)] * 2
    Ys = [np.sin(Xs[0]), np.ones(10)]
    for pkg, kw in ((R, {}), (T, {"device": "cpu"})):
        spec = pkg.LMCKernelSpec.create(D=2, lmc_kernels=[pkg.RBF()],
                                        lmc_ranks=[1])
        with pytest.raises(ValueError, match="constant"):
            pkg.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[8],
                                 normalize=normalize, **kw)


def test_unported_prediction_modes_raise():
    """Every variance mode of the JAX package is ported now
    (tests/test_torch_report.py); an unknown one raises as there."""
    Xs, Ys, _, mk, m = _problem("1d_lmc")
    for mode in ("on-the-fly", "precompute", "exact"):
        model = T.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(T), m=m,
                                   prediction=mode, device="cpu")
        assert model.prediction == mode
    for pkg, kw in ((R, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError, match="unrecognized"):
            pkg.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(pkg), m=m,
                                 prediction="bogus", **kw)


def test_stalled_f32_solve_escalates_to_the_model_dtype_factor():
    # a noise of about 1e-7 defeats the float32 preconditioner: both
    # packages escalate to the float64 Woodbury factor and certify there
    Xs, Ys, tXs, mk, m = _problem("1d_lmc")
    mj = R.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(R), m=m,
                            tolerance=TOLERANCE)
    mt = T.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(T), m=m,
                            tolerance=TOLERANCE, device="cpu")
    params = mj.param_array + 0.1 * np.cos(np.arange(mj.n_params))
    params[-3:] = -16.0  # raw noise of the three outputs
    mj.param_array = params
    mt.param_array = params
    mu_j, _ = mj.predict(tXs)
    mu_t, _ = mt.predict(tXs)
    for rep in (mj.prediction_report, mt.prediction_report):
        assert rep["explained-variance"]["escalated"]
        assert rep["explained-variance"]["residual"] <= TOLERANCE
    for a, b in zip(mu_t, mu_j):
        np.testing.assert_allclose(a, b, rtol=PREDICT_RTOL, atol=1e-10)

"""The exact objective's guards in training: the held-out-block
validation guard, the residual escalation ladder (float32 -> model
dtype -> equilibration flip), the flipped probe of objective='auto' and
the LOO z^2 statistic — ports of tests/test_models.py:198-290 and
tests/test_exact_residual.py:126-272, held against the JAX package where
both packages run."""

import numpy as np
import pytest
import torch

import runlmc_tpu as R
import runlmc_tpu.lmc.likelihood as jlk
import runlmc_tpu.lmc.woodbury as jwb
import runlmc_tpu.models.interpolated_llgp as jmod
import runlmc_tpu_torch as T
import runlmc_tpu_torch.lmc.likelihood as tlk
import runlmc_tpu_torch.lmc.woodbury as twb
import runlmc_tpu_torch.models.interpolated_llgp as tmod
from runlmc_tpu_torch.params import POSITIVE


def _sin_data(seed, n1, n2, freq, noise):
    rng = np.random.default_rng(seed)
    Xs = [np.sort(rng.uniform(0, 1, n1)), np.sort(rng.uniform(0, 1, n2))]
    Ys = [np.sin(freq * x) + noise * rng.standard_normal(len(x)) for x in Xs]
    return Xs, Ys


def _spec(pkg):
    return pkg.LMCKernelSpec.create(D=2, lmc_kernels=[pkg.RBF()],
                                    lmc_ranks=[1])


def _pair(Xs, Ys, **kw):
    mj = R.InterpolatedLLGP(Xs, Ys, functional_kernel=_spec(R), **kw)
    mt = T.InterpolatedLLGP(Xs, Ys, functional_kernel=_spec(T), device="cpu",
                            **kw)
    return mj, mt


def test_validation_split_equals_jax():
    Xs, Ys = _sin_data(0, 200, 150, 7.0, 0.0)
    mj, mt = _pair(Xs, Ys, m=[32], seed=0)
    for a, b in zip(mt._validation_split(), mj._validation_split()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    Xs_tr, _, Xs_va, _ = mt._validation_split()
    for X, Xtr, Xva in zip(Xs, Xs_tr, Xs_va):
        assert len(Xtr) + len(Xva) == len(X)
        assert 0.03 <= len(Xva) / len(X) <= 0.10
        held = np.flatnonzero(np.isin(X.ravel(), Xva.ravel()))
        assert int(np.sum(np.diff(held) > 1)) + 1 == 2  # two blocks


def test_guard_statistics_match_jax():
    """The twin's training and held-out prediction in both packages,
    float64 factorizations: the same z^2 and zero-variance share."""
    Xs, Ys = _sin_data(0, 200, 160, 5.0, 0.1)
    mj, mt = _pair(Xs, Ys, m=[48], seed=0, exact_precision="model")
    z2j, fj = mj._validate_exact_objective(R.AdaDelta(max_it=8))
    z2t, ft = mt._validate_exact_objective(T.AdaDelta(max_it=8))
    assert np.isfinite(z2t) and ft == fj
    np.testing.assert_allclose(z2t, z2j, rtol=1e-5)


def test_auto_objective_guard_keeps_healthy_exact():
    Xs, Ys = _sin_data(0, 200, 160, 5.0, 0.1)
    m = T.InterpolatedLLGP(Xs, Ys, functional_kernel=_spec(T), m=[48],
                           seed=0, objective="auto", device="cpu")
    assert m.objective == "exact" and m._auto_exact_guard
    info = m.optimize(optimizer=T.AdaDelta(max_it=15))
    assert m.objective == "exact" and not m._auto_exact_guard
    assert info["n_iter"] >= 1
    assert np.all(np.isfinite(m.param_array))


def test_auto_objective_guard_breach_raises_naming_slice_3(monkeypatch):
    """A failed validation guard demotes the auto-selected exact
    objective to the stochastic one and trains on, in both packages."""
    Xs, Ys = _sin_data(0, 150, 120, 7.0, 0.1)
    mj, mt = _pair(Xs, Ys, m=[32], seed=0, objective="auto")
    for mdl in (mj, mt):
        assert mdl.objective == "exact" and mdl._auto_exact_guard
        monkeypatch.setattr(type(mdl), "_validate_exact_objective",
                            lambda self, opt: (1e4, 0.5))
    ij = mj.optimize(optimizer=R.AdaDelta(max_it=5))
    it = mt.optimize(optimizer=T.AdaDelta(max_it=5))
    assert mj.objective == mt.objective == "stochastic"
    assert not mt._auto_exact_guard
    assert it["n_iter"] == ij["n_iter"]
    assert it["mean_solve_iters"] > 0 and "rng_key" in it["state"]
    assert np.all(np.isfinite(mt.param_array))


def test_stochastic_objective_raises_naming_slice_3():
    """The stochastic objective trains a dense model (slice 3 of the
    port); metrics=True (slice 4) now builds a model that records
    ``Metrics`` (tests/test_torch_report.py holds them to JAX's)."""
    Xs, Ys = _sin_data(0, 40, 40, 7.0, 0.1)
    m = T.InterpolatedLLGP(Xs, Ys, functional_kernel=_spec(T), m=[16],
                           objective="stochastic", device="cpu")
    info = m.optimize(max_it=2)
    assert m.objective == "stochastic" and info["n_iter"] == 2
    assert info["max_solve_error"] <= m.tolerance
    assert np.all(np.isfinite(m.param_array))
    mm = T.InterpolatedLLGP(Xs, Ys, functional_kernel=_spec(T), m=[16],
                            objective="stochastic", metrics=True,
                            device="cpu")
    mm.optimize(max_it=2)
    assert isinstance(mm.metrics, T.Metrics)
    assert len(mm.metrics.grad_error) == 2
    assert np.all(np.isfinite(mm.metrics.log_likely))


def _noisy_pair(**kw):
    """The calibration problem of tests/test_exact_residual.py, with the
    noise forced to 1e-6, past what a float32 factorization resolves."""
    rng = np.random.default_rng(0)
    Xs = [np.sort(rng.uniform(0, 2 * np.pi, (50, 1)), axis=0)
          for _ in range(2)]
    Ys = [np.sin(X[:, 0]) + 0.05 * rng.standard_normal(50) for X in Xs]
    mj, mt = _pair(Xs, Ys, m=[20], seed=2, objective="exact", **kw)
    p = np.array(mj.param_array)
    p[-2:] = POSITIVE.inverse(1e-6 * np.ones(2))  # raw noise, last leaf
    mj.param_array = p
    mt.param_array = p
    return mj, mt


def test_breach_escalates_to_model_precision():
    mj, mt = _noisy_pair()
    _, aux = mt._exact_grad(torch.as_tensor(mt.param_array))
    assert float(aux.solve_error) > tmod.EXACT_RESIDUAL_THRESHOLD
    ij = mj.optimize(optimizer=R.AdaDelta(max_it=4))
    it = mt.optimize(optimizer=T.AdaDelta(max_it=4))
    assert mj.exact_precision == mt.exact_precision == "model"
    assert it["n_iter"] == ij["n_iter"] == 4
    assert it["max_solve_error"] > tmod.EXACT_RESIDUAL_THRESHOLD
    assert np.all(np.isfinite(mt.param_array))


def test_auto_probe_tries_flipped_equilibration(monkeypatch):
    """A breaching default probe is retried with the equilibration
    flipped, and a certifying flip selects 'exact' with that mode, in
    both packages."""
    rng = np.random.default_rng(0)
    Xs = [np.sort(rng.uniform(0, 2 * np.pi, (40, 1)), axis=0)
          for _ in range(2)]
    Ys = [np.sin(X[:, 0]) + 0.05 * rng.standard_normal(40) for X in Xs]
    flipped = not twb.EQUILIBRATE_DEFAULT
    assert flipped == (not jwb.EQUILIBRATE_DEFAULT)
    calls = []

    def fake(spec, raw, gd32, lens, y, equilibrate=None):
        calls.append(equilibrate)
        return np.float32(1e-6 if equilibrate == flipped else 1.0)

    monkeypatch.setattr(jlk, "f32_factorization_residual", fake)
    monkeypatch.setattr(tlk, "f32_factorization_residual", fake)
    mj, mt = _pair(Xs, Ys, m=[16], seed=1, objective="auto")
    assert calls == [None, flipped] * 2
    for mdl in (mj, mt):
        assert mdl.objective == "exact"
        assert mdl._equilibrate == flipped and mdl._equilibrate_flip_tried
        assert mdl._auto_exact_guard
    # the flipped mode reaches the factorizations the model builds
    assert mt.loo_zsq() == pytest.approx(mj.loo_zsq(), rel=1e-8)


def test_training_breach_at_model_precision_probes_the_flip(monkeypatch):
    """Once training runs at exact_precision='model', a further breach
    reaches the equilibration-flip rung. A certifying flip
    keeps the exact objective; a breach after the flip was tried is where
    both packages demote to the stochastic objective. Residuals are
    forced past a threshold of 1e-30 and the flipped probe is faked, to
    isolate the control flow."""
    flipped = not twb.EQUILIBRATE_DEFAULT
    calls = []

    def fake_for(real):
        def fake(spec, raw, gd32, lens, y, equilibrate=None):
            calls.append(equilibrate)
            if equilibrate == flipped:
                return np.float32(0.0)
            return real(spec, raw, gd32, lens, y, equilibrate=equilibrate)
        return fake

    for mod, lkm in ((jmod, jlk), (tmod, tlk)):
        monkeypatch.setattr(mod, "EXACT_RESIDUAL_THRESHOLD", 1e-30)
        monkeypatch.setattr(lkm, "f32_factorization_residual",
                            fake_for(lkm.f32_factorization_residual))
    mj, mt = _noisy_pair(exact_precision="model")
    ij = mj.optimize(optimizer=R.AdaDelta(max_it=4))
    it = mt.optimize(optimizer=T.AdaDelta(max_it=4))
    assert calls == [flipped, flipped]
    for mdl, info in ((mj, ij), (mt, it)):
        assert mdl.objective == "exact" and mdl.exact_precision == "model"
        assert mdl._equilibrate == flipped and mdl._equilibrate_flip_tried
        assert info["n_iter"] == 4
    ij = mj.optimize(optimizer=R.AdaDelta(max_it=4))
    it = mt.optimize(optimizer=T.AdaDelta(max_it=4))
    assert mj.objective == mt.objective == "stochastic"
    assert it["n_iter"] == ij["n_iter"] == 4
    assert np.all(np.isfinite(mt.param_array))


def test_loo_zsq_statistic_matches_jax():
    Xs, Ys = _sin_data(0, 120, 100, 7.0, 0.1)
    mj, mt = _pair(Xs, Ys, m=[48], seed=1, objective="exact")
    mt.optimize(optimizer=T.AdaDelta(max_it=30))
    assert mt.loo_zsq() < 5.0
    mj.param_array = mt.param_array
    np.testing.assert_allclose(mt.loo_zsq(), mj.loo_zsq(), rtol=1e-8)
    p = mt.param_array
    p[-2:] = POSITIVE.inverse(1e-6 * np.ones(2))
    mt.param_array = p
    mj.param_array = p
    assert mt.loo_zsq() > 100.0
    np.testing.assert_allclose(mt.loo_zsq(), mj.loo_zsq(), rtol=1e-6)

"""The beyond-dense-cap path of the port: fft grids with their dense
float32 preconditioner twin, certified prediction, and the stochastic
objective's in-training rescue — ports of tests/test_large_grid.py.

The caps are lowered so that a small model leaves dense mode (and, with
the preconditioner cap lowered too, its twin really coarsens). The JAX
package's 'tiled' cases are left out: 'tiled' is a TPU-only mode that
the port does not have (the card runs float64 FFTs)."""

import logging

import numpy as np
import pytest
import torch

import runlmc_tpu_torch as T
from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.params import POSITIVE
from runlmc_tpu_torch.utils.carry import cast_params


@pytest.fixture
def small_cap(monkeypatch):
    """m=[96], D=2 grids beyond the dense and the preconditioner caps."""
    monkeypatch.setattr(tgrid, "DENSE_MAX_GRID", 64)
    monkeypatch.setattr(tgrid, "PRECOND_MAX_GRID", 64)


def _data(rng, n0=200, n1=150):
    Xs = [np.sort(rng.uniform(0, 1, n0)), np.sort(rng.uniform(0, 1, n1))]
    Ys = [np.sin(8 * x) + 0.05 * rng.standard_normal(len(x)) for x in Xs]
    return Xs, Ys


def _spec():
    return T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()], lmc_ranks=[1])


def _model(Xs, Ys, **kw):
    return T.InterpolatedLLGP(Xs, Ys, functional_kernel=_spec(), m=[96],
                              seed=1, device="cpu", **kw)


@pytest.mark.parametrize("sizes,D,cap", [
    ((2504,), 4, 8192), ((68, 68), 5, 8192), ((10,), 2, 8192),
    ((100, 100), 2, 64), ((2504,), 4, 16384),
])
def test_coarse_sizes(sizes, D, cap):
    got = tgrid.coarse_sizes(sizes, D, cap=cap)
    assert got == jgrid.coarse_sizes(sizes, D, cap=cap)
    assert D * np.prod(got) <= cap or got == (4,) * len(sizes)
    want = {(2504,): (2048,), (68, 68): (40, 40), (10,): (10,)}
    if cap == 8192:
        assert got == want[sizes]
    if cap == 16384:  # the weather m=2500 twin keeps the fine grid
        assert got == sizes


def test_coarse_artifacts_built_for_fft_groups(small_cap, rng):
    Xs, _ = _data(rng)
    spec = _spec().with_input_dim(1)
    grids, _ = tgrid.make_grids(spec, [x.reshape(-1, 1) for x in Xs], m=[96])
    gd = grids[0]
    assert gd.plan.mode == "fft"
    assert gd.coarse is not None and gd.coarse.plan.mode == "dense"
    assert np.prod(gd.coarse.plan.sizes) < np.prod(gd.plan.sizes)
    pc = tgrid.precond_dense_f32(grids, "cpu")
    assert pc[0].plan.mode == "dense" and pc[0].WtW is not None
    assert pc[0].WtW.dtype == torch.float32
    fi = tgrid.fine_fft_f32(grids, "cpu")
    assert fi[0].plan.mode == "fft" and fi[0].dists.dtype == torch.float32
    assert fi[0].coarse is None


def test_precond_twin_full_resolution_under_cap(monkeypatch, rng):
    """Between DENSE_MAX_GRID and PRECOND_MAX_GRID the twin keeps the
    exact fine geometry, sharing the fine artifacts."""
    monkeypatch.setattr(tgrid, "DENSE_MAX_GRID", 64)
    Xs, _ = _data(rng, 60, 50)
    spec = _spec().with_input_dim(1)
    grids, _ = tgrid.make_grids(spec, [x.reshape(-1, 1) for x in Xs], m=[96])
    gd = grids[0]
    assert gd.plan.mode == "fft"
    assert gd.coarse.plan.sizes == gd.plan.sizes
    np.testing.assert_array_equal(gd.coarse.dists, gd.dists)
    # placed once: the fine float32 copy and the twin share the tensors
    memo = {}
    pc = tgrid.precond_dense_f32(grids, "cpu", memo)
    fi = tgrid.fine_fft_f32(grids, "cpu", memo)
    assert pc[0].dists is fi[0].dists


def test_coarse_kski_approximates_fine(small_cap, rng):
    """The coarse operator is spectrally close to the fine one (what
    makes it a good preconditioner)."""
    Xs, _ = _data(rng, 80, 60)
    spec = _spec().with_input_dim(1)
    params = T.InterpolatedLLGP(
        Xs, [np.sin(x) for x in Xs], functional_kernel=_spec(), m=[96],
        device="cpu").params
    grids, _ = tgrid.make_grids(spec, [x.reshape(-1, 1) for x in Xs], m=[96],
                                mode="fft")
    K_fine = tgrid.build_kski(
        spec, params, tuple(g.to(torch.float64, "cpu") for g in grids),
        [80, 60])
    K_coarse = tgrid.build_kski(spec, cast_params(params, torch.float32),
                                tgrid.precond_dense_f32(grids, "cpu"),
                                [80, 60])
    v = rng.standard_normal(140)
    a = K_fine.matvec(torch.as_tensor(v)).numpy()
    b = K_coarse.matvec(torch.as_tensor(v, dtype=torch.float32)).numpy()
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert rel < 0.05, rel


def test_large_grid_certified_prediction(small_cap, rng):
    """Beyond-cap model end to end: training runs, the prediction solves
    certify true residuals below the tolerance through the coarse
    preconditioner, and the fit beats predicting the mean."""
    Xs, Ys = _data(rng)
    m = _model(Xs, Ys, grid_mode="fft")
    assert m.objective == "stochastic"  # fft grids cannot go exact
    assert np.prod(m.precond_data32[0].plan.sizes) < np.prod(
        m.grid_data[0].plan.sizes)
    m.optimize(optimizer=T.AdaDelta(max_it=8))
    tx = [np.linspace(0.1, 0.9, 30)] * 2
    mus, vs = m.predict(tx)
    worst = max(d["residual"] for d in m.prediction_report.values())
    assert worst <= m.tolerance, m.prediction_report
    assert all(np.all(np.asarray(v) >= 0) for v in vs)
    f = np.sin(8 * tx[0])
    smse = np.mean((np.asarray(mus[0]) - f) ** 2) / np.var(f)
    assert smse < 0.6, smse


def test_exact_objective_needs_dense_grids(small_cap, rng):
    Xs, Ys = _data(rng, 40, 30)
    with pytest.raises(ValueError, match="dense mode"):
        _model(Xs, Ys, objective="exact")
    assert _model(Xs, Ys, objective="auto").objective == "stochastic"


def _tiny_noise(m):
    params = dict(m.params)
    params["noise"] = torch.as_tensor(POSITIVE.inverse(2e-5 * np.ones(2)),
                                      dtype=m.dtype)
    m.set_params(params)


def test_training_escalation_fires_and_certifies(small_cap, rng, caplog):
    """Tiny noise stalls the plain chunk solves above the tolerance; the
    rescue fires and brings the worst chunk residual below it."""
    Xs, Ys = _data(rng)
    m = _model(Xs, Ys, grid_mode="fft")
    _tiny_noise(m)
    with caplog.at_level(logging.WARNING):
        info = m.optimize(optimizer=T.AdaDelta(max_it=4))
    assert info["rescued_chunks"] >= 1, "escalation did not fire"
    assert info["max_solve_error"] <= m.tolerance, info
    assert np.all(np.isfinite(m.param_array))


def test_rung2_certified_rescue_steps(small_cap, rng):
    """Rung 2: breached chunk steps re-run with certified-ladder solves
    land below the tolerance, the certified prefix is kept as it was, and
    the model's parameters are restored."""
    Xs, Ys = _data(rng)
    m = _model(Xs, Ys, grid_mode="fft")
    _tiny_noise(m)
    x0 = m.param_array
    z = np.zeros_like(x0)
    opt = T.AdaDelta()
    plain = m._chunk(x0, z, z, z, opt, n_steps=3, run_seed=7)
    errs = np.asarray(plain[6], dtype=float)
    assert np.any(errs > m.tolerance), errs
    x_before = m.param_array.copy()
    out = m._rescue_steps_certified((x0, z, z, z), plain, 0, opt, 7)
    assert all(len(np.asarray(o)) == 3 for o in out)
    assert np.max(out[6]) <= m.tolerance, out[6]
    j0 = int(np.argmax(errs > m.tolerance))
    if j0 > 0:
        np.testing.assert_array_equal(out[0][:j0], plain[0][:j0])
    np.testing.assert_array_equal(m.param_array, x_before)


def test_rescue_chunk_step_runs_plain_krylov(small_cap, rng):
    """Rung 1's single step: plain model-dtype Krylov without the
    preconditioner, on the same probes as the chunk it re-runs."""
    Xs, Ys = _data(rng, 80, 60)
    m = _model(Xs, Ys, grid_mode="fft", tolerance=1e-6)
    x0 = m.param_array
    z = np.zeros_like(x0)
    opt = T.AdaDelta()
    a = m._chunk(x0, z, z, z, opt, n_steps=1, run_seed=3)
    b = m._chunk(x0, z, z, z, opt, n_steps=1, run_seed=3, rescue=True)
    assert float(b[6][0]) <= 1e-6 and float(a[6][0]) <= 1e-6
    # both certify to 1e-6: the same step to that accuracy, by another
    # path (more, plain iterations)
    np.testing.assert_allclose(b[0], a[0], rtol=1e-4, atol=1e-6)
    assert b[5][0] > a[5][0]


def test_rescue_keeps_plain_result_when_better(small_cap, rng):
    """Healthy conditioning: no rescue, the residuals already certify."""
    Xs, Ys = _data(rng)
    m = _model(Xs, Ys, grid_mode="fft", tolerance=1e-2)
    info = m.optimize(optimizer=T.AdaDelta(max_it=4))
    assert info["rescued_chunks"] == 0
    assert info["max_solve_error"] <= 1e-2


def test_certified_solve_minres_rung(small_cap, rng, caplog, monkeypatch):
    """The certified solve of an fft model escalates past the float32
    factor to model-dtype cycles and then to plain MINRES when the
    preconditioned rungs cannot reach the tolerance (here they are cut
    to one iteration), and reports the true residual of what it
    keeps."""
    import runlmc_tpu_torch.models.interpolated_llgp as tmod

    calls = []

    def counted(*args, **kw):
        calls.append(kw.get("cycle"))
        return real(*args, **kw)

    def one_iteration(*args, **kw):
        # rungs 1 and 1.5 stall: one iteration each
        return real_pcg(*args, **dict(kw, maxiter=1))

    real = tmod.batched_minres
    real_pcg = tmod.wbm.woodbury_pcg
    monkeypatch.setattr(tmod, "batched_minres", counted)
    monkeypatch.setattr(tmod.wbm, "woodbury_pcg", one_iteration)
    Xs, Ys = _data(rng, 80, 60)
    m = _model(Xs, Ys, grid_mode="fft", tolerance=1e-8)
    _tiny_noise(m)
    rhs = torch.cat([m.y[None], torch.as_tensor(
        np.sign(rng.standard_normal((3, len(m.y)))))], 0)
    with caplog.at_level(logging.WARNING):
        x, worst = m._solve_certified(rhs, "probe", maxiter=300)
    rep = m.prediction_report["probe"]
    assert rep["escalated"] and rep["rhs"] == 4
    assert "plain-Krylov rung" in caplog.text
    assert calls == [tmod.KRYLOV_CYCLE]
    r = rhs - m._kski().matvec(x)
    true = float(torch.max(torch.linalg.norm(r, dim=1)))
    np.testing.assert_allclose(worst, true, rtol=1e-6)
    assert worst <= 1e-8

"""Checkpoint and resume (runlmc_tpu_torch/utils/checkpoint.py,
``MultiGP.save``/``restore``): one ``.npz`` that both packages read, a
resumed training run bit-identical to an uninterrupted one, and the
port's own state (run seeds, escalation, priors) restored."""

import json

import jax
import numpy as np
import pytest
import torch

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.utils import checkpoint as jck
from runlmc_tpu_torch.utils import checkpoint as tck


def _data():
    rng = np.random.RandomState(0)
    Xs = [rng.uniform(0, 4, (n, 1)) for n in (30, 26)]
    Ys = [np.sin(3 * X[:, 0]) + 0.1 * rng.standard_normal(len(X))
          for X in Xs]
    return Xs, Ys


def _spec(pkg):
    return pkg.LMCKernelSpec.create(
        D=2, lmc_kernels=[pkg.RBF()], lmc_ranks=[1],
        indep_gp=[pkg.Matern32(name="i")],
    )


def _port(objective="exact", seed=0, **kw):
    Xs, Ys = _data()
    return T.InterpolatedLLGP(Xs, Ys, functional_kernel=_spec(T), m=[10],
                              objective=objective, tolerance=1e-8,
                              seed=seed, device="cpu", **kw)


def _jax(**kw):
    Xs, Ys = _data()
    return R.InterpolatedLLGP(Xs, Ys, functional_kernel=_spec(R), m=[10],
                              objective="exact", **kw)


def _perturb(model):
    x = model.param_array
    model.param_array = x + 0.1 * np.cos(np.arange(len(x)))


def test_jax_written_file_loads_into_port(tmp_path):
    mj = _jax()
    _perturb(mj)
    for i, norm in enumerate(mj.normalizer):
        norm.mean += 0.5 + i
        norm.std *= 1.25
    n = mj.n_params
    rng = np.random.RandomState(1)
    opt = {"gms": rng.uniform(size=n), "sms": rng.uniform(size=n),
           "step": rng.standard_normal(n), "rolling_max": 3.5, "drops": 4,
           "n_iter": 10, "rng_key": np.asarray(jax.random.PRNGKey(7))}
    path = str(tmp_path / "jax.npz")
    mj.save(path, opt_state=opt, extra={"note": 2.0})

    mt = _port()
    with pytest.warns(RuntimeWarning, match="JAX package"):
        ckpt = mt.restore(path)
    np.testing.assert_array_equal(mt.param_array, mj.param_array)
    for a, b in zip(mt.normalizer, mj.normalizer):
        assert (a.mean, a.std) == (b.mean, b.std)
    for k in ("gms", "sms", "step"):
        np.testing.assert_array_equal(ckpt["opt_state"][k], opt[k])
    assert ckpt["extra"]["note"] == 2.0 and "torch" not in ckpt
    # the JAX run key cannot continue the port's probe stream: optimize
    # keeps its own, with a warning, from JAX's moments and stop state
    with pytest.warns(RuntimeWarning, match="JAX package"):
        info = mt.optimize(T.AdaDelta(max_it=11), state=ckpt["opt_state"])
    assert info["n_iter"] == 11
    assert np.asarray(info["state"]["rng_key"]).dtype == np.int64


def test_port_written_file_loads_into_jax(tmp_path):
    mt = _port(seed=3)
    _perturb(mt)
    mt.normalizer[1].mean += 2.0
    info = mt.optimize(T.AdaDelta(max_it=3))
    path = str(tmp_path / "port.npz")
    mt.save(path, opt_state=info["state"], extra={"tag": np.arange(3)})

    ckpt = jck.load_checkpoint(path)
    assert sorted(ckpt) == ["extra", "norm_means", "norm_stds", "opt_state",
                            "param_array", "rng_key"]
    mj = jck.restore_model(_jax(seed=3), ckpt)
    np.testing.assert_array_equal(np.asarray(mj.param_array), mt.param_array)
    for a, b in zip(mj.normalizer, mt.normalizer):
        assert (a.mean, a.std) == (b.mean, b.std)
    np.testing.assert_array_equal(np.asarray(mj._key),
                                  np.asarray(jax.random.PRNGKey(3)))
    run_seed = int(info["state"]["rng_key"])
    opt = ckpt["opt_state"]
    assert opt["rng_key"].dtype == np.uint32
    np.testing.assert_array_equal(opt["rng_key"],
                                  np.asarray(jax.random.PRNGKey(run_seed)))
    for k in ("gms", "sms", "step", "rolling_max", "drops", "n_iter"):
        np.testing.assert_array_equal(opt[k], info["state"][k])
    # the port's own reading keeps the int64 run seed
    back = tck.load_checkpoint(path)
    assert back["opt_state"]["rng_key"].dtype == np.int64
    assert int(back["opt_state"]["rng_key"]) == run_seed


def test_prng_key_layout_matches_jax():
    for seed in (0, 5, 2**31 - 2, 2**32 + 9):
        np.testing.assert_array_equal(tck.prng_key(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))


def test_no_object_arrays_in_the_file(tmp_path):
    mt = _port()
    mt.set_prior(("noise",), T.Gamma(2.0, 10.0))
    info = mt.optimize(T.AdaDelta(max_it=2))
    path = str(tmp_path / "c.npz")
    mt.save(path, opt_state=info["state"])
    with np.load(path, allow_pickle=False) as z:
        kinds = {k: z[k].dtype.kind for k in z.files}
    assert "O" not in kinds.values()
    assert {"torch__seed_rng", "torch__priors", "torch__objective",
            "torch__run_seed"} <= set(kinds)


@pytest.mark.parametrize("objective", ["exact", "stochastic"])
def test_resume_is_bit_identical(tmp_path, objective):
    """20-step budget, stopped by the rule after the chunk boundary at
    10: the uninterrupted run against a checkpoint after 10 steps
    restored into a fresh model and resumed."""
    opt = dict(max_it=40, min_grad_ratio=0.3)
    m_all = _port(objective)
    info_all = m_all.optimize(T.AdaDelta(**opt))
    assert 10 < info_all["n_iter"] < 40

    m_half = _port(objective)
    info_half = m_half.optimize(T.AdaDelta(**dict(opt, max_it=10)))
    assert info_half["n_iter"] == 10
    path = str(tmp_path / "half.npz")
    m_half.save(path, opt_state=info_half["state"])

    m_res = _port(objective, seed=9)  # its own seed is overwritten
    ckpt = m_res.restore(path)
    info_res = m_res.optimize(T.AdaDelta(**opt), state=ckpt["opt_state"])
    assert info_res["n_iter"] == info_all["n_iter"]
    np.testing.assert_array_equal(m_res.param_array, m_all.param_array)
    assert info_res["grad_norms"] == info_all["grad_norms"][10:]
    for k in ("gms", "sms", "step"):
        np.testing.assert_array_equal(info_res["state"][k],
                                      info_all["state"][k])
    assert info_res["state"]["rng_key"] == info_all["state"]["rng_key"]
    # the run-seed stream continues where the saved model's was
    assert m_res._next_run_seed() == m_half._next_run_seed()


@pytest.mark.parametrize("rung", ["model", "flip", "stochastic"])
def test_escalated_model_stays_escalated(tmp_path, rung):
    m = _port()
    if rung == "model":
        m._escalate(1.0, m.param_array)  # float32 -> model precision
        want = ("exact", "model", None, False)
    elif rung == "flip":
        m.exact_precision = "model"
        m._equilibrate, m._equilibrate_flip_tried = True, True
        want = ("exact", "model", True, True)
    else:
        m.exact_precision = "model"
        m._equilibrate_flip_tried = True
        m._escalate(1.0, m.param_array)  # nothing left: stochastic
        want = ("stochastic", "model", None, True)
    path = str(tmp_path / "esc.npz")
    m.save(path)
    fresh = _port()
    assert fresh.exact_precision == "f32"
    fresh.restore(path)
    assert (fresh.objective, fresh.exact_precision, fresh._equilibrate,
            fresh._equilibrate_flip_tried) == want
    assert fresh._auto_exact_guard is False


def test_auto_guard_state_round_trips(tmp_path):
    m = _port(objective="auto")
    assert m._auto_exact_guard
    path = str(tmp_path / "g.npz")
    m.save(path)
    fresh = _port()
    fresh.restore(path)
    assert fresh._auto_exact_guard and fresh.objective == m.objective


def test_priors_round_trip(tmp_path):
    m = _port()
    m.set_prior(("noise",), T.Gamma(2.0, 10.0))
    m.set_prior(("kernels", "q0", "inv_lengthscale"), T.InverseGamma(3, 2))
    m.set_prior(("coreg_vecs", "q0"), T.Gaussian(0.0, 2.0))
    path = str(tmp_path / "p.npz")
    m.save(path)
    fresh = _port()
    fresh.restore(path)
    assert [(p, pr) for p, pr, _ in fresh._prior_specs] == \
        [(p, pr) for p, pr, _ in m._prior_specs]
    assert float(fresh._log_prior(fresh.params)) == \
        float(m._log_prior(m.params))


@pytest.mark.parametrize("entry", [
    {"prior": "check_domain", "args": {}},
    {"prior": "Prior", "args": {}},
    {"prior": "Gamma", "args": {"a": 2.0}},
    {"prior": "Gamma", "args": {"a": "2", "b": 10.0}},
])
def test_unknown_prior_in_file_raises(tmp_path, entry):
    m = _port()
    m.set_prior(("noise",), T.Gamma(2.0, 10.0))
    state = tck.checkpoint_state(m)
    state["torch__priors"] = np.asarray(json.dumps(
        [dict(entry, path=["noise"])]))
    path = str(tmp_path / "bad.npz")
    np.savez(path, **state)
    with pytest.raises(ValueError, match="prior"):
        _port().restore(path)


def test_wrong_parameter_count_raises(tmp_path):
    path = str(tmp_path / "a.npz")
    _port().save(path)
    Xs, Ys = _data()
    other = T.InterpolatedLLGP(
        Xs, Ys, functional_kernel=T.LMCKernelSpec.create(
            D=2, lmc_kernels=[T.RBF()], lmc_ranks=[2]),
        m=[10], objective="exact", device="cpu")
    with pytest.raises(ValueError, match="parameters"):
        other.restore(path)


def test_newer_format_version_raises(tmp_path):
    path = str(tmp_path / "v.npz")
    state = tck.checkpoint_state(_port())
    state["format_version"] = np.asarray(tck.FORMAT_VERSION + 1)
    np.savez(path, **state)
    with pytest.raises(ValueError, match="newer"):
        tck.load_checkpoint(path)


def test_exact_lmc_save_restore(tmp_path):
    Xs, Ys = _data()
    e = T.ExactLMC(Xs, Ys, functional_kernel=_spec(T), device="cpu")
    _perturb(e)
    path = str(tmp_path / "e.npz")
    e.save(path)
    f = T.ExactLMC(Xs, Ys, functional_kernel=_spec(T), device="cpu")
    f.restore(path)
    np.testing.assert_array_equal(f.param_array, e.param_array)
    assert all(leaf.device.type == "cpu"
               for leaf in f.params["coreg_vecs"].values())
    torch.testing.assert_close(f.params["noise"], e.params["noise"],
                               rtol=0, atol=0)

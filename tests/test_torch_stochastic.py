"""The stochastic objective: the Hutchinson surrogate (kernel K14 of the
kernel table), its gradient through the fft operator (K10's backward)
or the dense one (K1's), a short stochastic ``optimize`` with the JAX
package's probe stream fed through the port's probe hook, and the
port's own probe stream — the port against the JAX package on the same
numpy inputs, in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import likelihood as jlk
from runlmc_tpu_torch.datasets import weather_synthetic
from runlmc_tpu_torch.lmc import likelihood as tlk
from runlmc_tpu_torch.utils.carry import (
    from_reference_params,
    ravel_params,
    unravel_params,
)


def _weather_spec(pkg, D):
    """The weather configuration's kernel (bench.py:78-94): SLFM rank 2
    plus a frozen-scale RBF per output."""
    return pkg.LMCKernelSpec.create(
        D=D, slfm_kernels=[pkg.RBF(name="slfm0"), pkg.RBF(name="slfm1")],
        indep_gp=[pkg.Scaled(inner=pkg.RBF(name="rbf%d" % i),
                             trainable_scale=False) for i in range(D)],
    )


def _problem(kind):
    """(Xs, Ys, spec maker, m, grid_mode) of a small model: a 1-D slfm
    spec on an fft or a dense grid, or the synth shape (bench.py:114-130:
    D=5, P=2, slfm rank 2 plus an RBF per output) on an fft grid."""
    rng = np.random.RandomState(31)
    if kind in ("1d_fft", "1d_dense"):
        Xs = [np.sort(rng.uniform(0, 6, n)) for n in (40, 34, 37)]
        Ys = [np.sin(X + d) + 0.3 * d + 0.05 * rng.randn(len(X))
              for d, X in enumerate(Xs)]
        return (Xs, Ys, lambda pkg: _weather_spec(pkg, 3), [24],
                kind.split("_")[1])
    Xs = [rng.uniform(0, 1, (22, 2)) for _ in range(5)]
    Ys = [np.sin(3 * X[:, 0] + d) * np.cos(2 * X[:, 1])
          + 0.05 * rng.randn(22) for d, X in enumerate(Xs)]

    def mk(pkg):
        return pkg.LMCKernelSpec.create(
            D=5, slfm_kernels=[pkg.RBF(name="slfm0"), pkg.RBF(name="slfm1")],
            indep_gp=[pkg.RBF(name="rbf%d" % i) for i in range(5)],
        )

    return Xs, Ys, mk, [7, 6], "fft"


def _pair(kind, **kw):
    Xs, Ys, mk, m, mode = _problem(kind)
    kw = dict(dict(m=m, grid_mode=mode, objective="stochastic", seed=3), **kw)
    mj = R.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(R), **kw)
    mt = T.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(T), device="cpu",
                            **kw)
    p0 = mj.param_array + 0.1 * np.cos(np.arange(mj.n_params))
    mj.param_array = p0
    mt.param_array = p0
    return mj, mt


def _jax_probes(key, n_probes, n):
    return np.asarray(jlk.rademacher_probes(key, n_probes, n, jnp.float64))


def _flat_grad_t(fn, params):
    x = ravel_params(params).detach().clone().requires_grad_(True)
    out = fn(unravel_params(x, params))
    (g,) = torch.autograd.grad(out, x)
    return out.detach(), g.numpy()


@pytest.mark.parametrize("kind", ["1d_fft", "1d_dense", "2d_synth"])
def test_surrogate_from_solves_matches_jax(kind):
    """The surrogate's value and gradient from the same alpha, z and
    probes: K10's backward (fft) or K1's (dense) against XLA's autodiff."""
    mj, mt = _pair(kind)
    n = len(mt.data.y)
    rng = np.random.RandomState(4)
    alpha = rng.standard_normal(n)
    zs = rng.standard_normal((3, n))
    probes = np.sign(rng.standard_normal((3, n)))
    want_v, want_g = jax.jit(jax.value_and_grad(
        lambda p: jlk.stochastic_surrogate_from_solves(
            mj.spec, p, mj.grid_data, mj.data.lens, jnp.asarray(alpha),
            jnp.asarray(zs), jnp.asarray(probes))))(mj.params)
    want_g = np.asarray(ravel_pytree(want_g)[0])
    got_v, got_g = _flat_grad_t(
        lambda p: tlk.stochastic_surrogate_from_solves(
            mt.spec, p, mt.grid_data, mt.data.lens, torch.as_tensor(alpha),
            torch.as_tensor(zs), torch.as_tensor(probes)), mt.params)
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=1e-10)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-10,
                               atol=1e-10 * np.abs(want_g).max())


@pytest.mark.parametrize("precond", [True, False])
@pytest.mark.parametrize("kind", ["1d_fft", "2d_synth"])
def test_surrogate_gradient_matches_jax(kind, precond):
    """The whole surrogate with JAX's probes at tolerance 1e-10: the
    Woodbury-preconditioned mixed-precision solve or plain MINRES, then
    the gradient through the model-dtype operator."""
    mj, mt = _pair(kind)
    n = len(mt.data.y)
    probes = _jax_probes(jax.random.PRNGKey(5), 4, n)
    kw_j = dict(grid_data32=mj.precond_data32,
                inner_data32=mj.inner_data32) if precond else {}
    kw_t = dict(grid_data32=mt.precond_data32,
                inner_data32=mt.inner_data32) if precond else {}

    def fj(p):
        return -jlk.stochastic_mll_surrogate(
            mj.spec, p, mj.grid_data, mj.data.lens, mj.y,
            jnp.asarray(probes), tol=1e-10, **kw_j)[0]

    want = np.asarray(ravel_pytree(jax.jit(jax.grad(fj))(mj.params))[0])
    auxes = []

    def ft(p):
        s, aux = tlk.stochastic_mll_surrogate(
            mt.spec, p, mt.grid_data, mt.data.lens, mt.y,
            torch.as_tensor(probes), tol=1e-10, **kw_t)
        auxes.append(aux)
        return -s

    _, got = _flat_grad_t(ft, mt.params)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    assert float(auxes[0].solve_error) <= 1e-10
    assert float(auxes[0].solve_iters) > 0


def _feed_jax_probes(mj, mt):
    """Point the port's probe hook at the JAX model's stream for its next
    ``optimize``: JAX folds the global iteration into the run key that
    its next ``_next_key`` returns."""
    _, run_key = jax.random.split(mj._key)
    n = len(mt.data.y)

    def stream(run_seed, it):
        return _jax_probes(jax.random.fold_in(run_key, it), mt.n_probes, n)

    mt.probe_stream = stream


@pytest.fixture(params=["1d_fft", "2d_synth"], scope="module")
def trained(request):
    mj, mt = _pair(request.param, tolerance=1e-10)
    _feed_jax_probes(mj, mt)
    ij = mj.optimize(optimizer=R.AdaDelta(max_it=5))
    it = mt.optimize(optimizer=T.AdaDelta(max_it=5))
    return mj, mt, ij, it


def test_stochastic_optimize_matches_jax(trained):
    mj, mt, ij, it = trained
    assert mj.objective == mt.objective == "stochastic"
    assert it["n_iter"] == ij["n_iter"]
    np.testing.assert_allclose(mt.param_array, mj.param_array, rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(it["grad_norms"], ij["grad_norms"],
                               rtol=1e-6)
    assert it["rescued_chunks"] == ij["rescued_chunks"] == 0
    assert it["max_solve_error"] <= 1e-10
    assert it["mean_solve_iters"] > 0


def test_stochastic_grad_is_finite(trained):
    _, mt, _, _ = trained
    g = mt.stochastic_grad()
    assert g.shape == (mt.n_params,) and np.all(np.isfinite(g))


def test_probe_stream_ignores_chunk_boundaries():
    """The probes of a global iteration depend on (run seed, iteration)
    only: chunks of 3 and of 10 steps, and a resume from
    ``info['state']``, train the same parameters."""
    _, mt = _pair("1d_fft")
    full = mt.optimize(optimizer=T.AdaDelta(max_it=6))
    seed = int(full["state"]["rng_key"])

    _, mt2 = _pair("1d_fft")  # the same model seed: the same run seed
    mt2.chunk_len = 3
    first = mt2.optimize(optimizer=T.AdaDelta(max_it=4))
    assert int(first["state"]["rng_key"]) == seed
    rest = mt2.optimize(optimizer=T.AdaDelta(max_it=6), state=first["state"])
    assert rest["n_iter"] == full["n_iter"] == 6
    np.testing.assert_array_equal(mt2.param_array, mt.param_array)
    np.testing.assert_array_equal(rest["grad_norms"], full["grad_norms"][4:])

    a = mt._probes(seed, 2)
    assert torch.equal(a, mt._probes(seed, 2))
    assert not torch.equal(a, mt._probes(seed, 3))
    assert not torch.equal(a, mt._probes(seed + 1, 2))
    assert set(torch.unique(a).tolist()) == {-1.0, 1.0}


def test_fresh_runs_draw_fresh_streams():
    _, mt = _pair("1d_fft")
    p0 = mt.param_array
    a = mt.optimize(optimizer=T.AdaDelta(max_it=2))
    mt.param_array = p0
    b = mt.optimize(optimizer=T.AdaDelta(max_it=2))
    assert int(a["state"]["rng_key"]) != int(b["state"]["rng_key"])


def test_weather_spec_carries():
    """The weather configuration's six kernels (SLFM coregionalization
    vectors, frozen Scaled scales) carry across: the same raw tree, flat
    order and coregionalization matrices as the JAX package."""
    sj, st = _weather_spec(R, 4).with_input_dim(1), \
        _weather_spec(T, 4).with_input_dim(1)
    assert st.Q == sj.Q == 6
    raw = sj.init_raw_params(seed=2)
    flat_j = np.asarray(ravel_pytree(raw)[0])
    pt = from_reference_params(jax.device_get(raw), torch.float64, "cpu")
    np.testing.assert_array_equal(ravel_params(pt).numpy(), flat_j)
    np.testing.assert_array_equal(
        ravel_params(from_reference_params(st.init_raw_params(seed=2),
                                           torch.float64, "cpu")).numpy(),
        flat_j)
    for q in range(6):
        np.testing.assert_allclose(st.coreg_mats(pt, (q,)).numpy(),
                                   np.asarray(sj.coreg_mats(raw, (q,))),
                                   rtol=1e-14)
    d = torch.linspace(0, 2, 7, dtype=torch.float64)
    np.testing.assert_allclose(
        st.eval_kernels_stacked(pt, d, tuple(range(6))).numpy(),
        np.asarray(sj.eval_kernels_stacked(raw, jnp.asarray(d.numpy()),
                                           tuple(range(6)))),
        rtol=1e-14)
    # the frozen scales are no parameters in either package
    for q in range(2, 6):
        assert set(raw["kernels"]["q%d" % q]) == set(pt["kernels"]["q%d" % q]) \
            == {"inner__inv_lengthscale"}


def test_weather_synthetic_shape():
    xss, yss, txs, tys, sensors = weather_synthetic(seed=0)
    assert len(xss) == len(yss) == 4 and len(sensors) == 4
    n = sum(len(x) for x in xss)
    assert 15_000 <= n <= 16_500
    assert [len(t) > 0 for t in txs] == [False, True, True, False]
    for x, t, (lo, hi) in zip(xss[1:3], txs[1:3],
                              [(10.2, 10.8), (13.5, 14.2)]):
        assert np.all((t >= lo) & (t <= hi))
        assert not np.any((x >= lo) & (x <= hi))
        # 5-minute spacing, a few readings dropped
        assert np.min(np.diff(x)) == pytest.approx(5 / 1440)
    a = weather_synthetic(seed=0)
    np.testing.assert_array_equal(a[1][0], yss[0])
    assert all(np.all(np.isfinite(y)) for y in yss)

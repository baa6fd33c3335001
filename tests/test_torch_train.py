"""Exact-objective training: the exact SKI MLL's gradient, the gradient
through the jittered Cholesky, AdaDelta and a short ``optimize`` — the
port against the JAX package on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu.lmc import likelihood as jlk
from runlmc_tpu.lmc import woodbury as jwb
from runlmc_tpu.models import optimization as jopt
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.lmc import likelihood as tlk
from runlmc_tpu_torch.lmc import woodbury as twb
from runlmc_tpu_torch.models import optimization as topt
from runlmc_tpu_torch.utils.carry import _leaves, from_reference_params


def _perturbed(raw, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)), raw
    )


def _mll_problem(groups):
    """(JAX spec, port spec, Xs, y, raw params, m): one active-dim group
    (1-D, lmc + indep, m=10) or two (2-D input split over the dims, so
    the capacitance has cross blocks)."""
    rng = np.random.RandomState(3)
    if groups == 1:
        Xs = [rng.uniform(0, 4, (n, 1)) for n in (26, 31)]

        def mk(pkg):
            return pkg.LMCKernelSpec.create(
                D=2, lmc_kernels=[pkg.RBF()], lmc_ranks=[2],
                indep_gp=[pkg.Matern32(name="i")],
            ).with_input_dim(1)

        m = [10]
    else:
        Xs = [rng.uniform(0, 1, (n, 2)) for n in (30, 24)]

        def mk(pkg):
            return pkg.LMCKernelSpec.create(
                D=2, lmc_kernels=[pkg.RBF(name="a", active_dims=(0,))],
                lmc_ranks=[1],
                indep_gp=[pkg.Matern32(name="b", active_dims=(1,)),
                          pkg.RBF(name="c", active_dims=(1,))],
            ).with_input_dim(2)

        m = [7, 6]
    y = np.concatenate([np.sin(3 * X[:, 0]) + 0.1 * rng.standard_normal(len(X))
                        for X in Xs])
    sj, st = mk(R), mk(T)
    raw = _perturbed(sj.init_raw_params(seed=1), 2)
    return sj, st, Xs, y, raw, m


def _mll_grads(groups, dtype, equilibrate):
    sj, st, Xs, y, raw, m = _mll_problem(groups)
    lens = [len(X) for X in Xs]
    gj, _ = jgrid.make_grids(sj, Xs, m=m)
    gt, _ = tgrid.make_grids(st, Xs, m=m)
    assert len(gj) == groups
    gj = jax.tree.map(lambda a: jnp.asarray(a, dtype)
                      if np.asarray(a).dtype.kind == "f" else jnp.asarray(a),
                      gj)

    def obj(p):
        return jlk.exact_ski_mll(sj, p, gj, lens, jnp.asarray(y, dtype),
                                 equilibrate=equilibrate)[0]

    want = jax.jit(jax.grad(obj))(
        jax.tree.map(lambda a: jnp.asarray(a, dtype), raw))
    want = np.concatenate([np.asarray(w).ravel()
                           for w in jax.tree_util.tree_leaves(want)])
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    pt = from_reference_params(raw, tdt, "cpu")
    leaves = [leaf.requires_grad_(True) for _, leaf in _leaves(pt)]
    mll, aux = tlk.exact_ski_mll(
        st, pt, tuple(gd.to(tdt, "cpu") for gd in gt), lens,
        torch.as_tensor(y, dtype=tdt), equilibrate=equilibrate,
    )
    assert not (aux.alpha.requires_grad or aux.solve_error.requires_grad
                or aux.quad.requires_grad)
    got = torch.autograd.grad(mll, leaves)
    got = np.concatenate([g.numpy().ravel() for g in got])
    return got.astype(float), want.astype(float)


@pytest.mark.parametrize("equilibrate", [True, False])
@pytest.mark.parametrize("groups", [1, 2])
def test_exact_mll_gradient_f64(groups, equilibrate):
    got, want = _mll_grads(groups, np.float64, equilibrate)
    # the same factorization at the same jitter scale in both packages;
    # the gradient goes through two Cholesky VJPs of a small,
    # well-conditioned problem
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("equilibrate", [True, False])
@pytest.mark.parametrize("groups", [1, 2])
def test_exact_mll_gradient_f32(groups, equilibrate):
    got, want = _mll_grads(groups, np.float32, equilibrate)
    # float32 factors round differently in each package
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos >= 0.999
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2


def _indefinite(n=30, seed=0):
    """Symmetric, one eigenvalue -5e-5, the rest in [1, 2]: a jitter of
    1e-6 relative to the diagonal leaves it indefinite, 1e-4 does not."""
    rng = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.concatenate([[-5e-5], np.linspace(1.0, 2.0, n - 1)])
    return (U * eig) @ U.T


@pytest.mark.parametrize("equilibrate", [True, False])
def test_chol_jittered_gradient_at_the_second_scale(equilibrate):
    A = _indefinite()
    w = np.random.RandomState(1).standard_normal(A.shape)

    def f_j(a):
        L = jwb.chol_jittered(a, equilibrate=equilibrate)
        return jnp.sum(jnp.tril(jnp.asarray(w)) * L)

    want = np.asarray(jax.jit(jax.grad(f_j))(jnp.asarray(A)))
    At = torch.as_tensor(A).requires_grad_(True)
    L = twb.chol_jittered(At, equilibrate=equilibrate)
    (got,) = torch.autograd.grad(torch.sum(torch.tril(torch.as_tensor(w))
                                           * L), At)
    assert np.all(np.isfinite(got.numpy()))
    # the Cholesky VJPs of the two frameworks return differently
    # symmetrized cotangents of a symmetric input: compare the
    # symmetric parts, which are what a symmetric A's perturbation sees
    got_s = 0.5 * (got.numpy() + got.numpy().T)
    want_s = 0.5 * (want + want.T)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-8,
                               atol=1e-8 * np.abs(want_s).max())


def _oracle(seed=0, n=6):
    """A deterministic gradient oracle: a convex quadratic plus a small
    smooth term."""
    rng = np.random.RandomState(seed)
    M = rng.standard_normal((n, n))
    A = M @ M.T / n + np.eye(n)
    b = rng.standard_normal(n)

    def fprime(x):
        return A @ x - b + 0.1 * np.sin(x)

    return fprime, rng.standard_normal(n)


def _host_chunk(opt, fprime, length):
    """A run_chunk for minimize_chunked: ``length`` AdaDelta steps with
    the chunked update rule, on the host."""

    def run_chunk(x, gms, sms, step, start_iter):
        outs = []
        for _ in range(length):
            step1 = step * opt.momentum
            x = x - step1
            g = fprime(x)
            gms = opt.decay * gms + (1 - opt.decay) * g * g
            step2 = (np.sqrt(sms + opt.offset) / np.sqrt(gms + opt.offset)
                     * g * opt.step_rate)
            x = x - step2
            step = step1 + step2
            sms = opt.decay * sms + (1 - opt.decay) * step * step
            outs.append((x, gms, sms, step, np.max(np.abs(g))))
        return tuple(np.stack(c) for c in zip(*outs))

    return run_chunk


@pytest.mark.parametrize("kw,stop", [
    # max_it lands inside the fifth chunk of 5
    (dict(max_it=23), 23),
    # the rolling-max rule stops it first
    (dict(max_it=200, min_grad_ratio=0.5, permitted_drops=3), None),
])
def test_adadelta_matches_jax(kw, stop):
    fprime, x0 = _oracle()
    for method in ("minimize", "minimize_chunked"):
        runs = []
        for mod in (jopt, topt):
            opt = mod.AdaDelta(**kw)
            arg = fprime if method == "minimize" else _host_chunk(opt,
                                                                   fprime, 5)
            runs.append(getattr(opt, method)(x0, arg))
        (xj, ij), (xt, it) = runs
        np.testing.assert_array_equal(xt, xj)
        assert it["n_iter"] == ij["n_iter"]
        np.testing.assert_array_equal(it["grad_norms"], ij["grad_norms"])
        for k in ("gms", "sms", "step", "rolling_max", "drops", "n_iter"):
            np.testing.assert_array_equal(it["state"][k], ij["state"][k])
        if stop is None:
            assert it["n_iter"] < kw["max_it"]
        else:
            assert it["n_iter"] == stop


def _train_problem(kind):
    rng = np.random.RandomState(21)
    if kind == "1d":
        Xs = [np.sort(rng.uniform(0, 6, 30)) for _ in range(3)]
        Ys = [np.sin(X + d) + 0.3 * d + 0.05 * rng.randn(30)
              for d, X in enumerate(Xs)]

        def mk(pkg):
            return pkg.LMCKernelSpec.create(D=3, lmc_kernels=[pkg.RBF()],
                                            lmc_ranks=[2])

        return Xs, Ys, mk, [16]
    # shaped like the synth benchmark (bench.py:114-130), small: D=5,
    # P=2, slfm rank 2 plus an RBF per output, one 2-D grid
    Xs = [rng.uniform(0, 1, (20, 2)) for _ in range(5)]
    Ys = [np.sin(3 * X[:, 0] + d) * np.cos(2 * X[:, 1])
          + 0.05 * rng.randn(20) for d, X in enumerate(Xs)]

    def mk(pkg):
        return pkg.LMCKernelSpec.create(
            D=5, slfm_kernels=[pkg.RBF(name="slfm0"), pkg.RBF(name="slfm1")],
            indep_gp=[pkg.RBF(name="rbf%d" % i) for i in range(5)],
        )

    return Xs, Ys, mk, [6, 6]


@pytest.fixture(params=["1d", "2d_synth"], scope="module")
def trained(request):
    Xs, Ys, mk, m = _train_problem(request.param)
    kw = dict(functional_kernel=None, m=m, objective="exact",
              exact_precision="model")
    mj = R.InterpolatedLLGP(Xs, Ys, **dict(kw, functional_kernel=mk(R)))
    mt = T.InterpolatedLLGP(Xs, Ys, device="cpu",
                            **dict(kw, functional_kernel=mk(T)))
    p0 = mj.param_array + 0.1 * np.cos(np.arange(mj.n_params))
    mj.param_array = p0
    mt.param_array = p0
    ij = mj.optimize(optimizer=R.AdaDelta(max_it=5))
    it = mt.optimize(optimizer=T.AdaDelta(max_it=5))
    return mj, mt, ij, it, p0


def test_optimize_matches_jax(trained):
    mj, mt, ij, it, _ = trained
    assert it["n_iter"] == ij["n_iter"] == 5
    # float64 factorizations at the same jitter in both packages
    np.testing.assert_allclose(mt.param_array, mj.param_array, rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(it["grad_norms"], ij["grad_norms"],
                               rtol=1e-6)
    for k in ("device_seconds", "device_steps", "mean_solve_iters",
              "max_solve_error", "rescued_chunks"):
        assert k in it
    assert it["device_steps"] == mt.chunk_len
    assert it["max_solve_error"] < 1e-6
    assert mt.objective == "exact" and mt.exact_precision == "model"


def test_optimize_resumes_from_state(trained):
    _, mt, _, it, p0 = trained
    mt.param_array = p0
    first = mt.optimize(optimizer=T.AdaDelta(max_it=3))
    rest = mt.optimize(optimizer=T.AdaDelta(max_it=5), state=first["state"])
    # the run seed of the probe stream rides in the state, as the JAX
    # package's run key does, whatever the objective
    assert rest["n_iter"] == 5 and "rng_key" in rest["state"]
    np.testing.assert_allclose(rest["grad_norms"], it["grad_norms"][3:],
                               rtol=1e-12)


def test_optimize_f32_steps_close_to_jax():
    Xs, Ys, mk, m = _train_problem("1d")
    mj = R.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(R), m=m,
                            objective="exact")
    mt = T.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(T), m=m,
                            objective="exact", device="cpu")
    x = mj.param_array + 0.1 * np.cos(np.arange(mj.n_params))
    gj, _ = mj._jit_grad(jnp.asarray(x), jax.random.PRNGKey(0),
                         mj.grid_data, mj.precond_data32, mj.inner_data32,
                         mj.y)
    gt, aux = mt._exact_grad(torch.as_tensor(x))
    gj = np.asarray(gj)
    assert gt.dtype == torch.float64 and float(aux.solve_error) < 1e-3
    # float32 factorizations: each package rounds its own way
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-2,
                               atol=1e-3 * np.abs(gj).max())

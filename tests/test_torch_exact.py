"""The exact dense oracle: K7's backward (``CrossKernel``), ``exact_mll``
and its gradient, ``ExactLMC``, and the ``-inf`` log-det guard — the
port against the JAX package on the same numpy inputs, in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import likelihood as jlk
from runlmc_tpu_torch.hopper import cross
from runlmc_tpu_torch.lmc import likelihood as tlk
from runlmc_tpu_torch.utils.carry import (
    from_reference_params,
    ravel_params,
    unravel_params,
)


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


def _data(seed, n=40):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0, 2, (n, 2))
    oidx = np.sort(rng.randint(0, 3, n)).astype(np.int32)
    y = np.sin(2 * X[:, 0]) * np.cos(X[:, 1]) + 0.1 * rng.randn(n)
    return X, oidx, y


def _raw(sj, seed):
    rng = np.random.RandomState(100 + seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)),
        sj.init_raw_params(seed=seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_mll_value_and_grad_match_jax(seed):
    sj, st = _all_kinds(R), _all_kinds(T)
    raw = _raw(sj, seed)
    X, oidx, y = _data(seed)
    want_v, want_g = jax.jit(jax.value_and_grad(
        lambda p: jlk.exact_mll(sj, p, jnp.asarray(X), jnp.asarray(oidx),
                                jnp.asarray(y))))(
        jax.tree.map(jnp.asarray, raw))
    want_g = np.asarray(ravel_pytree(want_g)[0])
    params = from_reference_params(raw, torch.float64, "cpu")
    x = ravel_params(params).requires_grad_(True)
    got_v = tlk.exact_mll(st, unravel_params(x, params), torch.as_tensor(X),
                          torch.as_tensor(oidx), torch.as_tensor(y))
    (got_g,) = torch.autograd.grad(got_v, x)
    np.testing.assert_allclose(got_v.item(), float(want_v), rtol=1e-12)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-10,
                               atol=1e-10 * np.abs(want_g).max())


def _kernel_args(seed, dtype=torch.float64):
    st = _all_kinds(T)
    p = from_reference_params(_raw(_all_kinds(R), seed), dtype, "cpu")
    rng = np.random.RandomState(seed)
    xa = rng.uniform(0, 2, (9, 2))
    xb = np.concatenate([xa[:3], rng.uniform(0, 2, (8, 2))])  # r = 0 hits
    oa = rng.randint(0, 3, 9).astype(np.int32)
    ob = np.concatenate([oa[:3], rng.randint(0, 3, 8)]).astype(np.int32)
    kinds, masks, prm = st.kernel_table(p)
    return (torch.as_tensor(xa, dtype=dtype), torch.as_tensor(oa),
            torch.as_tensor(xb, dtype=dtype), torch.as_tensor(ob),
            st.coreg_mats(p).detach(), kinds, masks, prm.detach())


def test_cross_kernel_gradcheck():
    """Autograd of K7 in B and in [gamma, period, scale] against finite
    differences (the inputs and indices are data, as in JAX)."""
    xa, oa, xb, ob, B, kinds, masks, prm = _kernel_args(0)
    B.requires_grad_(True)
    prm.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda b, p: cross.CrossKernel.apply(xa, oa, xb, ob, b, kinds,
                                             masks, p),
        (B, prm), eps=1e-6, atol=1e-8)


def test_cross_kernel_bwd_plain_matches_closed_form():
    """The cotangent tables of the CUDA design (S0, S1, S2 by output
    pair, then the four products) computed in numpy from the
    derivative table, against the plain backward (autograd)."""
    xa, oa, xb, ob, B, kinds, masks, prm = _kernel_args(1)
    G = torch.as_tensor(np.random.RandomState(2).standard_normal((9, 11)))
    dB, dprm = cross.cross_kernel_bwd(xa, oa, xb, ob, B, kinds, masks, prm,
                                      G)
    Q, D = B.shape[0], B.shape[1]
    xa_, xb_, G_ = xa.numpy(), xb.numpy(), G.numpy()
    S = np.zeros((Q, 3, D, D))
    for q in range(Q):
        dims = [p for p in range(2) if (int(masks[q]) >> p) & 1]
        r = np.sqrt(((xa_[:, None, dims] - xb_[None, :, dims]) ** 2).sum(-1))
        g, per = float(prm[q, 0]), float(prm[q, 1])
        kind = int(kinds[q])
        if kind == 0:
            k = np.exp(-0.5 * r * r * g)
            dg, dp = -0.5 * r * r * k, 0 * r
        elif kind == 1:
            s = np.sqrt(3) * g * r
            k = (1 + s) * np.exp(-s)
            dg, dp = -np.sqrt(3) * r * s * np.exp(-s), 0 * r
        elif kind == 2:
            a = np.pi * r / per
            k = np.exp(-0.5 * np.sin(a) ** 2 * g)
            dg = -0.5 * np.sin(a) ** 2 * k
            dp = g * np.sin(a) * np.cos(a) * np.pi * r / per ** 2 * k
        else:
            k, dg, dp = (r == 0).astype(float), 0 * r, 0 * r
        for t, tab in enumerate((k, dg, dp)):
            np.add.at(S[q, t], (oa.numpy()[:, None], ob.numpy()[None, :]),
                      G_ * tab)
    Bn, scale = B.numpy(), prm[:, 2].numpy()
    np.testing.assert_allclose(dB.numpy(), scale[:, None, None] * S[:, 0],
                               rtol=1e-12, atol=1e-13)
    want = np.stack([scale * (Bn * S[:, 1]).sum((1, 2)),
                     scale * (Bn * S[:, 2]).sum((1, 2)),
                     (Bn * S[:, 0]).sum((1, 2))], axis=1)
    np.testing.assert_allclose(dprm.numpy(), want, rtol=1e-12, atol=1e-13)


def _exact_pair(seed=0, **kw):
    rng = np.random.RandomState(seed)
    Xs = [rng.uniform(0, 2, (n, 2)) for n in (14, 11, 12)]
    Ys = [np.sin(2 * X[:, 0] + d) * np.cos(X[:, 1]) + 0.1 * rng.randn(len(X))
          for d, X in enumerate(Xs)]
    mj = R.ExactLMC(Xs, Ys, functional_kernel=_all_kinds(R), seed=seed, **kw)
    mt = T.ExactLMC(Xs, Ys, functional_kernel=_all_kinds(T), seed=seed,
                    device="cpu", **kw)
    p0 = mj.param_array + 0.1 * np.cos(np.arange(len(mj.param_array)))
    mj.param_array = p0
    mt.param_array = p0
    return mj, mt, Xs


def test_exact_lmc_log_likelihood_fit_and_predict_match_jax():
    mj, mt, Xs = _exact_pair()
    np.testing.assert_allclose(mt.log_likelihood(), mj.log_likelihood(),
                               rtol=1e-12)
    mj.optimize(max_iters=5)
    mt.optimize(max_iters=5)
    np.testing.assert_allclose(mt.param_array, mj.param_array, rtol=1e-6,
                               atol=1e-6)
    mt.param_array = mj.param_array  # predict at the same parameters
    rng = np.random.RandomState(7)
    tXs = [rng.uniform(0, 2, (n, 2)) for n in (5, 0, 4)]
    mu_j, var_j = mj.predict(tXs)
    mu_t, var_t = mt.predict(tXs)
    for a, b in zip(mu_t + var_t, mu_j + var_j):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_exact_lmc_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Xs = [np.linspace(0, 1, 8), np.linspace(0, 1, 7)]
    Ys = [np.sin(3 * X) for X in Xs]
    spec = T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()], lmc_ranks=[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        T.ExactLMC(Xs, Ys, functional_kernel=spec)


def test_log_det_K_is_minus_inf_on_a_non_pd_kernel():
    """A kernel whose Cholesky fails: cholesky_ex's info > 0 maps to a
    NaN factor, as XLA returns, and log_det_K reports -inf as the JAX
    package does, without raising."""
    rng = np.random.RandomState(0)
    X = np.sort(rng.uniform(0, 1, 30))
    Xs, Ys = [X, X], [np.sin(5 * X), np.cos(5 * X)]
    spec_of = (lambda pkg: pkg.LMCKernelSpec.create(
        D=2, lmc_kernels=[pkg.RBF(name="k")], lmc_ranks=[1]))
    mj = R.InterpolatedLLGP(Xs, Ys, functional_kernel=spec_of(R), m=[16])
    mt = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec_of(T), m=[16],
                            device="cpu")
    # no noise and a vanishing inverse lengthscale: K is the rank-2
    # B[o_a, o_b] pattern on 60 points, and its Cholesky breaks down
    p = np.array(mj.param_array)
    p[-2:] = -800.0  # raw noise (the last leaf): softplus underflows to 0
    p[-3] = -50.0  # raw inverse lengthscale: about 2e-22
    mj.param_array = p
    mt.param_array = p
    assert mj.log_det_K() == -np.inf
    assert mt.log_det_K() == -np.inf
    L = mt._chol()
    assert bool(torch.isnan(L).all())

"""Stochastic Lanczos quadrature (ops/slq.py, kernel K13's plain
version): the Lanczos recurrence and the SLQ log-det against the JAX
package with the same probes, the breakdown handling, and the port's
own estimates against dense oracles within the JAX package's bands
(tests/test_slq.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc.grid import build_kski as jbuild_kski
from runlmc_tpu.ops import slq as jslq
from runlmc_tpu_torch.hopper.lanczos import lanczos_step_plain
from runlmc_tpu_torch.lmc.grid import build_kski, make_grids
from runlmc_tpu_torch.ops import slq
from runlmc_tpu_torch.utils.carry import from_reference_params


def _mild(n, seed, cond=30.0):
    """A dense SPD matrix with eigenvalues spread over [1, cond]."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.linspace(1.0, cond, n)) @ Q.T


def _jax_probes(n_probes, n, seed=0):
    z = jax.random.bernoulli(jax.random.PRNGKey(seed), 0.5, (n_probes, n))
    return np.array(z.astype(jnp.float64) * 2.0 - 1.0)


@pytest.mark.parametrize("k", [5, 12])
def test_lanczos_tridiag_matches_jax(k):
    n = 60
    A = _mild(n, 0)
    v0 = _jax_probes(4, n) / np.sqrt(n)
    wa, wb = jslq.lanczos_tridiag(lambda v: v @ jnp.asarray(A),
                                  jnp.asarray(v0), k)
    At = torch.as_tensor(A)
    ga, gb = slq.lanczos_tridiag(lambda v: v @ At, torch.as_tensor(v0), k)
    assert ga.shape == (4, k) and gb.shape == (4, k - 1)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-10)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-10)


@pytest.mark.parametrize("n_probes,k", [(15, 20), (6, 40)])
def test_slq_from_probes_matches_jax_slq_logdet(n_probes, k):
    n = 80
    A = _mild(n, 1)
    want = float(jslq.slq_logdet(lambda v: v @ jnp.asarray(A), n,
                                 jax.random.PRNGKey(0), n_probes=n_probes,
                                 k=k))
    At = torch.as_tensor(A)
    got = float(slq.slq_logdet_from_probes(
        lambda v: v @ At, torch.as_tensor(_jax_probes(n_probes, n)), k))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_breakdown_row_matches_jax():
    """A row started on an eigenvector of a diagonal operator breaks down
    at the first step: its remaining alphas are 1 and betas 0 in both
    packages, and the other rows run on."""
    n = 40
    d = np.linspace(0.5, 2.0, n)
    v0 = _jax_probes(3, n) / np.sqrt(n)
    v0[0] = 0.0
    v0[0, 7] = 1.0  # e_7: K v0 = d_7 v0
    wa, wb = jslq.lanczos_tridiag(lambda v: v * jnp.asarray(d),
                                  jnp.asarray(v0), 6)
    dt = torch.as_tensor(d)
    ga, gb = slq.lanczos_tridiag(lambda v: v * dt, torch.as_tensor(v0), 6)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-10)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-10,
                               atol=1e-300)
    assert ga[0, 0] == d[7] and torch.all(ga[0, 1:] == 1.0)
    assert torch.all(gb[0] == 0.0) and torch.all(gb[1:] > 0)


def test_lanczos_step_plain_is_the_jax_body():
    """One step, with a live, a dying and a dead row, against the body
    of the JAX scan written out in numpy."""
    rng = np.random.RandomState(3)
    w, vp, v = (rng.standard_normal((3, 9)) for _ in range(3))
    v[1] = 0.0
    w[1] = 0.0  # beta' = 0 on row 1
    beta = np.array([0.3, 0.0, 0.0])
    alive = np.array([1, 1, 0], dtype=np.int32)
    eps = torch.full((1,), 1e-14, dtype=torch.float64)
    out = lanczos_step_plain(*(torch.as_tensor(a) for a in (w, vp, v, beta,
                                                           alive)), eps)
    w1 = w - beta[:, None] * vp
    alpha = (w1 * v).sum(-1)
    w2 = w1 - alpha[:, None] * v
    bn = np.sqrt((w2 * w2).sum(-1))
    live_n = alive.astype(bool) & (bn > 1e-14)
    vn = np.where(live_n[:, None], w2 / np.where(bn > 0, bn, 1.0)[:, None],
                  0.0)
    np.testing.assert_array_equal(out[0].numpy(), v)
    np.testing.assert_allclose(out[1].numpy(), vn, rtol=1e-14)
    np.testing.assert_allclose(out[2].numpy(),
                               np.where(alive.astype(bool), alpha, 1.0))
    np.testing.assert_allclose(out[3].numpy(), np.where(live_n, bn, 0.0))
    np.testing.assert_array_equal(out[4].numpy(), live_n.astype(np.int32))


def test_slq_logdet_diag(rng):
    """As tests/test_slq.py: a diagonal operator, 64 probes, k=20."""
    n = 64
    d = torch.as_tensor(rng.uniform(0.5, 2.0, n))
    gen = torch.Generator().manual_seed(0)
    est = float(slq.slq_logdet(lambda v: v * d, n, gen, n_probes=64, k=20))
    exact = float(torch.sum(torch.log(d)))
    assert abs(est - exact) / abs(exact) < 0.1, (est, exact)


def _ski_operator(rng, n_per, m, noise=None):
    """An fft-mode SKI operator (D=3, LMC rank 2) and its dense log-det."""
    from runlmc_tpu_torch.params import POSITIVE

    D = 3
    Xs = [np.sort(rng.uniform(0, 1, (n_per, 1)), axis=0) for _ in range(D)]
    spec = T.LMCKernelSpec.create(
        D=D, lmc_kernels=[T.RBF(name="k")], lmc_ranks=[2]).with_input_dim(1)
    raw = spec.init_raw_params(seed=0)
    if noise is not None:
        raw["noise"] = POSITIVE.inverse(noise * np.ones(D))
    params = from_reference_params(raw, torch.float64, "cpu")
    gd, _ = make_grids(spec, Xs, m=[m], mode="fft")
    gd = tuple(g.to(torch.float64, "cpu") for g in gd)
    K = build_kski(spec, params, gd, (n_per,) * D)
    n = D * n_per
    dense = K.matvec(torch.eye(n, dtype=torch.float64)).numpy()
    return K, np.linalg.slogdet(dense)[1], n


def test_slq_logdet_ski_operator(rng):
    """SLQ on an fft-mode SKI operator tracks its dense log-det (5%)."""
    K, exact, n = _ski_operator(rng, 30, 16)
    gen = torch.Generator().manual_seed(1)
    est = float(slq.slq_logdet(K.matvec, n, gen, n_probes=30, k=40))
    assert abs(est - exact) / abs(exact) < 0.05, (est, exact)


@pytest.mark.parametrize("noise", [1e-1, 1e-3, 1e-5])
def test_slq_accuracy_band(rng, noise):
    """The calibration sweep of the JAX package (tests/test_slq.py): with
    its probes (PRNGKey 0-2), k=40 and 15 probes stay within 1% of the
    dense log-det across conditioning, and k=80 stays in it."""
    K, exact, n = _ski_operator(rng, 60, 24, noise)
    for k, seeds in ((40, 3), (80, 1)):
        for s in range(seeds):
            z = torch.as_tensor(_jax_probes(15, n, seed=s))
            est = float(slq.slq_logdet_from_probes(K.matvec, z, k))
            assert abs(est - exact) / abs(exact) < 0.01, (noise, k, s, est)


def test_fft_model_ski_log_det_matches_jax_with_fed_probes():
    """The model's SLQ log-det (fft grid, n > 0, 15 probes, k=40) with
    JAX's PRNGKey(0) probes fed through ``slq_probes``: the same number
    as the JAX model, cached per parameter setting."""
    rng = np.random.RandomState(5)
    Xs = [np.sort(rng.uniform(0, 1, (40, 1)), axis=0) for _ in range(2)]
    Ys = [np.sin(6 * X[:, 0]) + 0.1 * rng.standard_normal(40) for X in Xs]
    mk = (lambda pkg: pkg.LMCKernelSpec.create(
        D=2, lmc_kernels=[pkg.RBF(name="k")], lmc_ranks=[1]))
    mj = R.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(R), m=[24], seed=0,
                            grid_mode="fft")
    mt = T.InterpolatedLLGP(Xs, Ys, functional_kernel=mk(T), m=[24], seed=0,
                            grid_mode="fft", device="cpu")
    mt.param_array = mj.param_array
    mt.slq_probes = lambda N, n: _jax_probes(N, n)
    want = mj.ski_log_det()
    got = mt.ski_log_det()
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert mt.ski_log_det() == got  # cached
    # the port's own probe stream: deterministic, near the dense oracle
    mt.slq_probes = None
    mt.param_array = mj.param_array
    own = mt.ski_log_det()
    mt.param_array = mj.param_array
    assert mt.ski_log_det() == own
    K = jbuild_kski(mj.spec, mj.params, mj.grid_data, mj.data.lens)
    exact = np.linalg.slogdet(np.asarray(K.as_dense()))[1]
    assert abs(own - exact) / abs(exact) < 0.1, (own, exact)

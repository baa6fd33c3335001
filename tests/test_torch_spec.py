"""Kernel spec, transforms and parameter carrying: the port against the
JAX package on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.params import POSITIVE as J_POSITIVE
from runlmc_tpu_torch.params import POSITIVE as T_POSITIVE
from runlmc_tpu_torch.utils.carry import (
    from_reference_params,
    ravel_params,
    unravel_params,
)

# elementwise float64 formulas evaluated the same way in both packages
RTOL = 1e-13


def _specs(pkg):
    """The same specs built from either package's classes."""
    return {
        "lmc": pkg.LMCKernelSpec.create(
            D=3, lmc_kernels=[pkg.RBF(), pkg.Matern32()], lmc_ranks=[2, 1]
        ),
        "slfm_indep": pkg.LMCKernelSpec.create(
            D=3, slfm_kernels=[pkg.RBF(name="s")],
            indep_gp=[pkg.StdPeriodic(period=2.0), pkg.IdentityKern(),
                      pkg.Scaled(inner=pkg.RBF(name="i"))],
            indep_gp_index=[0, 2, 1],
        ),
        "scaled_frozen": pkg.LMCKernelSpec.create(
            D=2, lmc_kernels=[pkg.Scaled(inner=pkg.Matern32(),
                                         trainable_scale=False, scale=0.5)],
            lmc_ranks=[1], indep_gp=[pkg.RBF(inv_lengthscale=3.0)],
        ),
        # >= 11 kernels: ravel_pytree sorts 'q10' before 'q2'
        "many": pkg.LMCKernelSpec.create(
            D=2, lmc_kernels=[pkg.RBF(name="k%d" % i) for i in range(12)],
            lmc_ranks=[1] * 12,
        ),
    }


SPEC_NAMES = list(_specs(T))


def _assert_tree_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, dict) == isinstance(b, dict))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _perturbed(raw, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.3 * rng.standard_normal(np.shape(a)), raw
    )


@pytest.mark.parametrize("name", SPEC_NAMES)
@pytest.mark.parametrize("seed", [0, 7])
def test_init_raw_params_bit_identical(name, seed):
    rj = _specs(R)[name].init_raw_params(seed=seed)
    rt = _specs(T)[name].init_raw_params(seed=seed)
    _assert_tree_equal(rj, rt)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_param_array_order_is_ravel_pytree(name):
    raw = _perturbed(_specs(R)[name].init_raw_params(seed=3), 1)
    flat_j, _ = ravel_pytree(jax.tree.map(jnp.asarray, raw))
    params = from_reference_params(raw, torch.float64, "cpu")
    flat_t = ravel_params(params)
    np.testing.assert_array_equal(np.asarray(flat_j), flat_t.numpy())
    back = unravel_params(flat_t, params)
    _assert_tree_equal(
        jax.tree.map(lambda t: t.numpy(), back),
        jax.tree.map(lambda t: t.numpy(), params),
    )
    if name == "many":
        kernel_keys = [k for k in sorted(raw["kernels"])]
        assert kernel_keys.index("q10") < kernel_keys.index("q2")


def test_softplus_matches():
    x = np.linspace(-30, 30, 101)
    np.testing.assert_allclose(
        T_POSITIVE.forward(torch.as_tensor(x)).numpy(),
        np.asarray(J_POSITIVE.forward(jnp.asarray(x))), rtol=RTOL,
    )
    np.testing.assert_array_equal(T_POSITIVE.inverse(x[x > 0]),
                                  J_POSITIVE.inverse(x[x > 0]))


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_coreg_mats_and_noise_match(name):
    sj = _specs(R)[name].with_input_dim(1)
    st = _specs(T)[name].with_input_dim(1)
    raw = _perturbed(sj.init_raw_params(seed=2), 5)
    pj = jax.tree.map(jnp.asarray, raw)
    pt = from_reference_params(raw, torch.float64, "cpu")
    np.testing.assert_allclose(st.coreg_mats(pt).numpy(),
                               np.asarray(sj.coreg_mats(pj)), rtol=RTOL)
    np.testing.assert_allclose(st.noise(pt).numpy(),
                               np.asarray(sj.noise(pj)), rtol=RTOL)


def _kernel_pairs():
    return [
        (R.RBF(inv_lengthscale=0.7), T.RBF(inv_lengthscale=0.7)),
        (R.Matern32(inv_lengthscale=2.0), T.Matern32(inv_lengthscale=2.0)),
        (R.StdPeriodic(inv_lengthscale=1.5, period=0.8),
         T.StdPeriodic(inv_lengthscale=1.5, period=0.8)),
        (R.IdentityKern(), T.IdentityKern()),
        (R.Scaled(inner=R.RBF(), scale=2.0),
         T.Scaled(inner=T.RBF(), scale=2.0)),
        (R.Scaled(inner=R.Matern32(), trainable_scale=False, scale=0.3),
         T.Scaled(inner=T.Matern32(), trainable_scale=False, scale=0.3)),
    ]


@pytest.mark.parametrize("idx", range(6))
def test_from_dist_matches(idx):
    kj, kt = _kernel_pairs()[idx]
    rng = np.random.RandomState(idx)
    dists = np.concatenate([[0.0, 0.0], rng.uniform(0, 5, 200)])
    raw = _perturbed(kj.init_raw_params(), idx)
    got = kt.from_dist(
        {k: torch.as_tensor(v) for k, v in raw.items()}, torch.as_tensor(dists)
    ).numpy()
    want = np.asarray(kj.from_dist(
        {k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(dists)
    ))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", SPEC_NAMES + ["mixed"])
def test_non_indep_idxs_matches_jax(name):
    """The rank-carrying kernels of the fft 'slfm' representation, for
    lmc, slfm and indep mixes, over every group and a reordered subset."""
    if name == "mixed":
        sj, st = (pkg.LMCKernelSpec.create(
            D=3, lmc_kernels=[pkg.RBF(name="l")], lmc_ranks=[2],
            slfm_kernels=[pkg.Matern32(name="s")],
            indep_gp=[pkg.RBF(name="i%d" % d) for d in range(3)],
        ) for pkg in (R, T))
    else:
        sj, st = _specs(R)[name], _specs(T)[name]
    sj, st = sj.with_input_dim(1), st.with_input_dim(1)
    groups = [tuple(k) for k in st.active_dims.values()]
    assert groups == [tuple(k) for k in sj.active_dims.values()]
    for idxs in groups + [tuple(range(st.Q))[::-1]]:
        assert st.non_indep_idxs(idxs) == tuple(sj.non_indep_idxs(idxs))
    kinds = [st.kinds[q] for q in range(st.Q)]
    assert st.non_indep_idxs(tuple(range(st.Q))) == tuple(
        q for q, k in enumerate(kinds) if k != "indep")

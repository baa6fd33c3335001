"""Dense-mode grid construction, kernel K1's plain version and the SKI
operator: the port against the JAX package on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu.ops.bttb import bttb_eig_upper_bound as j_bound
from runlmc_tpu_torch.hopper.kuu import kuu_dense_plain
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.ops.bttb import bttb_eig_upper_bound as t_bound
from runlmc_tpu_torch.utils.carry import from_reference_params

# K_UU entries are the same products B_q[d,e] * k_q(r) summed in the same
# order, so they agree to float64 rounding
RTOL = 1e-12


def _problem(kind):
    """(JAX spec, port spec, Xs, m) of a 1-D lmc or a 2-D slfm+indep
    problem (Q=3, the indep kernels on one input dim each)."""
    rng = np.random.RandomState(11)
    if kind == "1d":
        Xs = [rng.uniform(0, 5, n) for n in (30, 25, 28)]

        def mk(pkg):
            return pkg.LMCKernelSpec.create(
                D=3, lmc_kernels=[pkg.RBF(), pkg.Matern32()],
                lmc_ranks=[2, 1],
            ).with_input_dim(1)

        return mk(R), mk(T), [X.reshape(-1, 1) for X in Xs], [12]
    Xs = [rng.uniform(0, 1, (n, 2)) for n in (40, 35)]

    def mk(pkg):
        return pkg.LMCKernelSpec.create(
            D=2, slfm_kernels=[pkg.RBF(name="s")],
            indep_gp=[pkg.Matern32(name="a"), pkg.RBF(name="b")],
        ).with_input_dim(2)

    return mk(R), mk(T), Xs, [6, 7]


def _params(spec_j, seed=4):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)),
        spec_j.init_raw_params(seed=seed),
    )


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_make_grids_artifacts_equal(kind):
    sj, st, Xs, m = _problem(kind)
    gj, aj = jgrid.make_grids(sj, Xs, m=m)
    gt, at = tgrid.make_grids(st, Xs, m=m)
    assert len(gj) == len(gt)
    for axes_j, axes_t in zip(aj, at):
        for a, b in zip(axes_j, axes_t):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(gj, gt):
        assert a.plan.mode == b.plan.mode == "dense"
        assert (a.plan.active_dim, a.plan.kidxs, a.plan.rep, a.plan.sizes) \
            == (b.plan.active_dim, b.plan.kidxs, b.plan.rep, b.plan.sizes)
        np.testing.assert_array_equal(np.asarray(a.dists), b.dists)
        np.testing.assert_array_equal(np.asarray(a.interp.indices),
                                      b.interp.indices)
        np.testing.assert_array_equal(np.asarray(a.interp.weights),
                                      b.interp.weights)
        assert a.interp.ncols == b.interp.ncols
        for wa, wb in zip(a.W_blocks, b.W_blocks):
            np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(a.WtW, b.WtW)


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_kuu_dense_plain_matches_build_group_state(kind):
    sj, st, Xs, m = _problem(kind)
    raw = _params(sj)
    gj, _ = jgrid.make_grids(sj, Xs, m=m)
    pt = from_reference_params(raw, torch.float64, "cpu")
    for gd in gj:
        want = jgrid.build_group_state(
            sj, jax.tree.map(jnp.asarray, raw), gd.plan,
            jnp.asarray(gd.dists), gd.interp, jnp.asarray(gd.idx_map),
            gd.W_blocks,
        ).KUU_dense
        dists = torch.as_tensor(np.asarray(gd.dists))
        tops = st.eval_kernels_stacked(pt, dists, gd.plan.kidxs)
        B = st.coreg_mats(pt, gd.plan.kidxs)
        got = kuu_dense_plain(tops, B, gd.plan.sizes)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_kski_matvec_matches(kind):
    sj, st, Xs, m = _problem(kind)
    raw = _params(sj, seed=9)
    lens = [len(X) for X in Xs]
    gj, _ = jgrid.make_grids(sj, Xs, m=m)
    gt, _ = tgrid.make_grids(st, Xs, m=m)
    Kj = jgrid.build_kski(sj, jax.tree.map(jnp.asarray, raw),
                          jax.tree.map(jnp.asarray, gj), lens)
    Kt = tgrid.build_kski(
        st, from_reference_params(raw, torch.float64, "cpu"),
        tuple(gd.to(torch.float64, "cpu") for gd in gt), lens,
    )
    x = np.random.RandomState(1).standard_normal((3, sum(lens)))
    want = np.asarray(Kj.matvec(jnp.asarray(x)))
    got = Kt.matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11,
                               atol=1e-11 * np.abs(want).max())
    # and a single vector
    np.testing.assert_allclose(Kt.matvec(torch.as_tensor(x[0])).numpy(),
                               want[0], rtol=1e-11,
                               atol=1e-11 * np.abs(want).max())


def test_fft_mode_group_raises_naming_the_slice():
    spec = T.LMCKernelSpec.create(D=4, lmc_kernels=[T.RBF()],
                                  lmc_ranks=[1]).with_input_dim(1)
    Xs = [np.linspace(0, 1, 50).reshape(-1, 1)] * 4
    with pytest.raises(NotImplementedError, match="slice 3"):
        tgrid.make_grids(spec, Xs, m=[3000])  # D * m > DENSE_MAX_GRID
    with pytest.raises(NotImplementedError, match="fft"):
        tgrid.make_grids(spec, Xs, m=[10], mode="fft")


@pytest.mark.parametrize("sizes", [(9,), (4, 5)])
def test_bttb_eig_upper_bound_matches_loose_reference(sizes):
    # Reference quirk, matched on purpose: 2^P * sum|top| is looser than
    # the Gershgorin row maximum, which the port does not tighten.
    top = np.random.RandomState(2).standard_normal(int(np.prod(sizes)))
    assert t_bound(top, sizes) == j_bound(top, sizes)
    assert t_bound(top, sizes) == 2 ** len(sizes) * np.abs(top).sum()

"""The rest of the half-ported helpers against the JAX package on the
same numpy inputs: ``utils/np_utils.py`` and the ``utils`` exports,
``ops/bttb.py`` ``toeplitz_eig_upper_bound``, and ``Interp.T`` and
``SKI`` in ``ops/interpolation.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu.utils as JU
import runlmc_tpu_torch.utils as TU
from runlmc_tpu.ops import interpolation as jinterp
from runlmc_tpu.ops.bttb import toeplitz_eig_upper_bound as j_toeplitz
from runlmc_tpu.ops.operators import Dense as JDense
from runlmc_tpu_torch.ops import interpolation as tinterp
from runlmc_tpu_torch.ops.bttb import toeplitz_eig_upper_bound as t_toeplitz
from runlmc_tpu_torch.ops.operators import Dense as TDense


def test_exports_match_jax():
    assert TU.__all__ == JU.__all__
    for name in TU.__all__:
        assert callable(getattr(TU, name))


@pytest.mark.parametrize("lens", [[3, 0, 4], [5], []])
def test_begin_end_indices_and_tesselate(lens):
    for a, b in zip(TU.begin_end_indices(lens), JU.begin_end_indices(lens)):
        np.testing.assert_array_equal(a, b)
    flat = np.arange(sum(lens), dtype=float)
    for a, b in zip(TU.tesselate(flat, lens), JU.tesselate(flat, lens)):
        np.testing.assert_array_equal(a, b)


def test_tesselate_and_chunks_raise_as_jax():
    for mod in (TU, JU):
        with pytest.raises(ValueError):
            mod.tesselate(np.arange(4), [2, 3])
        with pytest.raises(ValueError):
            mod.chunks(np.arange(5), 2)
    assert [list(c) for c in TU.chunks(np.arange(6), 3)] == \
        [list(c) for c in JU.chunks(np.arange(6), 3)]


@pytest.mark.parametrize("x", [5.0, 3.0, 0.5, 9.0, -1.0])
@pytest.mark.parametrize("inclusive", [True, False])
def test_search_descending(x, inclusive):
    xs = [9.0, 7.0, 5.0, 5.0, 3.0, 1.0]
    assert TU.search_descending(x, xs, inclusive) == \
        JU.search_descending(x, xs, inclusive)
    with pytest.raises(ValueError):
        TU.search_descending(x, [1.0, 2.0])


def test_smallest_eig_and_symm_map():
    rng = np.random.RandomState(0)
    a = rng.standard_normal((6, 6))
    sym = a + a.T
    assert TU.smallest_eig(sym) == JU.smallest_eig(sym)
    xs = [[i * 3 + j for j in range(3)] for i in range(3)]
    assert TU.symm_2d_list_map(lambda v, k: v * k, xs, 3, 2) == \
        JU.symm_2d_list_map(lambda v, k: v * k, xs, 3, 2)
    np.testing.assert_array_equal(
        TU.cartesian_product(np.arange(2), np.arange(3)),
        JU.cartesian_product(np.arange(2), np.arange(3)))


@pytest.mark.parametrize("top", [[3.0, 1.0, -2.0, 0.5], [2.0], []])
def test_toeplitz_eig_upper_bound(top):
    if not top:
        # the JAX package indexes past the end of an empty first row
        with pytest.raises(IndexError):
            j_toeplitz(top)
        assert t_toeplitz(top) == 0.0
        return
    assert t_toeplitz(top) == j_toeplitz(top)
    n = len(top)
    dense = np.array([[top[abs(i - j)] for j in range(n)] for i in range(n)])
    assert t_toeplitz(top) >= np.linalg.eigvalsh(dense).max() - 1e-12


def _interps(dim):
    rng = np.random.RandomState(dim)
    axes = [np.linspace(-0.5, 1.5, 9) for _ in range(dim)]
    Xs = [rng.uniform(0, 1, (7, dim)), rng.uniform(0, 1, (5, dim))]
    return (jinterp.multi_interpolant(Xs, axes),
            tinterp.multi_interpolant(Xs, axes))


@pytest.mark.parametrize("dim", [1, 2])
def test_interp_transpose(dim):
    Wj, Wt = _interps(dim)
    np.testing.assert_array_equal(Wt.as_dense().numpy(),
                                  np.asarray(Wj.as_dense()))
    WTt = Wt.to(torch.float64, "cpu").T
    WTj = Wj.T
    assert WTt.shape == WTj.shape
    x = np.random.RandomState(4).standard_normal((3, Wt.shape[0]))
    np.testing.assert_allclose(WTt.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(WTj.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(WTt.as_dense().numpy(),
                                  np.asarray(WTj.as_dense()))


@pytest.mark.parametrize("dim", [1, 2])
def test_ski_operator(dim):
    Wj, Wt = _interps(dim)
    m = Wt.shape[1]
    a = np.random.RandomState(5).standard_normal((m, m))
    Kd = a @ a.T + m * np.eye(m)
    skij = jinterp.SKI(grid_K=JDense(jnp.asarray(Kd)), W=Wj)
    skit = tinterp.SKI(grid_K=TDense(torch.as_tensor(Kd)),
                       W=Wt.to(torch.float64, "cpu"))
    assert skit.shape == skij.shape
    v = np.random.RandomState(6).standard_normal((2, Wt.shape[0]))
    want = np.asarray(skij.matvec(jnp.asarray(v)))
    np.testing.assert_allclose(skit.matvec(torch.as_tensor(v)).numpy(),
                               want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    want = np.asarray(skij.as_dense())
    np.testing.assert_allclose(skit.as_dense().numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert float(skit.upper_eig_bound()) == pytest.approx(
        float(skij.upper_eig_bound()), rel=1e-12)

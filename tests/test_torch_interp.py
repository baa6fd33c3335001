"""Kernel K9's plain gather and scatter, and the host-side interpolation
builders, against the JAX package's ``Interp``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runlmc_tpu.ops import interpolation as ji
from runlmc_tpu_torch.hopper import build
from runlmc_tpu_torch.hopper import interp as tinterp
from runlmc_tpu_torch.hopper.interp import (
    interp_gather_plain,
    interp_scatter_lanes,
    interp_scatter_plain,
    scatter_variant,
)
from runlmc_tpu_torch.ops import interpolation as ti

# gather and scatter sum the same few products per output element, in
# another order
RTOL = 1e-13


def _samples(dim, rng):
    """Points spread over the grid plus points at and beyond its edges,
    whose clamped stencils repeat a column."""
    if dim == 1:
        inner = rng.uniform(0.0, 1.0, 40)
        return [np.concatenate([inner, [-0.2, -0.01, 0.0, 1.0, 1.3]]),
                rng.uniform(0.2, 0.8, 17)]
    inner = rng.uniform(0.0, 1.0, (30, 2))
    edge = np.array([[-0.1, 0.5], [0.0, 0.0], [1.0, 1.2], [0.5, 1.0]])
    return [np.concatenate([inner, edge]), rng.uniform(0, 1, (11, 2))]


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("batch", [(), (3,), (2, 4)])
def test_gather_and_scatter_match_reference_interp(dim, batch):
    rng = np.random.RandomState(dim)
    axes = [np.linspace(0.0, 1.0, 8 + p) for p in range(dim)]
    Xs = _samples(dim, rng)
    with np.errstate(all="ignore"):
        Wj = ji.multi_interpolant(Xs, axes)
        Wt = ti.multi_interpolant(Xs, axes)
    np.testing.assert_array_equal(np.asarray(Wj.indices), Wt.indices)
    np.testing.assert_array_equal(np.asarray(Wj.weights), Wt.weights)
    # clamped edges give rows with a repeated column
    dup = [len(set(r)) < len(r) for r in np.asarray(Wt.indices)]
    assert any(dup)
    W = Wt.to(torch.float64, "cpu")
    n, ncols = Wt.shape
    v = rng.standard_normal(batch + (ncols,))
    x = rng.standard_normal(batch + (n,))
    np.testing.assert_allclose(
        interp_gather_plain(W.indices, W.weights, torch.as_tensor(v)).numpy(),
        np.asarray(Wj.matvec(jnp.asarray(v))), rtol=RTOL, atol=1e-14,
    )
    np.testing.assert_allclose(
        interp_scatter_plain(W.t_ptr, W.t_rows, W.t_weights,
                             torch.as_tensor(x)).numpy(),
        np.asarray(Wj.rmatvec(jnp.asarray(x))), rtol=RTOL, atol=1e-14,
    )
    # the operator's own methods take the plain path for CPU tensors
    np.testing.assert_allclose(W.matvec(torch.as_tensor(v)).numpy(),
                               np.asarray(Wj.matvec(jnp.asarray(v))),
                               rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(W.rmatvec(torch.as_tensor(x)).numpy(),
                               np.asarray(Wj.rmatvec(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-14)


def test_transposed_csr_is_wT():
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 9, size=(12, 4)).astype(np.int32)
    w = rng.standard_normal((12, 4))
    ptr, rows, wt = ti.transposed_csr(idx, w, 10)
    dense = np.zeros((12, 10))
    for t in range(4):
        np.add.at(dense, (np.arange(12), idx[:, t]), w[:, t])
    rebuilt = np.zeros((10, 12))
    for c in range(10):
        for e in range(ptr[c], ptr[c + 1]):
            rebuilt[c, rows[e]] += wt[e]
    np.testing.assert_allclose(rebuilt, dense.T, rtol=0, atol=1e-15)
    assert ptr[0] == 0 and ptr[-1] == idx.size and np.all(np.diff(ptr) >= 0)
    assert ptr[10] - ptr[9] == 0  # column 9 is never hit


@pytest.mark.parametrize("dim", [1, 2])
def test_host_builders_match(dim):
    rng = np.random.RandomState(5)
    Xs = [rng.uniform(0, 3, (20, dim)) for _ in range(3)]
    axes_j = ji.autogrid(Xs, m=[9] * dim)
    axes_t = ti.autogrid(Xs, m=[9] * dim)
    for a, b in zip(axes_j, axes_t):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ji.interp_output_blocks(Xs, axes_t),
                    ti.interp_output_blocks(Xs, axes_t)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ji.cubic_kernel(np.linspace(-3, 3, 61)),
                                  ti.cubic_kernel(np.linspace(-3, 3, 61)))


def _skewed_interpolant(rng):
    """A 1-D interpolant whose transposed CSR has clamped-edge duplicates,
    empty columns (no point near the grid's middle) and four columns far
    longer than the rest (400 points at one spot)."""
    axes = [np.linspace(0.0, 1.0, 16)]
    pts = np.concatenate([rng.uniform(0.0, 0.3, 30), rng.uniform(0.7, 1.0, 30),
                          [-0.2, 0.0, 1.0, 1.3], np.full(400, 0.9)])
    return axes, [pts, rng.uniform(0.0, 0.25, 9)]


@pytest.mark.parametrize("batch", [(), (3,)])
def test_warp_scatter_order_matches_reference_rmatvec(batch):
    """The warp variant's order (strided lane sums, then the xor tree)
    against the JAX package's scatter-add, float64."""
    rng = np.random.RandomState(7)
    axes, Xs = _skewed_interpolant(rng)
    with np.errstate(all="ignore"):
        Wj = ji.multi_interpolant(Xs, axes)
        Wt = ti.multi_interpolant(Xs, axes)
    deg = np.diff(Wt.t_ptr)
    assert deg.min() == 0 and deg.max() >= 10 * np.median(deg[deg > 0])
    assert any(len(set(r)) < len(r) for r in np.asarray(Wt.indices))
    W = Wt.to(torch.float64, "cpu")
    x = rng.standard_normal(batch + (Wt.shape[0],))
    got = interp_scatter_lanes(W.t_ptr, W.t_rows, W.t_weights,
                               torch.as_tensor(x)).numpy()
    want = np.asarray(Wj.rmatvec(jnp.asarray(x)))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    assert np.all(got[..., deg == 0] == 0)


def test_scatter_variant_is_a_pure_function_of_the_shape():
    sites = {
        (4205, 759680, 1): tinterp.SCATTER_WARP,      # synth, one column
        (10016, 63072, 16): tinterp.SCATTER_THREAD,   # weather, 16
        (3094, 12452, 151): tinterp.SCATTER_THREAD,   # fx2007 predict
        (3094, 12452, 1): tinterp.SCATTER_THREAD,     # predict's mean
        (4205, 759680, 4096): tinterp.SCATTER_THREAD,  # columns fill the card
        (1, 0, 1): tinterp.SCATTER_THREAD,            # empty CSR
    }
    for args, want in sites.items():
        assert [scatter_variant(*args) for _ in range(3)] == [want] * 3
        assert scatter_variant(**dict(zip(("ncols", "nnz", "nbatch"),
                                          args))) == want


def test_scatter_wrapper_launches_the_variant_of_its_shape(monkeypatch):
    """The wrapper's host path (with the card's calls stubbed): it passes
    scatter_variant(ncols, nnz, nbatch) of its operands to the kernel."""
    rng = np.random.RandomState(8)
    axes, Xs = _skewed_interpolant(rng)
    W = ti.multi_interpolant(Xs, axes).to(torch.float64, "cpu")
    seen = []

    def fake_function(name, symbol, argtypes):
        def fn(*args):
            seen.append((symbol, args[5:9]))
            return 0
        return fn

    monkeypatch.setattr(build, "use_plain", lambda what, t: False)
    monkeypatch.setattr(build, "require_cuda", lambda what, *ts: None)
    monkeypatch.setattr(build, "function", fake_function)
    monkeypatch.setattr(build, "stream_ptr", lambda: None)
    monkeypatch.setattr(build, "sm_count", lambda index: build.H100_SMS)
    before = dict(tinterp.interp_scatter.launches)
    for nb in (1, 5):
        x = torch.as_tensor(rng.standard_normal((nb, W.shape[0])))
        tinterp.interp_scatter(W.t_ptr, W.t_rows, W.t_weights, x)
    nnz = W.t_rows.shape[0]
    assert seen == [("interp_scatter_f64",
                     (W.shape[0], W.ncols, nb,
                      scatter_variant(W.ncols, nnz, nb))) for nb in (1, 5)]
    assert tinterp.interp_scatter.launches["f64"] == before["f64"] + 2

"""fft grid mode: the BTTB Fourier helpers (K11), the Fourier-space
coregionalization contraction (K10's plain version and its autograd
function) and fft-mode grid construction — the port against the JAX
package on the same numpy inputs, in float64."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu.ops import bttb as jbttb
from runlmc_tpu_torch.hopper import fourier
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.ops import bttb as tbttb
from runlmc_tpu_torch.utils.carry import (
    from_reference_params,
    ravel_params,
    unravel_params,
)

# the same FFTs (pocketfft in both packages on the CPU) and the same
# few-term contractions: float64 rounding
RTOL = 1e-12
GRIDS = [(13,), (5, 6), (3, 4, 5)]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("sizes", GRIDS)
def test_bttb_helpers_match(sizes):
    rng = np.random.RandomState(len(sizes))
    m = int(np.prod(sizes))
    top = rng.standard_normal((2, m))
    v = rng.standard_normal((3, m))
    assert tbttb.extension_sizes(sizes) == jbttb.extension_sizes(sizes)
    assert tbttb.rfft_len(tbttb.extension_sizes(sizes)) \
        == jbttb.rfft_len(jbttb.extension_sizes(sizes))
    tt, tv = torch.as_tensor(top), torch.as_tensor(v)
    _close(tbttb.cyclic_extend(tt, sizes), jbttb.cyclic_extend(top, sizes))
    sym_t = tbttb.bttb_fft(tt, sizes)
    sym_j = jbttb.bttb_fft(jnp.asarray(top), sizes)
    assert tuple(sym_t.shape[1:]) == tbttb.fourier_shape(sizes)
    _close(sym_t, sym_j)
    vh_t = tbttb.operand_fft(tv, sizes)
    _close(vh_t, jbttb.operand_fft(jnp.asarray(v), sizes))
    _close(tbttb.operand_ifft(vh_t, sizes),
           jbttb.operand_ifft(jnp.asarray(vh_t.numpy()), sizes))
    _close(tbttb.bttb_matvec(sym_t[:1], tv, sizes),
           jbttb.bttb_matvec(sym_j[:1], jnp.asarray(v), sizes))
    _close(tbttb.bttb_matvec_from_top(tt[0], tv[0], sizes),
           jbttb.bttb_matvec_from_top(jnp.asarray(top[0]),
                                      jnp.asarray(v[0]), sizes))


@pytest.mark.parametrize("sizes", GRIDS)
def test_bttb_dense_is_the_index_map_matrix(sizes):
    """The fft oracle densifies to the dense mode's BTTB matrix, for a
    first row of a stationary kernel (the symmetric embedding needs
    t(r) even in every axis, which distances give)."""
    axes = [np.linspace(0, 1, s) for s in sizes]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(
        -1, len(sizes))
    top = np.exp(-np.sum((grid - grid[0]) ** 2, -1))
    dense = tbttb.bttb_dense(torch.as_tensor(top), sizes)
    want = top[tbttb.bttb_index_map(sizes)]
    _close(dense, want)
    _close(dense, jbttb.bttb_dense(jnp.asarray(top), sizes))


def _spec(pkg, D, Q, dim):
    """A spec of Q kernels on ``dim`` input dims: lmc kernels of rank 2
    and 1, then an indep one (Q = 3), or one rank-1 lmc kernel."""
    if Q == 1:
        return pkg.LMCKernelSpec.create(
            D=D, lmc_kernels=[pkg.RBF()], lmc_ranks=[1]).with_input_dim(dim)
    return pkg.LMCKernelSpec.create(
        D=D, lmc_kernels=[pkg.RBF(name="a"), pkg.Matern32(name="b")],
        lmc_ranks=[2, 1], indep_gp=[pkg.RBF(name="c")],
    ).with_input_dim(dim)


def _fft_problem(D, Q, sizes, rep, seed=0):
    """(JAX spec, port spec, raw params, JAX grid data, port grid data,
    lens) of an fft-mode group with representation ``rep``."""
    dim = len(sizes)
    rng = np.random.RandomState(seed)
    Xs = [rng.uniform(0, 1, (n, dim)) for n in (17, 12, 15)[:D]]
    sj, st = _spec(R, D, Q, dim), _spec(T, D, Q, dim)
    raw = jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)),
        sj.init_raw_params(seed=seed))
    gj, _ = jgrid.make_grids(sj, Xs, m=list(sizes), rep=rep, mode="fft")
    gt, _ = tgrid.make_grids(st, Xs, m=list(sizes), rep=rep, mode="fft")
    return sj, st, raw, gj, gt, [len(X) for X in Xs]


def _group_states(sj, st, raw, gj, gt):
    pj = jax.tree.map(jnp.asarray, raw)
    pt = from_reference_params(raw, torch.float64, "cpu")
    gsj = jgrid.build_group_state(sj, pj, gj.plan, jnp.asarray(gj.dists),
                                  gj.interp, None, gj.W_blocks)
    gst = tgrid.build_group_state(st, pt, gt.to(torch.float64, "cpu"))
    return gsj, gst


@pytest.mark.parametrize("rep", ["sum", "bt", "slfm"])
@pytest.mark.parametrize("D,Q", [(1, 1), (1, 3), (3, 1), (3, 3)])
def test_grid_matvec_matches_jax(rep, D, Q):
    sj, st, raw, gj, gt, _ = _fft_problem(D, Q, (11,), rep)
    gsj, gst = _group_states(sj, st, raw, gj[0], gt[0])
    assert gst.mode == "fft" and gst.rep == rep
    m = int(np.prod(gt[0].plan.sizes))  # autogrid pads the 11 points
    u = np.random.RandomState(5).standard_normal((4, D * m))
    _close(gst.grid_matvec(torch.as_tensor(u)),
           gsj.grid_matvec(jnp.asarray(u)))


@pytest.mark.parametrize("rep", ["sum", "bt", "slfm"])
@pytest.mark.parametrize("sizes", [(6, 5), (3, 4, 4)])
def test_grid_matvec_matches_jax_multidim(rep, sizes):
    """K_UU u on 2- and 3-D grids. Interpolation takes at most two
    active dims per group, so the group is built from its grid alone:
    the distances of a regular grid and an interpolant that only
    states its column count."""
    dim, D = len(sizes), 3
    sj, st = _spec(R, D, 3, dim), _spec(T, D, 3, dim)
    rng = np.random.RandomState(1)
    raw = jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)),
        sj.init_raw_params(seed=1))
    axes = [np.linspace(0, 1, s) for s in sizes]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, dim)
    dists = np.linalg.norm(grid - grid[0], axis=-1)
    m = len(dists)
    cols = types.SimpleNamespace(ncols=D * m)
    kidxs = tuple(range(3))
    gsj = jgrid.build_group_state(
        sj, jax.tree.map(jnp.asarray, raw),
        jgrid.GridPlan(active_dim=tuple(range(dim)), kidxs=kidxs, rep=rep,
                       sizes=sizes, mode="fft"),
        jnp.asarray(dists), cols)
    gst = tgrid.build_group_state(
        st, from_reference_params(raw, torch.float64, "cpu"),
        tgrid.GridData(
            plan=tgrid.GridPlan(active_dim=tuple(range(dim)), kidxs=kidxs,
                                rep=rep, sizes=sizes, mode="fft"),
            dists=torch.as_tensor(dists), interp=cols))
    u = np.random.RandomState(6).standard_normal((2, D * m))
    _close(gst.grid_matvec(torch.as_tensor(u)),
           gsj.grid_matvec(jnp.asarray(u)))
    # one vector, no batch axis
    _close(gst.grid_matvec(torch.as_tensor(u[0])),
           gsj.grid_matvec(jnp.asarray(u[0])))


@pytest.mark.parametrize("blocks", [True, False])
def test_kski_matvec_fft_matches_jax(monkeypatch, blocks):
    """The full SKI operator of an fft group, through the W blocks or,
    over a lowered element cap, through the interpolant (kernel K9)."""
    if not blocks:
        monkeypatch.setattr(jgrid, "W_BLOCKS_MAX_ELEMS", 10)
        monkeypatch.setattr(tgrid, "W_BLOCKS_MAX_ELEMS", 10)
    sj, st, raw, gj, gt, lens = _fft_problem(3, 3, (14,), "slfm", seed=2)
    assert (gt[0].W_blocks is not None) == blocks
    assert (gj[0].W_blocks is not None) == blocks
    Kj = jgrid.build_kski(sj, jax.tree.map(jnp.asarray, raw),
                          jax.tree.map(jnp.asarray,
                                       [g.replace(coarse=None) for g in gj]),
                          lens)
    Kt = tgrid.build_kski(st, from_reference_params(raw, torch.float64, "cpu"),
                          tuple(g.to(torch.float64, "cpu") for g in gt), lens)
    x = np.random.RandomState(3).standard_normal((2, sum(lens)))
    _close(Kt.matvec(torch.as_tensor(x)), Kj.matvec(jnp.asarray(x)), 1e-11)


def _contract_inputs(rep, nb=2, D=2, K=2, F=5, seed=0):
    g = torch.Generator().manual_seed(seed)

    def cplx(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.complex128)

    vf = cplx(nb, D, F)
    if rep == "sum":
        return vf, torch.randn(K, D, D, generator=g, dtype=torch.float64), \
            cplx(K, F), None
    if rep == "bt":
        return vf, None, cplx(D, D, F), None
    return vf, torch.randn(D, K, generator=g, dtype=torch.float64), \
        cplx(K, F), cplx(D, F)


@pytest.mark.parametrize("rep", ["sum", "bt", "slfm"])
def test_contract_function_gradcheck(rep):
    """The autograd function's backward (the batch outer product H and
    the einsums of every parameter cotangent) in complex128, against
    finite differences, under torch's conjugate Wirtinger convention."""
    ins = [t for t in _contract_inputs(rep) if t is not None]
    for t in ins:
        t.requires_grad_(True)

    def fn(*args):
        it = iter(args)
        full = [next(it) if t is not None else None
                for t in _contract_inputs(rep)]
        return fourier.contract(rep, *full)

    assert torch.autograd.gradcheck(fn, tuple(ins), eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("rep", ["sum", "bt", "slfm"])
def test_contract_function_matches_plain_autograd(rep):
    """The hand-written backward against torch autograd of the plain
    einsums, every input at once (the card-side test's CPU twin)."""
    ins = _contract_inputs(rep, nb=3, D=3, K=2, F=9, seed=4)
    G = _contract_inputs("bt", nb=3, D=3, F=9, seed=5)[0]

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in ins if t is not None]
        it = iter(leaves)
        args = [next(it) if t is not None else None for t in ins]
        return torch.autograd.grad(fn(rep, *args), leaves, G)

    for a, b in zip(grads(fourier.contract),
                    grads(fourier.fourier_contract_plain)):
        _close(a, b.detach().numpy())


@pytest.mark.parametrize("rep", ["sum", "bt", "slfm"])
def test_param_gradient_of_grid_matvec_matches_jax(rep):
    """d/dtheta <c, K_UU(theta) u> through the fft operator: K10's
    backward in the port, XLA's autodiff in the JAX package."""
    sj, st, raw, gj, gt, _ = _fft_problem(3, 3, (9,), rep, seed=3)
    rng = np.random.RandomState(7)
    dm = 3 * int(np.prod(gt[0].plan.sizes))
    u = rng.standard_normal((2, dm))
    c = rng.standard_normal((2, dm))

    def fj(p):
        gs = jgrid.build_group_state(sj, p, gj[0].plan,
                                     jnp.asarray(gj[0].dists), gj[0].interp,
                                     None, gj[0].W_blocks)
        return jnp.sum(jnp.asarray(c) * gs.grid_matvec(jnp.asarray(u)))

    want, _ = ravel_pytree(jax.grad(fj)(jax.tree.map(jnp.asarray, raw)))
    pt = from_reference_params(raw, torch.float64, "cpu")
    x = ravel_params(pt).requires_grad_(True)
    gs = tgrid.build_group_state(st, unravel_params(x, pt),
                                 gt[0].to(torch.float64, "cpu"))
    out = torch.sum(torch.as_tensor(c) * gs.grid_matvec(torch.as_tensor(u)))
    (got,) = torch.autograd.grad(out, x)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("cap", [None, 10])
def test_make_grids_fft_matches_jax(monkeypatch, cap):
    """fft mode under 'auto' past DENSE_MAX_GRID: the same modes, sizes,
    preconditioner twin and W blocks as the JAX package, with the
    blocks dropped over a lowered W_BLOCKS_MAX_ELEMS and the twin
    coarsened under a lowered PRECOND_MAX_GRID."""
    for mod in (jgrid, tgrid):
        monkeypatch.setattr(mod, "DENSE_MAX_GRID", 64)
        if cap is not None:
            monkeypatch.setattr(mod, "W_BLOCKS_MAX_ELEMS", cap)
            monkeypatch.setattr(mod, "PRECOND_MAX_GRID", 64)
    rng = np.random.RandomState(8)
    Xs = [rng.uniform(0, 1, (n, 1)) for n in (40, 33)]
    sj = R.LMCKernelSpec.create(D=2, lmc_kernels=[R.RBF()],
                                lmc_ranks=[1]).with_input_dim(1)
    st = T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()],
                                lmc_ranks=[1]).with_input_dim(1)
    gj, aj = jgrid.make_grids(sj, Xs, m=[50])
    gt, at = tgrid.make_grids(st, Xs, m=[50])
    np.testing.assert_array_equal(aj[0][0], at[0][0])
    a, b = gj[0], gt[0]
    assert a.plan.mode == b.plan.mode == "fft"
    assert (a.plan.rep, a.plan.sizes) == (b.plan.rep, b.plan.sizes)
    assert b.WtW is None
    assert (a.W_blocks is None) == (b.W_blocks is None) == (cap is not None)
    if b.W_blocks is not None:
        for wa, wb in zip(a.W_blocks, b.W_blocks):
            np.testing.assert_array_equal(wa, wb)
    ca, cb = a.coarse, b.coarse
    assert cb.plan.mode == ca.plan.mode == "dense"
    assert cb.plan.sizes == ca.plan.sizes == tgrid.coarse_sizes(
        b.plan.sizes, 2, cap=tgrid.PRECOND_MAX_GRID)
    assert (cb.plan.sizes == b.plan.sizes) == (cap is None)
    np.testing.assert_array_equal(np.asarray(ca.dists), cb.dists)
    np.testing.assert_array_equal(np.asarray(ca.interp.weights),
                                  cb.interp.weights)
    for wa, wb in zip(ca.W_blocks, cb.W_blocks):
        np.testing.assert_array_equal(wa, wb)
    np.testing.assert_array_equal(ca.WtW, cb.WtW)


def test_grid_mode_tiled_is_refused():
    st = T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()],
                                lmc_ranks=[1]).with_input_dim(1)
    Xs = [np.linspace(0, 1, 20).reshape(-1, 1)] * 2
    with pytest.raises(ValueError, match="TPU-only"):
        tgrid.make_grids(st, Xs, m=[10], mode="tiled")
    with pytest.raises(ValueError, match="unknown grid mode"):
        tgrid.make_grids(st, Xs, m=[10], mode="sparse")

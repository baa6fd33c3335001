"""K8 on the fft groups' first rows (``hopper/kern_rows_fft.py``): the
Fourier symbol that an fft group builds from the kernel table through
the embedding kernel, and its gradient in the raw parameters, against
the JAX package's ``bttb_fft(eval_kernels_stacked(...))`` for every
representation on 1-D and 2-D grids, in float64 (the plain version on
the CPU; the same pocketfft and elementwise k(r) on both sides: float64
rounding, 1e-12 of the largest magnitude); and numpy mirrors of the CUDA
kernels' index arithmetic (``src_of`` and the fold over each first-row
point's images) against the plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.ops import bttb as jbttb
from runlmc_tpu_torch.hopper import kern_rows_fft as k8
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.ops import bttb as tbttb
from runlmc_tpu_torch.utils.carry import (
    from_reference_params,
    ravel_params,
    unravel_params,
)

RTOL = 1e-12


def _spec(pkg, dim):
    """Q = 4: lmc kernels of rank 2 and 1, an slfm and an indep kernel,
    three kinds."""
    return pkg.LMCKernelSpec.create(
        D=3, lmc_kernels=[pkg.RBF(name="a"), pkg.Matern32(name="b")],
        lmc_ranks=[2, 1], slfm_kernels=[pkg.StdPeriodic(name="p",
                                                        period=0.7)],
        indep_gp=[pkg.RBF(name="c")],
    ).with_input_dim(dim)


def _problem(sizes, rep, seed=0):
    """(JAX spec, port spec, raw params, distances, port GridData) of a
    regular grid of ``sizes`` in fft mode with representation ``rep``."""
    dim = len(sizes)
    sj, st = _spec(R, dim), _spec(T, dim)
    rng = np.random.RandomState(seed)
    raw = jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)),
        sj.init_raw_params(seed=seed))
    axes = [np.linspace(0, 1, s) for s in sizes]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, dim)
    dists = np.linalg.norm(grid - grid[0], axis=-1)
    kidxs = tuple(range(st.Q))

    class Cols:  # the group's interpolant only states its width
        ncols = 3 * len(dists)

    gd = tgrid.GridData(
        plan=tgrid.GridPlan(active_dim=tuple(range(dim)), kidxs=kidxs,
                            rep=rep, sizes=tuple(sizes), mode="fft"),
        dists=torch.as_tensor(dists), interp=Cols())
    return sj, st, raw, dists, gd


def _jax_symbol(sj, p, dists, sizes):
    tops = sj.eval_kernels_stacked(p, jnp.asarray(dists), range(sj.Q))
    return jbttb.bttb_fft(tops, sizes).reshape(sj.Q, -1)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("sizes", [(23,), (6, 5)])
def test_symbol_matches_jax(sizes):
    """The embedding kernel's symbol (Q, F) against JAX's
    bttb_fft(eval_kernels_stacked), and the 'sum' group's That."""
    sj, st, raw, dists, gd = _problem(sizes, "sum")
    pt = from_reference_params(raw, torch.float64, "cpu")
    kinds, prm = st.table_rows(pt, range(st.Q))
    ext = k8.kern_rows_fft(kinds, prm, torch.as_tensor(dists), sizes)
    assert tuple(ext.shape) == (st.Q,) + tbttb.extension_sizes(sizes)
    sym = tbttb.extension_fft(ext, len(sizes)).reshape(st.Q, -1)
    want = _jax_symbol(sj, jax.tree.map(jnp.asarray, raw), dists, sizes)
    _close(torch.view_as_real(sym), np.stack([np.real(want),
                                              np.imag(want)], -1))
    gs = tgrid.build_group_state(st, pt, gd)
    _close(torch.view_as_real(gs.That), np.stack([np.real(want),
                                                  np.imag(want)], -1))


@pytest.mark.parametrize("rep", ["sum", "bt", "slfm"])
@pytest.mark.parametrize("sizes", [(23,), (6, 5)])
def test_symbol_gradient_matches_jax(rep, sizes):
    """d/dtheta of a seeded real functional of the group's Fourier
    fields (the symbol through its representation) in the raw
    parameters, against jax.grad of the same functional of JAX's group
    state built from bttb_fft(eval_kernels_stacked)."""
    from runlmc_tpu.lmc import grid as jgrid

    sj, st, raw, dists, gd = _problem(sizes, rep, seed=len(sizes))
    rng = np.random.RandomState(9)
    fields = {"sum": ("B", "That"), "bt": ("BThat",),
              "slfm": ("A", "That_rep", "diag_That")}[rep]

    class Cols:
        ncols = 3 * len(dists)

    jplan = jgrid.GridPlan(active_dim=gd.plan.active_dim,
                           kidxs=gd.plan.kidxs, rep=rep,
                           sizes=tuple(sizes), mode="fft")
    probe = {}

    def weights(name, shape):
        if name not in probe:
            probe[name] = rng.standard_normal(tuple(shape) + (2,))
        return probe[name]

    def fj(p):
        gs = jgrid.build_group_state(sj, p, jplan, jnp.asarray(dists),
                                     Cols())
        tot = 0.0
        for f in fields:
            v = jnp.asarray(getattr(gs, f))
            w = weights(f, v.shape)
            tot = tot + jnp.sum(w[..., 0] * jnp.real(v)) \
                + jnp.sum(w[..., 1] * jnp.imag(v))
        return tot

    want, _ = ravel_pytree(jax.grad(fj)(jax.tree.map(jnp.asarray, raw)))
    pt = from_reference_params(raw, torch.float64, "cpu")
    x = ravel_params(pt).requires_grad_(True)
    gs = tgrid.build_group_state(st, unravel_params(x, pt), gd)
    tot = 0.0
    for f in fields:
        v = getattr(gs, f)
        w = torch.as_tensor(probe[f])
        if torch.is_complex(v):
            tot = tot + torch.sum(w[..., 0] * v.real) \
                + torch.sum(w[..., 1] * v.imag)
        else:
            tot = tot + torch.sum(w[..., 0] * v)
    (got,) = torch.autograd.grad(tot, x)
    _close(got, want)


def _mirror_forward(kinds, prm, dists, sizes):
    """csrc/kern_rows_fft.cu's forward, one embedded element at a time:
    each axis maps e to e (e < n), E - e (e > E - n) or no source."""
    sizes = tuple(sizes)
    ext = tbttb.extension_sizes(sizes)
    tops = np.asarray(k8.eval_table(kinds, torch.as_tensor(prm),
                                    torch.as_tensor(dists)))
    out = np.zeros((len(kinds),) + ext)

    def src(e, n, E):
        return e if e < n else (E - e if e > E - n else -1)

    for idx in np.ndindex(*ext):
        s = [src(e, n, E) for e, n, E in zip(idx, sizes, ext)]
        if min(s) >= 0:
            out[(slice(None),) + idx] = tops[:, np.ravel_multi_index(s,
                                                                     sizes)]
    return out


def _mirror_fold(G, sizes):
    """csrc/kern_rows_fft.cu's backward fold: each first-row point's
    cotangent is the sum of its images (e = s, and E - s where s > 0,
    on each axis)."""
    sizes = tuple(sizes)
    ext = tbttb.extension_sizes(sizes)
    out = np.zeros((G.shape[0],) + sizes)
    for o in np.ndindex(*sizes):
        ims = [[s] + ([E - s] if s > 0 else []) for s, E in zip(o, ext)]
        for e in np.ndindex(*[len(i) for i in ims]):
            pos = tuple(ims[a][b] for a, b in enumerate(e))
            out[(slice(None),) + o] += G[(slice(None),) + pos]
    return out.reshape(G.shape[0], -1)


@pytest.mark.parametrize("sizes", [(1,), (2,), (7,), (4, 3), (2, 3, 4)])
def test_mirrors_of_the_kernel_loops(sizes):
    """The kernels' index arithmetic (numpy mirrors) against the plain
    version: the embedding, and the fold of a seeded cotangent, whose
    contraction with the per-point derivatives is the table's
    cotangent."""
    m = int(np.prod(sizes))
    rng = np.random.RandomState(m)
    kinds = (0, 1, 2, 3)
    prm = 0.5 + rng.uniform(size=(4, 3))
    dists = np.concatenate([[0.0], np.sort(rng.uniform(0, 2, m - 1))])
    want = k8.kern_rows_fft_plain(kinds, torch.as_tensor(prm),
                                  torch.as_tensor(dists), sizes)
    _close(_mirror_forward(kinds, prm, dists, sizes), want.numpy(),
           rtol=0)
    G = rng.standard_normal(tuple(want.shape))
    fold = _mirror_fold(G, sizes)
    p = torch.as_tensor(prm).requires_grad_(True)
    tops = k8.eval_table(kinds, p, torch.as_tensor(dists))
    (dprm,) = torch.autograd.grad(tops, p, torch.as_tensor(fold))
    got = k8.kern_rows_fft_bwd(kinds, torch.as_tensor(prm),
                               torch.as_tensor(dists), sizes,
                               torch.as_tensor(G))
    _close(got, dprm.numpy())


def test_autograd_function_gradcheck():
    sizes = (5, 3)
    m = 15
    rng = np.random.RandomState(2)
    dists = torch.as_tensor(np.concatenate(
        [[0.0], np.sort(rng.uniform(0, 2, m - 1))]))
    prm = torch.as_tensor(0.5 + rng.uniform(size=(3, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda p: k8.KernRowsFFT.apply((0, 1, 2), p, dists, sizes), (prm,))


def test_wrapper_checks_its_dtypes():
    """Table rows and distances of two dtypes are refused on every
    device (the kernel takes one)."""
    prm = torch.ones(2, 3, dtype=torch.float64)
    with pytest.raises(ValueError):
        k8.kern_rows_fft((0, 0), prm, torch.zeros(4, dtype=torch.float32),
                         (4,))

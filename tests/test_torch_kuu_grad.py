"""Kernel K1's backward (K8 fused in): the plain version and the autograd
function against JAX's autodiff of its dense ``build_group_state``, and
a line-by-line numpy mirror of the CUDA kernel's walk over offsets (the
kernel itself runs only on the card: tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu.ops.bttb import bttb_index_map as j_index_map
from runlmc_tpu_torch.hopper import kuu
from runlmc_tpu_torch.kernels.stationary import eval_table
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.utils.carry import _leaves, from_reference_params
from runlmc_tpu_torch.utils.np_utils import cartesian_product

# the same products and sums in another order: float64 rounding
RTOL = 1e-12

GRIDS = {"1d": [11], "2d": [4, 5], "3d": [3, 4, 2]}


def _problem(grid, Q, D):
    """JAX and port specs of Q kernels of rank 1 over all P input dims
    and D outputs, perturbed raw parameters, and the grid's sizes and
    first-row distances (built by hand: the interpolants take at most two
    dims, K1 takes three)."""
    sizes = tuple(GRIDS[grid])
    P = len(sizes)
    rng = np.random.RandomState(10 * Q + D)

    def mk(pkg):
        kerns = [pkg.RBF(name="r"), pkg.Matern32(name="m"),
                 pkg.StdPeriodic(name="p", period=0.8)][:Q]
        return pkg.LMCKernelSpec.create(
            D=D, lmc_kernels=kerns, lmc_ranks=[1] * Q,
        ).with_input_dim(P)

    sj, st = mk(R), mk(T)
    raw = jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)),
        sj.init_raw_params(seed=Q),
    )
    axes = [np.linspace(0.0, 0.3 * n, n) for n in sizes]
    grid_pts = cartesian_product(*axes)
    dists = np.linalg.norm(grid_pts - grid_pts[0], axis=-1)
    return sj, st, raw, sizes, dists


def _asym(n, seed):
    return np.random.RandomState(seed).standard_normal((n, n))


CASES = [(g, q, d) for g in GRIDS for q in (1, 3) for d in (1, 3)]


@pytest.mark.parametrize("grid,Q,D", CASES)
def test_param_gradient_matches_jax_vjp(grid, Q, D):
    """d <G, K_UU(params)> / d params: the port's autograd through
    KUUDense (plain backward on the CPU) vs jax.vjp of JAX's dense
    build_group_state, on an asymmetric cotangent G."""
    sj, st, raw, sizes, dists = _problem(grid, Q, D)
    m = int(np.prod(sizes))
    kidxs = tuple(range(Q))
    G = _asym(D * m, 7)

    def kuu_j(p):
        plan = jgrid.GridPlan(active_dim=tuple(range(len(sizes))),
                              kidxs=kidxs, rep="bt", sizes=sizes,
                              mode="dense")
        return jgrid.build_group_state(
            sj, p, plan, jnp.asarray(dists), None,
            jnp.asarray(j_index_map(sizes)),
        ).KUU_dense

    pj = jax.tree.map(jnp.asarray, raw)
    kj, vjp = jax.vjp(kuu_j, pj)
    (want,) = vjp(jnp.asarray(G))

    pt = from_reference_params(raw, torch.float64, "cpu")
    leaves = [leaf.requires_grad_(True) for _, leaf in _leaves(pt)]
    gdt = tgrid.GridData(
        plan=tgrid.GridPlan(active_dim=tuple(range(len(sizes))),
                            kidxs=kidxs, rep="bt", sizes=sizes),
        dists=torch.as_tensor(dists),
    )
    kt = tgrid.build_group_state(st, pt, gdt).KUU_dense
    np.testing.assert_allclose(kt.detach().numpy(), np.asarray(kj),
                               rtol=RTOL, atol=RTOL)
    got = torch.autograd.grad(kt, leaves, torch.as_tensor(G),
                              allow_unused=True)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(want_leaves) == len(got)
    for g, w in zip(got, want_leaves):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * max(np.abs(w).max(), 1.0))


def _table(Q, m, seed):
    """Kind codes (RBF, Matern32, StdPeriodic)[:Q], positive table rows
    [gamma, period, scale] and a (Q, m) sample of first-row distances
    (0 first)."""
    rng = np.random.RandomState(seed)
    kinds = (0, 1, 2)[:Q]
    prm = rng.uniform(0.5, 1.5, (Q, 3))
    dists = np.concatenate([[0.0], np.sort(rng.uniform(0.05, 2.0, m - 1))])
    return kinds, prm, dists


def _tops_j(kinds, prm, dists):
    """scale_q k~_q(dists) in jnp, the formulas of
    runlmc_tpu/kernels/stationary.py on the constrained table rows."""
    rows = []
    for q, kind in enumerate(kinds):
        g, p, s = prm[q, 0], prm[q, 1], prm[q, 2]
        if kind == 0:
            k = jnp.exp(-0.5 * jnp.square(dists) * g)
        elif kind == 1:
            sc = dists * (np.sqrt(3.0) * g)
            k = (1.0 + sc) * jnp.exp(-sc)
        else:
            k = jnp.exp(-0.5 * jnp.square(jnp.sin((np.pi / p) * dists)) * g)
        rows.append(s * k)
    return jnp.stack(rows)


@pytest.mark.parametrize("grid,Q,D", CASES)
def test_plain_backward_matches_jax_vjp_of_gather_einsum(grid, Q, D):
    """(d prm, d B) of kuu_dense_bwd's plain version vs jax.vjp of the
    JAX package's dense branch (grid.py:535-540: k(r) on the first rows,
    the gather and the einsum) on the same table rows and B."""
    sizes = GRIDS[grid]
    m = int(np.prod(sizes))
    rng = np.random.RandomState(Q + 5 * D)
    kinds, prm, dists = _table(Q, m, Q + 5 * D)
    B = rng.standard_normal((Q, D, D))
    G = _asym(D * m, 3)
    idx = jnp.asarray(j_index_map(sizes))

    def f(p, b):
        t = _tops_j(kinds, p, jnp.asarray(dists))
        return jnp.einsum("qde,qij->diej", b, t[:, idx],
                          precision=jax.lax.Precision.HIGHEST
                          ).reshape(D * m, D * m)

    _, vjp = jax.vjp(f, jnp.asarray(prm), jnp.asarray(B))
    dp_j, db_j = vjp(jnp.asarray(G))
    dp_t, db_t = kuu.kuu_dense_bwd(kinds, torch.as_tensor(prm),
                                   torch.as_tensor(dists), torch.as_tensor(B),
                                   sizes, torch.as_tensor(G))
    for got, want in ((dp_t, dp_j), (db_t, db_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


def _kernel_mirror(G, D, m, sizes, o_tile=32, slices=8):
    """H (D, D, m) by the CUDA kernel's own walk (csrc/kuu_dense_bwd.cu):
    per (d, e, o), every sign pattern in order, a0 sliced as the
    kernel's threadIdx.y slices, partial sums added in slice order."""
    n0, n1, n2 = kuu._sizes3(sizes)
    dm = D * m
    H = np.zeros((D, D, m))
    flat = G.reshape(-1)
    for d in range(D):
        for e in range(D):
            base = d * m * dm + e * m
            for o in range(m):
                dl0, dl1, dl2 = o // (n1 * n2), (o // n2) % n1, o % n2
                len0, len1, len2 = n0 - dl0, n1 - dl1, n2 - dl2
                chunk = (len0 + slices - 1) // slices
                parts = []
                for y in range(slices):
                    acc = 0.0
                    lo, hi = y * chunk, min(len0, y * chunk + chunk)
                    for pat in range(8):
                        f = [(pat >> p) & 1 for p in range(3)]
                        if ((f[0] and dl0 == 0) or (f[1] and dl1 == 0)
                                or (f[2] and dl2 == 0)):
                            continue
                        si = [dl if fp else 0
                              for dl, fp in zip((dl0, dl1, dl2), f)]
                        sj = [0 if fp else dl
                              for dl, fp in zip((dl0, dl1, dl2), f)]
                        for a0 in range(lo, hi):
                            for a1 in range(len1):
                                i = ((a0 + si[0]) * n1 + a1 + si[1]) * n2 \
                                    + si[2]
                                j = ((a0 + sj[0]) * n1 + a1 + sj[1]) * n2 \
                                    + sj[2]
                                p = base + i * dm + j
                                for a2 in range(len2):
                                    acc += flat[p + a2 * (dm + 1)]
                    parts.append(acc)
                H[d, e, o] = sum(parts)
    return H


@pytest.mark.parametrize("sizes", [(11,), (4, 5), (3, 4, 2), (2, 1, 3)])
def test_kernel_walk_visits_every_pair_once(sizes):
    """The CUDA kernel's offset decoding and sign patterns, mirrored in
    numpy, give the plain version's offset sums H on 1-, 2- and 3-D
    grids: a missed or doubled sign pattern would show here."""
    D = 2
    m = int(np.prod(sizes))
    G = _asym(D * m, 5)
    H = _kernel_mirror(G, D, m, sizes)
    # H from np.add.at through the index map, and the plain backward's
    # d B = sum_o tops[o] H[d, e, o] on one RBF row
    idx = j_index_map(sizes)
    want = np.zeros((D, D, m))
    for d in range(D):
        for e in range(D):
            np.add.at(want[d, e], idx.reshape(-1),
                      G[d * m:(d + 1) * m, e * m:(e + 1) * m].reshape(-1))
    kinds, prm, dists = _table(1, m, 2)
    _, dB = kuu.kuu_dense_bwd(kinds, torch.as_tensor(prm),
                              torch.as_tensor(dists),
                              torch.ones(1, D, D, dtype=torch.float64),
                              sizes, torch.as_tensor(G))
    tops = eval_table(kinds, torch.as_tensor(prm),
                      torch.as_tensor(dists)).numpy()[0]
    np.testing.assert_allclose(dB.numpy()[0], want @ tops, rtol=RTOL,
                               atol=RTOL * np.abs(want @ tops).max())
    np.testing.assert_allclose(H, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("sizes", [(5,), (3, 2), (2, 2, 2)])
def test_kuu_dense_function_gradcheck(sizes):
    m = int(np.prod(sizes))
    kinds, prm, dists = _table(3, m, 0)
    g = torch.Generator().manual_seed(0)
    prm = torch.as_tensor(prm).requires_grad_(True)
    B = torch.randn(3, 2, 2, generator=g, dtype=torch.float64,
                    requires_grad=True)
    dists = torch.as_tensor(dists)
    assert torch.autograd.gradcheck(
        lambda p, b: kuu.KUUDense.apply(kinds, p, dists, b, sizes), (prm, B))


def test_function_forward_is_kuu_dense_and_skips_unneeded_grads():
    sizes = (4, 3)
    kinds, prm, dists = _table(1, 12, 1)
    prm, dists = torch.as_tensor(prm), torch.as_tensor(dists)
    g = torch.Generator().manual_seed(1)
    B = torch.randn(1, 2, 2, generator=g, dtype=torch.float64,
                    requires_grad=True)
    out = kuu.KUUDense.apply(kinds, prm, dists, B, sizes)
    torch.testing.assert_close(
        out.detach(), kuu.kuu_dense_plain(kinds, prm, dists, B.detach(),
                                          sizes), rtol=0, atol=0)
    out.sum().backward()
    assert prm.grad is None and B.grad is not None

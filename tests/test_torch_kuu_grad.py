"""Kernel K1's backward (K8 fused in): the plain version and the autograd
function against JAX's autodiff of its dense ``build_group_state``, and
a numpy mirror of the CUDA kernel's tile walk over its host plan
(tests/torch_bwd_mirrors.py; the kernel itself runs only on the card:
tests/test_torch_cuda.py), and the plan's coverage and caching."""

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
from tests import torch_bwd_mirrors as mirrors

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


KUU_SIZES = [(11,), (4, 5), (3, 4, 2), (2, 1, 3), (40,), (3, 35), (1,),
             (5, 1), (2, 3, 33)]


@pytest.mark.parametrize("sizes", KUU_SIZES)
def test_kernel_walk_visits_every_pair_once(sizes):
    """The CUDA kernel's tile walk (csrc/kuu_dense_bwd.cu stage 1: band
    items of the host plan, lane k on the tile diagonals k and k - T) and
    the plan's slots per offset, mirrored in numpy, give the plain
    version's offset sums H on 1-, 2- and 3-D grids, with ragged tiles
    (sizes not a multiple of 32), one point and axes of size 1: a missed
    or doubled element would show here."""
    D = 2
    m = int(np.prod(sizes))
    G = _asym(D * m, 5)
    Hs = [mirrors.kuu_offset_sums(mirrors.kuu_tile_walk(G, D, m, sizes, b),
                                  D, m, sizes, b) for b in kuu.BANDS]
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
    for H in Hs:  # every band length the plan takes
        np.testing.assert_allclose(H, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("sizes", KUU_SIZES + [(29, 29), (238,)])
def test_bwd_plan_covers_every_element_once(sizes):
    """Every element of an (m, m) block lies in exactly one tile of the
    plan's items, and each tile of a band item lies on the item's
    signed offsets; the CSR over offsets lists each valid slot once."""
    n0, n1, N2 = kuu._sizes_inner(sizes)
    m = int(np.prod(sizes))
    tile = min(kuu.TILE, N2)
    nbk = -(-N2 // tile)
    for band in kuu.BANDS:
        seen = np.zeros((m, m), dtype=int)
        for s0, s1, kb, start, count in kuu.bwd_items(sizes, band):
            assert 1 <= count <= band
            a1, a2 = n1 - abs(s1), nbk - abs(kb)
            for u in range(start, start + count):
                u2, u1, u0 = u % a2, (u // a2) % a1, u // (a2 * a1)
                i0, i1 = u0 + max(0, -s0), u1 + max(0, -s1)
                bi = u2 + max(0, -kb)
                rb = (i0 * n1 + i1) * N2 + bi * tile
                cb = ((i0 + s0) * n1 + i1 + s1) * N2 + (bi + kb) * tile
                rl = min(tile, N2 - bi * tile)
                cl = min(tile, N2 - (bi + kb) * tile)
                seen[rb:rb + rl, cb:cb + cl] += 1
        assert np.all(seen == 1)
        counts = [c for *_, c in kuu.bwd_items(sizes, band)]
        assert counts == sorted(counts, reverse=True)  # deepest first
        _, optr, oent = kuu.bwd_plan(sizes, band)
        offs = kuu.slot_offsets(sizes, band).reshape(-1)
        assert optr[-1] == len(oent) == np.sum(offs >= 0)
        assert len(set(oent.tolist())) == len(oent)
        for o in range(m):
            assert np.all(offs[oent[optr[o]:optr[o + 1]]] == o)


def test_bwd_plan_is_cached():
    """The host plan is made once per grid and band (equal grids, trailing
    axes of size 1 included, share it) and placed once per (grid, D,
    device); the band is the longest that leaves stage 1 MIN_WARPS warps
    (the fx2007, synth and weather-twin grids take 4, 4 and 16)."""
    assert kuu.bwd_plan((7, 6)) is kuu.bwd_plan([7, 6])
    assert kuu.bwd_plan((9,), 8) is kuu.bwd_plan((9, 1), 8)
    assert kuu.bwd_items((3, 4, 2)) is kuu.bwd_items((3, 4, 2))
    dev = torch.device("cpu")
    a, n, longest = kuu._device_plan((7, 6), 2, dev)
    b, _, _ = kuu._device_plan((7, 6), 2, dev)
    band = kuu.band_for((7, 6), 2)
    assert a is b and n == len(kuu.bwd_items((7, 6), band))
    _, optr, _ = kuu.bwd_plan((7, 6), band)  # a second-pass CTA's list
    assert longest == max(optr[min(c + kuu._R, 42)] - optr[c]
                          for c in range(0, 42, kuu._R))
    assert [kuu.band_for(s, D) for s, D in
            (((238,), 13), ((29, 29), 5), ((2504,), 4))] == [4, 4, 16]


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

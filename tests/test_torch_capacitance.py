"""K2, the Woodbury capacitance matrix, and K4, the W-block applies
through K9: the port's plain versions and autograd functions against the
JAX package (build_device_woodbury, exact_ski_mll) on 1-D, 2-D and
two-group problems, gradchecks, and a numpy emulation of the CUDA
kernels' loops over the host tile plan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu.lmc import likelihood as jlk
from runlmc_tpu.lmc import woodbury as jwb
from runlmc_tpu_torch.hopper import capacitance as cap
from runlmc_tpu_torch.hopper.interp import InterpApply
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.lmc import likelihood as tlk
from runlmc_tpu_torch.lmc import woodbury as twb
from runlmc_tpu_torch.utils.carry import _leaves, from_reference_params


def _problem(kind):
    """(JAX spec, port spec, Xs, y, m): 1-D (D=3, m=[6] -> 10 grid
    points); 2-D (one bicubic group, block-banded grams); two groups (a
    2-D group and a 1-D one over a 3-D input, so C has cross blocks)."""
    rng = np.random.RandomState(5)
    if kind == "1d":
        Xs = [rng.uniform(0, 3, (n, 1)) for n in (17, 21, 14)]

        def mk(pkg):
            return pkg.LMCKernelSpec.create(
                D=3, lmc_kernels=[pkg.RBF()], lmc_ranks=[2],
                indep_gp=[pkg.Matern32(name="i")]).with_input_dim(1)

        m = [6]
    elif kind == "2d":
        Xs = [rng.uniform(0, 1, (n, 2)) for n in (40, 33)]

        def mk(pkg):
            return pkg.LMCKernelSpec.create(
                D=2, slfm_kernels=[pkg.RBF(name="s")],
                indep_gp=[pkg.RBF(name="r%d" % i) for i in range(2)],
            ).with_input_dim(2)

        m = [5, 6]
    else:
        Xs = [rng.uniform(0, 1, (n, 3)) for n in (28, 25)]

        def mk(pkg):
            return pkg.LMCKernelSpec.create(
                D=2, lmc_kernels=[pkg.RBF(name="a", active_dims=(0, 1))],
                lmc_ranks=[1],
                indep_gp=[pkg.Matern32(name="b", active_dims=(2,)),
                          pkg.RBF(name="c", active_dims=(2,))],
            ).with_input_dim(3)

        m = [4, 5, 7]
    y = np.concatenate([np.sin(3 * X[:, 0]) + 0.1 * rng.standard_normal(len(X))
                        for X in Xs])
    sj, st = mk(R), mk(T)
    return sj, st, Xs, y, m


def _raw(sj, seed=2):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)),
        sj.init_raw_params(seed=1))


KINDS = ["1d", "2d", "two_groups"]


def _jax_capacitance(gj, Fs, inv_eps):
    """C from the JAX package's factors and grams by the expressions of
    its diag_block / cross_block (runlmc_tpu/lmc/woodbury.py:260-298),
    which build_device_woodbury keeps to itself."""
    hi = jax.lax.Precision.HIGHEST
    n = len(gj)
    rows = [[None] * n for _ in range(n)]
    for a in range(n):
        G = jnp.asarray(gj[a].WtW)
        D, m = G.shape[0], G.shape[1]
        Fd = Fs[a].reshape(D, m, -1)
        T1 = jnp.einsum("dij,djk->dik", G, Fd, precision=hi)
        rows[a][a] = jnp.einsum("d,dik,dil->kl", inv_eps, Fd, T1,
                                precision=hi)
        for b in range(a + 1, n):
            ma, mb = m, gj[b].WtW.shape[1]
            out = 0.0
            for d, (wa, wb) in enumerate(zip(gj[a].W_blocks,
                                             gj[b].W_blocks)):
                G_ab = jnp.einsum("ni,nj->ij", wa, wb, precision=hi)
                out = out + inv_eps[d] * jnp.einsum(
                    "ik,ij,jl->kl", Fs[a][d * ma:(d + 1) * ma], G_ab,
                    Fs[b][d * mb:(d + 1) * mb], precision=hi)
            rows[a][b], rows[b][a] = out, out.T
    C = jnp.block(rows)
    return np.asarray(C + jnp.eye(C.shape[0]))


@pytest.mark.parametrize("kind", KINDS)
def test_capacitance_and_factor_match_jax(kind):
    """C (by the JAX package's expressions on its own factors), L_C and
    the log-det of the Woodbury factorization, float64, within 1e-12
    relative."""
    sj, st, Xs, y, m = _problem(kind)
    raw = _raw(sj)
    lens = [len(X) for X in Xs]
    gj, _ = jgrid.make_grids(sj, Xs, m=m)
    gt, _ = tgrid.make_grids(st, Xs, m=m)
    assert len(gj) == len(gt) == (2 if kind == "two_groups" else 1)
    pj = jax.tree.map(jnp.asarray, raw)
    Kj = jgrid.build_kski(sj, pj, gj, lens)
    wj = jwb.build_device_woodbury(Kj.groups, sj.noise(pj), Kj.noise_n,
                                   tuple(gd.WtW for gd in gj))
    pt = from_reference_params(raw, torch.float64, "cpu")
    gt = tuple(gd.to(torch.float64, "cpu") for gd in gt)
    Kt = tgrid.build_kski(st, pt, gt, lens)
    wt = twb.build_device_woodbury(Kt.groups, st.noise(pt), Kt.noise_n, gt)
    # K2 on the JAX package's own factors, so that C's comparison does
    # not carry the two packages' Cholesky rounding
    C = cap.capacitance_matrix(
        tgrid.gram_nest(gt), 1.0 / st.noise(pt),
        [torch.as_tensor(np.array(F)) for F in wj.Fs]).numpy()
    Cj = _jax_capacitance(gj, wj.Fs, 1.0 / sj.noise(pj))
    Lj = np.asarray(wj.L_C)
    assert np.abs(C - C.T).max() == 0.0
    np.testing.assert_allclose(C, Cj, rtol=0, atol=1e-12 * np.abs(Cj).max())
    # C's factor, from the same C
    L = twb.chol_jittered(torch.as_tensor(C), scales=(0.0, 1e-6, 1e-3, 1e-1))
    np.testing.assert_allclose(L.numpy(), Lj, rtol=0,
                               atol=1e-12 * np.abs(Lj).max())
    np.testing.assert_allclose(float(wt.logdet), float(wj.logdet),
                               rtol=1e-12)
    # the whole factorization: each package factors K_UU itself, and the
    # two float64 Cholesky factors round apart by about 1e-13, which C's
    # condition carries into L_C at about 1e-11
    np.testing.assert_allclose(wt.L_C.numpy(), Lj, rtol=0,
                               atol=1e-10 * np.abs(Lj).max())


def _seeded_inputs(ks, D, seed, grad=True):
    """inv_eps (D,) and lower factors F_g (k_g, k_g), float64."""
    rng = np.random.RandomState(seed)
    inv_eps = torch.as_tensor(rng.uniform(0.5, 2.0, D),
                              dtype=torch.float64).requires_grad_(grad)
    Fs = [torch.as_tensor(np.tril(rng.standard_normal((k, k))),
                          dtype=torch.float64).requires_grad_(grad)
          for k in ks]
    return inv_eps, Fs


def _seeded_nest(ms, D, seed):
    """A gram nest of seeded banded grams: G_aa symmetric, G_ba =
    G_ab^T, with the tile plans."""
    rng = np.random.RandomState(seed)
    n = len(ms)
    nest = [[None] * n for _ in range(n)]
    for a in range(n):
        for b in range(a, n):
            G = rng.standard_normal((D, ms[a], ms[b]))
            i, j = np.ogrid[:ms[a], :ms[b]]
            G = G * (np.abs(i * ms[b] / ms[a] - j) <= 2)
            if a == b:
                G = G + np.swapaxes(G, 1, 2)
            for x, y, g in ((a, b, G), (b, a, np.swapaxes(G, 1, 2))):
                g = np.ascontiguousarray(g)
                nest[x][y] = (torch.as_tensor(g), *(
                    torch.as_tensor(t) for t in cap.tile_plan(g)))
    return nest


@pytest.mark.parametrize("ms", [(5,), (4, 3)])
def test_capacitance_gradcheck(ms):
    D = 2
    nest = _seeded_nest(ms, D, seed=3)
    inv_eps, Fs = _seeded_inputs([D * m for m in ms], D, seed=4)

    def f(inv_eps, *Fs):
        return cap.Capacitance.apply(nest, inv_eps, *Fs)

    assert torch.autograd.gradcheck(f, (inv_eps, *Fs), eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("transpose", [False, True])
def test_interp_apply_gradcheck(transpose):
    rng = np.random.RandomState(6)
    Xs = [rng.uniform(0, 1, (n, 2)) for n in (9, 7)]
    W = tgrid.multi_interpolant(Xs, [np.linspace(-0.2, 1.2, 5),
                                     np.linspace(-0.2, 1.2, 6)])
    W = W.to(torch.float64, "cpu")
    v = torch.as_tensor(rng.standard_normal(
        (3, W.shape[0] if transpose else W.ncols))).requires_grad_(True)

    def f(v):
        return InterpApply.apply(v, *W._args(), transpose)

    assert torch.autograd.gradcheck(f, (v,))
    dense = torch.as_tensor(np.concatenate([
        np.pad(b, ((0, 0), (d * 30, (1 - d) * 30))) for d, b in
        enumerate(tgrid.interp_output_blocks(
            Xs, [np.linspace(-0.2, 1.2, 5), np.linspace(-0.2, 1.2, 6)]))]))
    want = v.detach() @ (dense if transpose else dense.T)
    np.testing.assert_allclose(f(v).detach().numpy(), want.numpy(),
                               rtol=0, atol=1e-14)


def _emulate(nest, inv_eps, Fs, bm):
    """The CUDA kernels' loops in numpy: stage 1 over the plan's tiles
    only, stage 2 over the lower tiles of C and, per tile, only the d and
    rows i that reach it, and the backward over its r-ranges, on tiles
    of ``bm``. Returns (C, Ts, d inv_eps, Fbars) for a seeded Cbar."""
    R_, P_ = cap.PLAN_ROWS, cap.PLAN_COLS
    inv = inv_eps.detach().numpy()
    D = len(inv)
    F = [np.tril(f.detach().numpy()) for f in Fs]
    ks = [f.shape[0] for f in F]
    ms = [k // D for k in ks]
    offs = np.cumsum([0] + ks[:-1])
    k = sum(ks)
    Ts = [np.zeros((D, m, k)) for m in ms]
    for a in range(len(F)):
        for b in range(len(F)):
            G, ptr, rblk = (t.numpy() for t in nest[a][b])
            mb = ms[b]
            for d in range(D):
                for pb in range(-(-ms[a] // R_)):
                    rows = slice(pb * R_, min((pb + 1) * R_, ms[a]))
                    for q0 in range(0, ks[b], R_):
                        if q0 >= (d + 1) * mb:
                            continue
                        cols = slice(q0, min(q0 + R_, ks[b]))
                        for e in range(ptr[d * (-(-ms[a] // R_)) + pb],
                                       ptr[d * (-(-ms[a] // R_)) + pb + 1]):
                            rs = max(rblk[e] * P_, q0 - d * mb, 0)
                            re = min(rblk[e] * P_ + P_, mb)
                            if rs >= re:
                                continue
                            Ts[a][d, rows, offs[b] + cols.start:
                                  offs[b] + cols.stop] += (
                                G[d, rows, rs:re]
                                @ F[b][d * mb + rs:d * mb + re, cols])
    C = np.zeros((k, k))
    for a in range(len(F)):
        for b in range(a + 1):
            for k0 in range(0, ks[a], bm):
                for l0 in range(0, ks[b], bm):
                    if a == b and l0 > k0:
                        continue
                    acc = np.zeros((min(bm, ks[a] - k0), min(bm, ks[b] - l0)))
                    for d in range(k0 // ms[a], D):
                        i0 = max(0, k0 - d * ms[a])
                        acc += inv[d] * F[a][d * ms[a] + i0:(d + 1) * ms[a],
                                             k0:k0 + bm].T @ Ts[a][
                            d, i0:, offs[b] + l0:offs[b] + l0 + acc.shape[1]]
                    if a == b and k0 == l0:  # a diagonal tile: k >= l
                        acc = np.tril(acc)
                    C[np.ix_(offs[a] + k0 + np.arange(acc.shape[0]),
                             offs[b] + l0 + np.arange(acc.shape[1]))] = acc
    C = np.tril(C) + np.tril(C, -1).T + np.eye(k)
    Cbar = np.random.RandomState(9).standard_normal((k, k))
    S = Cbar + Cbar.T
    d_inv = np.zeros(D)
    Fbars = []
    for a in range(len(F)):
        ma = ms[a]
        Y = np.zeros((ks[a], ks[a]))
        for d in range(D):
            for p0 in range(0, ma, bm):
                plast = min(p0 + bm, ma) - 1
                for q0 in range(0, ks[a], bm):
                    if q0 > d * ma + plast:
                        continue
                    rows = slice(d * ma + p0, d * ma + plast + 1)
                    cols = slice(q0, min(q0 + bm, ks[a]))
                    for g in range(len(F)):
                        r = slice(offs[g], offs[g] + min(ks[g],
                                                         (d + 1) * ms[g]))
                        Y[rows, cols] += Ts[a][d, p0:plast + 1, r] @ S[
                            r, offs[a] + cols.start:offs[a] + cols.stop]
        Y = np.tril(Y)
        d_inv += 0.5 * (F[a] * Y).reshape(D, ma, -1).sum(axis=(1, 2))
        Fbars.append(np.repeat(inv, ma)[:, None] * Y)
    return C, Ts, d_inv, Fbars, torch.as_tensor(Cbar)


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("case", ["1d", "2d", "two_groups"])
def test_tile_plan_emulation_equals_dense(case, bm):
    """Only the tiles and d-ranges the plan and the kernels visit add up
    to the dense C, T and backward, to 1e-14 relative: what the kernels
    skip is zero. Real grams (banded in 1-D, block-banded in 2-D, cross
    grams of two groups) at grids larger than a tile."""
    rng = np.random.RandomState(11)
    if case == "1d":
        Xs = [rng.uniform(0, 1, (n, 1)) for n in (300, 250, 200)]
        spec = T.LMCKernelSpec.create(D=3, lmc_kernels=[T.RBF()],
                                      lmc_ranks=[1]).with_input_dim(1)
        m = [146]
    elif case == "2d":
        Xs = [rng.uniform(0, 1, (n, 2)) for n in (300, 260)]
        spec = T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()],
                                      lmc_ranks=[1]).with_input_dim(2)
        m = [9, 10]
    else:
        Xs = [rng.uniform(0, 1, (n, 3)) for n in (200, 180)]
        spec = T.LMCKernelSpec.create(
            D=2, lmc_kernels=[T.RBF(active_dims=(0, 1))], lmc_ranks=[1],
            indep_gp=[T.RBF(name="b", active_dims=(2,))]).with_input_dim(3)
        m = [7, 8, 90]
    gds, _ = tgrid.make_grids(spec, Xs, m=m)
    gt = tuple(gd.to(torch.float64, "cpu") for gd in gds)
    nest = tgrid.gram_nest(gt)
    D = len(Xs)
    inv_eps, Fs = _seeded_inputs([gd.interp.ncols for gd in gt], D, seed=12,
                                 grad=False)
    plan_tiles = sum(int(t.numel()) for row in nest for _, _, t in row)
    dense_tiles = sum(D * -(-g.shape[1] // cap.PLAN_ROWS)
                      * -(-g.shape[2] // cap.PLAN_COLS)
                      for row in nest for g, _, _ in row)
    assert plan_tiles < dense_tiles  # the plan does skip tiles
    C, Ts, d_inv, Fbars, Cbar = _emulate(nest, inv_eps, Fs, bm)
    Cw, Tw = cap.capacitance_plain(nest, inv_eps, Fs)
    d_w, Fbw = cap.capacitance_bwd_plain(nest, inv_eps, Fs, Tw, Cbar)
    for got, want in [(C, Cw), (d_inv, d_w)] + list(zip(Ts, Tw)) + list(
            zip(Fbars, Fbw)):
        want = want.numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-14 * np.abs(want).max())


def test_exact_gradient_p2_matches_jax():
    """The exact objective's gradient on a P=2 (synth-shaped) problem:
    through K2's backward and the K4 pair in the port, XLA's autodiff in
    the JAX package, float64, within 1e-8 relative."""
    rng = np.random.RandomState(21)
    Xs = [rng.uniform(0, 1, (25, 2)) for _ in range(3)]
    y = np.concatenate([np.sin(3 * X[:, 0] + d) * np.cos(2 * X[:, 1])
                        + 0.05 * rng.standard_normal(25)
                        for d, X in enumerate(Xs)])

    def mk(pkg):
        return pkg.LMCKernelSpec.create(
            D=3, slfm_kernels=[pkg.RBF(name="slfm0"),
                               pkg.RBF(name="slfm1")],
            indep_gp=[pkg.RBF(name="rbf%d" % i) for i in range(3)],
        ).with_input_dim(2)

    sj, st = mk(R), mk(T)
    raw = _raw(sj, seed=8)
    lens = [len(X) for X in Xs]
    gj, _ = jgrid.make_grids(sj, Xs, m=[4, 4])
    gt, _ = tgrid.make_grids(st, Xs, m=[4, 4])

    def obj(p):
        return jlk.exact_ski_mll(sj, p, gj, lens, jnp.asarray(y))[0]

    want = jax.grad(obj)(jax.tree.map(jnp.asarray, raw))
    want = np.concatenate([np.asarray(w).ravel()
                           for w in jax.tree_util.tree_leaves(want)])
    pt = from_reference_params(raw, torch.float64, "cpu")
    leaves = [leaf.requires_grad_(True) for _, leaf in _leaves(pt)]
    mll, _ = tlk.exact_ski_mll(st, pt, tuple(gd.to(torch.float64, "cpu")
                                             for gd in gt), lens,
                               torch.as_tensor(y))
    got = np.concatenate([g.numpy().ravel()
                          for g in torch.autograd.grad(mll, leaves)])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-8 * np.abs(want).max())


def test_kinv_diag_through_k9_matches_jax():
    """diag(K^-1) with V = W F formed by K9's gather, against JAX's dense
    W-block product, on the two-group problem."""
    sj, st, Xs, y, m = _problem("two_groups")
    raw = _raw(sj)
    lens = [len(X) for X in Xs]
    gj, _ = jgrid.make_grids(sj, Xs, m=m)
    gt, _ = tgrid.make_grids(st, Xs, m=m)
    pj = jax.tree.map(jnp.asarray, raw)
    Kj = jgrid.build_kski(sj, pj, gj, lens)
    wj = jwb.build_device_woodbury(Kj.groups, sj.noise(pj), Kj.noise_n,
                                   tuple(gd.WtW for gd in gj))
    pt = from_reference_params(raw, torch.float64, "cpu")
    gt = tuple(gd.to(torch.float64, "cpu") for gd in gt)
    Kt = tgrid.build_kski(st, pt, gt, lens)
    wt = twb.build_device_woodbury(Kt.groups, st.noise(pt), Kt.noise_n, gt)
    want = np.asarray(jwb.kinv_diag(wj))
    np.testing.assert_allclose(twb.kinv_diag(wt).numpy(), want, rtol=1e-11)


def test_placed_grids_drop_dense_blocks():
    """The placed artifacts carry no dense W blocks (every W apply is
    K9's); the grams, tile plans and cross grams are placed."""
    sj, st, Xs, y, m = _problem("two_groups")
    gt, _ = tgrid.make_grids(st, Xs, m=m)
    assert all(gd.W_blocks is not None for gd in gt)
    placed = [gd.to(torch.float32, "cpu") for gd in gt]
    assert all(gd.W_blocks is None for gd in placed)
    assert placed[0].WtW.dtype == torch.float32
    assert placed[0].gram_tiles[0].dtype == torch.int32
    assert len(placed[0].cross) == 1 and len(placed[1].cross) == 0
    g_ab = placed[0].cross[0][0].G
    np.testing.assert_allclose(
        g_ab.numpy(), np.stack([wa.T @ wb for wa, wb in
                                zip(gt[0].W_blocks, gt[1].W_blocks)]),
        rtol=1e-6)

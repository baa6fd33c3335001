"""Kernel K1 with K8 fused in: the dense branch of ``build_group_state``
evaluates k(r) on the grid from the group's rows of the kernel table.
Its plain path (what the wrappers run for CPU tensors) against the JAX
package's ``build_group_state`` in float64 — K_UU and the gradient of
<G, K_UU> with respect to the raw parameters — for every kernel kind,
Scaled (trainable and frozen), split active dims, and 1-D and 2-D grids;
and numpy mirrors of the forward kernel's fold and write pass
(csrc/kuu_dense.cu, tests/torch_fwd_mirrors.py) and of the backward
kernel's tile walk and fused second pass
(csrc/kuu_dense_bwd.cu, tests/torch_bwd_mirrors.py: the derivative
formulas of common.cuh ``kern_grads``) against the plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu_torch.hopper import kuu
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.utils.carry import (
    _leaves,
    cast_params,
    from_reference_params,
)
from runlmc_tpu_torch.ops.bttb import bttb_index_map
from tests import torch_bwd_mirrors as mirrors
from tests import torch_fwd_mirrors as fwd_mirrors

# the same products and sums, in another order: float64 rounding
RTOL = 1e-12


def _spec(pkg, case):
    """Every kind (RBF, Matern32, StdPeriodic, Identity, Scaled with a
    trainable and a frozen scale) over D=3 outputs: on one 1-D input
    ('1d'), on two input dims together ('2d', one 2-D grid), or split
    over the two dims ('split': a group per dim and one for both)."""
    if case == "split":
        dims = [(0,), (1,), None, (0,), (1,), (0, 1)]
    else:
        dims = [None] * 6
    kern = [
        pkg.RBF(name="r", active_dims=dims[0]),
        pkg.Matern32(name="m", active_dims=dims[1]),
        pkg.StdPeriodic(name="p", period=0.7, active_dims=dims[2]),
        pkg.IdentityKern(active_dims=dims[3]),
        pkg.Scaled(inner=pkg.RBF(name="s", active_dims=dims[4]), scale=1.5),
        pkg.Scaled(inner=pkg.Matern32(name="f", active_dims=dims[5]),
                   trainable_scale=False, scale=0.7),
    ]
    return pkg.LMCKernelSpec.create(
        D=3, lmc_kernels=kern[:2], lmc_ranks=[1, 2], slfm_kernels=kern[2:3],
        indep_gp=kern[3:], indep_gp_index=[0, 1, 2],
    ).with_input_dim(1 if case == "1d" else 2)


M = {"1d": [14], "2d": [5, 6], "split": [9, 7]}


def _problem(case, seed=3):
    rng = np.random.RandomState(seed)
    P = 1 if case == "1d" else 2
    Xs = [rng.uniform(0, 1, (n, P)) for n in (25, 20, 22)]
    sj, st = _spec(R, case), _spec(T, case)
    raw = jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)),
        sj.init_raw_params(seed=seed),
    )
    gj, _ = jgrid.make_grids(sj, Xs, m=M[case], mode="dense")
    gt, _ = tgrid.make_grids(st, Xs, m=M[case], mode="dense")
    return sj, st, raw, gj, gt


def _cotangents(grids, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((g.interp.ncols, g.interp.ncols))
            for g in grids]


@pytest.mark.parametrize("case", ["1d", "2d", "split"])
def test_value_and_raw_gradient_match_jax(case):
    sj, st, raw, gj, gt = _problem(case)
    if case == "split":
        assert len(gt) == 3
        assert sorted(len(g.plan.sizes) for g in gt) == [1, 1, 2]
    Gs = _cotangents(gj)

    def kuus_j(p):
        return [jgrid.build_group_state(
            sj, p, g.plan, jnp.asarray(g.dists), None,
            jnp.asarray(g.idx_map)).KUU_dense for g in gj]

    def loss_j(p):
        return sum(jnp.sum(jnp.asarray(G) * k)
                   for G, k in zip(Gs, kuus_j(p)))

    pj = jax.tree.map(jnp.asarray, raw)
    want_k = kuus_j(pj)
    want_g = jax.tree_util.tree_leaves(jax.grad(loss_j)(pj))

    pt = from_reference_params(raw, torch.float64, "cpu")
    leaves = [leaf.requires_grad_(True) for _, leaf in _leaves(pt)]
    kt = [tgrid.build_group_state(st, pt, g.to(torch.float64, "cpu"))
          .KUU_dense for g in gt]
    for got, want in zip(kt, want_k):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    loss = sum(torch.sum(torch.as_tensor(G) * k) for G, k in zip(Gs, kt))
    got_g = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * max(np.abs(w).max(), 1.0))


def test_dense_branch_does_not_evaluate_kernels_stacked(monkeypatch):
    _, st, raw, _, gt = _problem("split")

    def boom(*args, **kwargs):
        raise AssertionError("the dense branch called eval_kernels_stacked")

    monkeypatch.setattr(T.LMCKernelSpec, "eval_kernels_stacked", boom)
    pt = from_reference_params(raw, torch.float64, "cpu")
    for g in gt:
        assert tgrid.build_group_state(
            st, pt, g.to(torch.float64, "cpu")).KUU_dense is not None


def test_float32_twin_gets_a_float32_table():
    """The float32 preconditioner twin (``to_dense_f32``) builds K_UU from
    a float32 table of the same parameters."""
    _, st, raw, _, gt = _problem("2d")
    placed = tuple(g.to(torch.float64, "cpu") for g in gt)
    p64 = from_reference_params(raw, torch.float64, "cpu")
    p32 = cast_params(p64, torch.float32)
    kinds, prm = st.table_rows(p32, placed[0].plan.kidxs)
    assert prm.dtype == torch.float32
    k32 = tgrid.build_group_state(st, p32, tgrid.to_dense_f32(placed)[0])
    k64 = tgrid.build_group_state(st, p64, placed[0])
    assert k32.KUU_dense.dtype == torch.float32
    want = k64.KUU_dense.numpy()
    np.testing.assert_allclose(k32.KUU_dense.double().numpy(), want,
                               rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _kern_grads_np(kind, r, gamma, period):
    """numpy mirror of common.cuh ``kern_grads``: (k~, dk~/dgamma,
    dk~/dperiod)."""
    z = np.zeros_like(r)
    if kind == 0:
        k = np.exp(-0.5 * r * r * gamma)
        return k, -0.5 * r * r * k, z
    if kind == 1:
        s = r * (np.sqrt(3.0) * gamma)
        e = np.exp(-s)
        return (1 + s) * e, -(np.sqrt(3.0) * r) * s * e, z
    if kind == 2:
        arg = (np.pi / period) * r
        s = np.sin(arg)
        k = np.exp(-0.5 * s * s * gamma)
        return (k, -0.5 * s * s * k,
                gamma * s * np.cos(arg) * (np.pi * r / (period * period)) * k)
    return (r == 0).astype(float), z, z


@pytest.mark.parametrize("sizes", [(300,), (7, 6), (1,), (33,)])
def test_backward_reduction_mirror_matches_autograd(sizes):
    """The backward kernel's fused second pass (derivatives at r = 0
    included: the first offset is 0) mirrored in numpy
    (tests/torch_bwd_mirrors.py): the tile walk's slots summed per offset
    through the plan, the per-CTA sums over offsets, the CTAs' sums in
    order and the warp sums per q give the plain backward's (d prm, d B)
    for a table of every kind."""
    m = int(np.prod(sizes))
    D = 2
    rng = np.random.RandomState(5)
    kinds = (0, 1, 2, 3, 0)
    prm = rng.uniform(0.5, 1.5, (len(kinds), 3))
    axes = [np.linspace(0.0, 0.2 * n, n) for n in sizes]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(m, -1)
    dists = np.linalg.norm(grid - grid[0], axis=-1)
    B = rng.standard_normal((len(kinds), D, D))
    G = rng.standard_normal((D * m, D * m))
    H = mirrors.kuu_offset_sums(mirrors.kuu_tile_walk(G, D, m, sizes), D,
                                m, sizes)
    got = mirrors.kuu_reduce(kinds, prm, dists, B, H)
    want = kuu.kuu_dense_bwd(kinds, torch.as_tensor(prm),
                             torch.as_tensor(dists), torch.as_tensor(B),
                             sizes, torch.as_tensor(G))
    for g, w in zip(got, want):
        w = w.numpy()
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())


def _k1_problem(sizes, D, seed=8):
    """Every kind (RBF, Matern32, StdPeriodic, Identity) on a grid of
    ``sizes``: (kinds, prm, first-row distances, B)."""
    m = int(np.prod(sizes))
    rng = np.random.RandomState(seed)
    kinds = (0, 1, 2, 3)
    prm = rng.uniform(0.5, 1.5, (4, 3))
    axes = [np.linspace(0.0, 0.3 * n, n) for n in sizes]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(m, -1)
    dists = np.linalg.norm(grid - grid[0], axis=-1)
    return kinds, prm, dists, rng.standard_normal((4, D, D))


# D*m = 111, 15, 105 (odd), 38, 126, 290 (2 mod 4, as fx2007's 3094: a
# float32 row starts on 16 bytes every other row), 84, 120 (0 mod 4)
K1_WALKS = [((37,), 3), ((6, 7), 2), ((3, 4, 5), 2), ((5,), 3), ((19,), 2),
            ((7, 5), 3), ((2, 3, 7), 3), ((58,), 5)]


@pytest.mark.parametrize("V", [4, 2])
@pytest.mark.parametrize("sizes,D", K1_WALKS)
def test_forward_tile_walk_mirror_matches_plain(sizes, D, V):
    """The forward kernel mirrored in numpy: the fold, then the write
    pass's CTAs (one, 40 whose ranges of rows start and end inside a
    block and cross blocks, and one wave of a card's), its (row, vector)
    walk with each row's head and tail peeled (V = 4: float32, 2:
    float64), the doubled row of a 1-D grid (and, where that would not
    fit, the 1-D grid read as any other) and the grid coordinates of any
    grid: every element stored once, no read of shared memory the kernel
    did not fill, and the plain version's K_UU."""
    kinds, prm, dists, B = _k1_problem(sizes, D)
    want = kuu.kuu_dense_plain(kinds, torch.as_tensor(prm),
                               torch.as_tensor(dists), torch.as_tensor(B),
                               sizes).numpy()
    c = fwd_mirrors.kuu_fold(kinds, prm, dists, B)
    runs = [(1, None), (40, None), (1056, None)] + (
        [(40, False)] if len(sizes) == 1 else [])
    for ctas, one_d in runs:
        got, count = fwd_mirrors.kuu_write(c, D, sizes, V, ctas, one_d)
        assert np.all(count == 1)
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sizes", [(37,), (6, 7), (3, 4, 5)])
def test_fold_in_q_order_reproduces_the_per_element_sum(sizes, dtype):
    """Folding over q once per (d, e, offset) and copying the folded value
    to each element gives each element's own sum in q order bit for bit
    (K_UU keeps the bits of the kernel that summed per element), and the
    plain version's K_UU within the dtype's rounding."""
    D = 3
    kinds, prm, dists, B = _k1_problem(sizes, D, seed=5)
    prm, dists, B = (a.astype(dtype) for a in (prm, dists, B))
    m = len(dists)
    c = fwd_mirrors.kuu_fold(kinds, prm, dists, B)
    assert c.dtype == dtype
    idx = bttb_index_map(sizes)
    folded = c.reshape(D, D, m)[:, :, idx].transpose(0, 2, 1, 3)
    tops = [prm[q, 2] * fwd_mirrors.kern_eval(k, dists, prm[q, 0],
                                               prm[q, 1])
            for q, k in enumerate(kinds)]
    per_elem = np.zeros((D, m, D, m), dtype=dtype)
    for q in range(len(kinds)):
        per_elem = (B[q][:, None, :, None] * tops[q][idx][None, :, None, :]
                    + per_elem)
    assert np.array_equal(folded, per_elem)
    want = kuu.kuu_dense_plain(kinds, torch.as_tensor(prm),
                               torch.as_tensor(dists), torch.as_tensor(B),
                               sizes).numpy()
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(folded.reshape(D * m, D * m), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_fast_division_matches_integer_division():
    """The write pass's multiply-high division by every divisor a grid
    axis of up to 2^20 points can have, on the numerators a launch can
    give it (up to 2^20) and the range's ends."""
    rng = np.random.RandomState(0)
    n = np.concatenate([np.arange(4096), rng.randint(0, 1 << 20, 4096),
                        [(1 << 20) - 1, (1 << 31) - 1]]).astype(np.int64)
    for d in list(range(1, 600)) + [1023, 1024, 1025, 2504, 4096, 65535,
                                   (1 << 20) - 1, 1 << 20]:
        f = fwd_mirrors.fast_div(d)
        assert np.array_equal(fwd_mirrors.div_by(n, f), n // d), d

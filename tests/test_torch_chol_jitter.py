"""K3, the jittered Cholesky's equilibrate, jitter and de-scale around
``cholesky_ex``, with their backward (``hopper/chol_jitter.py``): the
port's ``chol_jittered`` (the plain K3a/K3b on the CPU) against the JAX
package's at every rung of both jitter ladders, in both equilibration
modes and both dtypes; the hand backward against JAX's gradient and
against finite differences; the flag; the host reads per attempt; numpy
mirrors of the CUDA kernels' tile loops; and, on bench.py's reduced
synth copy, the rung where each float32 factorization lands, against
the JAX package's rule on the same matrices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu_torch as T
from runlmc_tpu.lmc import woodbury as jwb
from runlmc_tpu_torch import datasets as tdata
from runlmc_tpu_torch.hopper import chol_jitter as k3
from runlmc_tpu_torch.lmc import woodbury as twb

KUU_LADDER = (1e-6, 1e-4, 1e-2)
C_LADDER = (0.0, 1e-6, 1e-3, 1e-1)
# the lowest eigenvalue that makes each rung of a ladder the first to
# factor, in both equilibration modes (the diagonal lies near 1.5, so the
# scaled matrix's lowest eigenvalue is 1/2-1 of it, and the unscaled
# jitter 1.5 times the scale). A float32 Cholesky of a 30 x 30 matrix
# needs a margin of a few 1e-6, so C's 1e-6 rung is a float64 case only.
RUNGS = {
    KUU_LADDER: {0: 0.5, 1: -5e-5, 2: -5e-3},
    C_LADDER: {0: 0.5, 1: -5e-7, 2: -5e-4, 3: -5e-2},
}
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64,
                                                      torch.float64)}
# the same rung gives the same factor in both packages to rounding:
# float64 LAPACK in both, float32 LAPACK builds that sum apart (their
# float32 factors differ by ~1e-6 of the largest entry times the
# jittered matrix's condition, up to 1e4 at the last rungs)
FWD_TOL = {"f64": 1e-9, "f32": 2e-3}


def _matrix(eig0, n=30, seed=0):
    """Symmetric: one eigenvalue ``eig0``, the rest in [1, 2]."""
    rng = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.concatenate([[eig0], np.linspace(1.0, 2.0, n - 1)])
    return (U * eig) @ U.T


@pytest.fixture
def reads(monkeypatch):
    """The flags ``chol_jittered`` reads, in order (True: accepted)."""
    seen = []
    real = twb._accepted

    def spy(flag):
        ok = real(flag)
        seen.append(ok)
        return ok

    monkeypatch.setattr(twb, "_accepted", spy)
    return seen


def _cases():
    for ladder, rungs in RUNGS.items():
        for rung in rungs:
            for dt in DTYPES:
                if dt == "f32" and ladder == C_LADDER and rung == 1:
                    continue
                yield ladder, rung, dt


@pytest.mark.parametrize("equilibrate", [True, False])
@pytest.mark.parametrize("ladder,rung,dt", list(_cases()))
def test_factor_and_rung_match_jax(ladder, rung, dt, equilibrate, reads):
    A = _matrix(RUNGS[ladder][rung]).astype(DTYPES[dt][0])
    Lt = twb.chol_jittered(torch.as_tensor(A), scales=ladder,
                           equilibrate=equilibrate)
    last = len(ladder) - 1
    # one host read per attempt but the last; the rung the port landed on
    assert len(reads) == min(rung + 1, last)
    assert reads == [False] * rung + ([True] if rung < last else [])
    Lj = np.asarray(jwb.chol_jittered(jnp.asarray(A), scales=ladder,
                                      equilibrate=equilibrate))
    assert Lt.dtype == DTYPES[dt][1] and Lj.dtype == A.dtype
    assert np.all(np.isfinite(Lj)) and np.all(np.isfinite(Lt.numpy()))
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=0,
                               atol=FWD_TOL[dt] * np.abs(Lj).max())


@pytest.mark.parametrize("equilibrate", [True, False])
@pytest.mark.parametrize("ladder,rung", [(KUU_LADDER, 0), (KUU_LADDER, 1),
                                         (KUU_LADDER, 2), (C_LADDER, 1),
                                         (C_LADDER, 3)])
def test_gradient_matches_jax(ladder, rung, equilibrate):
    """The hand backward of K3a and K3b around torch's Cholesky VJP
    against jax.grad of the reference, float64, by symmetric parts (the
    two Cholesky VJPs symmetrize a symmetric input's cotangent apart),
    at 1e-8 relative as in test_torch_train."""
    A = _matrix(RUNGS[ladder][rung])
    if equilibrate:
        # graded rows and columns, as mid-training capacitance is: D A D
        # equilibrates back to the same scaled matrix and rung
        d = np.exp(np.random.RandomState(5).uniform(-2, 2, 30))
        A = d[:, None] * A * d[None, :]
    w = np.random.RandomState(1).standard_normal(A.shape)

    def f_j(a):
        L = jwb.chol_jittered(a, scales=ladder, equilibrate=equilibrate)
        return jnp.sum(jnp.tril(jnp.asarray(w)) * L)

    want = np.asarray(jax.jit(jax.grad(f_j))(jnp.asarray(A)))
    At = torch.as_tensor(A).requires_grad_(True)
    L = twb.chol_jittered(At, scales=ladder, equilibrate=equilibrate)
    (got,) = torch.autograd.grad(
        torch.sum(torch.tril(torch.as_tensor(w)) * L), At)
    got_s = 0.5 * (got.numpy() + got.numpy().T)
    want_s = 0.5 * (want + want.T)
    assert np.all(np.isfinite(got_s))
    np.testing.assert_allclose(got_s, want_s, rtol=1e-8,
                               atol=1e-8 * np.abs(want_s).max())


@pytest.mark.parametrize("equilibrate", [True, False])
def test_prologue_gradcheck_on_a_nonsymmetric_matrix(equilibrate):
    """K3a's backward (A-bar with the kept scale's own backward folded
    in) against finite differences, on a non-symmetric A with a negative
    diagonal entry: nothing in it assumes A = A^T."""
    rng = np.random.RandomState(2)
    A = rng.standard_normal((9, 9)) + np.diag(rng.uniform(1, 3, 9))
    A[4, 4] = -2.0
    At = torch.as_tensor(A).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a: k3.CholPrologue.apply(a, 1e-3, equilibrate, {}), (At,))


def test_descale_gradcheck():
    rng = np.random.RandomState(3)
    L = torch.as_tensor(np.tril(rng.standard_normal((8, 8))) + 3 * np.eye(8))
    s = torch.as_tensor(rng.uniform(0.5, 2.0, 8))
    info = torch.zeros((), dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda L_, s_: k3.CholDescale.apply(torch.tril(L_), s_, info)[0],
        (L.requires_grad_(True), s.requires_grad_(True)))


@pytest.mark.parametrize("equilibrate", [True, False])
def test_whole_factorization_gradcheck_at_the_second_rung(equilibrate):
    """chol_jittered end to end against finite differences along
    symmetric directions of a graded, indefinite A whose first rung
    fails. The ladder's second scale is large (0.5), so the factored
    matrix is well conditioned and the rung does not move under the
    perturbation: at the model ladders' second rungs a condition of 1e4
    would drown the differences in their own truncation error."""
    d = np.exp(np.linspace(-0.5, 0.5, 10))
    A0 = d[:, None] * _matrix(-0.1, n=10, seed=4) * d[None, :]
    X = torch.as_tensor(A0).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: twb.chol_jittered(0.5 * (x + x.T), scales=(1e-6, 0.5),
                                    equilibrate=equilibrate), (X,))


def test_flag_semantics():
    L = torch.tril(torch.ones(4, 4, dtype=torch.float64)) + torch.eye(4)
    s = torch.full((4,), 2.0, dtype=torch.float64)
    ok = torch.zeros((), dtype=torch.int32)
    O, flag = k3.chol_descale(L, ok, s)
    assert int(flag) == 0 and torch.equal(O, L / 2.0)
    _, flag = k3.chol_descale(L, torch.full((), 3, dtype=torch.int32), s)
    assert int(flag) != 0  # info > 0: cholesky_ex stopped at a pivot
    Ln = L.clone()
    Ln[2, 1] = float("nan")
    O, flag = k3.chol_descale(Ln, ok, s)
    assert int(flag) != 0
    Ln[2, 1] = float("inf")
    O, flag = k3.chol_descale(Ln, ok, None)  # without equilibration
    assert int(flag) != 0 and O is Ln


@pytest.mark.parametrize("equilibrate", [True, False])
def test_host_reads_per_attempt(equilibrate, reads):
    """One read per attempt but the last: the last scale is taken
    unread, even when it fails."""
    twb.chol_jittered(torch.as_tensor(_matrix(0.5)), equilibrate=equilibrate)
    assert reads == [True]
    del reads[:]
    A = _matrix(-0.5)  # no rung of KUU_LADDER factors it
    L = twb.chol_jittered(torch.as_tensor(A), scales=KUU_LADDER,
                          equilibrate=equilibrate)
    assert reads == [False, False]
    assert L.shape == A.shape


# ---- numpy mirrors of csrc/chol_jitter.cu's loops (32 x 32 tiles, 32 x
# 8 threads), run on the storage buffers at a ragged size, against the
# plain versions: they check the kernels' index arithmetic (storage
# orders, the triangle, the partial sums' layout), which only the card
# can run

TILE, ROWS = 32, 8


def _threads():
    for ty in range(ROWS):
        for tx in range(TILE):
            yield ty, tx


def _load_tile(X, xcol, i0, j0, n, lower):
    t = np.zeros((TILE, TILE + 1))
    for ty, tx in _threads():
        for r in range(ty, TILE, ROWS):
            i = i0 + tx if xcol else i0 + r
            j = j0 + r if xcol else j0 + tx
            v = 0.0
            if i < n and j < n and not (lower and j > i):
                v = X[j * n + i] if xcol else X[i * n + j]
            if xcol:
                t[tx, r] = v
            else:
                t[r, tx] = v
    return t


def _mirror_prologue(A, sd, equil, scale):
    n = A.shape[0]
    Ab, M = A.reshape(-1), np.zeros(n * n)
    cd = scale if equil else scale * sd[0]
    nt = -(-n // TILE)
    for bi in range(nt):
        for bj in range(nt):
            i0, j0 = bi * TILE, bj * TILE
            tile = np.zeros((TILE, TILE + 1))
            for ty, tx in _threads():
                j = j0 + tx
                sj = sd[j] if (equil and j < n) else 1.0
                for r in range(ty, TILE, ROWS):
                    i = i0 + r
                    if i < n and j < n:
                        v = Ab[i * n + j]
                        if equil:
                            v = (v * sd[i]) * sj
                        tile[r, tx] = v + (cd if i == j else 0.0)
            for ty, tx in _threads():
                i = i0 + tx
                for c in range(ty, TILE, ROWS):
                    if i < n and j0 + c < n:
                        M[(j0 + c) * n + i] = tile[tx, c]
    return M.reshape(n, n).T  # column-major storage


def _mirror_tile_bwd(X, xcol, Y, ycol, s, ocol, pro, n):
    nt = -(-n // TILE)
    out = np.zeros(n * n)
    rowpart, colpart = np.zeros((nt, n)), np.zeros((nt, n))
    for bi in range(nt):
        for bj in range(nt):
            i0, j0 = bi * TILE, bj * TILE
            xs = _load_tile(X, xcol, i0, j0, n, False)
            ys = (_load_tile(Y, ycol, i0, j0, n, not pro)
                  if pro or j0 <= i0 + TILE - 1 else np.zeros_like(xs))
            for ty, tx in _threads():
                for r in range(ty, TILE, ROWS):
                    i = i0 + tx if ocol else i0 + r
                    j = j0 + r if ocol else j0 + tx
                    if i < n and j < n:
                        x = xs[tx, r] if ocol else xs[r, tx]
                        out[j * n + i if ocol else i * n + j] = (
                            (x * s[j]) * s[i] if pro else x / s[i])
            ys[:, :TILE] = xs[:, :TILE] * ys[:, :TILE]
            for r in range(TILE):
                lane = [ys[r, tx] * (s[j0 + tx] if j0 + tx < n else 0.0)
                        if pro else ys[r, tx] for tx in range(TILE)]
                if i0 + r < n:
                    rowpart[bj, i0 + r] = sum(lane)
            if pro:
                for c in range(TILE):
                    lane = [ys[tx, c] * s[i0 + tx] if i0 + tx < n else 0.0
                            for tx in range(TILE)]
                    if j0 + c < n:
                        colpart[bi, j0 + c] = sum(lane)
    return out, rowpart, colpart


def _storage(M, col):
    return (M.T if col else M).reshape(-1).copy()


def _from_storage(b, col, n):
    M = b.reshape(n, n)
    return M.T if col else M


N_MIRROR = 45  # two tiles a side, the second ragged


def _spd_and_factor(n=N_MIRROR, seed=6):
    rng = np.random.RandomState(seed)
    G = rng.standard_normal((n, n))
    A = G @ G.T / n + np.diag(rng.uniform(0.5, 4.0, n))
    return A, np.linalg.cholesky(A)


@pytest.mark.parametrize("equil", [True, False])
def test_mirror_prologue_matches_plain(equil):
    A, _ = _spd_and_factor()
    A[3, 7] += 0.25  # not symmetric
    At = torch.as_tensor(A)
    sd = k3.chol_scale_plain(At, equil)
    want, _ = k3.chol_prologue_plain(At, 1e-3, equil, sd)
    got = _mirror_prologue(A, sd.numpy(), equil, 1e-3)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-15, atol=0)


@pytest.mark.parametrize("lcol", [0, 1])
def test_mirror_descale_matches_plain(lcol):
    n = N_MIRROR
    _, L = _spd_and_factor()
    s = np.random.RandomState(7).uniform(0.5, 2.0, n)
    Lb = _storage(L, lcol)
    O = np.zeros(n * n)
    bad = False
    for r in range(n):
        for c in range(n):
            i, j = (c, r) if lcol else (r, c)
            v = Lb[r * n + c] if j <= i else 0.0
            bad |= not np.isfinite(v)
            O[r * n + c] = v / s[i]
    want, _ = k3.chol_descale_plain(torch.as_tensor(L), torch.zeros(
        (), dtype=torch.int32), torch.as_tensor(s))
    np.testing.assert_array_equal(_from_storage(O, lcol, n), want.numpy())
    assert not bad


@pytest.mark.parametrize("ocol,lcol", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_mirror_descale_bwd_matches_plain(ocol, lcol):
    n = N_MIRROR
    _, L = _spd_and_factor()
    rng = np.random.RandomState(8)
    s, Ob = rng.uniform(0.5, 2.0, n), rng.standard_normal((n, n))
    out, rowpart, _ = _mirror_tile_bwd(_storage(Ob, ocol), ocol,
                                       _storage(L, lcol), lcol, s, ocol,
                                       False, n)
    sbar = -rowpart.sum(0) / (s * s)  # the reduce kernel, tile by tile
    wl, ws = k3.chol_descale_bwd_plain(torch.as_tensor(L),
                                       torch.as_tensor(s), torch.as_tensor(Ob))
    np.testing.assert_array_equal(_from_storage(out, ocol, n), wl.numpy())
    np.testing.assert_allclose(sbar, ws.numpy(), rtol=1e-13, atol=0)


@pytest.mark.parametrize("mcol", [0, 1])
def test_mirror_prologue_bwd_matches_plain(mcol):
    n = N_MIRROR
    A, _ = _spd_and_factor()
    rng = np.random.RandomState(9)
    A += 0.1 * rng.standard_normal((n, n))  # not symmetric
    A[5, 5] = -A[5, 5]
    Mb, sb_in = rng.standard_normal((n, n)), rng.standard_normal(n)
    s = k3.chol_scale_plain(torch.as_tensor(A), True).numpy()
    out, rowpart, colpart = _mirror_tile_bwd(
        _storage(Mb, mcol), mcol, A.reshape(-1), 0, s, 0, True, n)
    Abar = out.reshape(n, n)
    sbar = sb_in + rowpart.sum(0) + colpart.sum(0)
    a = np.diag(A)
    Abar[np.diag_indices(n)] += np.where(
        np.abs(a) > 1e-30, (-0.5 * sbar * s ** 3) * np.sign(a), 0.0)
    want = k3.chol_prologue_bwd_plain(
        torch.as_tensor(A), torch.as_tensor(s), torch.as_tensor(Mb),
        torch.as_tensor(sb_in), 1e-3, True)
    np.testing.assert_allclose(Abar, want.numpy(), rtol=1e-13,
                               atol=1e-13 * np.abs(want.numpy()).max())


# ---- the reduced synth copy (bench.py's VALIDATE["synth"]: every 30th
# point, m=[8, 8], Dm=720) trained in float32 factors: where each
# factorization lands on its ladder, F (K_UU) and C apart


def test_reduced_synth_float32_rungs_match_jax(monkeypatch):
    """Three float32 exact steps of the reduced synth copy record every
    factorization's matrix and the rung the port landed on; the JAX
    package's chol_jittered on the same matrices lands on the same rung
    (its factor equals the port's factor at that rung, and at no earlier
    one)."""
    xss, yss, _, _ = tdata.synth_synthetic(0)
    spec = T.LMCKernelSpec.create(
        D=5, slfm_kernels=[T.RBF(name="slfm0"), T.RBF(name="slfm1")],
        indep_gp=[T.RBF(name="rbf%d" % i) for i in range(5)])
    m = T.InterpolatedLLGP([x[::30] for x in xss], [y[::30] for y in yss],
                           functional_kernel=spec, m=[8, 8], tolerance=1e-3,
                           objective="exact", device="cpu")
    seen, real = [], twb.chol_jittered

    def spy(A, scales=(1e-6, 1e-4, 1e-2), equilibrate=None):
        L = real(A, scales=scales, equilibrate=equilibrate)
        if A.dtype == torch.float32:
            seen.append((A.detach().numpy().copy(), tuple(scales),
                         L.detach().numpy().copy()))
        return L

    monkeypatch.setattr(twb, "chol_jittered", spy)
    info = m.optimize(optimizer=T.AdaDelta(max_it=3))
    assert info["n_iter"] == 3 and m.exact_precision == "f32"
    kinds = {}
    for A, scales, L in seen:
        kind = "C" if scales[0] == 0.0 else "F"
        Lj = np.asarray(jwb.chol_jittered(jnp.asarray(A), scales=scales))
        rung = None
        for k, c in enumerate(scales):
            Lk = real(torch.as_tensor(A), scales=(c,)).numpy()
            if np.allclose(Lk, Lj, rtol=0, atol=2e-3 * np.abs(Lj).max()):
                rung = k
                break
        port = next(k for k, c in enumerate(scales)
                    if np.array_equal(real(torch.as_tensor(A),
                                           scales=(c,)).numpy(), L))
        assert rung == port
        kinds.setdefault(kind, []).append(port)
    # every K_UU factor needs the second scale (1e-4 of its unit
    # diagonal) in float32, every C factors at the first (no jitter)
    assert set(kinds["F"]) == {1} and set(kinds["C"]) == {0}, kinds

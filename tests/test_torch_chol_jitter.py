"""K3, the jittered Cholesky's equilibrate, jitter and de-scale around
``cholesky_ex``, with their backward (``hopper/chol_jitter.py``): the
port's ``chol_jittered`` (the plain K3a/K3b on the CPU) against the JAX
package's at every rung of both jitter ladders, in both equilibration
modes and both dtypes; the hand backward against JAX's gradient and
against finite differences; the flag; the host reads per attempt; numpy
mirrors of the CUDA kernels' loops (the forward's tiles and lines, the
backward's line, tile and finishing passes); and, on bench.py's reduced
synth copy, the rung where each float32 factorization lands, against
the JAX package's rule on the same matrices."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu_torch as T
from runlmc_tpu.lmc import woodbury as jwb
from runlmc_tpu_torch import datasets as tdata
from runlmc_tpu_torch.hopper import chol_jitter as k3
from runlmc_tpu_torch.hopper import chol_vjp as cv
from runlmc_tpu_torch.hopper import potrf
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


class _OutOfPlaceCholesky(torch.autograd.Function):
    """The earlier attempt's factorization: cholesky_ex into a new factor
    (M stays as it was), with the same hand backward."""

    @staticmethod
    def forward(ctx, M):
        L, info = torch.linalg.cholesky_ex(M)
        ctx.save_for_backward(L)
        ctx.mark_non_differentiable(info)
        return L, info

    @staticmethod
    def backward(ctx, Lbar, _info_bar):
        (L,) = ctx.saved_tensors
        return cv.cholesky_backward(L, Lbar)


@pytest.mark.parametrize("equilibrate", [True, False])
@pytest.mark.parametrize("rung", [0, 1])
def test_in_place_attempt_matches_the_out_of_place_chain(rung, equilibrate,
                                                         monkeypatch,
                                                         reads):
    """Each attempt factors the prologue's M in place (CholeskyEx marks
    it dirty, its backward is unchanged): the factor and the float64
    gradient equal, bit for bit, those of the chain that factors into a
    new matrix, on the rung the ladder lands on."""
    A = _matrix(RUNGS[KUU_LADDER][rung])
    if equilibrate:
        # graded, as in test_gradient_matches_jax: the same rung
        d = np.exp(np.random.RandomState(5).uniform(-2, 2, 30))
        A = d[:, None] * A * d[None, :]
    w = torch.as_tensor(np.random.RandomState(1).standard_normal(A.shape))
    out = []
    for chain in ("in place", "out of place"):
        if chain == "out of place":
            monkeypatch.setattr(twb, "cholesky_ex", _OutOfPlaceCholesky.apply)
        At = torch.as_tensor(A).requires_grad_(True)
        L = twb.chol_jittered(At, scales=KUU_LADDER, equilibrate=equilibrate)
        (g,) = torch.autograd.grad(torch.sum(torch.tril(w) * L), At)
        out.append((L.detach(), g))
    assert reads == [False] * rung + [True] + [False] * rung + [True]
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


@pytest.mark.parametrize("equilibrate", [True, False])
def test_factor_upper_is_zero_and_a_nan_above_leaves_the_flag(equilibrate,
                                                             reads):
    """The factor's strict upper triangle is exactly 0, and a NaN above
    A's diagonal (which potrf never reads) does not set the flag: the
    first rung is taken, with the same factor as without the NaN."""
    A = _matrix(0.5)
    L0 = twb.chol_jittered(torch.as_tensor(A), equilibrate=equilibrate)
    A[2, 25] = np.nan
    L = twb.chol_jittered(torch.as_tensor(A), equilibrate=equilibrate)
    assert reads == [True, True]
    assert torch.equal(L, torch.tril(L)) and torch.equal(L, L0)
    M, _, _ = k3.chol_prologue(torch.as_tensor(A), 1e-6, equilibrate)
    L1, info = potrf.potrf_(M)
    assert L1 is M and torch.equal(torch.triu(L1, 1), torch.zeros_like(L1))
    assert int(k3.chol_descale(L1, info, None)[1]) == 0


@pytest.mark.parametrize("order", ["row", "column"])
def test_potrf_factors_in_place(order):
    """potrf_ on the CPU: LAPACK's factor in M's own storage, bit for bit
    cholesky_ex's; what it cannot take raises."""
    A = torch.as_tensor(_matrix(0.5))
    M = A.clone() if order == "row" else A.mT.contiguous().mT
    ptr = M.data_ptr()
    L, info = potrf.potrf_(M)
    want, info0 = torch.linalg.cholesky_ex(A)
    assert L is M and M.data_ptr() == ptr
    assert torch.equal(L, want) and int(info) == int(info0) == 0
    with pytest.raises(ValueError):
        potrf.potrf_(A[:, :5])
    with pytest.raises(ValueError):
        potrf.potrf_(A.to(torch.int64))


# ---- numpy mirrors of csrc/chol_jitter.cu's loops, run on the storage
# buffers at ragged sizes, against the plain versions: they check the
# kernels' index arithmetic (the triangular work list, storage orders,
# the 16-byte split of each line into a scalar head, a vector body and
# a scalar tail, the triangle, the partial sums' layout), which only the
# card can run. The backward's tiles are 32 x 32 on 32 x 8 threads.

# the forward's constants: K3a's 64 x 64 tiles on 256 threads, K3b's 128
# threads with 4 vectors each; V elements a 16-byte vector (4 for
# float32, 2 for float64)
KT, THREADS_A, THREADS_B, UNROLL_B = 64, 256, 128, 4


def _split(addr, length, V):
    """(head, nv, ns) of a line of ``length`` elements whose first sits
    at element address ``addr`` (Split in the source)."""
    head = min((V - addr % V) % V, length)
    nv = (length - head) // V
    return head, nv, length - nv * V


def _pos(u, head, nv, V):
    return u if u < head else u + nv * V


def _line(addr, length, V, G, k):
    """The positions thread ``k`` of a line's G threads takes, as
    (positions, is_vector): its vector's V positions, or its scalars."""
    head, nv, ns = _split(addr, length, V)
    if k < nv:
        q0 = head + k * V
        assert (addr + q0) % V == 0  # an aligned 16-byte access
        return list(range(q0, q0 + V)), True
    if ns:
        assert G - nv >= 1
    return [_pos(u, head, nv, V)
            for u in range(k - nv, ns, max(G - nv, 1))], False


def _tri_tile(t):
    b = int((math.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while b * (b + 1) // 2 > t:
        b -= 1
    while (b + 1) * (b + 2) // 2 <= t:
        b += 1
    return b, t - b * (b + 1) // 2


def _mirror_prologue(A, sd, equil, scale, V=4, a_off=0, prepass=True):
    """K3a on A's storage (its first element at element address
    ``a_off``) into a fresh column-major M filled with NaN: returns (M,
    writes per entry, loads per entry of A, s_out, the kept sd it
    stores)."""
    n = A.shape[0]
    G = KT // V
    LP = THREADS_A // G
    P = KT // LP
    Ab = A.reshape(-1)
    M = np.full(n * n, np.nan)
    writes = np.zeros(n * n, dtype=int)
    a_loads = np.zeros(n * n, dtype=int)
    s_out, sd_kept = np.full(n, np.nan), np.full(n, np.nan)
    cd = scale if equil else scale * sd[0]
    nt = -(-n // KT)
    nlower = nt * (nt + 1) // 2
    tiles = [_tri_tile(t) for t in range(nlower)]
    tiles += [(b, a + 1) for a, b in (_tri_tile(u)
                                      for u in range(nt * nt - nlower))]
    assert sorted(tiles) == [(i, j) for i in range(nt) for j in range(nt)]
    for t, (bi, bj) in enumerate(tiles):
        i0, j0 = bi * KT, bj * KT
        rows, cols = min(KT, n - i0), min(KT, n - j0)
        if t >= nlower:  # above the diagonal: stores of zeros, no load
            assert bi < bj
            for x in range(THREADS_A):
                k, l0 = x % G, x // G
                for p in range(P):
                    c = l0 + p * LP
                    if c >= cols:
                        continue
                    start = (j0 + c) * n + i0
                    for r in _line(start, rows, V, G, k)[0]:
                        M[start + r] = 0.0
                        writes[start + r] += 1
            continue
        sr, sc = np.zeros(KT), np.zeros(KT)
        if equil:
            for x in range(2 * KT):
                isrow, q = x < KT, x % KT
                i = (i0 if isrow else j0) + q
                if q < (rows if isrow else cols):
                    if prepass:
                        a = abs(Ab[i * (n + 1)])
                        v = float(torch.rsqrt(torch.tensor(
                            max(a, 1e-30), dtype=torch.float64)))
                    else:
                        v = sd[i]
                    (sr if isrow else sc)[q] = v
                    if isrow and bi == bj:
                        s_out[i] = v
                        if prepass:
                            sd_kept[i] = v
        tile = np.full((KT, KT + 1), np.nan)
        loaded = np.zeros((KT, KT), dtype=int)
        for x in range(THREADS_A):
            k, l0 = x % G, x // G
            for p in range(P):
                r = l0 + p * LP
                if r >= rows:
                    continue
                start = (i0 + r) * n + j0
                for c in _line(a_off + start, cols, V, G, k)[0]:
                    tile[r, c] = Ab[start + c]
                    loaded[r, c] += 1
                    a_loads[start + c] += 1
        # each entry of the tile's rows and columns read once, no other
        assert np.all(loaded[:rows, :cols] == 1)
        assert loaded.sum() == rows * cols
        for x in range(THREADS_A):
            k, l0 = x % G, x // G
            for p in range(P):
                c = l0 + p * LP
                if c >= cols:
                    continue
                j = j0 + c
                start = j * n + i0
                for r in _line(start, rows, V, G, k)[0]:
                    v = tile[r, c]
                    if equil:
                        v = (v * sr[r]) * sc[c]
                    v = v + (cd if i0 + r == j else 0.0)
                    M[start + r] = 0.0 if i0 + r < j else v
                    writes[start + r] += 1
    # M's storage is column-major, A's row-major
    return (M.reshape(n, n).T, writes.reshape(n, n).T, a_loads.reshape(n, n),
            s_out, sd_kept)


def _mirror_descale(Lb, s, lcol, n, V=4, with_o=True):
    """K3b on L's storage ``Lb`` (its first element 16-byte aligned, as
    the wrapper requires): (O's storage or None, the flag's bad, writes
    per entry, loads per entry, positions loaded above the diagonal and
    whether each one's vector held a lower entry)."""
    CV = THREADS_B * UNROLL_B
    chunk = THREADS_B * UNROLL_B * V
    chunks = -(-n // chunk)
    O = np.full(n * n, np.nan) if with_o else None
    writes = np.zeros(n * n, dtype=int)
    loads = np.zeros(n * n, dtype=int)
    bad = False
    for c in range(chunks):
        for r in range(n):
            start = r * n
            head, nv, ns = _split(start, n, V)
            lo, hi = (r, n - 1) if lcol else (0, r)
            assert nv <= chunks * CV
            for x in range(THREADS_B):
                for u in range(UNROLL_B):
                    w = c * CV + u * THREADS_B + x
                    if w >= nv:
                        continue
                    q0 = head + w * V
                    assert (start + q0) % V == 0
                    got = q0 + V - 1 >= lo and q0 <= hi
                    for e in range(V):
                        q = q0 + e
                        v = 0.0
                        if got:
                            loads[start + q] += 1
                        if got and lo <= q <= hi:
                            v = Lb[start + q]
                            bad |= not np.isfinite(v)
                            if with_o:
                                v = v / s[q if lcol else r]
                        if with_o:
                            O[start + q] = v
                            writes[start + q] += 1
            if c == 0:
                for x in range(min(THREADS_B, ns)):
                    q = _pos(x, head, nv, V)
                    v = 0.0
                    if lo <= q <= hi:
                        v = Lb[start + q]
                        loads[start + q] += 1
                        bad |= not np.isfinite(v)
                        if with_o:
                            v = v / s[q if lcol else r]
                    if with_o:
                        O[start + q] = v
                        writes[start + q] += 1
    return O, bad, writes, loads


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


def _check_prologue_mirror(A, equil, V, a_off, scale=1e-3):
    """K3a's mirror against the plain version, first attempt and a later
    one (the kept sd read back): M is the plain version's lower triangle
    bit for bit with zeros above, each entry written once; A is read
    once in the lower block triangle and nowhere above it; s and the kept
    sd are the plain version's."""
    n = A.shape[0]
    At = torch.as_tensor(A)
    sd = k3.chol_scale_plain(At, equil)
    want, s_want = k3.chol_prologue_plain(At, scale, equil, sd)
    want = np.tril(want.numpy())
    bi, bj = np.meshgrid(np.arange(n) // KT, np.arange(n) // KT,
                         indexing="ij")
    for prepass in (True, False):
        M, writes, a_loads, s_out, sd_kept = _mirror_prologue(
            A, sd.numpy(), equil, scale, V=V, a_off=a_off, prepass=prepass)
        np.testing.assert_array_equal(M, want)
        assert np.all(writes == 1)
        assert np.all(a_loads[bi >= bj] == 1) and np.all(a_loads[bi < bj] == 0)
        if equil:
            np.testing.assert_array_equal(s_out, s_want.numpy())
            if prepass:
                np.testing.assert_array_equal(sd_kept, sd.numpy())


@pytest.mark.parametrize("equil", [True, False])
def test_mirror_prologue_matches_plain(equil):
    A, _ = _spd_and_factor()
    A[3, 7] += 0.25  # not symmetric
    for V in (4, 2):
        _check_prologue_mirror(A, equil, V, 0)


@pytest.mark.parametrize("equil", [True, False])
@pytest.mark.parametrize("V,a_off", [(4, 0), (4, 1), (4, 3), (2, 1)])
@pytest.mark.parametrize("n", [130, 131, 129])
def test_mirror_prologue_ragged_rows(n, V, a_off, equil):
    """n = 2, 3, 1 mod 4 (three tiles a side, the last ragged): every
    other row, or every row, starts off a 16-byte boundary, and A itself
    may start off one (a view into a larger buffer)."""
    A, _ = _spd_and_factor(n=n, seed=n)
    A[2, n - 3] = np.nan  # above the diagonal tiles: never read
    _check_prologue_mirror(A, equil, V, a_off)


def _check_descale_mirror(L, lcol, V, with_s):
    n = L.shape[0]
    s = np.random.RandomState(7).uniform(0.5, 2.0, n)
    Lb = _storage(L, lcol)
    O, bad, writes, loads = _mirror_descale(Lb, s, lcol, n, V=V,
                                            with_o=with_s)
    want, _ = k3.chol_descale_plain(torch.as_tensor(L), torch.zeros(
        (), dtype=torch.int32), torch.as_tensor(s) if with_s else None)
    lower = np.tril(np.ones((n, n), dtype=bool))
    lower_st = _storage(lower, lcol)
    if with_s:
        np.testing.assert_array_equal(_from_storage(O, lcol, n),
                                      want.numpy())
        assert np.all(writes == 1)  # the zeros above are stores too
    else:
        assert O is None and not writes.any()
    # the lower triangle read once; above it only inside a vector that
    # straddles the diagonal (at most V - 1 a line)
    assert np.all(loads[lower_st] == 1)
    above = (loads > 0) & ~lower_st
    assert np.all(above.reshape(n, n).sum(1) <= V - 1)
    return bad


@pytest.mark.parametrize("lcol", [0, 1])
def test_mirror_descale_matches_plain(lcol):
    _, L = _spd_and_factor()
    for V in (4, 2):
        for with_s in (True, False):
            assert not _check_descale_mirror(L, lcol, V, with_s)


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("V", [4, 2])
@pytest.mark.parametrize("lcol", [0, 1])
@pytest.mark.parametrize("n", [130, 131, 129])
def test_mirror_descale_ragged_rows(n, lcol, V, with_s):
    """The flag: a NaN above the diagonal (even inside a vector that
    straddles it) never sets it; one in the lower triangle does."""
    _, L = _spd_and_factor(n=n, seed=n)
    L = L.copy()
    L[0, 1] = L[5, 6] = L[3, n - 1] = np.nan
    assert not _check_descale_mirror(L, lcol, V, with_s)
    L[n - 1, n - 2] = np.inf
    assert _check_descale_mirror(L, lcol, V, with_s)


# the backward's constants: CTAs of THREADS threads (NW warps); the line
# pass's LINE_ELEMS positions of each line a thread (by V), so panels of
# THREADS LINE_ELEMS positions; the tile pass's strips of RT lines in
# chunks of CT positions, its cross sums in panels of shared memory
# (PANEL_BYTES); the finishing pass's FIN_LANES lanes of partial rows a
# column, FIN_UNROLL loads at a time
THREADS, RT, CT, FIN_LANES, FIN_UNROLL = 256, 16, 128, 32, 8
LINE_ELEMS = {4: 16, 2: 8}
NW = THREADS // 32
PANEL_BYTES = 128 * 1024


def _panel(n, V):
    """The tile pass's panel where there are cross sums."""
    return min(n, PANEL_BYTES // (16 // V))


def _warp_sum(v):
    """warp_sum's xor butterfly over 32 lanes: every lane ends with the
    same value."""
    v = np.asarray(v, dtype=float)
    for off in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ off]
    return v[0]


def _block_sum(lacc):
    """A line sum of a line pass CTA: each warp's butterfly, then the
    warps in order."""
    w = [_warp_sum(lacc[32 * i:32 * (i + 1)]) for i in range(len(lacc) // 32)]
    t = w[0]
    for x in w[1:]:
        t += x
    return t


def _low(pro, lr, l, q):
    """F's entry (line l, position q) lies in the lower triangle."""
    return np.ones_like(q, dtype=bool) if pro else (q <= l if lr else q >= l)


def _line_pass(Gb, Fb, s, n, pro, lr, V, grid, counts, threads=THREADS,
               elems=None):
    """k3_line_bwd_kernel on the storages Gb, Fb (each from a 16-byte
    boundary, as the wrappers make them): every line starts on a
    multiple of W = gcd(n, V) elements, thread t owns the W-element
    accesses p0 + (j threads + t) W of each line in the panel at p0.
    Returns (out's storage, lsum, sbar, part); counts["out"] and
    counts["f"] count stores and F's loads. ``threads`` and ``elems``
    (positions a thread a line) default to the kernel's."""
    cross, line = pro or not lr, pro or lr
    W = math.gcd(n, V)
    J = (elems or LINE_ELEMS[V]) // W
    panel = threads * J * W
    out, lsum = np.full(n * n, np.nan), np.full(n, np.nan)
    sbar, part = np.full(n, np.nan), np.full((grid, n), np.nan)
    t = np.arange(threads)
    for p0 in range(0, n, panel):
        last = p0 + panel >= n
        for b in range(grid):
            cacc = np.zeros((J, W, threads))
            for l in range(b, n, grid):
                off, sl = l * n, s[l]
                lacc = np.zeros(threads)
                for j in range(J):
                    q0 = p0 + (j * threads + t) * W
                    ok = q0 < n  # W divides n: an access is in or out
                    assert np.all((off + q0) % W == 0)
                    got = ok & _low(pro, lr, l, q0 if lr else q0 + W - 1)
                    for e in range(W):
                        q = np.where(ok, q0 + e, 0)
                        counts["f"][(off + q)[got]] += 1
                        g = np.where(ok, Gb[off + q], 0.0)
                        f = np.where(got & _low(pro, lr, l, q),
                                     Fb[off + q], 0.0)
                        pr = g * f
                        if pro:
                            o = (g * s[q]) * sl
                            lacc += np.where(ok, pr * s[q], 0.0)
                            cacc[j, e] += np.where(ok, pr * sl, 0.0)
                        else:  # the reciprocal's product
                            o = g * (1.0 / (sl if lr else s[q]))
                            if lr:
                                lacc += np.where(ok, pr, 0.0)
                            else:
                                cacc[j, e] += np.where(ok, pr, 0.0)
                        out[(off + q)[ok]] = o[ok]
                        counts["out"][(off + q)[ok]] += 1
                if line:
                    tot = _block_sum(lacc)
                    if p0 > 0:
                        tot = lsum[l] + tot
                    if pro or not last:
                        lsum[l] = tot
                    else:
                        sbar[l] = -tot / (sl * sl)
            if cross:
                for j in range(J):
                    for e in range(W):
                        q = p0 + (j * threads + t) * W + e
                        part[b, q[q < n]] = cacc[j, e][q < n]
    return out, lsum, sbar, part


def _tile_pass(Sb, Xb, s, n, pro, lr, grid, panel, counts):
    """k3_tile_bwd_kernel (PRO: S = A, X = M-bar; else S = O-bar, X =
    L): (out's storage, lsum, sbar, part); counts["out"], counts["x"]."""
    cross, line = pro or not lr, pro or lr
    LPW, CPL, XPT = RT // NW, CT // 32, RT * CT // THREADS
    out, lsum = np.full(n * n, np.nan), np.full(n, np.nan)
    sbar, part = np.full(n, np.nan), np.full((grid, n), np.nan)
    nstrips = -(-n // RT)
    warp, lane = np.meshgrid(np.arange(NW), np.arange(32), indexing="ij")
    for p0 in range(0, n, panel):
        pend = min(n, p0 + panel)
        for b in range(grid):
            acc = np.zeros(pend - p0)
            for st in range(b, nstrips, grid):
                l0 = st * RT
                lacc = np.zeros((LPW, NW, 32))
                for q0 in range(p0, pend, CT):
                    xneed = pro or (q0 <= l0 + RT - 1 if lr
                                    else q0 + CT - 1 >= l0)
                    xt = np.zeros((RT, CT))
                    for u in range(XPT):
                        idx = u * THREADS + np.arange(THREADS)
                        q, l = q0 + idx // RT, l0 + idx % RT
                        ok = xneed & (q < pend) & (l < n)
                        counts["x"][(q * n + l)[ok]] += 1
                        xt[idx % RT, idx // RT] = np.where(
                            ok, Xb[np.where(ok, q * n + l, 0)], 0.0)
                    csum = np.zeros((CPL, NW, 32))
                    for c in range(CPL):
                        q = q0 + lane + 32 * c
                        sq = np.where(q < pend, s[np.minimum(q, n - 1)], 1.0)
                        for r in range(LPW):
                            l = l0 + warp + NW * r
                            ok = (l < n) & (q < pend)
                            idx = np.where(ok, l * n + q, 0)
                            xv = xt[warp + NW * r, lane + 32 * c]
                            sv = np.where(ok, Sb[idx], 0.0)
                            sl = np.where(l < n, s[np.minimum(l, n - 1)], 1.0)
                            if pro:
                                o = (xv * sq) * sl
                                pr = xv * sv
                                lacc[r] += np.where(ok, pr * sq, 0.0)
                                csum[c] += np.where(ok, pr * sl, 0.0)
                            else:
                                f = np.where(_low(pro, lr, l, q), xv, 0.0)
                                o = sv / (sl if lr else sq)
                                if lr:
                                    lacc[r] += np.where(ok, sv * f, 0.0)
                                else:
                                    csum[c] += np.where(ok, sv * f, 0.0)
                            out[idx[ok]] = o[ok]
                            counts["out"][idx[ok]] += 1
                    if cross:
                        for c in range(CPL):
                            for tq in range(32):
                                q = q0 + tq + 32 * c
                                if q < pend:
                                    t = csum[c, 0, tq]
                                    for i in range(1, NW):
                                        t += csum[c, i, tq]
                                    acc[q - p0] += t
                if line:
                    for r in range(LPW):
                        for wi in range(NW):
                            l = l0 + wi + NW * r
                            if l >= n:
                                continue
                            tot = _warp_sum(lacc[r, wi])
                            if pro:
                                lsum[l] = tot if p0 == 0 else lsum[l] + tot
                            else:
                                sbar[l] = -tot / (s[l] * s[l])
            if cross:
                part[b, p0:pend] = acc
    return out, lsum, sbar, part


def _finish(part, nparts, n):
    """k3_finish_kernel's cross sums: lane ty sums partial rows ty, ty +
    FIN_LANES, ... in order (FIN_UNROLL loads at a time, zeros past the
    last), then the lanes in order."""
    lanes = []
    for ty in range(FIN_LANES):
        acc = np.zeros(n)
        for b0 in range(ty, nparts, FIN_LANES * FIN_UNROLL):
            for u in range(FIN_UNROLL):
                b = b0 + u * FIN_LANES
                acc += part[b] if b < nparts else 0.0
        lanes.append(acc)
    c = lanes[0]
    for x in lanes[1:]:
        c = c + x
    return c


def _mirror_bwd(pro, G, gcol, F, fcol, s, V, grid, panel=None,
                sbar_in=None, threads=THREADS, elems=None):
    """bwd_pass: the line pass when G and F are stored alike, else the
    tile pass, then the finishing pass where there are cross sums. PRO:
    A-bar (F = A, row-major); else (L-bar, s-bar). Also the stores per
    entry of out and the loads per entry of F (its storage). ``panel``
    sets the tile pass's, ``threads`` and ``elems`` the line pass's."""
    n = G.shape[0]
    lr = pro or not gcol
    cross, same = pro or not lr, gcol == fcol
    Gb, Fb = _storage(G, gcol), _storage(F, fcol)
    counts = {"out": np.zeros(n * n, dtype=int),
              "f": np.zeros(n * n, dtype=int)}
    if not cross:  # one panel: s-bar's line sums close in it
        panel = n
    elif panel is None:
        panel = _panel(n, V)
    grid = min(grid, n if same else -(-n // RT))
    if same:
        out, lsum, sbar, part = _line_pass(Gb, Fb, s, n, pro, lr, V, grid,
                                           counts, threads, elems)
    else:
        counts["x"] = counts["f"] if not pro else np.zeros(n * n, dtype=int)
        out, lsum, sbar, part = _tile_pass(Fb if pro else Gb,
                                           Gb if pro else Fb, s, n, pro, lr,
                                           grid, panel, counts)
    ocol = 0 if pro else gcol
    if cross:
        c = _finish(part, grid, n)
        if pro:
            sb = ((sbar_in if sbar_in is not None else 0.0) + lsum) + c
            a = np.diag(F)
            out[np.arange(n) * (n + 1)] += np.where(
                np.abs(a) > 1e-30, (-0.5 * sb * (s * s * s)) * np.sign(a),
                0.0)
        else:
            sbar = -c / (s * s)
    o = _from_storage(out, ocol, n)
    return (o if pro else (o, sbar)), counts


def _descale_bwd_case(n, seed):
    _, L = _spd_and_factor(n=n, seed=seed)
    rng = np.random.RandomState(seed + 1)
    return L, rng.uniform(0.5, 2.0, n), rng.standard_normal((n, n))


@pytest.mark.parametrize("n", [129, 130, 131, 132])
@pytest.mark.parametrize("ocol,lcol", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_mirror_descale_bwd_matches_plain(ocol, lcol, n):
    """n = 1, 2, 3, 0 mod 4 (rows off a 16-byte boundary), every storage
    order: L-bar the plain version's to an ulp (the line pass multiplies
    by 1 / s, the tile pass divides), each entry stored once; s-bar to rounding (the line sums in
    lines, the cross sums through the CTAs' partials); L's lower
    triangle read once, above it only inside a vector that straddles the
    diagonal (the line pass) or a chunk that meets it (the tile
    pass)."""
    L, s, Ob = _descale_bwd_case(n, n)
    wl, ws = k3.chol_descale_bwd_plain(torch.as_tensor(L), torch.as_tensor(s),
                                       torch.as_tensor(Ob))
    lower = np.tril(np.ones((n, n), dtype=bool))
    for V in (4, 2):
        (Lb, sb), counts = _mirror_bwd(False, Ob, ocol, L, lcol, s, V,
                                       grid=2 * 132)
        np.testing.assert_allclose(Lb, wl.numpy(), rtol=1e-15, atol=0)
        np.testing.assert_allclose(sb, ws.numpy(), rtol=1e-13, atol=0)
        assert np.all(counts["out"] == 1)
        loads = _from_storage(counts["f"], lcol, n)
        assert np.all(loads[lower] == 1) and np.all(loads[~lower] <= 1)
        if ocol == lcol:  # straddling vectors only
            assert np.all((loads & ~lower).sum(1 if lcol == 0 else 0)
                          <= V - 1)


@pytest.mark.parametrize("n", [129, 130, 131, 132])
@pytest.mark.parametrize("mcol", [0, 1])
def test_mirror_prologue_bwd_matches_plain(mcol, n):
    """Both storage orders of M-bar (the line pass, the tile pass) at n =
    1, 2, 3, 0 mod 4, with and without the epilogue's s-bar: A-bar to
    rounding, each entry stored once."""
    A, _ = _spd_and_factor(n=n, seed=n + 2)
    rng = np.random.RandomState(n)
    A += 0.1 * rng.standard_normal((n, n))  # not symmetric
    A[5, 5] = -A[5, 5]
    Mb, sb_in = rng.standard_normal((n, n)), rng.standard_normal(n)
    s = k3.chol_scale_plain(torch.as_tensor(A), True).numpy()
    for V in (4, 2):
        for sb in (None, sb_in):
            want = k3.chol_prologue_bwd_plain(
                torch.as_tensor(A), torch.as_tensor(s), torch.as_tensor(Mb),
                None if sb is None else torch.as_tensor(sb), 1e-3,
                True).numpy()
            Ab, counts = _mirror_bwd(True, Mb, mcol, A, 0, s, V,
                                     grid=2 * 132, sbar_in=sb)
            np.testing.assert_allclose(Ab, want, rtol=1e-13,
                                       atol=1e-13 * np.abs(want).max())
            assert np.all(counts["out"] == 1)


@pytest.mark.parametrize("kind", ["prologue", "epilogue rows",
                                  "epilogue columns"])
@pytest.mark.parametrize("same", [True, False])
def test_mirror_backward_grid_and_panels(kind, same):
    """Any grid (one CTA, a few, more than the lines) and panels split
    the sums alike: the result agrees with the plain version to rounding
    and is the same whatever the panel, for one grid."""
    n = 131
    pro = kind == "prologue"
    if pro:
        A, _ = _spd_and_factor(n=n, seed=3)
        A[2, 9] += 0.5
        rng = np.random.RandomState(4)
        G, F = rng.standard_normal((n, n)), A
        s = k3.chol_scale_plain(torch.as_tensor(A), True).numpy()
        gcol, fcol = (0, 0) if same else (1, 0)
        want = k3.chol_prologue_bwd_plain(
            torch.as_tensor(A), torch.as_tensor(s), torch.as_tensor(G), None,
            1e-3, True).numpy()
    else:
        F, s, G = _descale_bwd_case(n, 5)
        gcol = 1 if kind == "epilogue columns" else 0
        fcol = gcol if same else 1 - gcol
        want = np.concatenate([t.numpy().ravel() for t in
                               k3.chol_descale_bwd_plain(
                                   torch.as_tensor(F), torch.as_tensor(s),
                                   torch.as_tensor(G))])
    for grid in (1, 3, 7, 300):
        got = []
        # panels: the tile pass's, or the line pass's with 32-thread
        # CTAs and fewer positions a thread (64 positions a panel)
        for panel, elems in ((None, None), (40, 2), (128, 4)):
            r, counts = _mirror_bwd(pro, G, gcol, F, fcol, s, 2, grid,
                                    panel=panel,
                                    threads=THREADS if elems is None else 32,
                                    elems=elems)
            assert np.all(counts["out"] == 1)
            got.append(r if pro else np.concatenate([x.ravel() for x in r]))
            np.testing.assert_allclose(got[-1], want, rtol=1e-13,
                                       atol=1e-13 * np.abs(want).max())
        if not pro and gcol == 0 and not same:
            # the tile pass's line sums: panels change nothing
            assert all(np.array_equal(got[0], x) for x in got[1:])


@pytest.mark.parametrize("V", [4, 2])
@pytest.mark.parametrize("n", [129, 130, 131, 132, 3094, 4205, 10016])
def test_line_pass_accesses_are_aligned_and_cover_each_line_once(n, V):
    """The line pass's accesses at every site's n: W = gcd(n, V) elements
    each, on a multiple of W from every line's start (so a 16-byte base
    keeps them aligned: 16, 8 or one element's bytes), the same
    positions of every line for a thread, and each position of a line
    in exactly one access of one thread."""
    W = math.gcd(n, V)
    J = LINE_ELEMS[V] // W
    panel = THREADS * J * W
    cover = np.zeros(n, dtype=int)
    for p0 in range(0, n, panel):
        for j in range(J):
            q0 = p0 + (j * THREADS + np.arange(THREADS)) * W
            q0 = q0[q0 < n]
            assert np.all(q0 % W == 0) and np.all(q0 + W <= n)
            for e in range(W):
                cover[q0 + e] += 1
    assert np.all(cover == 1)
    lines = np.arange(n, dtype=np.int64) * n
    assert np.all(lines % W == 0)  # every line starts on a multiple of W
    assert W * (16 // V) in (16, 8, 16 // V)


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

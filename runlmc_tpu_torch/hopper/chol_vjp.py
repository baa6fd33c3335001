"""K3's VJP: the backward of the Cholesky factorization, as XLA's
autodiff of ``jnp.linalg.cholesky`` computes it in
runlmc_tpu/lmc/woodbury.py:121 (``chol_jittered``, the exact
objective's factors F of K_UU and L_C of C). For A = L L^T and a
cotangent L-bar of L's lower triangle,

    A-bar = 1/2 (X + X^T),  X = L^-T S L^-1,  S = 1/2 (P + P^T),
    P = Phi(L^T L-bar),

Phi keeping the lower triangle with its diagonal halved (the JAX
package's JVP), the outer symmetrization that of ``jnp.linalg.cholesky``,
which symmetrizes its input.

    chol_vjp(L, Lbar)          -> S       the tri kernel (csrc/chol_vjp.cu)
    chol_vjp_solve(L, S)       -> A-bar   the solve kernels: both
                                           substitutions, exactly symmetric
    cholesky_backward(L, Lbar) -> A-bar   chol_vjp_solve(L, chol_vjp(L, Lbar))
    cholesky_ex(M)             -> (L, info)  cuSOLVER's potrf in place
                                           on M, with this backward

``chol_vjp`` forms P's lower triangle, n^3 / 3 operations against the
full GEMM's 2 n^3, with Phi and the symmetrization in its epilogue, from
the (a-tile, b-tile) pairs of :func:`tri_work`. ``chol_vjp_solve`` forms
Y = L^-T S and then, in float32, only the lower block triangle of X =
L^-T Y^T (X is symmetric), 4 n^3 / 3 operations against two triangular
solves' 2 n^3, and writes each entry with its mirror; in float64 all of
X (2 n^3) and A-bar = 1/2 (X + X^T), the plain version's rounding of
X's two triangles (at a nearly singular factor the mirrored triangle
alone strays from it by 1e-8 of a gradient entry). Both in the order of
:func:`solve_work`. L and L-bar come row-major or column-major (cuSOLVER leaves L
column-major). Its plain version is two triangular solves through
``torch.linalg.solve_triangular`` (cuBLAS's on the card) and the
symmetrization. :class:`CholeskyEx` is the factorization as an autograd
function: forward cuSOLVER's ``potrf`` in place on its input
(``hopper/potrf.py``, a library call by design), backward
:func:`cholesky_backward`; ``info`` carries no gradient. The wrappers
launch their kernels for CUDA tensors and run the plain PyTorch versions
beside them for CPU tensors; each counts one launch per call.
"""

import ctypes

import numpy as np
import torch

from runlmc_tpu_torch.hopper import build
from runlmc_tpu_torch.hopper.potrf import potrf_

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the kernels' tile edge: S's output tiles, L's blocks, Y's tiles
TILE = 64


def _square(what, *ts):
    n = ts[0].shape[-1]
    for t in ts:
        if t.dim() != 2 or tuple(t.shape) != (n, n):
            raise ValueError("%s: expected (%d, %d) matrices, got %s"
                             % (what, n, n, tuple(t.shape)))
        if t.dtype != ts[0].dtype or t.device != ts[0].device:
            raise ValueError("%s: matrices differ in dtype or device" % what)
    return build.suffix(what, ts[0].dtype)


def _order(X):
    """(X or a row-major copy, 1 if X is stored column-major else 0)."""
    if X.is_contiguous():
        return X, 0
    if X.mT.is_contiguous():
        return X, 1
    return X.contiguous(), 0


def chol_vjp_plain(L, Lbar):
    """S = 1/2 (P + P^T), P = Phi(L^T L-bar), from the lower triangles."""
    P = torch.tril(torch.tril(L).mT @ torch.tril(Lbar))
    P.diagonal().mul_(0.5)
    return 0.5 * (P + P.mT)


def tri_work(n):
    """The tri kernel's work list: (pairs, 2) int32 rows (a-tile, b-tile),
    a-tile >= b-tile, of S's TILE x TILE lower tiles, deepest inner range
    (n - TILE a-tile rows) first, then by b-tile."""
    nb = -(-n // TILE)
    pairs = [(ta, tb) for ta in range(nb) for tb in range(ta + 1)]
    pairs.sort(key=lambda p: (-(n - TILE * p[0]), p[1]))
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


def solve_work(n, full=False):
    """The solve kernel's work list, in ticket order: (items, 3) int32
    rows (stage, I, c) over the TILE-row blocks. Stage 0 forms Y's block
    (I, c) (Y = L^-T S), I descending, every column tile c; stage 1
    forms X's block (I, K) (X = L^-T Y^T), I descending, K descending,
    K <= I unless ``full`` (float64: every K). Every item reads only
    items before it: (0, I, c) the blocks (0, J, c), J > I; (1, I, K)
    the block (0, K, I) and the blocks (1, J, K), J > I, and with
    ``full`` and I < K also (1, K, I)."""
    nb = -(-n // TILE)
    items = [(0, i, c) for i in range(nb - 1, -1, -1) for c in range(nb)]
    items += [(1, i, k) for i in range(nb - 1, -1, -1)
              for k in range(nb - 1 if full else i, -1, -1)]
    return np.asarray(items, dtype=np.int32).reshape(-1, 3)


def chol_vjp(L, Lbar, route=0):
    """S (n, n), row-major, from the factor ``L`` and the cotangent
    ``Lbar``, each stored row-major or column-major (only their lower
    triangles are read); the CUDA kernel for CUDA tensors. ``route`` 1
    launches the yardstick kernel instead, a thread an entry, whose sums
    run in route 0's float32 order (each entry over k ascending, one
    fused multiply-add a term), so the two agree to the bit in float32."""
    sfx = _square("chol_vjp", L, Lbar)
    if route not in (0, 1):
        raise ValueError("chol_vjp: route 0 or 1, got %r" % (route,))
    if build.use_plain("chol_vjp", L):
        return chol_vjp_plain(L, Lbar)
    L, lcol = _order(L)
    Lbar, gcol = _order(Lbar)
    n = L.shape[0]
    S = torch.empty((n, n), dtype=L.dtype, device=L.device)
    build.require_cuda("chol_vjp", L.mT if lcol else L,
                       Lbar.mT if gcol else Lbar, S)
    work = build.device_work(("tri", n), L.device, lambda: tri_work(n))
    ticket = torch.empty(1, dtype=torch.int32, device=L.device)
    fn = build.function("chol_vjp", "chol_vjp_tri_" + sfx,
                        [_P, _I32, _P, _I32, _P, _I64, _P, _I32, _P, _I32,
                         _P])
    build.check(fn(build.ptr(L), lcol, build.ptr(Lbar), gcol, build.ptr(S),
                   n, build.ptr(work), work.shape[0], build.ptr(ticket),
                   route, build.stream_ptr()), "chol_vjp")
    chol_vjp.launches[sfx] += 1
    return S


chol_vjp.launches = build.counter()


def chol_vjp_solve_plain(L, S):
    """1/2 (X + X^T), X = L^-T S L^-1 by two triangular solves with L^T
    (cuBLAS's on the card)."""
    Y = torch.linalg.solve_triangular(L.mT, S, upper=True)
    X = torch.linalg.solve_triangular(L, Y, upper=False, left=False)
    return 0.5 * (X + X.mT)


def chol_vjp_solve(L, S):
    """A-bar = L^-T S L^-1 (n, n) for a symmetric ``S``, exactly
    symmetric and row-major, from the factor ``L`` (row-major or
    column-major; its lower triangle is read) and S (read row-major);
    the CUDA kernels for CUDA tensors (one launch counted). Float64 forms
    all of X and symmetrizes it (module docstring)."""
    sfx = _square("chol_vjp_solve", L, S)
    if build.use_plain("chol_vjp_solve", L):
        return chol_vjp_solve_plain(L, S)
    L, lcol = _order(L)
    S = S.contiguous()
    n = L.shape[0]
    nb = -(-n // TILE)
    ntri = nb * (nb + 1) // 2
    full = L.dtype == torch.float64
    dev = L.device
    X = torch.empty((n, n), dtype=L.dtype, device=dev)
    build.require_cuda("chol_vjp_solve", L.mT if lcol else L, S, X)
    # L's packed tiles and X's lower block triangle (float64: all of X),
    # then Y's tiles
    scratch = torch.empty(
        (ntri + (nb * nb if full else ntri) + nb * nb) * TILE * TILE,
        dtype=L.dtype, device=dev)
    flags = torch.empty(2 * nb * nb + 1, dtype=torch.int32, device=dev)
    work = build.device_work(("solve", n, full), dev,
                             lambda: solve_work(n, full))
    fn = build.function("chol_vjp", "chol_vjp_solve_" + sfx,
                        [_P, _I32, _P, _P, _P, _P, _P, _I32, _I64, _P])
    build.check(fn(build.ptr(L), lcol, build.ptr(S), build.ptr(X),
                   build.ptr(scratch), build.ptr(flags), build.ptr(work),
                   work.shape[0], n, build.stream_ptr()), "chol_vjp_solve")
    chol_vjp_solve.launches[sfx] += 1
    return X


chol_vjp_solve.launches = build.counter()


def cholesky_backward(L, Lbar):
    """A-bar (n, n), exactly symmetric (row-major on the card):
    :func:`chol_vjp_solve` of :func:`chol_vjp` (each wrapper runs its
    plain version for CPU tensors)."""
    return chol_vjp_solve(L, chol_vjp(L, Lbar))


class CholeskyEx(torch.autograd.Function):
    """The factorization in place (``hopper/potrf.py`` ``potrf_``) with
    :func:`cholesky_backward` as its backward: the input is marked dirty
    and comes back as L; ``info`` is not differentiable. Whatever made
    the input must not need it for its own backward (K3a's does not)."""

    @staticmethod
    def forward(ctx, M):
        L, info = potrf_(M)
        ctx.mark_dirty(L)
        ctx.save_for_backward(L)
        ctx.mark_non_differentiable(info)
        return L, info

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, Lbar, _info_bar):
        (L,) = ctx.saved_tensors
        return cholesky_backward(L, Lbar)


def cholesky_ex(M):
    """``(L, info)`` of :class:`CholeskyEx`: ``M`` factored in place."""
    return CholeskyEx.apply(M)

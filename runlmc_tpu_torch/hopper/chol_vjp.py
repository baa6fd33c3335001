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

    chol_vjp(L, Lbar)         -> S            the kernel (csrc/chol_vjp.cu)
    chol_vjp_sym(X)           -> A-bar        1/2 (X + X^T), in place
    cholesky_backward(L, Lbar) -> A-bar       S, the two solves, the sym
    cholesky_ex(A)            -> (L, info)    torch.linalg.cholesky_ex
                                               with this backward

``chol_vjp`` forms P's lower triangle, n^3 / 3 operations against the
full GEMM's 2 n^3, with Phi and the symmetrization in its epilogue; L
and L-bar come row-major or column-major (cuSOLVER leaves L
column-major). The two n-column triangular solves between the kernels
are cuBLAS's, through ``torch.linalg.solve_triangular``: at every call
site's shape they measured as fast as K5 (``hopper/trsm.py``) or
faster, up to 2.3x at n = 10016 (``chip_smoke.py`` times both;
``PERF.md``). :class:`CholeskyEx`
is the factorization as an autograd function: forward cuSOLVER's
``potrf`` (``torch.linalg.cholesky_ex``, a library call by design),
backward :func:`cholesky_backward`; ``info`` carries no gradient. The
wrappers launch their kernel for CUDA tensors and run the plain
PyTorch versions beside them for CPU tensors; each counts one launch
per call.
"""

import ctypes

import torch

from runlmc_tpu_torch.hopper import build

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


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


def chol_vjp(L, Lbar):
    """S (n, n), row-major, from the factor ``L`` and the cotangent
    ``Lbar``, each stored row-major or column-major (only their lower
    triangles are read); the CUDA kernel for CUDA tensors."""
    sfx = _square("chol_vjp", L, Lbar)
    if build.use_plain("chol_vjp", L):
        return chol_vjp_plain(L, Lbar)
    L, lcol = _order(L)
    Lbar, gcol = _order(Lbar)
    n = L.shape[0]
    S = torch.empty((n, n), dtype=L.dtype, device=L.device)
    build.require_cuda("chol_vjp", L.mT if lcol else L,
                       Lbar.mT if gcol else Lbar, S)
    fn = build.function("chol_vjp", "chol_vjp_tri_" + sfx,
                        [_P, _I32, _P, _I32, _P, _I64, _P])
    build.check(fn(build.ptr(L), lcol, build.ptr(Lbar), gcol, build.ptr(S),
                   n, build.stream_ptr()), "chol_vjp")
    chol_vjp.launches[sfx] += 1
    return S


chol_vjp.launches = build.counter()


def chol_vjp_sym_plain(X):
    return 0.5 * (X + X.mT)


def chol_vjp_sym(X):
    """1/2 (X + X^T) of an (n, n) ``X``, returned row-major: in place for
    CUDA tensors (the kernel), a new tensor for CPU ones. A column-major
    X is symmetrized through its row-major transpose (the same sum), so
    the solves' column-major result needs no copy."""
    sfx = _square("chol_vjp_sym", X)
    if build.use_plain("chol_vjp_sym", X):
        return chol_vjp_sym_plain(X)
    X, col = _order(X)
    if col:
        X = X.mT
    build.require_cuda("chol_vjp_sym", X)
    fn = build.function("chol_vjp", "chol_vjp_sym_" + sfx, [_P, _I64, _P])
    build.check(fn(build.ptr(X), X.shape[0], build.stream_ptr()),
                "chol_vjp_sym")
    chol_vjp_sym.launches[sfx] += 1
    return X


chol_vjp_sym.launches = build.counter()


def solves(L, S):
    """X = L^-T S L^-1 for a symmetric ``S``, in the column-major order
    cuBLAS leaves it: two triangular solves with L^T."""
    Y = torch.linalg.solve_triangular(L.mT, S, upper=True)
    return torch.linalg.solve_triangular(L, Y, upper=False, left=False)


def cholesky_backward(L, Lbar):
    """A-bar (n, n), exactly symmetric and row-major: :func:`chol_vjp`,
    the two solves, :func:`chol_vjp_sym` in place on their result (each
    wrapper runs its plain version for CPU tensors)."""
    return chol_vjp_sym(solves(L, chol_vjp(L, Lbar)))


class CholeskyEx(torch.autograd.Function):
    """``torch.linalg.cholesky_ex`` (cuSOLVER's potrf on the card) with
    :func:`cholesky_backward` as its backward; ``info`` is not
    differentiable."""

    @staticmethod
    def forward(ctx, A):
        L, info = torch.linalg.cholesky_ex(A)
        ctx.save_for_backward(L)
        ctx.mark_non_differentiable(info)
        return L, info

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, Lbar, _info_bar):
        (L,) = ctx.saved_tensors
        return cholesky_backward(L, Lbar)


def cholesky_ex(A):
    """``(L, info)`` of :class:`CholeskyEx`."""
    return CholeskyEx.apply(A)

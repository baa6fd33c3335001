"""K5: triangular solves with a lower Cholesky factor, and the Cholesky
solve built from two of them, with its own backward.

    trsm_lower(L, B)             X[j] = L^-1 B[j]
    trsm_lower(L, B, trans=True) X[j] = L^-T B[j]
    cho_solve(L, S)              X[j] = (L L^T)^-1 S[j]

The right-hand sides are the ROWS of ``B`` / ``S`` (c, k), the way the
callers hold them. Replaces runlmc_tpu/lmc/woodbury.py:186-195
(``DeviceWoodbury._cho_solve_C``, ``jax.scipy.linalg.cho_solve``) and
:313-337 (``kinv_diag``, ``solve_triangular``), which XLA expands into
blocked matmuls, and the solves of the exact oracle and the dense
'exact' predictions. The CUDA kernel (``csrc/trsm.cu``) runs one launch
per triangle: a CTA per (64-row block, tile of right-hand sides) that
waits on the blocks before it through per-block flags; it takes L in
row-major or column-major storage (cuSOLVER's Cholesky leaves the
latter), so no caller copies a factor. :func:`trsm_lower_plain` is the
plain PyTorch version, which the wrapper runs for CPU tensors.

:class:`ChoSolve` is ``cho_solve`` as an autograd function. In column
notation (right-hand sides as columns), for X = C^-1 S with C = L L^T
and a cotangent G of X,

    S-bar = C^-1 G                      (two more K5 launches)
    L-bar = -(S-bar (X^T L) + X (S-bar^T L)),

torch's ``cholesky_solve`` rule -(S-bar X^T + X S-bar^T) L reordered to
cost O(k^2 c) instead of O(k^3). L-bar is the full (k, k) matrix, as
torch returns it; a Cholesky backward reads its lower triangle. The two
products stay ``torch.matmul``, as JAX computes them outside any kernel.
"""

import ctypes

import torch

from runlmc_tpu_torch.hopper import build

# rows of a block and the narrowest tile of right-hand sides of the
# kernel (csrc/trsm.cu): the wrapper sizes the flag scratch from them
_NB = 64
_CT_MIN = 16


def _check(L, B):
    what = "trsm_lower"
    if L.dim() != 2 or L.shape[0] != L.shape[1]:
        raise ValueError("%s: L must be square (k, k), got %s"
                         % (what, tuple(L.shape)))
    if B.dim() != 2 or B.shape[1] != L.shape[0]:
        raise ValueError("%s: B must be (c, k) with k = %d, got %s"
                         % (what, L.shape[0], tuple(B.shape)))
    if L.dtype != B.dtype:
        raise ValueError("%s: L is %s but B is %s" % (what, L.dtype, B.dtype))
    build.suffix(what, L.dtype)
    if L.device != B.device:
        raise ValueError("%s: L is on %s but B is on %s"
                         % (what, L.device, B.device))
    if not (L.is_contiguous() or L.mT.is_contiguous()):
        raise ValueError("%s: L must be stored row-major or column-major"
                         % what)
    if not B.is_contiguous():
        raise ValueError("%s: B must be contiguous (right-hand sides as "
                         "rows)" % what)
    if torch.is_grad_enabled() and (L.requires_grad or B.requires_grad):
        raise ValueError("%s has no backward: differentiate through "
                         "cho_solve" % what)


def trsm_lower_plain(L, B, trans=False):
    """Plain version: ``torch.linalg.solve_triangular`` on the
    transposed right-hand sides."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, B.mT, upper=True).mT
    return torch.linalg.solve_triangular(L, B.mT, upper=False).mT


def trsm_lower(L, B, trans=False):
    """Each row x of the result solves L x = b (L^T x = b with
    ``trans``) for the matching row b of ``B`` (c, k); ``L`` (k, k) is
    lower triangular (its upper triangle is not used). The CUDA kernel
    for CUDA tensors. k = 0 or c = 0 gives an empty (c, k) result."""
    _check(L, B)
    if build.use_plain("trsm_lower", B):
        return trsm_lower_plain(L, B, trans)
    k, c = L.shape[0], B.shape[0]
    X = torch.empty_like(B)
    if k == 0 or c == 0:
        return X
    build.require_cuda("trsm_lower", B)
    lcol = 0 if L.is_contiguous() else 1
    nflags = -(-k // _NB) * -(-c // _CT_MIN) + 1
    flags = torch.empty(nflags, dtype=torch.int32, device=B.device)
    sfx = build.suffix("trsm_lower", B.dtype)
    fn = build.function(
        "trsm", "k5_trsm_" + sfx,
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    build.check(fn(build.ptr(L), build.ptr(B), build.ptr(X),
                   build.ptr(flags), k, c, int(bool(trans)), lcol,
                   build.stream_ptr()), "trsm_lower")
    trsm_lower.launches[sfx] += 1
    return X


trsm_lower.launches = build.counter()


def _cho_solve(L, S):
    return trsm_lower(L, trsm_lower(L, S), trans=True)


class ChoSolve(torch.autograd.Function):
    """(L L^T)^-1 applied to each row of S, with the hand-written
    backward of the module docstring; forward and S-bar are K5 launches
    on the card and the plain version on the CPU."""

    @staticmethod
    def forward(ctx, L, S):
        X = _cho_solve(L, S)
        ctx.save_for_backward(L, X)
        return X

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, G):
        L, X = ctx.saved_tensors
        Sbar = _cho_solve(L, G.contiguous())
        Lbar = None
        if ctx.needs_input_grad[0]:
            Lbar = Sbar.mT @ (X @ L)
            Lbar.addmm_(X.mT, Sbar @ L).neg_()
        return Lbar, (Sbar if ctx.needs_input_grad[1] else None)


def cho_solve(L, S):
    """(L L^T)^-1 s for each row s of ``S`` (c, k): two :func:`trsm_lower`
    launches, differentiable in ``L`` and ``S`` (:class:`ChoSolve`)."""
    return ChoSolve.apply(L, S)

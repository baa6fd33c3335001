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
per triangle in 64-row blocks. For c <= 16 right-hand sides (training,
the oracle, the stochastic preconditioner) one chain CTA per right-hand
side walks every block and keeps the solved block in shared memory,
while helper CTAs stream L's row bands once for all of them and publish
each block's lagged sum over the blocks solved more than
:data:`LOOKAHEAD` steps before it; for wider c a CTA per (block, tile of
right-hand sides) waits on the blocks before it through per-block
flags. Both sum the same terms in the same order (each coupling tile's
terms apart, in the order the solve produced them), so they agree to
the bit. L is taken in row-major or column-major storage (cuSOLVER's
Cholesky leaves the latter), so no caller copies a factor.
:func:`trsm_lower_plain` is the plain PyTorch version, which the wrapper
runs for CPU tensors; :func:`trsm_lower_schedule` follows the kernel's
block order and its split between the helpers and the chain, for the
tests.
"""

import ctypes

import torch

from runlmc_tpu_torch.hopper import build

# rows of a block, the narrowest tile of right-hand sides of the
# per-block kernel and the widest c the chain takes (csrc/trsm.cu): the
# wrapper sizes the flag and partial-sum scratch from them
_NB = 64
_CT_MIN = 16
_NARROW = 16
# the coupling tiles the chain takes away itself (kLookahead)
LOOKAHEAD = 2


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


def schedule_plan(nblocks, trans=False, lookahead=LOOKAHEAD):
    """The kernel's order: for each step s, ``(block, helper_blocks,
    chain_blocks)``: the row block solved at step s (descending for
    ``trans``), the blocks whose coupling tiles a helper sums (steps
    before s - lookahead) and those the chain takes away itself, each in
    the order they are taken."""
    def at(s):
        return nblocks - 1 - s if trans else s

    return [(at(s), [at(j) for j in range(max(0, s - lookahead))],
             [at(j) for j in range(max(0, s - lookahead), s)])
            for s in range(nblocks)]


def trsm_lower_schedule(L, B, trans=False, lookahead=LOOKAHEAD):
    """Plain PyTorch in the kernel's order (:func:`schedule_plan`): block
    i's sum starts from B_i and takes away each coupling tile's 64 terms,
    summed apart (a product here), the helpers' tiles first; the diagonal
    block is then solved by substitution with reciprocal pivots. For the
    tests and the card's checks; the wrapper's CPU path is
    :func:`trsm_lower_plain`."""
    k = L.shape[0]
    X = torch.zeros_like(B)

    def rows(b):
        return slice(b * _NB, min(k, (b + 1) * _NB))

    def coupling(bi, bj):  # maps X_bj into block bi
        return L[rows(bj), rows(bi)].mT if trans else L[rows(bi), rows(bj)]

    for bi, helper_blocks, chain_blocks in schedule_plan(
            -(-k // _NB), trans, lookahead):
        acc = B[:, rows(bi)].clone()
        for bj in helper_blocks + chain_blocks:
            acc = acc - X[:, rows(bj)] @ coupling(bi, bj).mT
        D = L[rows(bi), rows(bi)]
        inv = 1.0 / torch.diagonal(D)
        nr = D.shape[0]
        for r in (range(nr - 1, -1, -1) if trans else range(nr)):
            x = acc[:, r] * inv[r]
            acc[:, r] = x
            if trans:
                acc[:, :r] -= x[:, None] * D[r, :r][None, :]
            else:
                acc[:, r + 1:] -= x[:, None] * D[r + 1:, r][None, :]
        X[:, rows(bi)] = acc
    return X


def _launch(L, B, trans, route):
    """One K5 launch (route 0: the chains for c <= 16, the per-block
    kernel past it; route 1: the per-block kernel at any c, the chains'
    yardstick on the card)."""
    k, c = L.shape[0], B.shape[0]
    X = torch.empty_like(B)
    if k == 0 or c == 0:
        return X
    build.require_cuda("trsm_lower", B)
    lcol = 0 if L.is_contiguous() else 1
    nblocks = -(-k // _NB)
    flags = torch.empty(max(nblocks * -(-c // _CT_MIN) + 1, nblocks + c),
                        dtype=torch.int32, device=B.device)
    P = torch.empty(nblocks * _NB * _NARROW if c <= _NARROW else 1,
                    dtype=B.dtype, device=B.device)
    sfx = build.suffix("trsm_lower", B.dtype)
    fn = build.function(
        "trsm", "k5_trsm_" + sfx,
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    build.check(fn(build.ptr(L), build.ptr(B), build.ptr(X), build.ptr(P),
                   build.ptr(flags), k, c, int(bool(trans)), lcol, route,
                   build.stream_ptr()), "trsm_lower")
    return X


def trsm_lower(L, B, trans=False):
    """Each row x of the result solves L x = b (L^T x = b with
    ``trans``) for the matching row b of ``B`` (c, k); ``L`` (k, k) is
    lower triangular (its upper triangle is not used). The CUDA kernel
    for CUDA tensors. k = 0 or c = 0 gives an empty (c, k) result."""
    _check(L, B)
    if build.use_plain("trsm_lower", B):
        return trsm_lower_plain(L, B, trans)
    X = _launch(L, B, trans, 0)
    if X.numel():
        trsm_lower.launches[build.suffix("trsm_lower", B.dtype)] += 1
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

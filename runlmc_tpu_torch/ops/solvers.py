"""Batched conjugate gradients with true-residual refinement cycles
(parity: runlmc_tpu/ops/solvers.py:34-298, 322-343).

An *inner* CG cycle (at most ``cycle`` iterations) runs on the current
residual; an *outer* refinement loop recomputes the TRUE residual
r = b - A x, restarts the cycle on it and keeps the best iterate. With
``inner_matvec``/``inner_dtype`` the inner cycles run in a lower
precision on the scaled, downcast residual (mixed-precision iterative
refinement) while the outer loop certifies at b's dtype.

One solver call handles a whole batch of right-hand sides; per-row
convergence is a mask. Each iteration is the operator, then kernel K6's
first pass, the preconditioner, and K6's second pass
(runlmc_tpu_torch/hopper/cg.py). The loops run on the host: the inner
loop reads one flag per iteration to stop once every row is done,
which changes nothing but the cost, since an iteration with no active
row updates nothing.
"""

from typing import Callable, NamedTuple, Optional

import torch

from runlmc_tpu_torch.hopper.cg import cg_update_p, cg_update_xr


class SolveResult(NamedTuple):
    x: torch.Tensor  # (B, n) solutions
    iterations: torch.Tensor  # (B,) Krylov iterations used
    error: torch.Tensor  # (B,) final true residual ||b - A x||
    converged: torch.Tensor  # (B,) bool: error < tol


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _cg_cycle(matvec, b, tol, max_inner, M=None):
    """One (preconditioned) CG cycle from zero, batched (parity:
    solvers.py:145-202). ``tol`` is a one-element tensor of b's dtype.
    Returns (x, iters)."""
    B, n = b.shape
    M = M if M is not None else (lambda v: v)
    x = torch.zeros_like(b)
    # K6 updates x, r and p in place: none may alias b
    r = b.clone()
    p = M(b).clone(memory_format=torch.contiguous_format)
    rz = torch.sum(b * p, dim=-1)
    active = (_norm(b) >= tol).to(torch.int32)
    iters = torch.zeros(B, dtype=torch.int32, device=b.device)
    for _ in range(int(max_inner)):
        if not bool(active.any()):
            break
        Ap = matvec(p).contiguous()
        pAp, rnorm = cg_update_xr(p, Ap, x, r, rz, active)
        z = M(r).contiguous()
        cg_update_p(r, z, p, rz, active, iters, pAp, rnorm, tol)
    return x, iters


def _refined_solve(cycle_fn, matvec, b, tol, maxiter, cycle, stall_ratio,
                   inner_matvec=None, inner_dtype=None):
    """Outer refinement loop (parity: solvers.py:210-298)."""
    b = torch.atleast_2d(b)
    B, n = b.shape
    if maxiter is None:
        maxiter = n

    x = torch.zeros_like(b)
    r = b
    rnorm = _norm(b)
    total = torch.zeros(B, dtype=torch.int32, device=b.device)
    active = rnorm >= tol
    tol_t = torch.full((1,), tol, dtype=b.dtype, device=b.device)

    while bool(active.any()):
        budget = maxiter - int(torch.max(torch.where(active, total, 0)))
        max_inner = min(cycle, max(budget, 1))
        rhs = torch.where(active[:, None], r, 0.0)
        if inner_matvec is not None:
            # scale the residual block to O(1) before downcasting so
            # tiny late-refinement residuals survive the cast
            scale = torch.max(torch.abs(rhs))
            safe_scale = torch.where(scale > 0, scale, 1.0)
            rhs_lo = (rhs / safe_scale).to(inner_dtype)
            # stop inner rows near the inner dtype's floor
            inner_tol = (1e-7 * torch.max(_norm(rhs_lo))).reshape(1)
            dx_lo, iters = cycle_fn(inner_matvec, rhs_lo, inner_tol,
                                    max_inner)
            dx = dx_lo.to(b.dtype) * safe_scale
        else:
            dx, iters = cycle_fn(matvec, rhs, tol_t, max_inner)
        x_new = x + dx
        r_new = b - matvec(x_new)
        rn_new = _norm(r_new)

        better = rn_new < rnorm
        x = torch.where(better[:, None], x_new, x)
        r = torch.where(better[:, None], r_new, r)
        rn_keep = torch.where(better, rn_new, rnorm)

        total = total + iters
        # stop rows that converged, stalled (the cycle failed to cut the
        # residual by stall_ratio: the fp accuracy floor), or ran out of
        # iteration budget
        progressing = rn_new < stall_ratio * rnorm
        active = (
            active & (rn_keep >= tol) & progressing & (total < maxiter)
        )
        rnorm = rn_keep
    return SolveResult(x=x, iterations=total, error=rnorm,
                       converged=rnorm < tol)


def batched_cg(
    matvec: Callable,
    b: torch.Tensor,
    tol: float = 1e-4,
    maxiter: Optional[int] = None,
    precond: Optional[Callable] = None,
    cycle: int = 100,
    stall_ratio: float = 0.99,
    inner_matvec: Optional[Callable] = None,
    inner_dtype=None,
) -> SolveResult:
    """Conjugate gradients for SPD A, batched over the rows of ``b``
    (B, n); ``matvec`` maps (B, n) -> (B, n); optional SPD
    preconditioner ``precond``. ``tol`` is an absolute residual 2-norm
    per row."""

    def cycle_fn(mv, rhs, tol_, max_inner):
        return _cg_cycle(mv, rhs, tol_, max_inner, M=precond)

    return _refined_solve(
        cycle_fn, matvec, b, tol, maxiter, cycle, stall_ratio,
        inner_matvec=inner_matvec, inner_dtype=inner_dtype,
    )

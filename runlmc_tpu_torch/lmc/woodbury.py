"""Direct Woodbury factorization of the dense-grid SKI covariance
(parity: runlmc_tpu/lmc/woodbury.py:60-412).

With the grid kernel materialized (grid.py), write

    K = sum_g W_g K_UU_g W_g^T + diag(eps)  =  V V^T + D,
    V = [ W_g F_g ]_g,   F_g = chol(K_UU_g + delta_g I)  (Dm_g x Dm_g),

and Woodbury gives a closed-form inverse and determinant:

    K^-1 = D^-1 - D^-1 V C^-1 V^T D^-1,   C = I + V^T D^-1 V,
    log det K = log det C + sum_i log D_ii.

The capacitance C is K2, the hand kernel of ``hopper/capacitance.py``
(with its own backward), on the grams and tile plans that
``grid.make_grids`` made once per grid; every W and W^T apply (K4) is
K9's gather or scatter through the group's interpolant
(``hopper/interp.py``, differentiable); the products with F stay
``torch.matmul`` and the factorizations ``torch.linalg.cholesky_ex``
(cuBLAS / cuSOLVER on the card), as the JAX package leaves them to XLA;
the triangular solves with C's factor are K5 (``hopper/trsm.py``:
``cho_solve`` with its own backward, ``trsm_lower``). Everything here is
differentiable by torch autograd, which the exact training objective
(likelihood.exact_ski_mll) runs through. The float32 factor
preconditions the prediction solves (:func:`woodbury_pcg`); the
model-dtype factor is the escalation rung.
"""

from typing import NamedTuple, Tuple

import torch

from runlmc_tpu_torch.hopper.capacitance import capacitance_matrix
from runlmc_tpu_torch.hopper.trsm import cho_solve, trsm_lower
from runlmc_tpu_torch.lmc.grid import gram_nest
from runlmc_tpu_torch.ops.solvers import batched_cg

# Default of chol_jittered's Jacobi equilibration (parity:
# woodbury.py:57). ``equilibrate=None`` anywhere below means this value;
# the model flips it only as a rescue rung.
EQUILIBRATE_DEFAULT = True


def chol_jittered(A, scales=(1e-6, 1e-4, 1e-2), equilibrate=None):
    """Cholesky of ``A + delta * diag-scale`` with escalating jitter and
    Jacobi equilibration (parity: woodbury.py:60-124).

    ``equilibrate=True`` factorizes S A S (S = diag(A)^-1/2) and returns
    the de-scaled factor S^-1 chol(S A S); the jitter is then relative to
    the unit diagonal. Otherwise the jitter is relative to
    |mean(diag(A))|. ``None`` means ``EQUILIBRATE_DEFAULT``.

    Scale selection: the first scale whose factorization succeeds —
    ``cholesky_ex`` reports ``info == 0`` and the factor is finite — and
    otherwise the last scale. (The JAX package keeps the first scale
    whose factor is finite; XLA's Cholesky returns NaNs where LAPACK and
    cuSOLVER report ``info > 0``.) Reading ``info`` costs one host sync
    per tried scale.

    Differentiable: the returned factor is the one Cholesky at the
    chosen scale; failed attempts are dropped, so none of them sends a
    cotangent (the JAX package's rule, woodbury.py:78-87). The scale
    ``s`` and the jitter's reference ``d`` stay in the graph, as there."""
    if equilibrate is None:
        equilibrate = EQUILIBRATE_DEFAULT
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    if equilibrate:
        d0 = torch.diagonal(A)
        s = torch.rsqrt(torch.clamp(torch.abs(d0), min=1e-30))
        A = A * s[:, None] * s[None, :]
        d = torch.ones((), dtype=A.dtype, device=A.device)
    else:
        s = None
        d = torch.abs(torch.mean(torch.diagonal(A)))
    for i, scale in enumerate(scales):
        L, info = torch.linalg.cholesky_ex(A + (scale * d) * eye)
        last = i == len(scales) - 1
        if last or (int(info) == 0 and bool(torch.isfinite(L).all())):
            break
    if equilibrate:
        L = L / s[:, None]
    return L


class DeviceWoodbury(NamedTuple):
    """The factorized SKI covariance."""

    Fs: Tuple  # per-group (Dm_g, Dm_g) lower Cholesky of K_UU_g
    L_C: torch.Tensor  # (k, k) lower Cholesky of C, k = sum_g Dm_g
    noise_n: torch.Tensor  # (n,) per-data-point noise
    interps: Tuple  # per-group interpolant W_g (n, Dm_g), applied by K9
    logdet: torch.Tensor  # scalar: log det of the factorized K

    @property
    def dtype(self):
        return self.L_C.dtype

    def _vt(self, x):
        """V^T x: (..., n) -> (..., k)."""
        parts = [W.rmatvec(x) @ f for W, f in zip(self.interps, self.Fs)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, -1)

    def _v(self, t):
        """V t: (..., k) -> (..., n)."""
        out, off = 0.0, 0
        for W, f in zip(self.interps, self.Fs):
            kg = f.shape[1]
            out = out + W.matvec(t[..., off:off + kg] @ f.T)
            off += kg
        return out

    def _cho_solve_C(self, s):
        """C^-1 s for s (..., k): K5 on the rows of ``s``."""
        flat = s.reshape(-1, s.shape[-1]).contiguous()
        return cho_solve(self.L_C, flat).reshape(s.shape)

    def solve(self, rhs):
        """K^-1 rhs for rhs (..., n): closed form, no iteration."""
        r = rhs / self.noise_n
        t = self._cho_solve_C(self._vt(r))
        return r - self._v(t) / self.noise_n

    def matvec(self, x):
        """K x (the factorized operator, for residual checks)."""
        return self._v(self._vt(x)) + self.noise_n * x


def build_device_woodbury(
    groups, noise_eps, noise_n, grids, jitter=(1e-6, 1e-4, 1e-2, 1e-1),
    c_jitter=(0.0, 1e-6, 1e-3, 1e-1), equilibrate=None,
):
    """Factor the SKI covariance (parity: woodbury.py:208-310).

    :param groups: dense-mode ``GroupState`` tuple (grid.py).
    :param noise_eps: (D,) constrained per-output noise.
    :param noise_n: (n,) per-data-point noise.
    :param grids: the placed dense-mode ``GridData`` the groups were
        built from: their grams ``WtW``, tile plans and cross grams
        (:func:`grid.gram_nest`) feed K2.
    :param jitter: escalating relative jitter scales for the K_UU
        Cholesky factors; ``c_jitter`` the same for C.
    :param equilibrate: Jacobi equilibration of both factorizations
        (:func:`chol_jittered`); ``None`` means ``EQUILIBRATE_DEFAULT``.
        The model flips it when a float32 factorization breaches and the
        flipped one certifies (parity: woodbury.py:232-246).
    """
    dtype = noise_n.dtype
    Fs = tuple(chol_jittered(g.KUU_dense, scales=jitter,
                             equilibrate=equilibrate) for g in groups)
    inv_eps = (1.0 / noise_eps).to(dtype)
    # C = I + sum_d eps_d^-1 F_{a,d}^T G_{ab,d} F_{b,d} over the blocks
    # (a, b), C_ba = C_ab^T: kernel K2 (woodbury.py:260-298's diag_block
    # and cross_block)
    C = capacitance_matrix(gram_nest(grids), inv_eps, Fs)
    L_C = chol_jittered(C, scales=c_jitter, equilibrate=equilibrate)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L_C))) + torch.sum(
        torch.log(noise_n)
    )
    return DeviceWoodbury(
        Fs=Fs, L_C=L_C, noise_n=noise_n,
        interps=tuple(g.interp for g in groups), logdet=logdet,
    )


def kinv_diag(wb: DeviceWoodbury):
    """diag(K^-1) from the factorization (parity: woodbury.py:313-337):
    [K^-1]_ii = 1/d_i - ||L_C^-1 V_i||^2 / d_i^2 with V = [W_g F_g]_g,
    materialized once as an (n, k) matrix (K9's gather of F_g's columns)
    whose rows K5 solves with L_C in one launch."""
    V = torch.cat([W.matvec(F.T) for W, F in zip(wb.interps, wb.Fs)],
                  dim=0).T.contiguous()  # (n, k), rows in data order
    T = trsm_lower(wb.L_C, V)
    s = torch.sum(T * T, dim=1)
    d = wb.noise_n
    return 1.0 / d - s / (d * d)


def loo_zsq(wb: DeviceWoodbury, y):
    """Mean squared leave-one-out standardized residual of the factorized
    GP, mean(alpha_i^2 / [K^-1]_ii) with alpha = K^-1 y (parity:
    woodbury.py:340-360): about 1 for a calibrated fit, >> 1 for an
    overconfident one."""
    alpha = wb.solve(y)
    diag = torch.clamp(kinv_diag(wb), min=torch.finfo(y.dtype).tiny)
    return torch.mean(alpha * alpha / diag)


def woodbury_precond(wb: DeviceWoodbury):
    """An ``M^-1``-apply for :func:`batched_cg` (parity:
    woodbury.py:363-383): scales each residual ROW to O(1), applies the
    factor in its own precision, casts back; rows whose apply comes back
    non-finite fall back to the identity preconditioner."""

    def apply(r):
        scale = torch.amax(torch.abs(r), dim=-1, keepdim=True)
        safe = torch.where(scale > 0, scale, 1.0)
        out = wb.solve((r / safe).to(wb.dtype)).to(r.dtype)
        ok = torch.all(torch.isfinite(out), dim=-1, keepdim=True)
        return torch.where(ok, out * safe, r)

    return apply


def woodbury_pcg(matvec, wb: DeviceWoodbury, b, tol, maxiter=None,
                 cycle=10, inner_matvec=None, stall_ratio=0.99):
    """Solve ``K x = b`` (batched) by CG preconditioned with a direct
    Woodbury factor (parity: woodbury.py:386-412). With ``inner_matvec``
    (the operator at the factor's dtype) and a factor in a lower dtype
    than ``b``, the CG cycles run entirely in that precision and only
    the outer true-residual refinement applies ``matvec``."""
    if inner_matvec is not None and b.dtype != wb.dtype:
        return batched_cg(
            matvec, b, tol=tol, maxiter=maxiter,
            precond=woodbury_precond(wb), cycle=cycle,
            inner_matvec=inner_matvec, inner_dtype=wb.dtype,
            stall_ratio=stall_ratio,
        )
    return batched_cg(
        matvec, b, tol=tol, maxiter=maxiter, precond=woodbury_precond(wb),
        cycle=cycle, stall_ratio=stall_ratio,
    )

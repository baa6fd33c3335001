"""Direct Woodbury factorization of the dense-grid SKI covariance
(parity: runlmc_tpu/lmc/woodbury.py:60-310, 363-412).

With the grid kernel materialized (grid.py), write

    K = sum_g W_g K_UU_g W_g^T + diag(eps)  =  V V^T + D,
    V = [ W_g F_g ]_g,   F_g = chol(K_UU_g + delta_g I)  (Dm_g x Dm_g),

and Woodbury gives a closed-form inverse and determinant:

    K^-1 = D^-1 - D^-1 V C^-1 V^T D^-1,   C = I + V^T D^-1 V,
    log det K = log det C + sum_i log D_ii.

The capacitance assembly is plain large matmuls and the factorizations
and triangular solves are ``torch.linalg.cholesky_ex`` and
``torch.cholesky_solve`` (cuBLAS / cuSOLVER on the card), as the JAX
package leaves them to XLA. The float32 factor preconditions the
prediction solves (:func:`woodbury_pcg`); the model-dtype factor is the
escalation rung.
"""

from typing import NamedTuple, Tuple

import torch

from runlmc_tpu_torch.lmc.grid import w_apply, wt_apply
from runlmc_tpu_torch.ops.solvers import batched_cg


def chol_jittered(A, scales=(1e-6, 1e-4, 1e-2), equilibrate=True):
    """Cholesky of ``A + delta * diag-scale`` with escalating jitter and
    Jacobi equilibration (parity: woodbury.py:60-124).

    ``equilibrate=True`` factorizes S A S (S = diag(A)^-1/2) and returns
    the de-scaled factor S^-1 chol(S A S); the jitter is then relative to
    the unit diagonal. Otherwise the jitter is relative to
    |mean(diag(A))|.

    Scale selection: the first scale whose factorization succeeds —
    ``cholesky_ex`` reports ``info == 0`` and the factor is finite — and
    otherwise the last scale. (The JAX package keeps the first scale
    whose factor is finite; XLA's Cholesky returns NaNs where LAPACK and
    cuSOLVER report ``info > 0``.) Reading ``info`` costs one host sync
    per tried scale."""
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
    W_blocks: Tuple  # per-group tuple of per-output (n_d, m_g) blocks
    logdet: torch.Tensor  # scalar: log det of the factorized K

    @property
    def dtype(self):
        return self.L_C.dtype

    def _vt(self, x):
        """V^T x: (..., n) -> (..., k)."""
        parts = [wt_apply(blocks, x) @ f
                 for blocks, f in zip(self.W_blocks, self.Fs)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, -1)

    def _v(self, t):
        """V t: (..., k) -> (..., n)."""
        out, off = 0.0, 0
        for blocks, f in zip(self.W_blocks, self.Fs):
            kg = f.shape[1]
            out = out + w_apply(blocks, t[..., off:off + kg] @ f.T)
            off += kg
        return out

    def _cho_solve_C(self, s):
        """C^-1 s for s (..., k)."""
        flat = s.reshape(-1, s.shape[-1])
        sol = torch.cholesky_solve(flat.T, self.L_C).T
        return sol.reshape(s.shape)

    def solve(self, rhs):
        """K^-1 rhs for rhs (..., n): closed form, no iteration."""
        r = rhs / self.noise_n
        t = self._cho_solve_C(self._vt(r))
        return r - self._v(t) / self.noise_n

    def matvec(self, x):
        """K x (the factorized operator, for residual checks)."""
        return self._v(self._vt(x)) + self.noise_n * x


def build_device_woodbury(
    groups, noise_eps, noise_n, wtw, jitter=(1e-6, 1e-4, 1e-2, 1e-1),
    c_jitter=(0.0, 1e-6, 1e-3, 1e-1),
):
    """Factor the SKI covariance (parity: woodbury.py:208-310).

    :param groups: dense-mode ``GroupState`` tuple (grid.py).
    :param noise_eps: (D,) constrained per-output noise.
    :param noise_n: (n,) per-data-point noise.
    :param wtw: per-group (D, m_g, m_g) stacked per-output grams.
    :param jitter: escalating relative jitter scales for the K_UU
        Cholesky factors; ``c_jitter`` the same for C. Both factors are
        Jacobi-equilibrated, the JAX package's default; its
        flipped-equilibration rescue rung exists for emulated f64 on the
        TPU and is not ported.
    """
    dtype = noise_n.dtype
    Fs = tuple(chol_jittered(g.KUU_dense, scales=jitter) for g in groups)
    inv_eps = (1.0 / noise_eps).to(dtype)

    def diag_block(F, G):
        # C_gg = sum_d eps_d^-1 F[d-rows]^T (W_d^T W_d) F[d-rows]
        D, m = G.shape[0], G.shape[1]
        Fd = F.reshape(D, m, F.shape[1])
        T1 = torch.bmm(G, Fd)
        Fs_scaled = Fd * inv_eps[:, None, None]
        return Fs_scaled.reshape(D * m, -1).T @ T1.reshape(D * m, -1)

    def cross_block(ga, gb, Fa, Fb):
        # C_ab = sum_d eps_d^-1 Fa[d-rows]^T (W_ad^T W_bd) Fb[d-rows]
        ma = groups[ga].W_blocks[0].shape[1]
        mb = groups[gb].W_blocks[0].shape[1]
        out = 0.0
        for d, (wa, wb) in enumerate(
            zip(groups[ga].W_blocks, groups[gb].W_blocks)
        ):
            G_ab = wa.T @ wb
            Fad = Fa[d * ma:(d + 1) * ma]
            Fbd = Fb[d * mb:(d + 1) * mb]
            out = out + inv_eps[d] * (Fad.T @ (G_ab @ Fbd))
        return out

    nblocks = len(groups)
    if nblocks == 1:
        C = diag_block(Fs[0], wtw[0])
    else:
        rows = [[None] * nblocks for _ in range(nblocks)]
        for a in range(nblocks):
            rows[a][a] = diag_block(Fs[a], wtw[a])
            for b in range(a + 1, nblocks):
                rows[a][b] = cross_block(a, b, Fs[a], Fs[b])
        for a in range(nblocks):
            for b in range(a):
                rows[a][b] = rows[b][a].T
        C = torch.cat([torch.cat(r, dim=1) for r in rows], dim=0)
    C = C + torch.eye(C.shape[0], dtype=dtype, device=C.device)
    L_C = chol_jittered(C, scales=c_jitter)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L_C))) + torch.sum(
        torch.log(noise_n)
    )
    return DeviceWoodbury(
        Fs=Fs, L_C=L_C, noise_n=noise_n,
        W_blocks=tuple(g.W_blocks for g in groups), logdet=logdet,
    )


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

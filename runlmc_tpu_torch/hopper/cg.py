"""K6: the fused per-iteration update of masked, batched, preconditioned
conjugate gradients, in two Triton passes.

Replaces the body of ``_cg_cycle`` at runlmc_tpu/ops/solvers.py:175-199,
which XLA runs as a dozen elementwise ops and row reductions over the
(B, n) state. An iteration here is

    Ap = A p                      (the operator; not this module)
    cg_update_xr   pAp = <p, Ap>; alpha = rz / pAp (0 unless pAp > 0);
                   on active rows x += alpha p, r -= alpha Ap;
                   rnorm = ||r||
    z = M r                       (the preconditioner; not this module)
    cg_update_p    rz' = <r, z>; beta = rz' / rz (rz = 0 -> 1);
                   on active rows p = z + beta p, rz = rz';
                   active &= (rnorm >= tol) & (pAp > 0); iters += active

One program owns one right-hand side: it reduces the row, then streams
it again for the update, so the row's dot product never leaves the
chip. ``active`` and ``iters`` are int32 (B,) tensors; ``tol`` is a
one-element tensor, so the inner tolerance of a mixed-precision cycle
is never read back to the host. Bound on the card: bytes — the
first pass reads p, Ap, x, r and writes x, r; the second reads r, z, p
and writes p: about 10 (B, n) arrays per iteration (about 38 MB in f64
at B = 151, n = 3113: 11 us at 3.35 TB/s). The plain versions below
are what the wrappers run for CPU tensors.

The Triton kernels live in ``triton_cg.py``, which is imported only when
the first CUDA launch needs them.
"""

import os

import torch

from runlmc_tpu_torch.hopper import build

_BLOCK = 1024


def cg_update_xr_plain(p, Ap, x, r, rz, active):
    pAp = torch.sum(p * Ap, dim=-1)
    pos = pAp > 0
    alpha = torch.where(pos, rz / torch.where(pos, pAp, 1.0), 0.0)
    r_new = r - alpha[:, None] * Ap
    m = active.bool()[:, None]
    x.copy_(torch.where(m, x + alpha[:, None] * p, x))
    r.copy_(torch.where(m, r_new, r))
    return pAp, torch.sqrt(torch.sum(r_new * r_new, dim=-1))


def cg_update_p_plain(r, z, p, rz, active, iters, pAp, rnorm, tol):
    rz_new = torch.sum(r * z, dim=-1)
    beta = rz_new / torch.where(rz != 0, rz, 1.0)
    act = active.bool()
    p.copy_(torch.where(act[:, None], z + beta[:, None] * p, p))
    rz.copy_(torch.where(act, rz_new, rz))
    still = act & (rnorm >= tol) & (pAp > 0)
    iters += act.to(iters.dtype)
    active.copy_(still.to(active.dtype))


def _kernels():
    # triton exists only where there is a card: import it at first
    # launch, with its compile cache beside the CUDA builds
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(build.BUILD_DIR, "triton"))
    from runlmc_tpu_torch.hopper import triton_cg

    return triton_cg


def _check_state(what, floats, ints):
    dtype = floats[0].dtype
    sfx = build.suffix(what, dtype)
    for t in floats:
        if t.dtype != dtype:
            raise ValueError("%s: mixed float dtypes" % what)
    for t in ints:
        if t.dtype != torch.int32:
            raise ValueError("%s: active/iters must be int32" % what)
    build.require_cuda(what, *floats, *ints)
    return sfx


def cg_update_xr(p, Ap, x, r, rz, active):
    """First pass: updates ``x`` and ``r`` in place on active rows;
    returns ``(pAp, rnorm)``, each (B,)."""
    if build.use_plain("cg_update_xr", p):
        return cg_update_xr_plain(p, Ap, x, r, rz, active)
    B, n = p.shape
    pAp = torch.empty(B, dtype=p.dtype, device=p.device)
    rnorm = torch.empty_like(pAp)
    sfx = _check_state("cg_update_xr", (p, Ap, x, r, rz), (active,))
    if B:
        _kernels().xr_kernel[(B,)](
            p, Ap, x, r, rz, active, pAp, rnorm, n, BLOCK=_BLOCK, num_warps=4
        )
        cg_update_xr.launches[sfx] += 1
    return pAp, rnorm


def cg_update_p(r, z, p, rz, active, iters, pAp, rnorm, tol):
    """Second pass: updates ``p``, ``rz``, ``active`` and ``iters`` in
    place; ``tol`` is a one-element tensor."""
    if build.use_plain("cg_update_p", p):
        return cg_update_p_plain(r, z, p, rz, active, iters, pAp, rnorm, tol)
    B, n = p.shape
    sfx = _check_state("cg_update_p", (r, z, p, rz, pAp, rnorm, tol),
                       (active, iters))
    if B:
        _kernels().p_kernel[(B,)](
            r, z, p, rz, active, iters, pAp, rnorm, tol, n, BLOCK=_BLOCK,
            num_warps=4,
        )
        cg_update_p.launches[sfx] += 1


cg_update_xr.launches = build.counter()
cg_update_p.launches = build.counter()

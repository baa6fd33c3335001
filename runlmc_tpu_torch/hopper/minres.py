"""K12: the fused per-iteration update of masked, batched MINRES
(Paige-Saunders Lanczos with a Givens QR), one Triton kernel.

Replaces the body of ``_minres_cycle`` at runlmc_tpu/ops/solvers.py:96-139,
which XLA runs as some thirty elementwise ops and row reductions over the
(B, n) state. After ``w = A v`` (the operator; not this module) one
program per right-hand side sweeps its row three times:

1. ``w -= beta v_prev`` (kept in ``w``) and ``alpha = <v, w>``;
2. ``beta' = ||w - alpha v||``;
3. the row's Givens scalars (with the ``safe_*`` guards of the JAX
   code), then, on active rows, ``v_prev = v``, ``v = (w - alpha v) /
   beta'``, ``d_prev = d``, ``d = (v - delta2 d - eps d_prev) / gamma``,
   ``x += tau d``; the scalars ``beta, c, s, c_prev, s_prev, phi_bar``
   follow, ``active &= |phi_bar'| >= tol & gamma > 0`` and ``iters +=
   active``.

The row's dot products never leave the chip. ``w`` is scratch: the
kernel overwrites it. ``active`` and ``iters`` are int32 (B,) tensors
and ``tol`` a one-element tensor, so nothing is read back to the host.
Bound on the card: bytes — the update reads w, v, v_prev, d, d_prev and
x and writes x, v, v_prev, d and d_prev, eleven (B, n) arrays per
iteration (22 MB in float64 at B = 16, n = 15789: 6.6 us at 3.35 TB/s);
the kernel moves sixteen, since sweep 1 writes w and sweeps 2 and 3 read
it and v again. :func:`minres_update_plain` is the plain PyTorch
version, which the wrapper runs for CPU tensors.
"""

import os

import torch

from runlmc_tpu_torch.hopper import build

_BLOCK = 1024


def minres_update_plain(w, x, v, v_prev, d, d_prev, beta, c, s, c_prev,
                        s_prev, phi_bar, active, iters, tol):
    w = w - beta[:, None] * v_prev
    alpha = torch.sum(v * w, dim=-1)
    w = w - alpha[:, None] * v
    beta_next = torch.sqrt(torch.sum(w * w, dim=-1))
    safe_bn = torch.where(beta_next > 0, beta_next, 1.0)
    v_next = w / safe_bn[:, None]
    eps = s_prev * beta
    delta = c_prev * beta
    delta2 = c * delta + s * alpha
    gamma_t = -s * delta + c * alpha
    gamma = torch.sqrt(gamma_t**2 + beta_next**2)
    pos = gamma > 0
    safe_gamma = torch.where(pos, gamma, 1.0)
    c_new = torch.where(pos, gamma_t / safe_gamma, 1.0)
    s_new = torch.where(pos, beta_next / safe_gamma, 0.0)
    tau = c_new * phi_bar
    phi_bar_new = -s_new * phi_bar
    d_new = (v - delta2[:, None] * d - eps[:, None] * d_prev) \
        / safe_gamma[:, None]
    act = active.bool()
    m = act[:, None]
    x.copy_(torch.where(m, x + tau[:, None] * d_new, x))
    v_prev.copy_(torch.where(m, v, v_prev))
    v.copy_(torch.where(m, v_next, v))
    d_prev.copy_(torch.where(m, d, d_prev))
    d.copy_(torch.where(m, d_new, d))
    c_prev.copy_(torch.where(act, c, c_prev))
    s_prev.copy_(torch.where(act, s, s_prev))
    beta.copy_(torch.where(act, beta_next, beta))
    c.copy_(torch.where(act, c_new, c))
    s.copy_(torch.where(act, s_new, s))
    phi_bar.copy_(torch.where(act, phi_bar_new, phi_bar))
    still = act & (torch.abs(phi_bar_new) >= tol) & pos
    iters += act.to(iters.dtype)
    active.copy_(still.to(active.dtype))


def _kernels():
    # triton exists only where there is a card: import it at first
    # launch, with its compile cache beside the CUDA builds
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(build.BUILD_DIR, "triton"))
    from runlmc_tpu_torch.hopper import triton_minres

    return triton_minres


def minres_update(w, x, v, v_prev, d, d_prev, beta, c, s, c_prev, s_prev,
                  phi_bar, active, iters, tol):
    """One MINRES iteration after ``w = A v``: updates the state in
    place (``w`` is overwritten); ``tol`` is a one-element tensor."""
    if build.use_plain("minres_update", v):
        return minres_update_plain(w, x, v, v_prev, d, d_prev, beta, c, s,
                                   c_prev, s_prev, phi_bar, active, iters,
                                   tol)
    floats = (w, x, v, v_prev, d, d_prev, beta, c, s, c_prev, s_prev,
              phi_bar, tol)
    dtype = v.dtype
    sfx = build.suffix("minres_update", dtype)
    B, n = v.shape
    for t in floats:
        if t.dtype != dtype:
            raise ValueError("minres_update: mixed float dtypes")
    for t in floats[:6]:
        if t.shape != (B, n):
            raise ValueError("minres_update: vectors must be (B, n)")
    for t in (active, iters):
        if t.dtype != torch.int32:
            raise ValueError("minres_update: active/iters must be int32")
    build.require_cuda("minres_update", *floats, active, iters)
    if B:
        _kernels().minres_kernel[(B,)](
            w, x, v, v_prev, d, d_prev, beta, c, s, c_prev, s_prev,
            phi_bar, active, iters, tol, n, BLOCK=_BLOCK, num_warps=4,
        )
        minres_update.launches[sfx] += 1


minres_update.launches = build.counter()

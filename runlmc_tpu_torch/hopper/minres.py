"""K12: one iteration of masked, batched MINRES (Paige-Saunders Lanczos
with a Givens QR), one CUDA launch an iteration.

Replaces the body of ``_minres_cycle`` at runlmc_tpu/ops/solvers.py:103-142,
which XLA runs as some thirty elementwise ops and row reductions over the
(B, n) state. After ``w = A v`` (the operator; not this module) an
iteration is ``w1 = w - beta v_prev``, ``alpha = <v, w1>``, ``w2 = w1 -
alpha v``, ``beta' = ||w2||`` (K13's step, ``lanczos.py``), the row's
Givens scalars with the ``safe_*`` guards of the JAX code, then, on
active rows, ``v_prev = v``, ``v = w2 / beta'``, ``d_prev = d``, ``d =
(v - delta2 d - eps d_prev) / gamma``, ``x += tau d``; the scalars
``beta, c, s, c_prev, s_prev, phi_bar`` follow, ``active &= |phi_bar'|
>= tol & gamma > 0`` and ``iters += active``.

The kernel (``csrc/minres.cu``) runs on K13's cluster row reduction
(``csrc/lanczos_core.cuh``): a thread-block cluster of
:func:`lanczos.lanczos_cluster` CTAs a row, each a slice
(:func:`lanczos.lanczos_slice`) of the row's 16-byte vectors, which
share their partial sums through distributed shared memory. One pass
over memory: pass 1 loads w, v_prev and v, issues the loads of d, d_prev
and x and stores v_prev = v and d_prev = d; two cluster exchanges give
alpha and beta'; pass 3 writes x, v and d (an inactive row's cluster
exits at once; a slice too long for registers re-reads w, v_prev and v
and writes all five in pass 3). The row's sums take a fixed order, so a
relaunch gives the same bits. Bound on the card: bytes, the eleven (B,
n) arrays read (w, v_prev, v, d, d_prev, x) or written (x, v, v_prev, d,
d_prev) once: 22.2 MB in float64 at the MINRES rung's B = 16, n = 15768,
6.62 us at 3.35 TB/s.

``x, v, v_prev, d, d_prev`` and the scalars are updated in place; ``w``
is only read. ``active`` and ``iters`` are int32 (B,) tensors and ``tol``
a one-element tensor, so nothing is read back to the host.
:func:`minres_update_plain` is the plain PyTorch version, which the
wrapper runs for CPU tensors.
"""

import ctypes

import torch

from runlmc_tpu_torch.hopper import build
from runlmc_tpu_torch.hopper.lanczos import lanczos_cluster, vector_width

_P, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 15 + [_I32] * 4 + [_P]


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


def minres_update(w, x, v, v_prev, d, d_prev, beta, c, s, c_prev, s_prev,
                  phi_bar, active, iters, tol):
    """One MINRES iteration after ``w = A v``: updates the state in
    place (``w`` is only read); ``tol`` is a one-element tensor."""
    if build.use_plain("minres_update", v):
        return minres_update_plain(w, x, v, v_prev, d, d_prev, beta, c, s,
                                   c_prev, s_prev, phi_bar, active, iters,
                                   tol)
    dtype = v.dtype
    sfx = build.suffix("minres_update", dtype)
    B, n = v.shape
    vecs = (w, x, v, v_prev, d, d_prev)
    scal = (beta, c, s, c_prev, s_prev, phi_bar)
    if any(t.dtype != dtype for t in vecs + scal + (tol,)):
        raise ValueError("minres_update: mixed float dtypes")
    if any(t.shape != (B, n) for t in vecs):
        raise ValueError("minres_update: vectors must be (B, n)")
    if (any(t.shape != (B,) for t in scal + (active, iters))
            or tol.numel() != 1):
        raise ValueError("minres_update: scalars, active and iters must be "
                         "(B,), tol one element")
    if active.dtype != torch.int32 or iters.dtype != torch.int32:
        raise ValueError("minres_update: active/iters must be int32")
    # the device by index (a CPU tensor gives -1): a cheaper test than
    # comparing torch.device objects, at every iteration of a solve
    index = v.get_device()
    every = vecs + scal + (active, iters, tol)
    if any(t.get_device() != index for t in every):
        raise ValueError("minres_update: every tensor must be on %s"
                         % v.device)
    if not all(t.is_contiguous() for t in every):
        raise ValueError("minres_update: tensors must be contiguous")
    if B:
        vec = vector_width(dtype)
        ptrs = [t.data_ptr() for t in vecs]
        if n % vec or any(p % 16 for p in ptrs):
            vec = 1
        fn = build.function("minres", "minres_update_" + sfx, _ARGS)
        build.check(fn(*ptrs, *(t.data_ptr() for t in scal),
                       active.data_ptr(), iters.data_ptr(), tol.data_ptr(),
                       B, n, lanczos_cluster(B, n, dtype,
                                             sms=build.sm_count(index)),
                       vec, build.stream_ptr(v.device)), "minres_update")
        minres_update.launches[sfx] += 1


minres_update.launches = build.counter()

"""K13: one step of batched Lanczos (the stochastic Lanczos quadrature
log-determinant's recurrence), three Triton kernels.

Replaces the ``lax.scan`` body of ``lanczos_tridiag`` at
runlmc_tpu/ops/slq.py:41-52, which XLA runs as a dozen elementwise ops
and two row reductions over the (B, n) state. After ``w = K v`` (the
operator; not this module) a step is

    w -= beta v_prev;  alpha = <w, v>
    w -= alpha v;      beta' = ||w||
    alive' = alive & (beta' > eps)
    v' = w / beta' on live rows, 0 after a breakdown
    alpha_out = alpha on live rows, 1 after;  beta_out = beta' or 0

with the JAX package's constants: ``eps`` 1e-8 (float32) or 1e-14
(float64), no reorthogonalization. The two reductions stay sequential:
beta' is the norm of w after the alpha update, never the expansion
||w||^2 - 2 alpha <w, v> + alpha^2 ||v||^2, which cancels exactly where
Lanczos converges and the breakdown test compares beta' with 1e-14.

Design: a row is split over blocks of ``_BLOCK`` elements (B = 15 rows of
n = 15768 give 240 programs on the card's 132 SMs, where one program per
row would give 15), so a reduction needs a pass of its own: kernel 1
updates w and writes the blocks' partial <w, v>, kernel 2 sums them in a
fixed order, updates w and writes the partial ||w||^2, kernel 3 sums
those, applies the breakdown mask and writes v'. Deterministic, no
atomics. Bound on the card: bytes — the step must read K v, v and
v_prev and write v', four (B, n) arrays (7.6 MB in float64 at (15, 15768):
2.3 us at 3.35 TB/s); the three kernels move nine, since w is written
and read back between them.

:func:`lanczos_step_plain` (the JAX body in torch) is what the wrapper
runs for CPU tensors.
"""

import os

import torch

from runlmc_tpu_torch.hopper import build

_BLOCK = 1024


def breakdown_eps(dtype):
    """The breakdown threshold of ops/slq.py:38: 1e-8 in float32, 1e-14
    in float64."""
    return 1e-8 if dtype == torch.float32 else 1e-14


def lanczos_step_plain(w, v_prev, v, beta, alive, eps):
    """One Lanczos step after ``w = K v``; returns ``(v, v_next,
    alpha_out, beta_out, alive_next)`` as new tensors."""
    w = w - beta[:, None] * v_prev
    alpha = torch.sum(w * v, dim=-1)
    w = w - alpha[:, None] * v
    beta_n = torch.sqrt(torch.sum(w * w, dim=-1))
    live = alive.bool()
    live_n = live & (beta_n > eps)
    safe = torch.where(beta_n > 0, beta_n, 1.0)
    v_next = torch.where(live_n[:, None], w / safe[:, None], 0.0)
    alpha_out = torch.where(live, alpha, 1.0)
    beta_out = torch.where(live_n, beta_n, 0.0)
    return v, v_next, alpha_out, beta_out, live_n.to(alive.dtype)


def _kernels():
    # triton exists only where there is a card: import it at first
    # launch, with its compile cache beside the CUDA builds
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(build.BUILD_DIR, "triton"))
    from runlmc_tpu_torch.hopper import triton_lanczos

    return triton_lanczos


def lanczos_step(w, v_prev, v, beta, alive, eps):
    """One Lanczos step after ``w = K v`` on (B, n) rows: returns
    ``(v, v_next, alpha_out, beta_out, alive_next)``. ``beta`` is the
    previous step's ``beta_out``, ``alive`` an int32 (B,) mask and
    ``eps`` a one-element tensor. On the card ``w`` is scratch (the
    kernels overwrite it) and ``v_next`` is written into ``v_prev``'s
    storage, which the step no longer needs."""
    if build.use_plain("lanczos_step", v):
        return lanczos_step_plain(w, v_prev, v, beta, alive, eps)
    dtype = v.dtype
    sfx = build.suffix("lanczos_step", dtype)
    B, n = v.shape
    for t in (w, v_prev, v, beta, eps):
        if t.dtype != dtype:
            raise ValueError("lanczos_step: mixed float dtypes")
    for t in (w, v_prev):
        if t.shape != (B, n):
            raise ValueError("lanczos_step: vectors must be (B, n)")
    if beta.shape != (B,) or alive.shape != (B,) or eps.numel() != 1:
        raise ValueError("lanczos_step: beta/alive must be (B,), eps one "
                         "element")
    if alive.dtype != torch.int32:
        raise ValueError("lanczos_step: alive must be int32")
    build.require_cuda("lanczos_step", w, v_prev, v, beta, alive, eps)
    nblk = max(1, -(-n // _BLOCK))
    nb_pow2 = 1 << (nblk - 1).bit_length()
    apart = torch.empty((B, nblk), dtype=dtype, device=v.device)
    bpart = torch.empty_like(apart)
    alpha_out = torch.empty((B,), dtype=dtype, device=v.device)
    beta_out = torch.empty_like(alpha_out)
    alive_out = torch.empty_like(alive)
    if B:
        k = _kernels()
        grid = (B, nblk)
        k.lanczos_dot_kernel[grid](w, v_prev, v, beta, apart, n, nblk,
                                   BLOCK=_BLOCK, num_warps=4)
        k.lanczos_norm_kernel[grid](w, v, apart, bpart, n, nblk,
                                    BLOCK=_BLOCK, NB=nb_pow2, num_warps=4)
        k.lanczos_next_kernel[grid](w, v_prev, apart, bpart, alive,
                                    alive_out, alpha_out, beta_out, eps, n,
                                    nblk, BLOCK=_BLOCK, NB=nb_pow2,
                                    num_warps=4)
        lanczos_step.launches[sfx] += 1
    return v, v_prev, alpha_out, beta_out, alive_out


lanczos_step.launches = build.counter()

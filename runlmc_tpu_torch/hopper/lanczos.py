"""K13: one step of batched Lanczos (the stochastic Lanczos quadrature
log-determinant's recurrence), one CUDA launch a step.

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

The kernel (``csrc/lanczos.cu``, design and bound there) gives each row
a thread-block cluster of :func:`lanczos_cluster` CTAs, which share
their partial sums through distributed shared memory: one launch, no
scratch, deterministic. :func:`lanczos_slice` mirrors a CTA's part of a
row. :func:`lanczos_step_plain` (the JAX body in torch) is what the
wrapper runs for CPU tensors.
"""

import ctypes
import functools

import torch

from runlmc_tpu_torch.hopper import build

# csrc/lanczos_core.cuh: threads a CTA, the portable cluster limit
THREADS = 256
MAX_CLUSTER = 8
# the multiprocessors that B rows of C CTAs should fill, by default an
# H100's (the wrappers pass their card's: build.sm_count)
SMS = build.H100_SMS

_P, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = ([_P] * 4 + [_I32] + [_P] * 2 + [_I32] + [_P] + [_I32] + [_P] * 2
         + [_I32] * 4 + [_P])


def breakdown_eps(dtype):
    """The breakdown threshold of ops/slq.py:38: 1e-8 in float32, 1e-14
    in float64."""
    return 1e-8 if dtype == torch.float32 else 1e-14


def vector_width(dtype):
    """Elements of a 16-byte vector."""
    return 16 // (8 if dtype == torch.float64 else 4)


@functools.lru_cache(maxsize=None)
def lanczos_cluster(B, n, dtype, sms=SMS):
    """CTAs per row of K13 and K12: enough for B rows to fill the card's
    ``sms`` multiprocessors, at most ``MAX_CLUSTER``, and no more than
    give each CTA one 16-byte vector a thread (a shorter slice wastes a
    cluster barrier)."""
    per_cta = THREADS * vector_width(dtype)
    return max(1, min(MAX_CLUSTER, sms // max(B, 1), -(-n // per_cta)))


def lanczos_slice(n, vec, C, rank):
    """Element range ``[lo, hi)`` of a row that CTA ``rank`` of ``C``
    takes, with loads ``vec`` elements wide (csrc/lanczos_core.cuh
    row_slice)."""
    nvec = n // vec
    return nvec * rank // C * vec, nvec * (rank + 1) // C * vec


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


def lanczos_step(w, v_prev, v, beta, alive, eps, out=None):
    """One Lanczos step after ``w = K v`` on (B, n) rows: returns
    ``(v, v_next, alpha_out, beta_out, alive_next)``. ``beta`` is the
    previous step's ``beta_out`` (a (B,) tensor, strided or not),
    ``alive`` an int32 (B,) mask and ``eps`` a one-element tensor.
    ``out``, if given, is ``(alpha_out, beta_out, alive_out)``: (B,)
    tensors (alpha's and beta's strided or not, such as columns of (B, k)
    tensors; alive_out contiguous and possibly ``alive`` itself)
    that the step writes and returns in place of new ones. On the card
    ``v_next`` is written into ``v_prev``'s storage, which the step no
    longer needs; ``w`` is only read."""
    if build.use_plain("lanczos_step", v):
        res = lanczos_step_plain(w, v_prev, v, beta, alive, eps)
        if out is None:
            return res
        for dst, src in zip(out, res[2:]):
            dst.copy_(src)
        return res[:2] + tuple(out)
    dtype = v.dtype
    sfx = build.suffix("lanczos_step", dtype)
    B, n = v.shape
    if out is None:
        alpha_out = torch.empty((B,), dtype=dtype, device=v.device)
        beta_out = torch.empty_like(alpha_out)
        alive_out = torch.empty_like(alive)
    else:
        alpha_out, beta_out, alive_out = out
    if not (w.dtype == v_prev.dtype == beta.dtype == eps.dtype
            == alpha_out.dtype == beta_out.dtype == dtype):
        raise ValueError("lanczos_step: mixed float dtypes")
    if w.shape != (B, n) or v_prev.shape != (B, n):
        raise ValueError("lanczos_step: vectors must be (B, n)")
    if (beta.shape != (B,) or alive.shape != (B,) or eps.numel() != 1
            or alpha_out.shape != (B,) or beta_out.shape != (B,)
            or alive_out.shape != (B,)):
        raise ValueError("lanczos_step: beta/alive/outputs must be (B,), "
                         "eps one element")
    if alive.dtype != torch.int32 or alive_out.dtype != torch.int32:
        raise ValueError("lanczos_step: alive must be int32")
    # the device by index (a CPU tensor gives -1): a cheaper test than
    # comparing torch.device objects, at tens of steps a log-det
    index = v.get_device()
    if any(t.get_device() != index for t in (w, v_prev, beta, alive, eps,
                                              alpha_out, beta_out,
                                              alive_out)):
        raise ValueError("lanczos_step: every tensor must be on %s"
                         % v.device)
    if not all(t.is_contiguous() for t in (w, v_prev, v, alive, eps,
                                           alive_out)):
        raise ValueError("lanczos_step: vectors, alive and eps must be "
                         "contiguous")
    if B:
        vec = vector_width(dtype)
        ptrs = (w.data_ptr(), v_prev.data_ptr(), v.data_ptr())
        if n % vec or any(p % 16 for p in ptrs):
            vec = 1
        fn = build.function("lanczos", "lanczos_step_" + sfx, _ARGS)
        build.check(fn(ptrs[0], ptrs[1], ptrs[2], beta.data_ptr(),
                       beta.stride()[0], alive.data_ptr(),
                       alpha_out.data_ptr(), alpha_out.stride()[0],
                       beta_out.data_ptr(), beta_out.stride()[0],
                       alive_out.data_ptr(), eps.data_ptr(), B, n,
                       lanczos_cluster(B, n, dtype,
                                       sms=build.sm_count(index)), vec,
                       build.stream_ptr(v.device)), "lanczos_step")
        lanczos_step.launches[sfx] += 1
    return v, v_prev, alpha_out, beta_out, alive_out


lanczos_step.launches = build.counter()

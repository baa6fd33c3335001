"""K7 (+K8): the dense LMC cross-covariance K[a, b] between two point
sets, without noise.

    K[a,b] = sum_q B_q[o_a, o_b] * scale_q * k_q(||x_a - x_b|| over q's dims)

Replaces runlmc_tpu/lmc/likelihood.py:76-96 (``pairwise_dists`` and
``cross_kernel``) together with the elementwise k(r) of
runlmc_tpu/kernels/stationary.py:64-157. Kernels are described by a
table (``LMCKernelSpec.kernel_table``): a kind code, a bitmask of active
input dims and constrained ``[gamma, period, scale]`` per q. The CUDA
kernel (``csrc/cross_kernel.cu``) fuses distance, k(r) and the
coregionalization scale, one thread per output element; it is bound by
its (na, nb) output write. :func:`cross_kernel_plain` evaluates the
same table in plain PyTorch and is what the wrapper runs for CPU
tensors.

K7 backward (``csrc/cross_kernel_bwd.cu``) replaces XLA's autodiff of
the same lines inside ``jax.grad`` of ``exact_mll``: from the cotangent
G (na, nb) it recomputes each element's k~_q(r) and its derivatives in
gamma and period, and reduces them into per-row partial tables over the
column's output; a one-hot product sums the rows of each output into
S0, S1, S2 (Q, D, D), and four small products give the cotangents of
``B`` and ``prm`` (see :func:`cross_kernel_bwd`). Like the JAX package,
it differentiates the parameters only, not the inputs.
:class:`CrossKernel` joins forward and backward as one autograd
function; :func:`cross_kernel_bwd_plain` (autograd of the plain
forward) is what the backward wrapper runs for CPU tensors.
"""

import ctypes

import torch

from runlmc_tpu_torch.hopper import build
from runlmc_tpu_torch.kernels.stationary import eval_kind


def cross_kernel_plain(xa, oa, xb, ob, B, kinds, masks, prm):
    """Plain version: one distance tensor per active-dim mask, one k(r)
    tensor and one gathered coregionalization scale per q."""
    P = xa.shape[1]
    K = torch.zeros((xa.shape[0], xb.shape[0]), dtype=xa.dtype,
                    device=xa.device)
    kinds = [int(k) for k in kinds.tolist()]
    masks = [int(m) for m in masks.tolist()]
    dists = {}
    for q, (kind, mask) in enumerate(zip(kinds, masks)):
        if mask not in dists:
            dims = [p for p in range(P) if (mask >> p) & 1]
            diff = xa[:, None, dims] - xb[None, :, dims]
            d2 = torch.sum(diff * diff, dim=-1)
            dists[mask] = torch.sqrt(torch.clamp(d2, min=0.0))
        k = prm[q, 2] * eval_kind(kind, dists[mask], prm[q, 0], prm[q, 1])
        K = K + B[q][oa][:, ob] * k
    return K


def cross_kernel(xa, oa, xb, ob, B, kinds, masks, prm):
    """K (na, nb) for inputs ``xa`` (na, P) / ``xb`` (nb, P) with output
    indices ``oa`` / ``ob`` (int32), coregionalization ``B`` (Q, D, D)
    and the kernel table ``kinds``, ``masks`` (int32, (Q,)) and ``prm``
    (Q, 3); the CUDA kernel for CUDA tensors."""
    if build.use_plain("cross_kernel", xa):
        return cross_kernel_plain(xa, oa, xb, ob, B, kinds, masks, prm)
    na, P = xa.shape
    nb = xb.shape[0]
    Q, D = B.shape[0], B.shape[1]
    if (xb.shape[1] != P or prm.shape != (Q, 3) or kinds.shape != (Q,)
            or masks.shape != (Q,) or oa.shape != (na,)
            or ob.shape != (nb,)):
        raise ValueError("cross_kernel: inconsistent shapes")
    if P > 31:
        raise ValueError("cross_kernel: at most 31 input dims")
    if not (xa.dtype == xb.dtype == B.dtype == prm.dtype):
        raise ValueError("cross_kernel: mixed float dtypes")
    if not (oa.dtype == ob.dtype == kinds.dtype == masks.dtype
            == torch.int32):
        raise ValueError("cross_kernel: index tensors must be int32")
    xa, oa, xb, ob, B, kinds, masks, prm = (
        t.contiguous() for t in (xa, oa, xb, ob, B, kinds, masks, prm)
    )
    build.require_cuda("cross_kernel", xa, oa, xb, ob, B, kinds, masks, prm)
    out = torch.empty((na, nb), dtype=xa.dtype, device=xa.device)
    sfx = build.suffix("cross_kernel", xa.dtype)
    fn = build.function(
        "cross_kernel", "cross_kernel_" + sfx,
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    if na and nb:
        build.check(fn(
            build.ptr(xa), build.ptr(oa), build.ptr(xb), build.ptr(ob),
            build.ptr(B), build.ptr(kinds), build.ptr(masks),
            build.ptr(prm), build.ptr(out), na, nb, P, Q, D,
            build.stream_ptr(),
        ), "cross_kernel")
        cross_kernel.launches[sfx] += 1
    return out


cross_kernel.launches = build.counter()


# the kernel keeps 3 * _MAX_Q accumulators per lane (kMaxQ in
# csrc/cross_kernel_bwd.cu); more kernels run as several launches
_MAX_Q = 8


def cross_kernel_bwd_plain(xa, oa, xb, ob, B, kinds, masks, prm, G,
                           alpha=None):
    """Plain version of the backward: torch autograd through
    :func:`cross_kernel_plain` (with ``alpha``, of the cotangent
    G - alpha alpha^T); returns ``(d B, d prm)``."""
    if alpha is not None:
        G = G - torch.outer(alpha, alpha)
    with torch.enable_grad():
        b = B.detach().requires_grad_(True)
        p = prm.detach().requires_grad_(True)
        K = cross_kernel_plain(xa, oa, xb, ob, b, kinds, masks, p)
        return torch.autograd.grad(K, (b, p), G)


def cross_kernel_bwd(xa, oa, xb, ob, B, kinds, masks, prm, G, alpha=None):
    """``(d B (Q, D, D), d prm (Q, 3))`` from the cotangent ``G``
    (na, nb) of :func:`cross_kernel`'s output; the CUDA kernel computes
    the per-row partial tables for CUDA tensors. With ``alpha`` (na,)
    (and na = nb) the cotangent is G - alpha alpha^T, formed in the
    kernel's loads."""
    if build.use_plain("cross_kernel_bwd", G):
        return cross_kernel_bwd_plain(xa, oa, xb, ob, B, kinds, masks, prm, G,
                                      alpha)
    na, P = xa.shape
    nb = xb.shape[0]
    Q, D = B.shape[0], B.shape[1]
    if (G.shape != (na, nb) or xb.shape[1] != P or prm.shape != (Q, 3)
            or kinds.shape != (Q,) or masks.shape != (Q,)
            or oa.shape != (na,) or ob.shape != (nb,)):
        raise ValueError("cross_kernel_bwd: inconsistent shapes")
    if P > 31:
        raise ValueError("cross_kernel_bwd: at most 31 input dims")
    if not (G.dtype == xa.dtype == xb.dtype == B.dtype == prm.dtype):
        raise ValueError("cross_kernel_bwd: mixed float dtypes")
    if alpha is not None and (na != nb or alpha.shape != (na,)
                              or alpha.dtype != G.dtype):
        raise ValueError("cross_kernel_bwd: alpha must be (na,) = (nb,) of "
                         "G's dtype")
    if not (oa.dtype == ob.dtype == kinds.dtype == masks.dtype
            == torch.int32):
        raise ValueError("cross_kernel_bwd: index tensors must be int32")
    G, xa, oa, xb, ob, B, kinds, masks, prm = (
        t.contiguous() for t in (G, xa, oa, xb, ob, B, kinds, masks, prm))
    if alpha is not None:
        alpha = alpha.contiguous()
    build.require_cuda("cross_kernel_bwd", G, xa, oa, xb, ob, B, kinds,
                       masks, prm, *([] if alpha is None else [alpha]))
    # the columns in a stable order by output, and each output's segment
    perm = torch.argsort(ob, stable=True).to(torch.int32)
    seg = torch.zeros(D + 1, dtype=torch.int32, device=G.device)
    seg[1:] = torch.cumsum(torch.bincount(ob.long(), minlength=D)[:D], 0)
    part = torch.empty((na, D, Q, 3), dtype=G.dtype, device=G.device)
    sfx = build.suffix("cross_kernel_bwd", G.dtype)
    fn = build.function(
        "cross_kernel_bwd", "cross_kernel_bwd_" + sfx,
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    )
    if na and Q:
        for q0 in range(0, Q, _MAX_Q):
            build.check(fn(
                build.ptr(G), build.ptr(xa), build.ptr(xb), build.ptr(perm),
                build.ptr(seg), build.ptr(kinds), build.ptr(masks),
                build.ptr(prm),
                ctypes.c_void_p(None if alpha is None else alpha.data_ptr()),
                build.ptr(part), na, nb, P, Q, D, q0,
                min(_MAX_Q, Q - q0), build.stream_ptr(),
            ), "cross_kernel_bwd")
            cross_kernel_bwd.launches[sfx] += 1
    else:
        part.zero_()
    onehot = torch.nn.functional.one_hot(oa.long(), D).to(G.dtype)
    S = torch.einsum("ad,aeqk->qkde", onehot, part)  # (Q, 3, D, D)
    scale = prm[:, 2]
    dB = scale[:, None, None] * S[:, 0]
    dscale = torch.sum(B * S[:, 0], dim=(1, 2))
    dgamma = scale * torch.sum(B * S[:, 1], dim=(1, 2))
    dperiod = scale * torch.sum(B * S[:, 2], dim=(1, 2))
    return dB, torch.stack([dgamma, dperiod, dscale], dim=1)


cross_kernel_bwd.launches = build.counter()


class CrossKernel(torch.autograd.Function):
    """K7 with its hand-written backward: forward :func:`cross_kernel`,
    backward :func:`cross_kernel_bwd`; cotangents for ``B`` and ``prm``
    only (the inputs and indices are data)."""

    @staticmethod
    def forward(ctx, xa, oa, xb, ob, B, kinds, masks, prm):
        ctx.save_for_backward(xa, oa, xb, ob, B, kinds, masks, prm)
        return cross_kernel(xa, oa, xb, ob, B, kinds, masks, prm)

    @staticmethod
    def backward(ctx, G):
        xa, oa, xb, ob, B, kinds, masks, prm = ctx.saved_tensors
        dB, dprm = cross_kernel_bwd(xa, oa, xb, ob, B, kinds, masks, prm, G)
        return (None, None, None, None,
                dB if ctx.needs_input_grad[4] else None, None, None,
                dprm if ctx.needs_input_grad[7] else None)

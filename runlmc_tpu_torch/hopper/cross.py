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
"""

import ctypes
import math

import torch

from runlmc_tpu_torch.hopper import build
from runlmc_tpu_torch.kernels.stationary import (
    KIND_MATERN32,
    KIND_RBF,
    KIND_STD_PERIODIC,
)


def _k_of_r(kind, r, gamma, period):
    if kind == KIND_RBF:
        return torch.exp(-0.5 * torch.square(r) * gamma)
    if kind == KIND_MATERN32:
        s = r * (math.sqrt(3.0) * gamma)
        return (1.0 + s) * torch.exp(-s)
    if kind == KIND_STD_PERIODIC:
        s = torch.sin((math.pi / period) * r)
        return torch.exp(-0.5 * torch.square(s) * gamma)
    return (r == 0.0).to(r.dtype)


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
        k = prm[q, 2] * _k_of_r(kind, dists[mask], prm[q, 0], prm[q, 1])
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

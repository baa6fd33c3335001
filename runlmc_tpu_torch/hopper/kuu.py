"""K1: the dense LMC grid kernel K_UU of one active-dim group, and its
backward.

    K_UU[(d,i),(e,j)] = sum_q B_q[d,e] * tops_q[off(i,j)],
    off(i,j) = sum_p |i_p - j_p| * stride_p

Replaces runlmc_tpu/lmc/grid.py:537-547 (``build_group_state``, dense
branch: an index-map gather of a (Q, m, m) stack, then an einsum with
B) and XLA's autodiff of it. The forward CUDA kernel
(``csrc/kuu_dense.cu``) works out each element's BTTB offset from the
two flat grid indices and reads no index map; it is bound by its (Dm)^2
output write. The backward kernel (``csrc/kuu_dense_bwd.cu``) sums the
cotangent G over the pairs of each offset,

    H[d,e,o] = sum_{off(i,j)=o} G[(d,i),(e,j)],

bound by its (Dm)^2 read of G; ``d tops = einsum(B, H)`` and
``d B = einsum(tops, H)`` are two small products, (Q, D^2) x (D^2, m),
left to torch. :class:`KUUDense` joins the two as one autograd
function. :func:`kuu_dense_plain` and :func:`kuu_dense_bwd_plain` are
the plain PyTorch versions, which the wrappers run for CPU tensors.
"""

import ctypes

import torch

from runlmc_tpu_torch.hopper import build
from runlmc_tpu_torch.ops.bttb import bttb_index_map


def _sizes3(sizes):
    sizes = tuple(int(s) for s in sizes)
    if not 1 <= len(sizes) <= 3:
        raise ValueError("kuu_dense takes grids of 1 to 3 dims, got %s"
                         % (sizes,))
    return sizes + (1,) * (3 - len(sizes))


def kuu_dense_plain(tops, B, sizes):
    """Plain version: gather the (Q, m, m) BTTB stack through the host
    index map and contract it with B, as the XLA code does."""
    Q, m = tops.shape
    D = B.shape[1]
    idx = torch.as_tensor(bttb_index_map(sizes), dtype=torch.int64,
                          device=tops.device)
    T = tops[:, idx]
    return torch.einsum("qde,qij->diej", B, T).reshape(D * m, D * m)


def kuu_dense(tops, B, sizes):
    """K_UU (D*m, D*m) from ``tops`` (Q, m) and ``B`` (Q, D, D) on a
    grid of ``sizes``; the CUDA kernel for CUDA tensors."""
    if build.use_plain("kuu_dense", tops):
        return kuu_dense_plain(tops, B, sizes)
    Q, m = tops.shape
    D = B.shape[1]
    n0, n1, n2 = _sizes3(sizes)
    if D * m > 1 << 20:
        raise ValueError("kuu_dense: D*m = %d exceeds the kernel's grid"
                         % (D * m))
    if n0 * n1 * n2 != m or B.shape != (Q, D, D) or B.dtype != tops.dtype:
        raise ValueError("kuu_dense: tops %s, B %s, sizes %s disagree"
                         % (tuple(tops.shape), tuple(B.shape), sizes))
    tops = tops.contiguous()
    B = B.contiguous()
    build.require_cuda("kuu_dense", tops, B)
    out = torch.empty((D * m, D * m), dtype=tops.dtype, device=tops.device)
    sfx = build.suffix("kuu_dense", tops.dtype)
    fn = build.function(
        "kuu_dense", "kuu_dense_" + sfx,
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    )
    build.check(fn(build.ptr(tops), build.ptr(B), build.ptr(out), Q, D, m,
                   n0, n1, n2, build.stream_ptr()), "kuu_dense")
    kuu_dense.launches[sfx] += 1
    return out


kuu_dense.launches = build.counter()


def kuu_dense_bwd_plain(tops, B, sizes, G):
    """Plain version of the backward: torch autograd through
    :func:`kuu_dense_plain` (the gather's transpose is a scatter-add)."""
    with torch.enable_grad():
        t = tops.detach().requires_grad_(True)
        b = B.detach().requires_grad_(True)
        return torch.autograd.grad(kuu_dense_plain(t, b, sizes), (t, b), G)


def kuu_dense_bwd(tops, B, sizes, G):
    """``(d tops, d B)`` from the cotangent ``G`` (D*m, D*m) of
    :func:`kuu_dense`'s output; the CUDA kernel computes the offset sums
    H (D, D, m) for CUDA tensors."""
    if build.use_plain("kuu_dense_bwd", G):
        return kuu_dense_bwd_plain(tops, B, sizes, G)
    Q, m = tops.shape
    D = B.shape[1]
    n0, n1, n2 = _sizes3(sizes)
    if D * D > 65535:
        raise ValueError("kuu_dense_bwd: D = %d exceeds the kernel's grid" % D)
    if (n0 * n1 * n2 != m or B.shape != (Q, D, D)
            or G.shape != (D * m, D * m) or G.dtype != tops.dtype
            or B.dtype != tops.dtype or tops.device != G.device
            or B.device != G.device):
        raise ValueError("kuu_dense_bwd: tops %s, B %s, G %s, sizes %s "
                         "disagree" % (tuple(tops.shape), tuple(B.shape),
                                       tuple(G.shape), sizes))
    G = G.contiguous()
    build.require_cuda("kuu_dense_bwd", G)
    H = torch.empty((D, D, m), dtype=G.dtype, device=G.device)
    sfx = build.suffix("kuu_dense_bwd", G.dtype)
    fn = build.function(
        "kuu_dense_bwd", "kuu_dense_bwd_" + sfx,
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    build.check(fn(build.ptr(G), build.ptr(H), D, m, n0, n1, n2,
                   build.stream_ptr()), "kuu_dense_bwd")
    kuu_dense_bwd.launches[sfx] += 1
    return (torch.einsum("qde,deo->qo", B, H),
            torch.einsum("qo,deo->qde", tops, H))


kuu_dense_bwd.launches = build.counter()


class KUUDense(torch.autograd.Function):
    """K_UU with its hand-written backward: forward :func:`kuu_dense`,
    backward :func:`kuu_dense_bwd`."""

    @staticmethod
    def forward(ctx, tops, B, sizes):
        ctx.save_for_backward(tops, B)
        ctx.sizes = sizes
        return kuu_dense(tops, B, sizes)

    @staticmethod
    def backward(ctx, G):
        tops, B = ctx.saved_tensors
        dtops, dB = kuu_dense_bwd(tops, B, ctx.sizes, G)
        return (dtops if ctx.needs_input_grad[0] else None,
                dB if ctx.needs_input_grad[1] else None, None)

"""K1 (+K8): the dense LMC grid kernel K_UU of one active-dim group, with
the kernels' k(r) on the grid fused in, and its backward.

    K_UU[(d,i),(e,j)] = sum_q B_q[d,e] * scale_q * k~_q(dists[off(i,j)]),
    off(i,j) = sum_p |i_p - j_p| * stride_p

The kernels enter as the group's rows of the kernel table
(``LMCKernelSpec.table_rows``): a kind code per q and a (Q, 3) tensor of
constrained ``[gamma, period, scale]``, as kernel K7 reads them;
``dists`` (m,) are the grid's first-row distances.

Replaces runlmc_tpu/lmc/grid.py:535-547 (``build_group_state``, dense
branch: the elementwise k(r) of runlmc_tpu/kernels/stationary.py:64-157
on the first rows, an index-map gather of a (Q, m, m) stack, then an
einsum with B) and XLA's autodiff of it. The forward CUDA kernel
(``csrc/kuu_dense.cu``) evaluates scale_q k~_q on the m offsets into
shared memory, works out each element's BTTB offset from the two flat
grid indices and reads no index map; it is bound by its (Dm)^2 output
write. The backward (``csrc/kuu_dense_bwd.cu``) sums the cotangent G
over the pairs of each offset,

    H[d,e,o] = sum_{off(i,j)=o} G[(d,i),(e,j)],

bound by its (Dm)^2 read of G, and reduces H over the offsets on the
device, in a fixed order, into per-(q, d, e) sums of H against k~, dk~/d
gamma and dk~/d period, and those into the table's cotangent (Q, 3) and
d B (Q, D, D). :class:`KUUDense` joins the two as one autograd function;
autograd carries the table's cotangent through ``table_rows``'
transforms to the raw parameters. :func:`kuu_dense_plain` (k(r) by
:func:`~runlmc_tpu_torch.kernels.stationary.eval_table`, then the gather
and the einsum) and :func:`kuu_dense_bwd_plain` (autograd through it)
are the plain PyTorch versions, which the wrappers run for CPU tensors.
"""

import ctypes

import torch

from runlmc_tpu_torch.hopper import build
from runlmc_tpu_torch.kernels.stationary import eval_table
from runlmc_tpu_torch.ops.bttb import bttb_index_map

# kernels one launch takes (kMaxTableQ in csrc/common.cuh)
MAX_Q = 64


def _sizes3(sizes):
    sizes = tuple(int(s) for s in sizes)
    if not 1 <= len(sizes) <= 3:
        raise ValueError("kuu_dense takes grids of 1 to 3 dims, got %s"
                         % (sizes,))
    return sizes + (1,) * (3 - len(sizes))


def kuu_dense_plain(kinds, prm, dists, B, sizes):
    """Plain version: k(r) on the first rows, then the (Q, m, m) BTTB
    stack gathered through the host index map and contracted with B, as
    the XLA code does."""
    tops = eval_table(kinds, prm, dists)
    Q, m = tops.shape
    D = B.shape[1]
    idx = torch.as_tensor(bttb_index_map(sizes), dtype=torch.int64,
                          device=tops.device)
    T = tops[:, idx]
    return torch.einsum("qde,qij->diej", B, T).reshape(D * m, D * m)


def _checked(what, kinds, prm, dists, B, sizes, *more):
    """The launch's ``(kinds array, Q, D, m, n0, n1, n2)`` after checking
    the inputs; ``more`` are further tensors of the same dtype."""
    Q, m, D = len(kinds), dists.shape[0], B.shape[1]
    n0, n1, n2 = _sizes3(sizes)
    if not 1 <= Q <= MAX_Q:
        raise ValueError("%s: 1 to %d kernels per launch, got %d"
                         % (what, MAX_Q, Q))
    if D * m > 1 << 20 or D * D > 65535:
        raise ValueError("%s: D*m = %d exceeds the kernel's grid"
                         % (what, D * m))
    if (n0 * n1 * n2 != m or dists.shape != (m,) or prm.shape != (Q, 3)
            or B.shape != (Q, D, D)):
        raise ValueError("%s: kinds %d, prm %s, dists %s, B %s, sizes %s "
                         "disagree" % (what, Q, tuple(prm.shape),
                                       tuple(dists.shape), tuple(B.shape),
                                       sizes))
    if any(t.dtype != prm.dtype for t in (dists, B) + more):
        raise ValueError("%s: prm, dists and B must share one dtype" % what)
    build.require_cuda(what, prm, dists, B, *more)
    return ((ctypes.c_int * Q)(*kinds), Q, D, m, n0, n1, n2)


def kuu_dense(kinds, prm, dists, B, sizes):
    """K_UU (D*m, D*m) from the table rows ``kinds`` (Q ints) and ``prm``
    (Q, 3), the first-row distances ``dists`` (m,) and ``B`` (Q, D, D) on
    a grid of ``sizes``; the CUDA kernel for CUDA tensors."""
    if build.use_plain("kuu_dense", prm):
        return kuu_dense_plain(kinds, prm, dists, B, sizes)
    prm, dists, B = (t.contiguous() for t in (prm, dists, B))
    karr, Q, D, m, n0, n1, n2 = _checked("kuu_dense", kinds, prm, dists, B,
                                         sizes)
    out = torch.empty((D * m, D * m), dtype=prm.dtype, device=prm.device)
    sfx = build.suffix("kuu_dense", prm.dtype)
    fn = build.function(
        "kuu_dense", "kuu_dense_" + sfx,
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    )
    build.check(fn(ctypes.cast(karr, ctypes.c_void_p), build.ptr(prm),
                   build.ptr(dists), build.ptr(B), build.ptr(out), Q, D, m,
                   n0, n1, n2, build.stream_ptr()), "kuu_dense")
    kuu_dense.launches[sfx] += 1
    return out


kuu_dense.launches = build.counter()


def kuu_dense_bwd_plain(kinds, prm, dists, B, sizes, G):
    """Plain version of the backward: torch autograd through
    :func:`kuu_dense_plain` (the gather's transpose is a scatter-add);
    returns ``(d prm, d B)``."""
    with torch.enable_grad():
        p = prm.detach().requires_grad_(True)
        b = B.detach().requires_grad_(True)
        return torch.autograd.grad(kuu_dense_plain(kinds, p, dists, b, sizes),
                                   (p, b), G)


def kuu_dense_bwd(kinds, prm, dists, B, sizes, G):
    """``(d prm (Q, 3), d B (Q, D, D))`` from the cotangent ``G``
    (D*m, D*m) of :func:`kuu_dense`'s output; for CUDA tensors the CUDA
    kernels compute the offset sums H (D, D, m) and reduce them."""
    if build.use_plain("kuu_dense_bwd", G):
        return kuu_dense_bwd_plain(kinds, prm, dists, B, sizes, G)
    prm, dists, B, G = (t.contiguous() for t in (prm, dists, B, G))
    karr, Q, D, m, n0, n1, n2 = _checked("kuu_dense_bwd", kinds, prm, dists,
                                         B, sizes, G)
    if G.shape != (D * m, D * m):
        raise ValueError("kuu_dense_bwd: G %s for D*m = %d"
                         % (tuple(G.shape), D * m))
    H = torch.empty((D, D, m), dtype=G.dtype, device=G.device)
    S = torch.empty((Q, D, D, 3), dtype=G.dtype, device=G.device)
    dprm = torch.empty((Q, 3), dtype=G.dtype, device=G.device)
    dB = torch.empty((Q, D, D), dtype=G.dtype, device=G.device)
    sfx = build.suffix("kuu_dense_bwd", G.dtype)
    fn = build.function(
        "kuu_dense_bwd", "kuu_dense_bwd_" + sfx,
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    )
    build.check(fn(ctypes.cast(karr, ctypes.c_void_p), build.ptr(prm),
                   build.ptr(dists), build.ptr(B), build.ptr(G),
                   build.ptr(H), build.ptr(S), build.ptr(dprm), build.ptr(dB),
                   Q, D, m, n0, n1, n2, build.stream_ptr()), "kuu_dense_bwd")
    kuu_dense_bwd.launches[sfx] += 1
    return dprm, dB


kuu_dense_bwd.launches = build.counter()


class KUUDense(torch.autograd.Function):
    """K_UU with its hand-written backward: forward :func:`kuu_dense`,
    backward :func:`kuu_dense_bwd`; cotangents for ``prm`` and ``B``
    (the kind codes, distances and sizes are data)."""

    @staticmethod
    def forward(ctx, kinds, prm, dists, B, sizes):
        ctx.save_for_backward(prm, dists, B)
        ctx.kinds, ctx.sizes = kinds, sizes
        return kuu_dense(kinds, prm, dists, B, sizes)

    @staticmethod
    def backward(ctx, G):
        prm, dists, B = ctx.saved_tensors
        dprm, dB = kuu_dense_bwd(ctx.kinds, prm, dists, B, ctx.sizes, G)
        return (None, dprm if ctx.needs_input_grad[1] else None, None,
                dB if ctx.needs_input_grad[3] else None, None)

"""K8 on the fft groups' first rows: scale_q k~_q(r) of a group's kernels
at the grid's first-row distances, written as the symmetric circulant
embedding that the Fourier symbol's rfftn (K11, cuFFT) reads, and its
backward to the kernel table.

    kern_rows_fft(kinds, prm, dists, sizes)        -> E (Q, *ext_sizes)
    kern_rows_fft_bwd(kinds, prm, dists, sizes, G) -> d prm (Q, 3)

``kinds`` and ``prm`` are the group's rows of the kernel table
(``LMCKernelSpec.table_rows``: kind codes and constrained ``[gamma,
period, scale]``), ``dists`` (m,) the first-row distances of the grid of
per-axis ``sizes`` (1 to 3 axes); each axis of size n is embedded in
``ops.bttb.extension_sizes`` points as ``[t_0..t_{n-1}, 0...0,
t_{n-1}..t_1]``. Replaces the fft branch of runlmc_tpu/lmc/grid.py:535
(``eval_kernels_stacked``, then ops/bttb.py:54 ``cyclic_extend`` inside
:86 ``bttb_fft``) and XLA's autodiff of them. The CUDA kernels
(``csrc/kern_rows_fft.cu``) are one launch each way; the plain versions
(``kernels.stationary.eval_table`` and ``ops.bttb.cyclic_extend``, and
autograd through them) run for CPU tensors. The backward runs a
thread-block cluster of :func:`bwd_cluster` CTAs per kernel q, each
running a share of the one-CTA kernel's summation chains, with the
bits of the one-CTA kernel that larger q's keep (:func:`bwd_points`
mirrors a CTA's points). :class:`KernRowsFFT` joins the two as one
autograd function, differentiable in ``prm``; the distances are data.
"""

import ctypes

import torch

from runlmc_tpu_torch.hopper import build
from runlmc_tpu_torch.kernels.stationary import eval_table
from runlmc_tpu_torch.ops.bttb import cyclic_extend, extension_sizes

# kernels one launch takes (kMaxTableQ in csrc/common.cuh)
MAX_Q = 64
# the backward's summation chains (threads of the one-CTA kernel), its
# largest cluster and the dynamic shared memory a CTA of the cluster
# kernel takes (the 48 KB a CTA has without an opt-in, less 1 KB for its
# static shared memory; csrc/kern_rows_fft.cu), and the multiprocessors
# that the clusters should fill, by default an H100's (the wrapper passes
# its card's: build.sm_count)
THREADS = 256
MAX_CLUSTER = 8
SMEM_LIMIT = 47 * 1024
SMS = build.H100_SMS

_P, _I32 = ctypes.c_void_p, ctypes.c_int


def _axes3(sizes):
    """(n0, n1, n2, E0, E1, E2): the sizes and their embedding sizes,
    padded to three axes with 1."""
    sizes = tuple(int(s) for s in sizes)
    if not 1 <= len(sizes) <= 3:
        raise ValueError("kern_rows_fft takes grids of 1 to 3 dims, got %s"
                         % (sizes,))
    ext = extension_sizes(sizes)
    pad = (1,) * (3 - len(sizes))
    return sizes + pad + ext + pad


def _checked(what, kinds, prm, dists, sizes, *more):
    """The launch's ``(kinds array, Q, axes)`` after checking the
    inputs; ``more`` are further tensors of prm's dtype."""
    Q, m = len(kinds), dists.shape[0]
    axes = _axes3(sizes)
    if not 1 <= Q <= MAX_Q:
        raise ValueError("%s: 1 to %d kernels per launch, got %d"
                         % (what, MAX_Q, Q))
    if (axes[0] * axes[1] * axes[2] != m or dists.shape != (m,)
            or prm.shape != (Q, 3)):
        raise ValueError("%s: kinds %d, prm %s, dists %s, sizes %s disagree"
                         % (what, Q, tuple(prm.shape), tuple(dists.shape),
                            sizes))
    if any(t.dtype != prm.dtype for t in (dists,) + more):
        raise ValueError("%s: prm and dists must share one dtype" % what)
    build.require_cuda(what, prm, dists, *more)
    return (ctypes.c_int * Q)(*kinds), Q, axes


def kern_rows_fft_plain(kinds, prm, dists, sizes):
    """Plain version: k(r) by torch ops, then the flips and concats."""
    return cyclic_extend(eval_table(kinds, prm, dists), sizes)


def kern_rows_fft(kinds, prm, dists, sizes):
    """The embedding E (Q, *ext_sizes) of the group's first rows; the
    CUDA kernel for CUDA tensors."""
    if prm.dtype != dists.dtype:
        raise ValueError("kern_rows_fft: prm is %s but dists %s"
                         % (prm.dtype, dists.dtype))
    if build.use_plain("kern_rows_fft", prm):
        return kern_rows_fft_plain(kinds, prm, dists, sizes)
    prm, dists = prm.contiguous(), dists.contiguous()
    karr, Q, axes = _checked("kern_rows_fft", kinds, prm, dists, sizes)
    ext = extension_sizes(sizes)
    out = torch.empty((Q,) + ext, dtype=prm.dtype, device=prm.device)
    sfx = build.suffix("kern_rows_fft", prm.dtype)
    fn = build.function("kern_rows_fft", "kern_rows_fft_" + sfx,
                        [_P] * 4 + [_I32] * 7 + [_P])
    build.check(fn(ctypes.cast(karr, _P), build.ptr(prm), build.ptr(dists),
                   build.ptr(out), Q, *axes, build.stream_ptr()),
                "kern_rows_fft")
    kern_rows_fft.launches[sfx] += 1
    return out


kern_rows_fft.launches = build.counter()


def bwd_cluster(Q, m, dtype, sms=SMS):
    """CTAs per kernel q of the backward's cluster kernel, 1, 2, 4 or 8:
    the most that Q clusters fit on the card's ``sms`` SMs, no more than the
    ``THREADS`` chains' points need (one CTA a ``THREADS`` points); 0
    (the one-CTA kernel) where a CTA's terms, four values a point, would
    not fit in its shared memory."""
    C = min(MAX_CLUSTER, sms // max(Q, 1), -(-m // THREADS))
    C = 1 << (max(C, 1).bit_length() - 1)
    itemsize = 8 if dtype == torch.float64 else 4
    slots = -(-m // THREADS) * (THREADS // C)
    return C if 4 * itemsize * slots <= SMEM_LIMIT else 0


def bwd_points(m, C, rank):
    """The first-row points of CTA ``rank`` of the cluster kernel with
    ``C`` CTAs a q, in the order of its shared memory (slot p = j T +
    (t - t0) holds point t + THREADS j of chain t, T = THREADS / C chains
    from t0 = rank T); -1 where a chain has no j-th point."""
    chains = THREADS // C
    t0 = rank * chains
    out = []
    for j in range(-(-m // THREADS)):
        for t in range(t0, t0 + chains):
            o = t + THREADS * j
            out.append(o if o < m else -1)
    return out


def kern_rows_fft_bwd_plain(kinds, prm, dists, sizes, G):
    """Plain version of the backward: autograd through
    :func:`kern_rows_fft_plain`."""
    with torch.enable_grad():
        p = prm.detach().requires_grad_(True)
        (dprm,) = torch.autograd.grad(
            kern_rows_fft_plain(kinds, p, dists, sizes), p, G)
    return dprm


def kern_rows_fft_bwd(kinds, prm, dists, sizes, G):
    """d prm (Q, 3) from the cotangent ``G`` (Q, *ext_sizes) of the
    embedding; the CUDA kernel for CUDA tensors."""
    if build.use_plain("kern_rows_fft_bwd", G):
        return kern_rows_fft_bwd_plain(kinds, prm, dists, sizes, G)
    prm, dists, G = prm.contiguous(), dists.contiguous(), G.contiguous()
    karr, Q, axes = _checked("kern_rows_fft_bwd", kinds, prm, dists, sizes,
                             G)
    if tuple(G.shape) != (Q,) + extension_sizes(sizes):
        raise ValueError("kern_rows_fft_bwd: G %s is not the embedding's "
                         "shape" % (tuple(G.shape),))
    dprm = torch.empty_like(prm)
    sfx = build.suffix("kern_rows_fft_bwd", prm.dtype)
    fn = build.function("kern_rows_fft", "kern_rows_fft_bwd_" + sfx,
                        [_P] * 5 + [_I32] * 8 + [_P])
    build.check(fn(ctypes.cast(karr, _P), build.ptr(prm), build.ptr(dists),
                   build.ptr(G), build.ptr(dprm), Q, *axes,
                   bwd_cluster(Q, dists.shape[0], prm.dtype,
                               sms=build.sm_count(G.get_device())),
                   build.stream_ptr()), "kern_rows_fft_bwd")
    kern_rows_fft_bwd.launches[sfx] += 1
    return dprm


kern_rows_fft_bwd.launches = build.counter()


class KernRowsFFT(torch.autograd.Function):
    """:func:`kern_rows_fft` with :func:`kern_rows_fft_bwd` as its
    backward; differentiable in ``prm`` only."""

    @staticmethod
    def forward(ctx, kinds, prm, dists, sizes):
        ctx.save_for_backward(prm, dists)
        ctx.kinds, ctx.sizes = kinds, sizes
        return kern_rows_fft(kinds, prm, dists, sizes)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, G):
        prm, dists = ctx.saved_tensors
        return (None, kern_rows_fft_bwd(ctx.kinds, prm, dists, ctx.sizes, G),
                None, None)

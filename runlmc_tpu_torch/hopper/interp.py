"""K9: the SKI interpolation operator W applied to a batch, both ways.

    interp_gather   W v:   out[b, r] = sum_t w[r, t] v[b, idx[r, t]]
    interp_scatter  W^T x: out[b, c] = sum over W's entries in column c

Replaces runlmc_tpu/ops/interpolation.py:219-240 (``Interp.matvec``, a
take + einsum, and ``Interp.rmatvec``, a scatter-add). The scatter reads
a transposed CSR of W built once on the host (``ptr``, ``rows``,
``wt``), so each output column is a private sum: no atomics, the same
result on every run. It has two variants, chosen by
:func:`scatter_variant` from (ncols, nnz, nbatch) alone: a thread per
column for short columns over many batch rows, a warp per column (lanes
on strided entries, then a fixed shuffle tree) for long columns that
would leave the card idle (synth's one-column apply).
Both CUDA kernels (``csrc/interp.cu``) are bound by bytes. The plain
versions below are what the wrappers run for CPU tensors;
:func:`interp_scatter_lanes` sums in the warp variant's order, for the
tests.

They are also K4, the per-output W-block applies of the Woodbury
factorization and of the dense SKI matvec (runlmc_tpu/lmc/woodbury.py:
141-184, runlmc_tpu/lmc/grid.py:420-444, dense (n_d, m) GEMMs there):
the blocks are W's rows of each output, so 4^P taps per row replace m
columns. :class:`InterpApply` makes either direction differentiable in
its operand: the backward of the gather is the scatter and the other way
round (W's weights are constants).
"""

import ctypes

import torch

from runlmc_tpu_torch.hopper import build


def interp_gather_plain(idx, w, v):
    return torch.sum(v[..., idx.long()] * w, dim=-1)


def interp_scatter_plain(ptr, rows, wt, x):
    """Each column's CSR entries, padded to the longest column with
    zero weights, summed in one reduction."""
    deg = ptr[1:] - ptr[:-1]
    width = int(deg.max()) if deg.numel() else 0
    k = torch.arange(width, device=ptr.device)
    pos = ptr[:-1, None].long() + k[None, :]
    valid = k[None, :] < deg[:, None]
    pos = torch.where(valid, pos, torch.zeros_like(pos))
    w_e = torch.where(valid, wt[pos], torch.zeros((), dtype=wt.dtype,
                                                   device=wt.device))
    return torch.sum(x[..., rows[pos].long()] * w_e, dim=-1)


# scatter variants (csrc/interp.cu kScatterThread, kScatterWarp)
SCATTER_THREAD = 0
SCATTER_WARP = 1
# a warp per column once the columns average this many entries and the
# thread variant's ncols * nbatch threads fall short of the card's
# resident threads (132 SMs x 2048)
WARP_MIN_MEAN = 16
CARD_THREADS = 132 * 2048
WARP = 32


def scatter_variant(ncols, nnz, nbatch):
    """The scatter kernel's variant for a CSR of ``ncols`` columns and
    ``nnz`` entries applied to ``nbatch`` batch rows: a pure function of
    the three."""
    if nnz >= WARP_MIN_MEAN * ncols and ncols * nbatch < CARD_THREADS:
        return SCATTER_WARP
    return SCATTER_THREAD


def interp_scatter_lanes(ptr, rows, wt, x):
    """W^T x in the warp variant's order: lane l of a column's warp sums
    its entries l, l + 32, ... in turn, then the xor tree (offsets 16,
    8, 4, 2, 1) adds the lane sums; lane 0's total is the column's."""
    deg = ptr[1:] - ptr[:-1]
    width = -(-int(deg.max()) // WARP) * WARP if deg.numel() else 0
    k = torch.arange(width, device=ptr.device)
    pos = ptr[:-1, None].long() + k[None, :]
    valid = k[None, :] < deg[:, None]
    pos = torch.where(valid, pos, torch.zeros_like(pos))
    w_e = torch.where(valid, wt[pos], torch.zeros((), dtype=wt.dtype,
                                                   device=wt.device))
    terms = (x[..., rows[pos].long()] * w_e).unflatten(-1, (-1, WARP))
    acc = torch.zeros(terms.shape[:-2] + (WARP,), dtype=x.dtype,
                      device=x.device)
    for i in range(terms.shape[-2]):
        acc = acc + terms[..., i, :]
    lane = torch.arange(WARP, device=ptr.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    return acc[..., 0]


def _flat_batch(t):
    batch = t.shape[:-1]
    return batch, t.reshape(-1, t.shape[-1]).contiguous()


def interp_gather(idx, w, v):
    """W v for ``v`` (..., ncols), ``idx`` (n, taps) int32, ``w`` (n, taps)
    -> (..., n); the CUDA kernel for CUDA tensors."""
    if build.use_plain("interp_gather", v):
        return interp_gather_plain(idx, w, v)
    n, taps = idx.shape
    if idx.dtype != torch.int32 or w.shape != idx.shape or w.dtype != v.dtype:
        raise ValueError("interp_gather: idx int32 and w (n, taps) in v's "
                         "dtype expected")
    batch, v2 = _flat_batch(v)
    ncols = v2.shape[1]
    idx, w = idx.contiguous(), w.contiguous()
    build.require_cuda("interp_gather", idx, w, v2)
    out = torch.empty((v2.shape[0], n), dtype=v.dtype, device=v.device)
    sfx = build.suffix("interp_gather", v.dtype)
    fn = build.function(
        "interp", "interp_gather_" + sfx,
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    if out.numel():
        build.check(fn(build.ptr(idx), build.ptr(w), build.ptr(v2),
                       build.ptr(out), n, taps, ncols, v2.shape[0],
                       build.stream_ptr()), "interp_gather")
        interp_gather.launches[sfx] += 1
    return out.reshape(batch + (n,))


def interp_scatter(ptr, rows, wt, x):
    """W^T x for ``x`` (..., n) from W's transposed CSR (``ptr``
    (ncols + 1,), ``rows`` and ``wt`` (nnz,)) -> (..., ncols); the CUDA
    kernel for CUDA tensors."""
    if build.use_plain("interp_scatter", x):
        return interp_scatter_plain(ptr, rows, wt, x)
    ncols = ptr.shape[0] - 1
    if (ptr.dtype != torch.int32 or rows.dtype != torch.int32
            or wt.dtype != x.dtype or rows.shape != wt.shape):
        raise ValueError("interp_scatter: int32 CSR with weights in x's "
                         "dtype expected")
    batch, x2 = _flat_batch(x)
    n = x2.shape[1]
    ptr, rows, wt = ptr.contiguous(), rows.contiguous(), wt.contiguous()
    build.require_cuda("interp_scatter", ptr, rows, wt, x2)
    out = torch.empty((x2.shape[0], ncols), dtype=x.dtype, device=x.device)
    sfx = build.suffix("interp_scatter", x.dtype)
    fn = build.function(
        "interp", "interp_scatter_" + sfx,
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    if out.numel():
        variant = scatter_variant(ncols, rows.shape[0], x2.shape[0])
        build.check(fn(build.ptr(ptr), build.ptr(rows), build.ptr(wt),
                       build.ptr(x2), build.ptr(out), n, ncols, x2.shape[0],
                       variant, build.stream_ptr()), "interp_scatter")
        interp_scatter.launches[sfx] += 1
    return out.reshape(batch + (ncols,))


interp_gather.launches = build.counter()
interp_scatter.launches = build.counter()


class InterpApply(torch.autograd.Function):
    """W v (``transpose=False``, the gather) or W^T x (the scatter) as an
    autograd function whose backward is the other direction."""

    @staticmethod
    def forward(ctx, v, idx, w, ptr, rows, wt, transpose):
        ctx.save_for_backward(idx, w, ptr, rows, wt)
        ctx.transpose = transpose
        if transpose:
            return interp_scatter(ptr, rows, wt, v)
        return interp_gather(idx, w, v)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        idx, w, ptr, rows, wt = ctx.saved_tensors
        g = g.contiguous()
        out = (interp_gather(idx, w, g) if ctx.transpose
               else interp_scatter(ptr, rows, wt, g))
        return out, None, None, None, None, None, None


def interp_apply(v, idx, w, ptr, rows, wt, transpose=False):
    """W v, or W^T v with ``transpose``, through :class:`InterpApply` when
    ``v`` needs a gradient, else straight through the wrapper."""
    if torch.is_grad_enabled() and v.requires_grad:
        return InterpApply.apply(v, idx, w, ptr, rows, wt, transpose)
    if transpose:
        return interp_scatter(ptr, rows, wt, v)
    return interp_gather(idx, w, v)

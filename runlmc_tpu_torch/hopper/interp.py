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
would leave the card idle (synth's one-column apply). The gather loads
each row's taps once as vectors where the tap count has an instance
(:func:`gather_taps`), walks a chunk of batch rows per thread
(:func:`gather_chunk`, from (n, nbatch) and the layout), and reads its
operand through its two strides, so a transposed view is not copied;
such a view (batch rows adjacent) takes tiles with lanes on batch rows
(:func:`gather_layout`).
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
import functools

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
# resident threads (its SMs x 2048; by default an H100's 132 SMs, the
# wrappers pass their card's: build.sm_count)
WARP_MIN_MEAN = 16
SMS = build.H100_SMS
SM_THREADS = 2048
WARP = 32


# gather layouts (csrc/interp.cu kGatherRows, kGatherCols): a thread a
# row over a chunk of batch rows, or tiles of GATHER_TILE rows x
# GATHER_TILE * chunk batch rows with lanes on batch rows, for an
# operand whose batch rows are adjacent in memory (a transposed view)
GATHER_ROWS = 0
GATHER_COLS = 1
GATHER_TILE = 32
# gather: the CTA (csrc/interp.cu kGatherThreads), the tap counts with an
# instance of their own, and each layout's chunks (batch rows a thread),
# largest first; the largest chunk that leaves the grid at least a
# quarter of the card's resident threads is taken, else the smallest
GATHER_THREADS = 256
GATHER_TAPS = (4, 16)
GATHER_CHUNKS = {GATHER_ROWS: (4, 2, 1), GATHER_COLS: (2,)}
MAX_GRID_Y = 65535


def gather_taps(taps):
    """The gather's instance for ``taps`` taps a row: the tap count
    itself where it has one (taps in registers, loaded as vectors), else
    0 (the generic instance): a pure function of ``taps``."""
    return taps if taps in GATHER_TAPS else 0


@functools.lru_cache(maxsize=256)
def gather_chunk(n, nbatch, layout, sms=SMS):
    """Batch rows per thread of the gather of ``n`` rows over ``nbatch``
    batch rows in ``layout`` (every tap instance alike) on a card of
    ``sms`` SMs: a pure function of the four, so kept per shape."""
    chunks = GATHER_CHUNKS[layout]
    for c in chunks[:-1]:
        (gx, gy), _, _ = gather_grid(n, nbatch, c, layout)
        if 4 * gx * gy * GATHER_THREADS >= sms * SM_THREADS:
            return c
    return chunks[-1]


def gather_layout(sb, sc, nbatch):
    """The gather's layout for an operand of strides (``sb``, ``sc``)
    over ``nbatch`` batch rows: the column tiles where batch rows are
    adjacent (sb == 1, sc != 1) and fill a warp, else a thread a row: a
    pure function of the three."""
    if sb == 1 and sc != 1 and nbatch >= GATHER_TILE:
        return GATHER_COLS
    return GATHER_ROWS


def gather_grid(n, nbatch, chunk, layout):
    """The gather's launch as csrc/interp.cu's gather forms it: ((grid
    x, grid y), rows, batch rows), each axis as (its grid size, items a
    CTA, strided). Grid x is over blocks of rows (GATHER_THREADS in the
    row layout, GATHER_TILE in the column tiles), grid y over blocks of
    batch rows (``chunk``, or GATHER_TILE * ``chunk``), strided: grid
    row y takes blocks y, y + grid y, ..."""
    rows, per = ((GATHER_TILE, GATHER_TILE * chunk) if layout == GATHER_COLS
                 else (GATHER_THREADS, chunk))
    gx = -(-n // rows)
    gy = max(1, min(-(-nbatch // per), MAX_GRID_Y))
    return (gx, gy), (gx, rows, False), (gy, per, True)


def scatter_variant(ncols, nnz, nbatch, sms=SMS):
    """The scatter kernel's variant for a CSR of ``ncols`` columns and
    ``nnz`` entries applied to ``nbatch`` batch rows on a card of ``sms``
    SMs: a pure function of the four."""
    if (nnz >= WARP_MIN_MEAN * ncols
            and ncols * nbatch < sms * SM_THREADS):
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


_GATHER_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])


def interp_gather(idx, w, v):
    """W v for ``v`` (..., ncols), ``idx`` (n, taps) int32, ``w`` (n, taps)
    -> (..., n) contiguous; the CUDA kernel for CUDA tensors, which reads
    ``v`` through its strides (no copy of a transposed view)."""
    if build.use_plain("interp_gather", v):
        return interp_gather_plain(idx, w, v)
    n, taps = idx.shape
    if idx.dtype != torch.int32 or w.shape != idx.shape or w.dtype != v.dtype:
        raise ValueError("interp_gather: idx int32 and w (n, taps) in v's "
                         "dtype expected")
    # a view wherever the strides allow (the paths pass 2-D operands)
    v2 = v if v.dim() == 2 else v.reshape(-1, v.shape[-1])
    sb, sc = v2.stride()
    idx, w = idx.contiguous(), w.contiguous()
    out = torch.empty((v2.shape[0], n), dtype=v.dtype, device=v.device)
    build.require_cuda("interp_gather", idx, w, out)
    sfx = build.suffix("interp_gather", v.dtype)
    fn = build.function("interp", "interp_gather_" + sfx, _GATHER_ARGS)
    if out.numel():
        aligned = idx.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
        nb = v2.shape[0]
        layout = gather_layout(sb, sc, nb)
        build.check(fn(idx.data_ptr(), w.data_ptr(), v2.data_ptr(),
                       out.data_ptr(), n, taps, nb, sb, sc,
                       gather_taps(taps) if aligned else 0,
                       gather_chunk(n, nb, layout,
                                    sms=build.sm_count(v.get_device())),
                       layout,
                       build.stream_ptr()),
                    "interp_gather")
        interp_gather.launches[sfx] += 1
    return out if v.dim() == 2 else out.reshape(v.shape[:-1] + (n,))


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
        variant = scatter_variant(ncols, rows.shape[0], x2.shape[0],
                                  sms=build.sm_count(x.get_device()))
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

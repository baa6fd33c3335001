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
(``csrc/kuu_dense.cu``) folds the sum over q once per (d, e, offset),

    c[d,e,o] = sum_q B[q,d,e] * scale_q * k~_q(dists[o]),

in q order with FMAs (each element's arithmetic of the kernel before
it, so K_UU keeps its bits), then copies c into the output: CTAs over
contiguous ranges of the blocks' rows, each block's c in shared memory
(doubled on a 1-D grid, so that a row is one contiguous slice), 16-byte
stores along each row with the row's head and tail peeled. It reads no
index map and is bound by its (Dm)^2 output write. The fold runs in
each CTA's prologue where the table is small (Q * m under
:data:`FOLD_LAUNCH_MIN`: fx2007's grid), else as a launch of its own
into an L2-resident scratch (synth, the weather twin), where the
prologue's Q * m transcendentals a CTA would cost more than the extra
launch. The backward (``csrc/kuu_dense_bwd.cu``) sums the cotangent G
over the pairs of each offset,

    H[d,e,o] = sum_{off(i,j)=o} G[(d,i),(e,j)],

bound by its (Dm)^2 read of G: one warp per work item of a host plan
(:func:`bwd_plan`, cached per grid) reads tiles of G row by row and
sums their diagonals into partial slots; a second launch sums the slots
of each offset into H, in a fixed order, and contracts H with k~,
dk~/d gamma and dk~/d period (evaluated once per (q, offset)) into the
table's cotangent (Q, 3) and d B (Q, D, D). :class:`KUUDense` joins the
two as one autograd function; autograd carries the table's cotangent
through ``table_rows``' transforms to the raw parameters.
:func:`kuu_dense_plain` (k(r) by
:func:`~runlmc_tpu_torch.kernels.stationary.eval_table`, then the gather
and the einsum) and :func:`kuu_dense_bwd_plain` (autograd through it)
are the plain PyTorch versions, which the wrappers run for CPU tensors.
"""

import ctypes
import functools

import numpy as np
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


# Q * m from which the forward folds over q in a launch of its own, and
# below which each CTA folds in its prologue (the same bits; measured on
# the H100 by chip_smoke.py --fwd-times, which times both: the prologue
# is faster at fx2007's 238, the launch at synth's 5887 and the weather
# twin's 15024)
FOLD_LAUNCH_MIN = 2048


def kuu_dense(kinds, prm, dists, B, sizes):
    """K_UU (D*m, D*m) from the table rows ``kinds`` (Q ints) and ``prm``
    (Q, 3), the first-row distances ``dists`` (m,) and ``B`` (Q, D, D) on
    a grid of ``sizes``; the CUDA kernel for CUDA tensors, which folds
    over q in a launch of its own where Q * m >= :data:`FOLD_LAUNCH_MIN`."""
    if build.use_plain("kuu_dense", prm):
        return kuu_dense_plain(kinds, prm, dists, B, sizes)
    prm, dists, B = (t.contiguous() for t in (prm, dists, B))
    karr, Q, D, m, n0, n1, n2 = _checked("kuu_dense", kinds, prm, dists, B,
                                         sizes)
    out = torch.empty((D * m, D * m), dtype=prm.dtype, device=prm.device)
    folded = (torch.empty(D * D * m, dtype=prm.dtype, device=prm.device)
              if Q * m >= FOLD_LAUNCH_MIN else None)
    sfx = build.suffix("kuu_dense", prm.dtype)
    fn = build.function(
        "kuu_dense", "kuu_dense_" + sfx,
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    )
    build.check(fn(ctypes.cast(karr, ctypes.c_void_p), build.ptr(prm),
                   build.ptr(dists), build.ptr(B),
                   None if folded is None else build.ptr(folded),
                   build.ptr(out), Q, D, m, n0, n1, n2,
                   int(folded is not None), build.stream_ptr()), "kuu_dense")
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


# the backward's tiles: at most TILE points of the innermost axis on each
# side (a warp's lanes; kTile in csrc/kuu_dense_bwd.cu), SLOTS partial
# slots a work item (2 * TILE), and at most `band` tiles of one band an
# item: the longest of BANDS that still gives stage 1 MIN_WARPS warps
# (about two waves of an H100's; longer items shorten the second pass's
# lists, shorter ones fill the card on small grids)
TILE = 32
SLOTS = 2 * TILE
BANDS = (4, 8, 16)
MIN_WARPS = 6000


def _sizes_inner(sizes):
    """Grid sizes as (n0, n1, N2) with the innermost (stride 1) axis last,
    ones in front for 1-D and 2-D grids."""
    real = list(_sizes3(sizes)[:len(tuple(sizes))])
    while len(real) > 1 and real[-1] == 1:  # trailing ones: the same layout
        real.pop()
    return (1,) * (3 - len(real)) + tuple(real)


def band_for(sizes, D):
    """Tiles a work item takes on a grid of ``sizes`` with D outputs (the
    warps of stage 1 are the items times D^2)."""
    inner = _sizes_inner(sizes)
    for band in BANDS[::-1]:
        if len(_items(inner, band)) * D * D >= MIN_WARPS:
            return band
    return BANDS[0]


def bwd_items(sizes, band=BANDS[0]):
    """The backward's work items on a grid of ``sizes``, the same for
    every (d, e) block of G: (nitems, 5) int32 rows (s0, s1, kb, start,
    count). An item walks ``count`` tiles, from the ``start``-th, of the
    band with signed outer offsets (s0, s1) (column coordinate minus row
    coordinate on the two outer axes) and signed tile offset kb on the
    innermost axis, whose T x T tiles (T = min(TILE, N2)) lie inside one
    Toeplitz block of the innermost axis; the tiles of a band, in
    row-major order of (i0, i1, tile row), are cut into items of at most
    ``band``. Items are listed deepest (most tiles) first."""
    return _items(_sizes_inner(sizes), band)


@functools.lru_cache(maxsize=64)
def _items(inner, band):
    n0, n1, N2 = inner
    tile = min(TILE, N2)
    nbk = -(-N2 // tile)
    rows = []
    for s0 in range(1 - n0, n0):
        for s1 in range(1 - n1, n1):
            for kb in range(1 - nbk, nbk):
                count = (n0 - abs(s0)) * (n1 - abs(s1)) * (nbk - abs(kb))
                rows += [(s0, s1, kb, st, min(band, count - st))
                         for st in range(0, count, band)]
    rows.sort(key=lambda r: -r[4])
    return np.asarray(rows, dtype=np.int32).reshape(-1, 5)


def slot_offsets(sizes, band=BANDS[0]):
    """(nitems, SLOTS) int64: the BTTB offset o that each partial slot of
    each item of :func:`bwd_items` sums, -1 for none. Lane k's slot k
    holds the tile diagonal col - row = k (signed inner offset
    kb T + k), slot TILE + k the diagonal k - T."""
    n0, n1, N2 = _sizes_inner(sizes)
    tile = min(TILE, N2)
    items = bwd_items(sizes, band)
    k = np.arange(TILE)
    s2 = np.concatenate([items[:, 2:3] * tile + k,
                         items[:, 2:3] * tile + k - tile], axis=1)
    valid = np.concatenate([np.broadcast_to(k < tile, (len(items), TILE)),
                            np.broadcast_to((k >= 1) & (k < tile),
                                            (len(items), TILE))], axis=1)
    valid = valid & (np.abs(s2) < N2)
    o = (np.abs(items[:, 0:1]).astype(np.int64) * n1 * N2
         + np.abs(items[:, 1:2]) * N2 + np.abs(s2))
    return np.where(valid, o, -1)


def bwd_plan(sizes, band=BANDS[0]):
    """``(items, optr, oent)``: :func:`bwd_items` and, as CSR over the m
    offsets, the slots (item * SLOTS + slot) each offset sums, ascending:
    the second pass's order (made once per grid and band)."""
    return _plan(_sizes_inner(sizes), band)


@functools.lru_cache(maxsize=64)
def _plan(sizes, band):
    m = int(np.prod(sizes))
    o = slot_offsets(sizes, band).reshape(-1)
    ent = np.nonzero(o >= 0)[0]
    order = ent[np.argsort(o[ent], kind="stable")]
    optr = np.searchsorted(o[order], np.arange(m + 1)).astype(np.int32)
    return bwd_items(sizes, band), optr, order.astype(np.int32)


def _device_plan(sizes, D, dev):
    """:func:`bwd_plan` at :func:`band_for` packed as the kernels read it
    (int32 [items | optr | oent]) on ``dev``, with the item count and the
    longest entry list of a second-pass CTA's _R offsets; made once per
    (grid, D, device)."""
    band = band_for(sizes, D)
    items, optr, oent = bwd_plan(sizes, band)
    packed = build.device_work(
        ("kuu_dense_bwd", band) + _sizes_inner(sizes), dev,
        lambda: np.concatenate([items.reshape(-1), optr, oent]))
    ends = optr[np.minimum(np.arange(_R, len(optr) - 1 + _R, _R),
                           len(optr) - 1)]
    starts = optr[0:len(optr) - 1:_R]
    return packed, len(items), int(np.max(ends - starts))


def kuu_dense_bwd(kinds, prm, dists, B, sizes, G):
    """``(d prm (Q, 3), d B (Q, D, D))`` from the cotangent ``G``
    (D*m, D*m) of :func:`kuu_dense`'s output; for CUDA tensors two CUDA
    kernels: the per-tile diagonal sums of G over the host plan
    (:func:`bwd_plan`), then their reduction to the offset sums H and,
    with k(r) evaluated once per (q, offset), to the cotangents."""
    if build.use_plain("kuu_dense_bwd", G):
        return kuu_dense_bwd_plain(kinds, prm, dists, B, sizes, G)
    prm, dists, B, G = (t.contiguous() for t in (prm, dists, B, G))
    karr, Q, D, m, n0, n1, n2 = _checked("kuu_dense_bwd", kinds, prm, dists,
                                         B, sizes, G)
    if G.shape != (D * m, D * m):
        raise ValueError("kuu_dense_bwd: G %s for D*m = %d"
                         % (tuple(G.shape), D * m))
    plan, nitems, max_chunk = _device_plan(sizes, D, G.device)
    noc = -(-m // _R)
    f = dict(dtype=G.dtype, device=G.device)
    part = torch.empty(D * D * nitems * SLOTS, **f)
    spart = torch.empty(noc * Q * 3 * D * D + Q * 3 * D * D, **f)
    dprm = torch.empty((Q, 3), **f)
    dB = torch.empty((Q, D, D), **f)
    sfx = build.suffix("kuu_dense_bwd", G.dtype)
    fn = build.function(
        "kuu_dense_bwd", "kuu_dense_bwd_" + sfx,
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    )
    i0, i1, i2 = _sizes_inner(sizes)
    build.check(fn(ctypes.cast(karr, ctypes.c_void_p), build.ptr(prm),
                   build.ptr(dists), build.ptr(B), build.ptr(G),
                   build.ptr(plan), build.ptr(part), build.ptr(spart),
                   build.ptr(build.ticket("kuu_dense_bwd", G.device)),
                   build.ptr(dprm), build.ptr(dB), Q, D, m, i0, i1, i2,
                   nitems, max_chunk, build.stream_ptr()), "kuu_dense_bwd")
    kuu_dense_bwd.launches[sfx] += 1
    return dprm, dB


# offsets per CTA of the second pass (kR in csrc/kuu_dense_bwd.cu)
_R = 64


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

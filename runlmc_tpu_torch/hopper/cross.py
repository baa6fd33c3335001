"""K7 (+K8): the dense LMC cross-covariance K[a, b] between two point
sets, without noise.

    K[a,b] = sum_q B_q[o_a, o_b] * scale_q * k_q(||x_a - x_b|| over q's dims)

Replaces runlmc_tpu/lmc/likelihood.py:76-96 (``pairwise_dists`` and
``cross_kernel``) together with the elementwise k(r) of
runlmc_tpu/kernels/stationary.py:64-157. Kernels are described by a
table (``LMCKernelSpec.kernel_table``): a kind code, a bitmask of active
input dims and constrained ``[gamma, period, scale]`` per q. The CUDA
kernel (``csrc/cross_kernel.cu``) fuses distance, k(r) and the
coregionalization scale and writes nothing but K; it is bound by its
(na, nb) output write, or on the weather oracle by its exps. Where the
two point sets are one and sorted by output (every square call on the
model's paths) it runs the pair path: the tile pairs I >= J of
:func:`bwd_plan`, each unordered pair's k(r) once for K[a, b] and
K[b, a], B[q, out I, out J] and B[q, out J, out I] constants of the
tile pair. Other inputs take the general path (a thread per column and
four rows); both give the same bits. :func:`cross_kernel_plain`
evaluates the same table in plain PyTorch and is what the wrapper runs
for CPU tensors.

K7 backward (``csrc/cross_kernel_bwd.cu``) replaces XLA's autodiff of
the same lines inside ``jax.grad`` of ``exact_mll``: from the cotangent
G (na, nb) it recomputes each element's k~_q(r) and its derivatives in
gamma and period and sums them per pair of outputs (d, e) into S0, S1,
S2 (Q, D, D); a finishing pass sums the tile pairs' partials in a fixed
order and does the four small products that give the cotangents of
``B`` and ``prm`` (see :func:`cross_kernel_bwd`). Rows and columns are
cut into tiles that never straddle two outputs (:func:`bwd_plan`, a
host plan cached per output counts and device; the index tensor's
order is read once per tensor, :func:`output_order`). Where both point
sets are one, each unordered pair is evaluated once for G[a, b] and
G[b, a]. Like the JAX package, it differentiates the parameters only,
not the inputs. :class:`CrossKernel` joins forward and backward as one
autograd function; :func:`cross_kernel_bwd_plain` (autograd of the
plain forward) is what the backward wrapper runs for CPU tensors.
"""

import ctypes
import functools

import numpy as np
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
    (Q, 3); the CUDA kernel for CUDA tensors: the pair path where ``xa``,
    ``oa`` are the same tensors as ``xb``, ``ob`` and sorted by output,
    the general path otherwise."""
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
    empty = not (na and nb and Q)
    plan = None if empty else _pair_plan(xa, oa, xb, ob, D)
    xa, oa, xb, ob, B, kinds, masks, prm = (
        t.contiguous() for t in (xa, oa, xb, ob, B, kinds, masks, prm)
    )
    build.require_cuda("cross_kernel", xa, oa, xb, ob, B, kinds, masks, prm)
    out = torch.empty((na, nb), dtype=xa.dtype, device=xa.device)
    if empty:
        return out.zero_()
    sfx = build.suffix("cross_kernel", xa.dtype)
    fn = build.function(
        "cross_kernel", "cross_kernel_" + sfx,
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    build.check(fn(
        xa.data_ptr(), oa.data_ptr(), xb.data_ptr(), ob.data_ptr(),
        B.data_ptr(), kinds.data_ptr(), masks.data_ptr(), prm.data_ptr(),
        *((None, 0, 0, 0) if plan is None else
          (plan[0].data_ptr(),) + plan[1:]),
        out.data_ptr(), na, nb, P, Q, D,
        build.stream_ptr(xa.device),
    ), "cross_kernel")
    cross_kernel.launches[sfx] += 1
    return out


cross_kernel.launches = build.counter()


# kernels per tile launch (kMaxQ in csrc/cross_kernel_bwd.cu); more run
# as further launches over slices of q
_MAX_Q = 8
# points per tile of the backward's plan (kTile in the CUDA source)
TILE = 64


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


def output_tiles(counts, tile=TILE):
    """(ntiles, 3) int32 rows ``(start, length, output)``: each output's
    run of a sorted index vector with ``counts[d]`` entries of output d,
    cut into tiles of at most ``tile`` points (no tile spans two
    outputs)."""
    rows, start = [], 0
    for d, c in enumerate(counts):
        rows += [(start + s, min(tile, c - s), d) for s in range(0, c, tile)]
        start += c
    return np.asarray(rows, dtype=np.int32).reshape(-1, 3)


@functools.lru_cache(maxsize=64)
def bwd_plan(counts_a, counts_b, pair, tile=TILE):
    """K7's host plan for rows and columns sorted by output (``counts_a``
    / ``counts_b`` entries per output), for the backward and the
    forward's pair path: ``(ta, tb, pairs, ptr, idx)``. ``ta`` / ``tb`` are the :func:`output_tiles`; ``pairs``
    (npairs, 2) the tile pairs (I, J) that run, I >= J when ``pair`` (one
    point set: tile pair (I, J) also takes G[J, I]), every pair
    otherwise. Partial slot 2p is G[I, J]'s, summed into
    (out I, out J); slot 2p + 1 (pair only) is G[J, I]'s, summed into
    (out J, out I). ``ptr`` (D * D + 1) and ``idx`` list each
    (d, e)'s slots, ascending: the finishing pass's order."""
    D = len(counts_a)
    ta = output_tiles(counts_a, tile)
    tb = ta if pair else output_tiles(counts_b, tile)
    nta, ntb = len(ta), len(tb)
    I, J = np.meshgrid(np.arange(nta), np.arange(ntb), indexing="ij")
    keep = (I >= J) if pair else np.ones(I.shape, dtype=bool)
    pairs = np.stack([I[keep], J[keep]], axis=1).astype(np.int32)
    np_ = len(pairs)
    slot = 2 * np.arange(np_)
    de = ta[pairs[:, 0], 2] * D + tb[pairs[:, 1], 2]
    if pair:
        slot = np.concatenate([slot, slot + 1])
        de = np.concatenate([de, tb[pairs[:, 1], 2] * D
                             + ta[pairs[:, 0], 2]])
    order = np.lexsort((slot, de))
    ptr = np.searchsorted(de[order], np.arange(D * D + 1)).astype(np.int32)
    return ta, tb, pairs, ptr, slot[order].astype(np.int32)


_PLANS = {}


def _device_plan(counts_a, counts_b, pair, dev):
    """:func:`bwd_plan` packed as the kernel reads it (int32 [ta | tb |
    pairs | ptr | idx]) on ``dev``, with (nta, ntb, npairs); made once
    per (counts, path, device)."""
    key = (counts_a, counts_b, pair, dev)
    if key not in _PLANS:
        ta, tb, pairs, ptr, idx = bwd_plan(counts_a, counts_b, pair)
        flat = np.concatenate([a.reshape(-1) for a in
                               (ta, tb, pairs, ptr, idx)])
        _PLANS[key] = (torch.as_tensor(flat, device=dev), len(ta), len(tb),
                       len(pairs))
    return _PLANS[key]


def output_order(o, D):
    """``(perm, counts)`` of an int32 output-index tensor: a stable sort
    by output (None where ``o`` is sorted already) and the entries per
    output. Read from the device once per tensor: the result is kept on
    the tensor itself, with its version, so later calls (the model keeps
    one index tensor) do not synchronize."""
    key = (o._version, D, o.shape, o.device)
    hit = getattr(o, "_runlmc_output_order", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    host = o.detach().cpu().numpy().astype(np.int64)
    if host.size and (host.min() < 0 or host.max() >= D):
        raise ValueError("cross_kernel: output indices outside [0, %d)"
                         % D)
    counts = tuple(int(c) for c in np.bincount(host, minlength=D))
    perm = None
    if np.any(host[1:] < host[:-1]):
        perm = torch.as_tensor(np.argsort(host, kind="stable"),
                               device=o.device)
    o._runlmc_output_order = (key, (perm, counts))
    return o._runlmc_output_order[1]


def _pair_plan(xa, oa, xb, ob, D):
    """K7's pair-path plan (:func:`_device_plan`) where ``xa``, ``oa``
    are the same tensors as ``xb``, ``ob`` and sorted by output; None
    for the general path."""
    if not (_same(xa, xb) and _same(oa, ob)):
        return None
    perm, counts = output_order(oa, D)
    if perm is not None:
        return None
    return _device_plan(counts, counts, True, xa.device)


def _same(t, u):
    """True where ``t`` and ``u`` are one tensor (or views of the same
    elements)."""
    return t is u or (t.data_ptr() == u.data_ptr() and t.shape == u.shape
                      and t.stride() == u.stride() and t.dtype == u.dtype
                      and t.device == u.device)


def cross_kernel_bwd(xa, oa, xb, ob, B, kinds, masks, prm, G, alpha=None):
    """``(d B (Q, D, D), d prm (Q, 3))`` from the cotangent ``G``
    (na, nb) of :func:`cross_kernel`'s output; the CUDA kernels for CUDA
    tensors. With ``alpha`` (na,) (and na = nb) the cotangent is
    G - alpha alpha^T, formed in the kernel's loads.

    Where the two point sets are one (``xa``, ``oa`` the same tensors as
    ``xb``, ``ob``: every call on the model's paths) the pair path runs,
    evaluating the kernels once per unordered pair; inputs not sorted by
    output are sorted first (a gather of G); distinct point sets take the
    general path (and ``alpha`` there by ``torch.addr`` first)."""
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
    pair = _same(xa, xb) and _same(oa, ob)
    xa, oa, xb, ob, B, kinds, masks, prm = (
        t.contiguous() for t in (xa, oa, xb, ob, B, kinds, masks, prm))
    if alpha is not None:
        alpha = alpha.contiguous()
    build.require_cuda("cross_kernel_bwd", xa, oa, xb, ob, B, kinds, masks,
                       prm, *([] if alpha is None else [alpha]))
    perm_a, counts_a = output_order(oa, D)
    perm_b, counts_b = (perm_a, counts_a) if pair else output_order(ob, D)
    # the pair path reads G[a, b] and G[b, a] alike, so a column-major G
    # (the oracle's K^-1 from cholesky_inverse) is read as the row-major
    # G^T with the two swapped, not copied
    gt = int(pair and perm_a is None and G.dim() == 2 and na > 1
             and not G.is_contiguous() and G.t().is_contiguous())
    G = G.t() if gt else G.contiguous()
    build.require_cuda("cross_kernel_bwd", G)
    if alpha is not None and not pair:
        G, alpha = torch.addr(G, alpha, alpha, alpha=-1.0), None
    if perm_a is not None:
        xa, G = xa[perm_a], G[perm_a]
        alpha = None if alpha is None else alpha[perm_a]
    if perm_b is not None:
        xb, G = xb[perm_b], G[:, perm_b].contiguous()
    if pair:
        xb = xa
    if not (na and nb and Q):
        return (torch.zeros((Q, D, D), dtype=G.dtype, device=G.device),
                torch.zeros((Q, 3), dtype=G.dtype, device=G.device))
    plan, nta, ntb, npairs = _device_plan(counts_a, counts_b, pair,
                                          G.device)
    # the tile pairs' partial slots, then S (Q, 3, D, D)
    work = torch.empty(npairs * 2 * Q * 3 + Q * 3 * D * D, dtype=G.dtype,
                       device=G.device)
    dB = torch.empty((Q, D, D), dtype=G.dtype, device=G.device)
    dprm = torch.empty((Q, 3), dtype=G.dtype, device=G.device)
    sfx = build.suffix("cross_kernel_bwd", G.dtype)
    fn = build.function(
        "cross_kernel_bwd", "cross_kernel_bwd_" + sfx,
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
        + [ctypes.c_int64] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )
    # pointers as plain ints (ctypes converts them by argtypes): the
    # wrapper's host time is the call's floor at the fx2007 shape
    build.check(fn(
        G.data_ptr(), xa.data_ptr(), xb.data_ptr(),
        None if alpha is None else alpha.data_ptr(), kinds.data_ptr(),
        masks.data_ptr(), prm.data_ptr(), B.data_ptr(), plan.data_ptr(),
        nta, ntb, npairs, int(pair), gt, work.data_ptr(),
        work.data_ptr() + npairs * 2 * Q * 3 * work.element_size(),
        build.ticket("cross_kernel_bwd", G.device).data_ptr(),
        dB.data_ptr(), dprm.data_ptr(), nb, P, Q, D,
        build.stream_ptr(G.device),
    ), "cross_kernel_bwd")
    # one count per tile launch (a slice of at most _MAX_Q kernels)
    cross_kernel_bwd.launches[sfx] += -(-Q // _MAX_Q)
    return dB, dprm


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

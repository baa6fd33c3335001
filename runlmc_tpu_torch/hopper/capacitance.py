"""K2: the Woodbury capacitance matrix, and its backward.

    C = I + sum_d eps_d^-1 F_{a,d}^T G_{ab,d} F_{b,d}   (block (a, b))

for the groups' lower Cholesky factors F_g (k_g = D m_g rows; F_{g,d}
its rows d m_g .. (d+1) m_g - 1), the per-output noise eps and the
interpolation grams G_{ab,d} = W_{a,d}^T W_{b,d} (``WtW`` for a == b).
Replaces runlmc_tpu/lmc/woodbury.py:260-298 (``diag_block`` /
``cross_block`` of ``build_device_woodbury``). C is a function of
tril(F): entries above F's diagonal are not read.

The CUDA kernels (``csrc/capacitance.cu``) skip what the dense product
would multiply by zero: F_{g,d}'s columns past (d+1) m_g, G's zero tiles
(the host plan :func:`tile_plan`, made once per grid) and C's upper
triangle (mirrored). Stage 1 forms T_{ab,d} = G_{ab,d} F_{b,d}, stage 2
C's 64 x 64 lower tiles from a host work list sorted deepest first
(:func:`cap_work`), which persistent CTAs take in turn; each tile sums
over d in a fixed order, no atomics. Their launches count once per C
(``capacitance``) and once per backward (``capacitance_bwd``).

The backward, with S = Cbar + Cbar^T and T_{a.,d} = [T_{ab,d}]_b,

    Y_{a,d}        = T_{a.,d} S[:, cols of a]
    Fbar_{a,d}     = eps_d^-1 Y_{a,d}    (on F_a's lower triangle, 0 above)
    d(eps_d^-1)    = 1/2 sum_a <F_{a,d}, Y_{a,d}>,

is a kernel of its own on the 64 x 64 tiles of each F_{a,d} that reach
its lower triangle, deepest first (:func:`bwd_work`), after one pass that
forms S and before one that scales Y into Fbar and sums <F, Y> per 128 x
128 tile (a Cholesky backward reads only the lower triangle of its
cotangent, so the upper entries are not needed). T is kept from the
forward only when a gradient is wanted.
:class:`Capacitance` joins the two as one autograd function;
:func:`capacitance_plain` and :func:`capacitance_bwd_plain` are the
plain PyTorch versions, which the wrappers run for CPU tensors.

``grams[a][b]`` is the triple ``(G_ab, ptr, rblk)`` (an
``lmc.grid.Gram``): the stacked (D, m_a, m_b) gram and its tile plan.
"""

import ctypes

import numpy as np
import torch

from runlmc_tpu_torch.hopper import build

# the plan's tile of G: rows (the stage-1 output tile) by columns; the
# kernel checks that the wrapper passes its own values
PLAN_ROWS = 64
PLAN_COLS = 16
# stage 2's and the backward's tile, and the tile of the backward's
# d(eps^-1) partial sums
TILE = 64
PARTIAL_TILE = 128
# float32's stage-2 rows of F start where a 128-row tile's would, which
# keeps C's rounding whatever the tile (the kernel's kAnchor)
ANCHOR = 128
# the most groups a backward takes (the kernel's Groups::kMax)
MAX_GROUPS = 8


def tile_plan(G):
    """The nonzero (PLAN_ROWS, PLAN_COLS) tiles of each G[d] of a stacked
    (D, m_a, m_b) host gram, as CSR over (d, row block): ``ptr``
    (D * ceil(m_a / PLAN_ROWS) + 1,) and the column-block indices
    ``rblk``, both int32."""
    G = np.asarray(G)
    D, ma, mb = G.shape
    npb, nrb = -(-ma // PLAN_ROWS), -(-mb // PLAN_COLS)
    nz = np.zeros((D, npb * PLAN_ROWS, nrb * PLAN_COLS), dtype=bool)
    nz[:, :ma, :mb] = G != 0
    nz = nz.reshape(D, npb, PLAN_ROWS, nrb, PLAN_COLS).any(axis=(2, 4))
    nz = nz.reshape(D * npb, nrb)
    ptr = np.zeros(D * npb + 1, dtype=np.int64)
    np.cumsum(nz.sum(axis=1), out=ptr[1:])
    return ptr.astype(np.int32), np.nonzero(nz)[1].astype(np.int32)


def cap_rows(k0, ma, D, anchor):
    """[(d, imin)] of a stage-2 tile whose first row of C is ``k0``: the
    d whose F_{a,d} reaches it, ascending, each from row imin of F_{a,d}
    (rows start where the ``anchor``-row block of k0 starts)."""
    a = k0 // anchor * anchor
    return [(d, max(0, a - d * ma)) for d in range(a // ma, D)]


def cap_work(ka, kb, ma, D, diag, tile, anchor):
    """Stage 2's work list of block (a, b): (ntiles, 2) int32 rows
    (tk, tl) of C's lower tiles (every tile when not ``diag``), deepest
    first (sum_d (m_a - imin_d) rows), then by tk and tl."""
    nk, nl = -(-ka // tile), -(-kb // tile)
    depth = [sum(ma - i for _, i in cap_rows(tk * tile, ma, D, anchor))
             for tk in range(nk)]
    tiles = [(tk, tl) for tk in range(nk)
             for tl in range(tk + 1 if diag else nl)]
    tiles.sort(key=lambda t: (-depth[t[0]], t[0], t[1]))
    return np.asarray(tiles, dtype=np.int32).reshape(-1, 2)


def bwd_work(ks, ms, a, D):
    """The backward's work list of group a: (ntiles, 3) int32 rows (d,
    pb, qb) of the TILE x TILE tiles of each F_{a,d} that reach F's
    lower triangle, deepest first (sum_g min(k_g, (d+1) m_g) rows), then
    by d, pb, qb."""
    ka, ma, t = ks[a], ms[a], TILE
    rows = []
    for d in range(D):
        depth = sum(min(k, (d + 1) * m) for k, m in zip(ks, ms))
        for pb in range(-(-ma // t)):
            plast = min(pb * t + t, ma) - 1
            for qb in range(-(-ka // t)):
                if qb * t <= d * ma + plast:
                    rows.append((-depth, d, pb, qb))
    rows.sort()
    return np.asarray([r[1:] for r in rows], dtype=np.int32).reshape(-1, 3)


_WORK = {}


def _device_work(key, dev, make):
    """A work list on ``dev``, made once per key and device."""
    key = key + (str(dev),)
    if key not in _WORK:
        _WORK[key] = torch.as_tensor(make(), device=dev)
    return _WORK[key]


def _layout(inv_eps, Fs):
    D = inv_eps.shape[0]
    ks = [int(F.shape[0]) for F in Fs]
    for F, k in zip(Fs, ks):
        if F.dim() != 2 or F.shape[1] != k or k % D:
            raise ValueError("capacitance: each F must be square with D*m "
                             "rows, got %s for D=%d" % (tuple(F.shape), D))
    ms = [k // D for k in ks]
    offs = [int(o) for o in np.cumsum([0] + ks[:-1])]
    return D, ks, ms, offs, sum(ks)


def _d_blocks(F, D, m):
    """tril(F) as (D, m, k): the row blocks F_d."""
    return torch.tril(F).reshape(D, m, F.shape[1])


def capacitance_plain(grams, inv_eps, Fs):
    """Plain version: ``(C, Ts)``, Ts[a] = [G_ab tril(F_b)_d]_b stacked as
    (D, m_a, k); C's lower triangle from sum_d eps_d^-1 F_{a,d}^T T_{a.,d},
    mirrored, plus I."""
    D, ks, ms, offs, k = _layout(inv_eps, Fs)
    Fd = [_d_blocks(F, D, m) for F, m in zip(Fs, ms)]
    Ts = [torch.cat([torch.matmul(grams[a][b][0], Fd[b])
                     for b in range(len(Fs))], dim=-1)
          for a in range(len(Fs))]
    rows = [(Fd[a] * inv_eps[:, None, None]).reshape(ks[a], ks[a]).T
            @ Ts[a].reshape(ks[a], k) for a in range(len(Fs))]
    C = torch.cat(rows, dim=0)
    C = torch.tril(C) + torch.tril(C, -1).T
    return C + torch.eye(k, dtype=C.dtype, device=C.device), Ts


def capacitance_bwd_plain(grams, inv_eps, Fs, Ts, Cbar):
    """Plain version of the backward: ``(d inv_eps, [d F_a])``."""
    D, ks, ms, offs, k = _layout(inv_eps, Fs)
    S = Cbar + Cbar.T
    d_inv = torch.zeros_like(inv_eps)
    Fbars = []
    for a, F in enumerate(Fs):
        Y = torch.matmul(Ts[a], S[:, offs[a]:offs[a] + ks[a]])
        Y = torch.tril(Y.reshape(ks[a], ks[a])).reshape(D, ms[a], ks[a])
        d_inv = d_inv + 0.5 * torch.sum(_d_blocks(F, D, ms[a]) * Y,
                                        dim=(1, 2))
        Fbars.append((Y * inv_eps[:, None, None]).reshape(ks[a], ks[a]))
    return d_inv, Fbars


def _strides(F):
    """(F, row stride, column stride): F as it is when row- or
    column-major, else a row-major copy."""
    if not (F.is_contiguous() or F.mT.is_contiguous()):
        F = F.contiguous()
    return F, F.stride(0), F.stride(1)


def _check(grams, inv_eps, Fs):
    if inv_eps.dim() != 1:
        raise ValueError("capacitance: inv_eps must be (D,)")
    build.suffix("capacitance", inv_eps.dtype)
    for F in Fs:
        if F.dtype != inv_eps.dtype or F.device != inv_eps.device:
            raise ValueError("capacitance: F and inv_eps must share dtype "
                             "and device")
    if len(grams) != len(Fs) or any(len(r) != len(Fs) for r in grams):
        raise ValueError("capacitance: grams must be a (groups, groups) "
                         "nest of (G, ptr, rblk)")


def capacitance(grams, inv_eps, Fs):
    """``(C, Ts)``: the capacitance matrix (k, k) and the stage-1
    products T (kept for the backward); the CUDA kernels for CUDA
    tensors. Not differentiable: see :func:`capacitance_matrix`."""
    _check(grams, inv_eps, Fs)
    if build.use_plain("capacitance", inv_eps):
        return capacitance_plain(grams, inv_eps, Fs)
    D, ks, ms, offs, k = _layout(inv_eps, Fs)
    dtype, dev = inv_eps.dtype, inv_eps.device
    inv_eps = inv_eps.contiguous()
    placed = [_strides(F) for F in Fs]
    sfx = build.suffix("capacitance", dtype)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    gram_apply = build.function(
        "capacitance", "k2_gram_apply_" + sfx,
        [p, i32, i32, i32, p, i64, i64, i32, p, p, p, i64, i32, i32, i32, p])
    cap = build.function(
        "capacitance", "k2_cap_" + sfx,
        [p, i64, i64, i32, i32, i32, p, i64, i32, i32, p, p, i64, i32, i32,
         p, i32, p, p])
    Ts = [torch.empty((D, m, k), dtype=dtype, device=dev) for m in ms]
    C = torch.empty((k, k), dtype=dtype, device=dev)
    if k == 0:
        return C, Ts
    for a in range(len(Fs)):
        for b, (Fb, fsr, fsc) in enumerate(placed):
            G, ptr, rblk = grams[a][b]
            build.require_cuda("capacitance", inv_eps, G, ptr, rblk)
            if (G.dtype != dtype or tuple(G.shape) != (D, ms[a], ms[b])
                    or ptr.dtype != torch.int32 or rblk.dtype != torch.int32
                    or ptr.numel() != D * -(-ms[a] // PLAN_ROWS) + 1):
                raise ValueError("capacitance: gram (%d, %d) must be (D, "
                                 "m_a, m_b) in F's dtype with its int32 "
                                 "tile plan" % (a, b))
            build.check(gram_apply(
                build.ptr(G), D, ms[a], ms[b], build.ptr(Fb), fsr, fsc,
                ks[b], build.ptr(ptr), build.ptr(rblk), build.ptr(Ts[a]), k,
                offs[b], PLAN_ROWS, PLAN_COLS, build.stream_ptr()),
                "capacitance (gram apply)")
    ticket = torch.empty(len(Fs) * (len(Fs) + 1) // 2, dtype=torch.int32,
                         device=dev)
    anchor = ANCHOR if dtype == torch.float32 else TILE
    n = 0
    for a, (Fa, fsr, fsc) in enumerate(placed):
        for b in range(a + 1):
            diag = a == b
            key = ("cap", ks[a], ks[b], ms[a], D, diag, anchor)
            work = _device_work(key, dev, lambda: cap_work(
                ks[a], ks[b], ms[a], D, diag, TILE, anchor))
            build.check(cap(
                build.ptr(Fa), fsr, fsc, ks[a], ms[a], D, build.ptr(Ts[a]),
                k, offs[b], ks[b], build.ptr(inv_eps), build.ptr(C), k,
                offs[a], int(diag), build.ptr(work), work.shape[0],
                build.ptr(ticket[n:]), build.stream_ptr()), "capacitance")
            n += 1
    capacitance.launches[sfx] += 1
    return C, Ts


def capacitance_bwd(grams, inv_eps, Fs, Ts, Cbar):
    """``(d inv_eps, [d F_a])`` from the cotangent ``Cbar`` of C and the
    forward's ``Ts``; the CUDA kernels for CUDA tensors."""
    _check(grams, inv_eps, Fs)
    if build.use_plain("capacitance_bwd", inv_eps):
        return capacitance_bwd_plain(grams, inv_eps, Fs, Ts, Cbar)
    D, ks, ms, offs, k = _layout(inv_eps, Fs)
    dtype, dev = inv_eps.dtype, inv_eps.device
    if Cbar.shape != (k, k) or Cbar.dtype != dtype:
        raise ValueError("capacitance_bwd: Cbar must be (k, k) in F's dtype")
    Cbar, inv_eps = Cbar.contiguous(), inv_eps.contiguous()
    build.require_cuda("capacitance_bwd", Cbar, inv_eps, *Ts)
    sfx = build.suffix("capacitance_bwd", dtype)
    if len(Fs) > MAX_GROUPS:
        raise ValueError("capacitance_bwd: at most %d groups, got %d"
                         % (MAX_GROUPS, len(Fs)))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ip = ctypes.POINTER(i32)
    bwd = build.function(
        "capacitance", "k2_cap_bwd_" + sfx,
        [p, i64, i64, i32, i32, i32, p, i64, p, i64, i32, i32, ip, ip, ip,
         p, p, p, i64, p, i32, p, p])
    sym = build.function("capacitance", "k2_sym_" + sfx, [p, i32, p, p])
    red = build.function("capacitance", "k2_eps_reduce_" + sfx,
                         [p, i32, i32, i32, p, p])
    S = torch.empty((k, k), dtype=dtype, device=dev)
    build.check(sym(build.ptr(Cbar), k, build.ptr(S), build.stream_ptr()),
                "capacitance_bwd (S)")
    tiles = max(-(-kk // PARTIAL_TILE) * -(-m // PARTIAL_TILE)
                for kk, m in zip(ks, ms))
    partial = torch.zeros((len(Fs), D, tiles), dtype=dtype, device=dev)
    ticket = torch.empty(len(Fs), dtype=torch.int32, device=dev)
    ng = len(Fs)
    arr = ctypes.c_int * ng
    goff, gk, gm = arr(*offs), arr(*ks), arr(*ms)
    Fbars = []
    for a, F in enumerate(Fs):
        Fa, fsr, fsc = _strides(F)
        work = _device_work(("bwd", tuple(ks), tuple(ms), a, D), dev,
                            lambda: bwd_work(ks, ms, a, D))
        Fbar = torch.empty((ks[a], ks[a]), dtype=dtype, device=dev)
        build.check(bwd(
            build.ptr(Fa), fsr, fsc, ks[a], ms[a], D, build.ptr(Ts[a]), k,
            build.ptr(S), k, offs[a], ng, goff, gk, gm, build.ptr(inv_eps),
            build.ptr(Fbar), build.ptr(partial[a]), tiles, build.ptr(work),
            work.shape[0], build.ptr(ticket[a:]), build.stream_ptr()),
            "capacitance_bwd")
        Fbars.append(Fbar)
    d_inv = torch.empty(D, dtype=dtype, device=dev)
    build.check(red(build.ptr(partial), ng, D, tiles, build.ptr(d_inv),
                    build.stream_ptr()), "capacitance_bwd (reduce)")
    capacitance_bwd.launches[sfx] += 1
    return d_inv, Fbars


capacitance.launches = build.counter()
capacitance_bwd.launches = build.counter()


class Capacitance(torch.autograd.Function):
    """C as a differentiable function of ``inv_eps`` and the factors
    ``Fs``, with the backward of the module docstring."""

    @staticmethod
    def forward(ctx, grams, inv_eps, *Fs):
        C, Ts = capacitance(grams, inv_eps, Fs)
        ctx.grams = grams
        ctx.save_for_backward(inv_eps, *Fs, *Ts)
        return C

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, Cbar):
        saved = ctx.saved_tensors
        ng = (len(saved) - 1) // 2
        inv_eps, Fs, Ts = saved[0], saved[1:1 + ng], saved[1 + ng:]
        d_inv, Fbars = capacitance_bwd(ctx.grams, inv_eps, Fs, Ts, Cbar)
        return (None, d_inv if ctx.needs_input_grad[1] else None,
                *(fb if need else None
                  for fb, need in zip(Fbars, ctx.needs_input_grad[2:])))


def capacitance_matrix(grams, inv_eps, Fs):
    """The capacitance matrix C (k, k), differentiable in ``inv_eps`` and
    ``Fs`` through :class:`Capacitance` when a gradient is wanted (then
    T is kept for the backward); otherwise the forward alone."""
    if torch.is_grad_enabled() and (
            inv_eps.requires_grad or any(F.requires_grad for F in Fs)):
        return Capacitance.apply(grams, inv_eps, *Fs)
    return capacitance(grams, inv_eps, Fs)[0]

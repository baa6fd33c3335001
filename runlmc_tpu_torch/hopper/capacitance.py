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
one lower tile of C per CTA with its sum over d in a fixed order; no
atomics. Their launches count once per C (``capacitance``) and once per
backward (``capacitance_bwd``).

The backward, with S = Cbar + Cbar^T and T_{a.,d} = [T_{ab,d}]_b,

    Y_{a,d}        = T_{a.,d} S[:, cols of a]
    Fbar_{a,d}     = eps_d^-1 Y_{a,d}    (on F_a's lower triangle, 0 above)
    d(eps_d^-1)    = 1/2 sum_a <F_{a,d}, Y_{a,d}>,

is a kernel of its own (a Cholesky backward reads only the lower
triangle of its cotangent, so the upper entries are not needed). T is
kept from the forward only when a gradient is wanted.
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
         p])
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
    for a, (Fa, fsr, fsc) in enumerate(placed):
        for b in range(a + 1):
            build.check(cap(
                build.ptr(Fa), fsr, fsc, ks[a], ms[a], D, build.ptr(Ts[a]),
                k, offs[b], ks[b], build.ptr(inv_eps), build.ptr(C), k,
                offs[a], int(a == b), build.stream_ptr()), "capacitance")
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
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    bm = build.function("capacitance", "k2_bwd_tile", [i32])(
        int(dtype == torch.float64))
    ip = ctypes.POINTER(i32)
    bwd = build.function(
        "capacitance", "k2_cap_bwd_" + sfx,
        [p, i64, i64, i32, i32, i32, p, i64, p, i64, i32, i32, ip, ip, ip, p,
         p, p, i64, p])
    red = build.function("capacitance", "k2_eps_reduce_" + sfx,
                         [p, i32, i32, i32, p, p])
    tiles = max(-(-kk // bm) * -(-m // bm) for kk, m in zip(ks, ms))
    partial = torch.zeros((len(Fs), D, tiles), dtype=dtype, device=dev)
    ng = len(Fs)
    arr = ctypes.c_int * ng
    goff, gk, gm = arr(*offs), arr(*ks), arr(*ms)
    Fbars = []
    for a, F in enumerate(Fs):
        Fa, fsr, fsc = _strides(F)
        Fbar = torch.empty((ks[a], ks[a]), dtype=dtype, device=dev)
        build.check(bwd(
            build.ptr(Fa), fsr, fsc, ks[a], ms[a], D, build.ptr(Ts[a]), k,
            build.ptr(Cbar), k, offs[a], ng, goff, gk, gm,
            build.ptr(inv_eps), build.ptr(Fbar), build.ptr(partial[a]),
            tiles, build.stream_ptr()), "capacitance_bwd")
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

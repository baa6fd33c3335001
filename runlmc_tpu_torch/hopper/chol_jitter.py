"""K3: the jittered Cholesky's equilibrate, jitter and de-scale, with
their backward: the hand part of runlmc_tpu/lmc/woodbury.py:60-124
(``chol_jittered``). The factorization between them stays cuSOLVER's
(``potrf``, in place on the prologue's buffer: ``hopper/potrf.py``,
through ``hopper/chol_vjp.py``'s ``cholesky_ex``), as the JAX package
leaves it to XLA; its VJP is the hand kernel of ``hopper/chol_vjp.py``.

    chol_prologue(A, scale, equilibrate, sd)  -> (M, s, sd)     K3a
    chol_descale(L, info, s)                  -> (O, flag)      K3b
    chol_descale_bwd(L, s, Obar)              -> (Lbar, sbar)
    chol_prologue_bwd(A, sd, Mbar, sbar, scale, equilibrate) -> Abar

With ``equilibrate`` the kept scale ``sd`` is s = rsqrt(max(|diag A|,
1e-30)) and M = (A_ij s_i) s_j + scale I; otherwise ``sd`` is the
one-element d = |mean(diag A)| and M = A + (scale d) I. ``sd`` is
computed on the first attempt (``sd=None``: inside the prologue's tiles
with equilibration, a one-CTA pre-pass in the same wrapper call
without) and passed to the later ones. ``s`` is a fresh copy of the kept
s, the differentiable s of one attempt (None without equilibration). On
the card the prologue writes M column-major (the storage potrf factors
in place) with zeros above the diagonal, which potrf leaves as the
factor's upper triangle; only the lower triangle enters the
factorization, and the backward takes M-bar as the cotangent of the
whole M, as the plain version (all of M) defines it. The epilogue reads
only L's lower triangle: it writes O = L / s[:, None] with zeros
above the diagonal (with ``s=None`` no copy: O is L) and returns the
flag: ``cholesky_ex``'s ``info``, which the kernel sets to -1 where an
entry of L's lower triangle is not finite, so that 0 means the attempt
succeeded.

:class:`CholPrologue` and :class:`CholDescale` are the two autograd
functions; ``woodbury.chol_jittered`` puts ``cholesky_ex`` between them.
The CUDA kernels (``csrc/chol_jitter.cu``) run for CUDA tensors; the
``*_plain`` functions beside them (torch ops, the backward as formulas)
for CPU tensors. Each wrapper counts one launch per call.
"""

import ctypes

import torch

from runlmc_tpu_torch.hopper import build

_TINY = 1e-30
# the backward's CTAs an SM that keep cross sums (as many as are resident
# at once): its scratch holds that many rows of n partials a
# multiprocessor, then n line sums
_PARTS_PER_SM = 2


def _check_square(what, *ts):
    n = ts[0].shape[0]
    for t in ts:
        if t.dim() != 2 or tuple(t.shape) != (n, n):
            raise ValueError("%s: expected (%d, %d) matrices, got %s"
                             % (what, n, n, tuple(t.shape)))
        if t.dtype != ts[0].dtype or t.device != ts[0].device:
            raise ValueError("%s: matrices differ in dtype or device" % what)
    build.suffix(what, ts[0].dtype)


def _order(X):
    """(X or a row-major copy, 1 if X is stored column-major else 0)."""
    if X.is_contiguous():
        return X, 0
    if X.mT.is_contiguous():
        return X, 1
    return X.contiguous(), 0


def _p(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _aligned(t):
    """``t``, or a copy in its storage order when it does not start on a
    16-byte boundary (the backward's line pass reads every line of its
    operands gcd(n, V) elements at a time from there)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scratch(n, dtype, device):
    """The backward's partial sums: (parts + 1) n elements and the count
    of partial rows ``parts``."""
    parts = _PARTS_PER_SM * torch.cuda.get_device_properties(
        device).multi_processor_count
    return torch.empty((parts + 1) * n, dtype=dtype, device=device), parts


def _fn(symbol, sfx, argtypes):
    return build.function("chol_jitter", "k3_%s_%s" % (symbol, sfx), argtypes)


_P, _I64, _I32, _F64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_double)


def chol_scale_plain(A, equilibrate):
    """The kept scale: s (n,) or d (1,)."""
    d0 = torch.diagonal(A)
    if equilibrate:
        return torch.rsqrt(torch.clamp(torch.abs(d0), min=_TINY))
    return torch.abs(torch.mean(d0)).reshape(1)


def chol_prologue_plain(A, scale, equilibrate, sd):
    """(M, s): the jittered (and equilibrated) matrix and a copy of s."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    if equilibrate:
        d = torch.ones((), dtype=A.dtype, device=A.device)
        return A * sd[:, None] * sd[None, :] + (scale * d) * eye, sd.clone()
    return A + (scale * sd.reshape(())) * eye, None


def chol_prologue(A, scale, equilibrate, sd=None):
    """``(M, s, sd)`` for one scale of the ladder; ``sd=None`` computes
    the kept scale first. ``A`` is row-major (A's upper triangle is not
    read on the card). On the card M comes back column-major: the plain
    version's lower triangle, bit for bit, and zeros above it."""
    _check_square("chol_prologue", A)
    if build.use_plain("chol_prologue", A):
        if sd is None:
            sd = chol_scale_plain(A, equilibrate)
        M, s = chol_prologue_plain(A, scale, equilibrate, sd)
        # column-major, as on the card (a tensor of its own, not a view:
        # CholeskyEx factors it in place), so LAPACK factors it in place
        Mc = torch.empty_strided(M.shape, (1, M.shape[0]), dtype=M.dtype)
        return Mc.copy_(M), s, sd
    n = A.shape[0]
    prepass = sd is None
    if prepass:
        sd = torch.empty(n if equilibrate else 1, dtype=A.dtype,
                         device=A.device)
    M = torch.empty_strided((n, n), (1, n), dtype=A.dtype, device=A.device)
    s = torch.empty_like(sd) if equilibrate else None
    build.require_cuda("chol_prologue", A, sd)
    sfx = build.suffix("chol_prologue", A.dtype)
    fn = _fn("prologue", sfx, [_P, _P, _P, _P, _I64, _I32, _F64, _I32, _P])
    build.check(fn(build.ptr(A), build.ptr(sd), build.ptr(M), _p(s), n,
                   int(bool(equilibrate)), float(scale), int(prepass),
                   build.stream_ptr()), "chol_prologue")
    chol_prologue.launches[sfx] += 1
    return M, s, sd


chol_prologue.launches = build.counter()


def chol_descale_plain(L, info, s):
    """(O, flag) from L's lower triangle: L / s[:, None] with zeros
    above the diagonal (L itself for ``s=None``) and ``info``, or -1
    where an entry of the lower triangle is not finite."""
    flag = torch.where(torch.isfinite(torch.tril(L)).all(), info,
                       -1).to(info.dtype)
    # tril_ in place keeps L's storage order, as the kernel does
    return (L if s is None else (L / s[:, None]).tril_()), flag


def chol_descale(L, info, s):
    """``(O, flag)`` of one attempt (module docstring). ``L`` is stored
    row-major or column-major, from a 16-byte boundary (as torch
    allocates); O is stored like it."""
    _check_square("chol_descale", L)
    if build.use_plain("chol_descale", L):
        return chol_descale_plain(L, info, s)
    n = L.shape[0]
    if not (L.is_contiguous() or L.mT.is_contiguous()):
        raise ValueError("chol_descale: L must be stored row-major or "
                         "column-major")
    if L.data_ptr() % 16:
        # O's lines must split at L's 16-byte boundaries
        raise ValueError("chol_descale: L must start on a 16-byte "
                         "boundary")
    if info.dtype != torch.int32 or info.numel() != 1:
        raise ValueError("chol_descale: info must be cholesky_ex's int32 "
                         "scalar")
    O = None if s is None else torch.empty_like(L)
    build.require_cuda("chol_descale", info,
                       *([] if s is None else [s]))
    sfx = build.suffix("chol_descale", L.dtype)
    fn = _fn("descale", sfx, [_P, _P, _P, _P, _I64, _I32, _P])
    build.check(fn(build.ptr(L), _p(s), _p(O), build.ptr(info), n,
                   int(not L.is_contiguous()), build.stream_ptr()),
                "chol_descale")
    chol_descale.launches[sfx] += 1
    return (L if O is None else O), info


chol_descale.launches = build.counter()


def chol_descale_bwd_plain(L, s, Obar):
    """(L-bar, s-bar) of O = L / s[:, None]."""
    return Obar / s[:, None], -torch.sum(Obar * L, dim=1) / (s * s)


def chol_descale_bwd(L, s, Obar):
    """``(Lbar, sbar)``: the epilogue's backward. ``Obar`` in either
    storage order; L-bar is stored like it."""
    _check_square("chol_descale_bwd", L, Obar)
    if build.use_plain("chol_descale_bwd", L):
        return chol_descale_bwd_plain(L, s, Obar)
    n = L.shape[0]
    Obar, ocol = _order(Obar)
    if not (L.is_contiguous() or L.mT.is_contiguous()):
        raise ValueError("chol_descale_bwd: L must be stored row-major or "
                         "column-major")
    Obar, L = _aligned(Obar), _aligned(L)
    Lbar = torch.empty_like(Obar)
    sbar = torch.empty_like(s)
    build.require_cuda("chol_descale_bwd", s)
    part, parts = _scratch(n, L.dtype, L.device)
    sfx = build.suffix("chol_descale_bwd", L.dtype)
    fn = _fn("descale_bwd", sfx, [_P, _I32, _P, _I32, _P, _P, _P, _P, _I32,
                                  _I64, _P])
    build.check(fn(build.ptr(Obar), ocol, build.ptr(L),
                   int(not L.is_contiguous()), build.ptr(s), build.ptr(Lbar),
                   build.ptr(sbar), build.ptr(part), parts, n,
                   build.stream_ptr()), "chol_descale_bwd")
    chol_descale_bwd.launches[sfx] += 1
    return Lbar, sbar


chol_descale_bwd.launches = build.counter()


def chol_prologue_bwd_plain(A, sd, Mbar, sbar, scale, equilibrate):
    """A-bar of the prologue, with s's own backward folded in."""
    if not equilibrate:
        g = (torch.sum(torch.diagonal(Mbar)) * scale) * torch.sign(
            torch.sum(torch.diagonal(A))) / A.shape[0]
        Abar = Mbar.clone()
        Abar.diagonal().add_(g)
        return Abar
    s = sd
    Abar = (Mbar * s[None, :]) * s[:, None]
    P = Mbar * A
    sb = torch.sum(P * s[None, :], dim=1) + torch.sum(P * s[:, None], dim=0)
    if sbar is not None:
        sb = sbar + sb
    a = torch.diagonal(A)
    g = torch.where(torch.abs(a) > _TINY, (-0.5 * sb * (s * s * s))
                    * torch.sign(a), torch.zeros_like(a))
    Abar.diagonal().add_(g)
    return Abar


def chol_prologue_bwd(A, sd, Mbar, sbar, scale, equilibrate):
    """A-bar from the cotangents of M and of the attempt's s (``sbar``,
    None for none). ``Mbar`` in either storage order; A-bar comes back
    row-major, like A."""
    _check_square("chol_prologue_bwd", A, Mbar)
    if build.use_plain("chol_prologue_bwd", A):
        return chol_prologue_bwd_plain(A, sd, Mbar, sbar, scale, equilibrate)
    n = A.shape[0]
    Mbar, mcol = _order(Mbar)
    A = A.contiguous()
    parts = 0
    if not equilibrate:
        # the diagonal term lands on M-bar's own storage
        Abar = torch.empty_like(Mbar)
        part = torch.empty(1, dtype=A.dtype, device=A.device)
    else:
        Mbar, A = _aligned(Mbar), _aligned(A)
        Abar = torch.empty_like(A)
        part, parts = _scratch(n, A.dtype, A.device)
        if sbar is not None:
            sbar = sbar.contiguous()
    build.require_cuda("chol_prologue_bwd", A, sd,
                       *([] if sbar is None else [sbar]))
    sfx = build.suffix("chol_prologue_bwd", A.dtype)
    fn = _fn("prologue_bwd", sfx, [_P, _I32, _P, _P, _P, _P, _P, _I32, _I64,
                                   _I32, _F64, _P])
    build.check(fn(build.ptr(Mbar), mcol, build.ptr(A), build.ptr(sd),
                   _p(sbar if equilibrate else None), build.ptr(Abar),
                   build.ptr(part), parts, n, int(bool(equilibrate)),
                   float(scale), build.stream_ptr()), "chol_prologue_bwd")
    chol_prologue_bwd.launches[sfx] += 1
    return Abar


chol_prologue_bwd.launches = build.counter()


class CholPrologue(torch.autograd.Function):
    """K3a as an autograd function: ``(M, s)`` with equilibration, ``M``
    without. ``kept`` (a dict) carries the kept scale from the first
    attempt of a ladder to the next ones."""

    @staticmethod
    def forward(ctx, A, scale, equilibrate, kept):
        M, s, sd = chol_prologue(A, scale, equilibrate, kept.get("sd"))
        kept["sd"] = sd
        ctx.save_for_backward(A)
        ctx.sd, ctx.scale, ctx.equilibrate = sd, scale, equilibrate
        return (M, s) if equilibrate else M

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, Mbar, sbar=None):
        (A,) = ctx.saved_tensors
        return (chol_prologue_bwd(A, ctx.sd, Mbar, sbar, ctx.scale,
                                  ctx.equilibrate), None, None, None)


class CholDescale(torch.autograd.Function):
    """K3b as an autograd function: ``(O, flag)``, differentiable in L
    and s."""

    @staticmethod
    def forward(ctx, L, s, info):
        O, flag = chol_descale(L, info, s)
        ctx.save_for_backward(L, s)
        ctx.mark_non_differentiable(flag)
        return O, flag

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, Obar, _flag_bar):
        L, s = ctx.saved_tensors
        Lbar, sbar = chol_descale_bwd(L, s, Obar)
        return Lbar, sbar, None

"""K10: the Fourier-space coregionalization contraction of an fft-mode
grid group, and its backward.

For operand spectra ``vf`` (B, D, F) (the rfftn of the zero-padded
operand, complex64 or complex128) the forward computes g (B, D, F):

    'sum'   g[b,d,f] = sum_q sum_e B[q,d,e] T[q,f] vf[b,e,f]
    'bt'    g[b,d,f] = sum_e S[d,e,f] vf[b,e,f]
    'slfm'  g[b,d,f] = sum_r A[d,r] T[r,f] sum_e A[e,r] vf[b,e,f]
                       + K[d,f] vf[b,d,f]

with ``mat`` the real B (Q, D, D) or A (D, R), ``sym`` the complex T
(Q or R, F) or S (D, D, F), and ``diag`` the complex K (D, F) of 'slfm'.
Replaces runlmc_tpu/lmc/grid.py:390-404 and XLA's autodiff of it. The
CUDA kernels are in ``csrc/fourier.cu`` (design and bound there).

The backward kernel computes the batch outer product

    H[d,e,f] = sum_b G[b,d,f] * conj(vf[b,e,f])

of the cotangent G of g; every parameter cotangent is a small einsum of
H. Torch's complex gradients follow the conjugate Wirtinger convention:
for g = S vf the cotangent of S is G conj(vf), and a real parameter
takes the real part. The operand's cotangent is the forward with the
conjugated, transposed symbol. :class:`FourierContract` joins the two
as one autograd function.

A Fourier range: both kernels take ``f0`` and read the operand
``vf`` (B, D, F) in place from frequency ``f0`` on, over the ``nf``
frequencies of the symbol they are given (the symbol and diag of the
range, ``nf`` wide), and write an ``nf``-wide result: the contraction of
one rank of a grid-sharded mesh (lmc/grid.py). The contraction is
pointwise in f, so a range's output is that slice of the full range's
to the bit; the full range (``f0 = 0``, ``nf = F``) is the default. The
plain versions of a range contract the whole width with the range's
symbol placed at [f0, f0 + nf) and zeros elsewhere, then keep the
range: torch's elementwise complex products round differently in the
vector body and the scalar tail of a loop on the CPU, so only the same
shapes give every frequency the operations it gets in the full
contraction.

The forward launches an instance specialised on small shapes where it
fits (:func:`fourier_instance`, from (rep, D, K) alone: the operand and
the symbol of a (b, f) in registers) and the generic kernel otherwise.
The instance gives the generic kernel's bits. The backward stages a
tile of frequencies of G and the operand in shared memory, in chunks of
batch rows through a ring of buffers, and forms all D^2 outputs of the
tile from there; :func:`bwd_tile` picks the tile and the chunk from the
shape and the card's SM count. Each output sums b from zero in
ascending order, so its bits do not depend on the tile or the chunk.
:func:`fourier_contract_plain` and :func:`fourier_contract_bwd_plain`
are the plain PyTorch versions, which the wrappers run for CPU tensors.
"""

import ctypes

import torch
from torch.profiler import record_function

from runlmc_tpu_torch.hopper import build

REPS = {"sum": 0, "bt": 1, "slfm": 2}
# forward instances (csrc/fourier.cu kGeneric, kSmall) and the largest
# (D, K) the small one takes: K is Q for 'sum' and R for 'slfm', and 'bt'
# has no K
GENERIC = 0
SMALL = 1
SMALL_MAX_D = 4
SMALL_MAX_K = 2
_SMEM_LIMIT = 48 * 1024
# the backward (csrc/fourier.cu kBwdThreads, kBwdSums, kBwdStages):
# threads a CTA, running sums a thread, buffers in its ring; the tile
# widths it takes, widest first; the bytes of a chunk's stage (its batch
# rows of G and of the operand); the card's opt-in shared memory a CTA
BWD_THREADS = 128
BWD_SUMS = 8
BWD_STAGES = 4
BWD_TILES = (32, 16, 8, 4, 2, 1)
BWD_STAGE_BYTES = 8 * 1024
BWD_SMEM_OPTIN = 232448
SMS = build.H100_SMS
# the profiler range of FourierContract's backward
BWD_RANGE = "fourier.FourierContract.backward"
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def _range(what, vf, nf, f0):
    """The operand's frequencies [f0, f0 + nf), checked."""
    F = vf.shape[-1]
    if not 0 <= f0 <= F - nf:
        raise ValueError("%s: the range [%d, %d) is outside the operand's "
                         "%d frequencies" % (what, f0, f0 + nf, F))
    return vf[..., f0:f0 + nf]


def _embed(t, f0, F):
    """``t`` at [f0, f0 + nf) of its last axis, zero elsewhere, F wide."""
    if t is None or t.shape[-1] == F:
        return t
    full = t.new_zeros(t.shape[:-1] + (F,))
    full[..., f0:f0 + t.shape[-1]] = t
    return full


def fourier_contract_plain(rep, vf, mat, sym, diag=None, f0=0):
    """Plain version: the einsums of the XLA code, on the operand's
    frequencies from ``f0`` over the symbol's (the whole width, then the
    range)."""
    F, nf = vf.shape[-1], sym.shape[-1]
    _range("fourier_contract", vf, nf, f0)
    if nf != F:
        return fourier_contract_plain(rep, vf, mat, _embed(sym, f0, F),
                                      _embed(diag, f0, F))[..., f0:f0 + nf]
    if rep == "sum":
        return torch.einsum("qde,qf,bef->bdf", mat.to(vf.dtype), sym, vf)
    if rep == "bt":
        return torch.einsum("def,bef->bdf", sym, vf)
    if rep == "slfm":
        A = mat.to(vf.dtype)
        proj = torch.einsum("dr,bdf->brf", A, vf) * sym
        return torch.einsum("dr,brf->bdf", A, proj) + diag * vf
    raise ValueError("unknown representation %r" % (rep,))


def fourier_instance(rep, D, K):
    """The forward's instance for ``rep`` at D outputs and K = Q ('sum')
    or R ('slfm'; 0 for 'bt'): a pure function of the three."""
    if D <= SMALL_MAX_D and (rep == "bt" or K <= SMALL_MAX_K):
        return SMALL
    return GENERIC


def _real_suffix(what, t):
    if t.dtype not in _REAL:
        raise ValueError("%s: complex64 or complex128 only, got %s"
                         % (what, t.dtype))
    return build.suffix(what, _REAL[t.dtype])


def fourier_contract(rep, vf, mat, sym, diag=None, f0=0):
    """g (B, D, nf) from ``vf`` (B, D, F) and the symbol of ``rep`` over
    its ``nf`` frequencies (``sym.shape[-1]``), the operand read from
    frequency ``f0``; the CUDA kernel for CUDA tensors."""
    if build.use_plain("fourier_contract", vf):
        return fourier_contract_plain(rep, vf, mat, sym, diag, f0)
    if rep not in REPS:
        raise ValueError("unknown representation %r" % (rep,))
    sfx = _real_suffix("fourier_contract", vf)
    nb, D, ldv = vf.shape
    F = sym.shape[-1]
    _range("fourier_contract", vf, F, f0)
    if rep == "sum":
        K = mat.shape[0]
        ok = mat.shape == (K, D, D) and sym.shape == (K, F)
        nmat = K * D * D
    elif rep == "bt":
        K = 0
        ok = sym.shape == (D, D, F)
        nmat = 0
    else:
        K = mat.shape[1]
        ok = (mat.shape == (D, K) and sym.shape == (K, F)
              and diag is not None and diag.shape == (D, F))
        nmat = D * K
    tensors = [vf, sym] + ([mat] if rep != "bt" else []) + (
        [diag] if rep == "slfm" else [])
    if (not ok or sym.dtype != vf.dtype
            or (rep != "bt" and mat.dtype != _REAL[vf.dtype])
            or (rep == "slfm" and diag.dtype != vf.dtype)):
        raise ValueError("fourier_contract: %s operand %s and symbol %s "
                         "disagree" % (rep, tuple(vf.shape),
                                       tuple(sym.shape)))
    if nmat * vf.element_size() // 2 > _SMEM_LIMIT:
        raise ValueError("fourier_contract: the %s coregionalization "
                         "matrices exceed the kernel's shared memory" % rep)
    # a conjugated view (``sym.conj()`` of the operand's cotangent) only
    # sets a bit: the kernel reads memory, so materialize it
    tensors = [t.resolve_conj().contiguous() for t in tensors]
    vf, sym = tensors[0], tensors[1]
    mat = tensors[2] if rep != "bt" else None
    diag = tensors[3] if rep == "slfm" else None
    build.require_cuda("fourier_contract", *tensors)
    g = torch.empty((nb, D, F), dtype=vf.dtype, device=vf.device)
    fn = build.function("fourier", "fourier_fwd_" + sfx, _FWD_ARGS)
    if nb:
        build.check(fn(REPS[rep], fourier_instance(rep, D, K),
                       vf.data_ptr(),
                       g.data_ptr(), None if mat is None else mat.data_ptr(),
                       sym.data_ptr(),
                       None if diag is None else diag.data_ptr(),
                       nb, D, K, F, f0, ldv, build.stream_ptr()),
                    "fourier_contract")
        fourier_contract.launches[sfx] += 1
    return g


_FWD_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])
fourier_contract.launches = build.counter()


def fourier_contract_bwd_plain(G, vf, f0=0):
    F, nf = vf.shape[-1], G.shape[-1]
    _range("fourier_contract_bwd", vf, nf, f0)
    H = torch.einsum("bdf,bef->def", _embed(G, f0, F), vf.conj())
    return H if nf == F else H[..., f0:f0 + nf]


def bwd_tile(nb, D, F, dtype, sms=SMS):
    """(tile, chunk) of the backward at ``nb`` batch rows, D outputs and
    F frequencies in ``dtype`` (complex64 or complex128) on a card of
    ``sms`` SMs: the widest of ``BWD_TILES`` whose D^2 outputs a CTA's
    ``BWD_SUMS`` running sums a thread hold (the narrowest past that)
    and that gives every SM a CTA (else the narrowest such), and the
    batch rows whose G and operand rows fill ``BWD_STAGE_BYTES`` (at
    least one, at most ``nb``); a pure function of the five."""
    item = 16 if dtype == torch.complex128 else 8
    fits = [t for t in BWD_TILES if D * D * t <= BWD_SUMS * BWD_THREADS]
    fits = fits or [BWD_TILES[-1]]
    tile = next((t for t in fits if -(-F // t) >= sms), fits[-1])
    return tile, max(1, min(nb, BWD_STAGE_BYTES // (2 * D * tile * item)))


def bwd_smem(nb, D, tile, chunk, dtype):
    """Shared-memory bytes a CTA of the backward takes (csrc/fourier.cu
    launch_bwd_sums): a buffer of ``chunk`` rows a chunk of ``nb``, at
    most ``BWD_STAGES``."""
    item = 16 if dtype == torch.complex128 else 8
    nst = min(max(-(-nb // chunk), 1), BWD_STAGES)
    return nst * 2 * chunk * D * tile * item


def fourier_contract_bwd(G, vf, f0=0):
    """H (D, D, nf) = sum_b G[b,d,f] conj(vf[b,e,f0+f]) for the cotangent
    G (B, D, nf) of a range's output and the whole operand ``vf``
    (B, D, F); the CUDA kernel for CUDA tensors."""
    if build.use_plain("fourier_contract_bwd", G):
        return fourier_contract_bwd_plain(G, vf, f0)
    sfx = _real_suffix("fourier_contract_bwd", G)
    nb, D, F = G.shape
    ldv = vf.shape[-1]
    if vf.shape[:2] != G.shape[:2] or vf.dtype != G.dtype:
        raise ValueError("fourier_contract_bwd: cotangent %s and operand %s "
                         "disagree" % (tuple(G.shape), tuple(vf.shape)))
    _range("fourier_contract_bwd", vf, F, f0)
    tile, chunk = bwd_tile(nb, D, F, G.dtype,
                           sms=build.sm_count(G.get_device()))
    if bwd_smem(nb, D, tile, chunk, G.dtype) > BWD_SMEM_OPTIN:
        raise ValueError("fourier_contract_bwd: D = %d exceeds the kernel's "
                         "shared memory" % D)
    G, vf = G.resolve_conj().contiguous(), vf.resolve_conj().contiguous()
    build.require_cuda("fourier_contract_bwd", G, vf)
    H = torch.empty((D, D, F), dtype=G.dtype, device=G.device)
    fn = build.function(
        "fourier", "fourier_bwd_" + sfx,
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    )
    build.check(fn(build.ptr(G), build.ptr(vf), build.ptr(H), nb, D, F, f0,
                   ldv, tile, chunk, build.stream_ptr()),
                "fourier_contract_bwd")
    fourier_contract_bwd.launches[sfx] += 1
    return H


fourier_contract_bwd.launches = build.counter()


def symbol_grads(rep, H, mat, sym):
    """Cotangents of ``(mat, sym, diag)`` from H (D, D, F)."""
    if rep == "sum":
        dmat = torch.einsum("qf,def->qde", sym.conj(), H).real
        dsym = torch.einsum("qde,def->qf", mat.to(H.dtype), H)
        return dmat, dsym, None
    if rep == "bt":
        return None, H, None
    A = mat.to(H.dtype)
    dsym = torch.einsum("dr,er,def->rf", A, A, H)
    tc = sym.conj()
    dmat = (torch.einsum("rf,er,kef->kr", tc, A, H)
            + torch.einsum("rf,dr,dkf->kr", tc, A, H)).real
    ddiag = torch.diagonal(H, dim1=0, dim2=1).T
    return dmat, dsym, ddiag


def adjoint_symbol(rep, mat, sym, diag):
    """The symbol of the operand's cotangent map G -> conj(M)^T G."""
    if rep == "sum":
        return mat.transpose(1, 2), sym.conj(), None
    if rep == "bt":
        return None, sym.transpose(0, 1).conj(), None
    return mat, sym.conj(), diag.conj()


class FourierContract(torch.autograd.Function):
    """K10 with its hand-written backward: forward
    :func:`fourier_contract`, backward :func:`fourier_contract_bwd` and
    the einsums of :func:`symbol_grads`, under the profiler range
    ``BWD_RANGE``. On a range (``f0``, the symbol's width) the operand's
    cotangent is zero outside it."""

    @staticmethod
    def forward(ctx, rep, vf, mat, sym, diag, f0):
        ctx.rep, ctx.f0 = rep, f0
        ctx.save_for_backward(vf, mat, sym, diag)
        return fourier_contract(rep, vf, mat, sym, diag, f0)

    @staticmethod
    def backward(ctx, G):
        with record_function(BWD_RANGE):
            vf, mat, sym, diag = ctx.saved_tensors
            rep, f0 = ctx.rep, ctx.f0
            need = ctx.needs_input_grad
            dv = dmat = dsym = ddiag = None
            if any(need[2:5]):
                H = fourier_contract_bwd(G.contiguous(), vf, f0)
                dmat, dsym, ddiag = symbol_grads(rep, H, mat, sym)
            if need[1]:
                dv = _embed(fourier_contract(
                    rep, G.contiguous(), *adjoint_symbol(rep, mat, sym, diag)),
                    f0, vf.shape[-1])
            return (None, dv,
                    dmat if need[2] else None,
                    dsym if need[3] else None,
                    ddiag if need[4] else None, None)


def contract(rep, vf, mat, sym, diag=None, f0=0):
    """Differentiable K10 (``mat`` None for 'bt', ``diag`` only for
    'slfm'), on the symbol's frequencies from the operand's ``f0``."""
    return FourierContract.apply(rep, vf, mat, sym, diag, f0)

"""Symmetric block-Toeplitz-with-Toeplitz-blocks (BTTB) helpers (parity:
runlmc_tpu/ops/bttb.py:35-172, 243-263).

A symmetric P-level BTTB matrix over a grid of per-axis sizes ``sizes``
is fully described by its first row ``top`` (length ``prod(sizes)``).
Dense grid mode materializes it through the index map (kernel K1's
plain version gathers through :func:`bttb_index_map`). The fft grid
mode embeds it into a P-dimensional circulant of per-axis size
``next_pow2(2 * n_p)`` and applies it in O(m log m): the symbol
``bttb_fft`` (kernel K11 of the kernel table) is a flip and concat of
the (Q, m) first rows and one ``torch.fft.rfftn``; the operand goes
through ``operand_fft``/``operand_ifft``, a zero-padded rfftn and the
cropped irfftn (cuFFT on the card). The model's fft groups write the
embedding with k(r) itself in one hand kernel (K8,
``hopper/kern_rows_fft.py``) and take its ``extension_fft``; the
transforms stay cuFFT's. Everything here is differentiable by torch
autograd down to ``top``.
"""

import numpy as np
import torch


def next_pow2(x):
    """Smallest power of two >= x (python int)."""
    return 1 << (int(x) - 1).bit_length()


def extension_sizes(sizes):
    """Per-axis circulant embedding sizes: next_pow2(2 * n_p)."""
    return tuple(next_pow2(2 * int(s)) for s in sizes)


def rfft_len(ext_sizes):
    """Length of the last axis after rfftn."""
    return ext_sizes[-1] // 2 + 1


def fourier_shape(sizes):
    """Shape of the rfftn of one embedded grid vector."""
    ext = extension_sizes(sizes)
    return ext[:-1] + (rfft_len(ext),)


def cyclic_extend(top, sizes):
    """Symmetric circulant embedding of a (batched) first row: (...,
    prod(sizes)) -> (..., *ext_sizes), each grid axis laid out as
    ``[t_0..t_{n-1}, 0...0, t_{n-1}..t_1]``."""
    sizes = tuple(int(s) for s in sizes)
    ext = extension_sizes(sizes)
    batch = top.shape[:-1]
    x = top.reshape(batch + sizes)
    for axis_off, (n, m) in enumerate(zip(sizes, ext)):
        axis = len(batch) + axis_off
        mirror = torch.flip(x.narrow(axis, 1, n - 1), dims=(axis,))
        pad_shape = list(x.shape)
        pad_shape[axis] = m - n - (n - 1)
        zeros = torch.zeros(pad_shape, dtype=top.dtype, device=top.device)
        x = torch.cat([x, zeros, mirror], dim=axis)
    return x


def extension_fft(ext, ndim):
    """rfftn over the last ``ndim`` axes of a circulant embedding
    (:func:`cyclic_extend`'s output): the Fourier symbol."""
    return torch.fft.rfftn(ext, dim=tuple(range(ext.ndim - ndim, ext.ndim)))


def bttb_fft(top, sizes):
    """rfftn of the circulant embedding of (batched) ``top``: the
    operator's Fourier symbol, (..., *fourier_shape)."""
    sizes = tuple(int(s) for s in sizes)
    return extension_fft(cyclic_extend(top, sizes), len(sizes))


def operand_fft(v, sizes):
    """Zero-padded rfftn of a (batched) grid vector: (..., prod(sizes))
    -> (..., *fourier_shape)."""
    sizes = tuple(int(s) for s in sizes)
    ext = extension_sizes(sizes)
    batch = v.shape[:-1]
    x = v.reshape(batch + sizes)
    dims = tuple(range(len(batch), len(batch) + len(sizes)))
    return torch.fft.rfftn(x, s=ext, dim=dims)


def operand_ifft(vhat, sizes):
    """Inverse of :func:`operand_fft` followed by the crop to the grid:
    (..., *fourier_shape) -> (..., prod(sizes))."""
    sizes = tuple(int(s) for s in sizes)
    ext = extension_sizes(sizes)
    nbatch = vhat.ndim - len(sizes)
    dims = tuple(range(nbatch, vhat.ndim))
    full = torch.fft.irfftn(vhat, s=ext, dim=dims)
    crop = tuple([slice(None)] * nbatch + [slice(0, n) for n in sizes])
    return full[crop].reshape(vhat.shape[:nbatch] + (int(np.prod(sizes)),))


def bttb_matvec(symbol_fft, v, sizes):
    """Matvec of a symmetric BTTB matrix given its Fourier symbol;
    leading batch axes of ``symbol_fft`` and ``v`` broadcast."""
    return operand_ifft(symbol_fft * operand_fft(v, sizes), sizes)


def bttb_matvec_from_top(top, v, sizes):
    """One-shot matvec from the first row."""
    return bttb_matvec(bttb_fft(top, sizes), v, sizes)


def bttb_dense(top, sizes):
    """The dense matrix, by applying the FFT matvec to the identity
    (a test oracle, O(m^2 log m))."""
    m = int(np.prod(tuple(int(s) for s in sizes)))
    eye = torch.eye(m, dtype=top.dtype, device=top.device)
    return bttb_matvec_from_top(top, eye, sizes).T


def bttb_index_map(sizes):
    """(m, m) int32 map from (i, j) to the flattened first-row index of a
    symmetric BTTB matrix: entry (i, j) equals ``top[idx_map[i, j]]``
    with offset sum_d |i_d - j_d| * stride_d. Host-side; the plain
    version of kernel K1 gathers through it (the kernel itself computes
    the offsets in place)."""
    sizes = tuple(int(s) for s in sizes)
    m = int(np.prod(sizes))
    idx = np.zeros((m, m), dtype=np.int64)
    stride = m
    for n in sizes:
        stride //= n
        c = (np.arange(m) // stride) % n  # this dim's coordinate
        idx += np.abs(c[:, None] - c[None, :]) * stride
    return idx.astype(np.int32)


def toeplitz_eig_upper_bound(top):
    """Gershgorin upper bound on the eigenvalues of a symmetric Toeplitz
    matrix: the largest absolute row sum, in O(n) with prefix sums
    (parity: runlmc_tpu/ops/bttb.py:243-251; 0 for an empty ``top``, where
    the JAX package's version indexes past the end)."""
    a = np.abs(np.asarray(top))
    if not len(a):
        return 0.0
    prefix = np.cumsum(a)
    return float((prefix + prefix[::-1] - a[0]).max())


def bttb_eig_upper_bound(top, sizes):
    """Upper bound 2^P * sum|top| on the eigenvalues of a symmetric BTTB
    matrix.

    Reference quirk, matched on purpose: the bound is loose — every
    row's absolute sum is bounded by the sum over the full signed-offset
    lattice — where a Gershgorin row maximum would be tighter
    (runlmc_tpu/ops/bttb.py:254-263). It serves conditioning
    diagnostics only."""
    p = len(tuple(sizes))
    return float((2**p) * np.abs(np.asarray(top)).sum())

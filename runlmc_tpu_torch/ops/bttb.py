"""Symmetric block-Toeplitz-with-Toeplitz-blocks (BTTB) helpers needed by
dense grid mode (parity: runlmc_tpu/ops/bttb.py:152-172, 254-263).

The fft-mode pieces (``cyclic_extend``, ``bttb_fft``, the operand FFTs)
come with the fft grid mode in a later slice of the port.
"""

import numpy as np


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

"""Cubic-convolution grid interpolation (parity:
runlmc_tpu/ops/interpolation.py).

Index/weight construction runs on the host in numpy at model-build time
(it depends only on data locations). The operator :class:`Interp`
applies W and W^T through kernel K9 (runlmc_tpu_torch/hopper/interp.py):
a fixed-width gather, and a scatter that reads a transposed CSR of W
built here once, on the host; both are differentiable in the operand
(``InterpApply``: each one's backward is the other). ``Interp.T`` and
:class:`SKI` (W K_UU W^T over any grid operator) join it to the operator
algebra of ops/operators.py.
"""

import dataclasses
import logging
from typing import Any

import numpy as np
import torch

from runlmc_tpu_torch.hopper.interp import interp_apply
from runlmc_tpu_torch.ops.operators import LinearOperator

_LOG = logging.getLogger(__name__)


def cubic_kernel(x):
    """Keys cubic convolution weight u(x), supported on |x| <= 2 (0
    outside the support)."""
    x = np.abs(np.asarray(x, dtype=float))
    near = ((1.5 * x - 2.5) * x) * x + 1
    far = ((-0.5 * x + 2.5) * x - 4) * x + 2
    return np.where(x <= 1, near, np.where(x <= 2, far, 0.0))


def _check_grid(grid, name="grid"):
    grid = np.asarray(grid, dtype=float)
    if grid.ndim != 1:
        raise ValueError("%s must be 1-D" % name)
    if grid.size < 4:
        raise ValueError("%s size %d must be >= 4" % (name, grid.size))
    return grid


def interp_cubic(grid, samples):
    """Indices/weights of the n x m cubic interpolation matrix onto an
    equispaced 1-D grid: returns (idx, w), each (n, 4). Edge indices are
    clamped (duplicate columns accumulate)."""
    grid = _check_grid(grid)
    samples = np.asarray(samples, dtype=float).ravel()
    n = samples.size
    if n == 0:
        return np.zeros((0, 4), np.int32), np.zeros((0, 4))
    if samples.min() <= grid[0] or samples.max() >= grid[-1]:
        _LOG.warning(
            "sample range [%f, %f] outside grid range [%f, %f]",
            samples.min(), samples.max(), grid[0], grid[-1],
        )
    m = grid.size
    delta = grid[1] - grid[0]
    factors = (samples - grid[0]) / delta
    closest = np.floor(factors)
    dist = factors - closest  # in units of delta, in [0, 1)
    idx = np.empty((n, 4), dtype=np.int64)
    w = np.empty((n, 4))
    for t, conv_idx in enumerate(range(-2, 2)):
        idx[:, t] = np.clip(closest - conv_idx, 0, m - 1)
        w[:, t] = cubic_kernel(dist + conv_idx)
    return idx.astype(np.int32), w


def interp_bicubic(gridx, gridy, samples):
    """Indices/weights of the n x (mx*my) tensor-product bicubic
    interpolation matrix: returns (idx, w), each (n, 16)."""
    gridx = _check_grid(gridx, "gridx")
    gridy = _check_grid(gridy, "gridy")
    samples = np.asarray(samples, dtype=float)
    if samples.ndim != 2 or samples.shape[1] != 2:
        raise ValueError("expected (n, 2) samples, got %s" % (samples.shape,))
    n = samples.shape[0]
    if n == 0:
        return np.zeros((0, 16), np.int32), np.zeros((0, 16))
    ix, wx = interp_cubic(gridx, samples[:, 0])
    iy, wy = interp_cubic(gridy, samples[:, 1])
    my = gridy.size
    # flattened grid index: x-major, y fastest (row-major)
    idx = ix[:, :, None].astype(np.int64) * my + iy[:, None, :]
    w = wx[:, :, None] * wy[:, None, :]
    return idx.reshape(n, 16).astype(np.int32), w.reshape(n, 16)


def interp_nd(grid_axes, samples):
    """Dispatch on input dimension: 1-D cubic or 2-D bicubic."""
    samples = np.asarray(samples, dtype=float)
    if len(grid_axes) == 1:
        return interp_cubic(grid_axes[0], samples.ravel())
    if len(grid_axes) == 2:
        return interp_bicubic(grid_axes[0], grid_axes[1], samples)
    raise NotImplementedError(
        "interpolation grids support 1 or 2 active dimensions; split the "
        "kernel over active_dims subsets for higher-dimensional inputs"
    )


def transposed_csr(indices, weights, ncols):
    """W^T as CSR over W's columns: ``(ptr, rows, wt)`` with ``ptr``
    (ncols + 1,), and each column's entries in row order."""
    indices = np.asarray(indices)
    n, taps = indices.shape
    flat = indices.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    ptr = np.zeros(ncols + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat, minlength=ncols), out=ptr[1:])
    rows = np.repeat(np.arange(n, dtype=np.int64), taps)[order]
    wt = np.asarray(weights).reshape(-1)[order]
    return ptr.astype(np.int32), rows.astype(np.int32), wt


@dataclasses.dataclass(frozen=True)
class Interp(LinearOperator):
    """Fixed-width sparse interpolation operator W: (n, ncols) with
    ``taps`` nonzeros per row (gather ``indices`` + ``weights``), and
    its transposed CSR (``t_ptr``, ``t_rows``, ``t_weights``) for W^T.
    Host-built with numpy arrays; :meth:`to` places it for compute."""

    indices: Any  # (n, taps) int32
    weights: Any  # (n, taps)
    ncols: int
    t_ptr: Any  # (ncols + 1,) int32
    t_rows: Any  # (n * taps,) int32
    t_weights: Any  # (n * taps,)

    @staticmethod
    def from_taps(indices, weights, ncols):
        ptr, rows, wt = transposed_csr(indices, weights, ncols)
        return Interp(indices=np.asarray(indices, np.int32),
                      weights=np.asarray(weights), ncols=int(ncols),
                      t_ptr=ptr, t_rows=rows, t_weights=wt)

    @property
    def shape(self):
        return (self.indices.shape[0], self.ncols)

    def to(self, dtype, device):
        def _i(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                   device=device)

        def _f(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return Interp(indices=_i(self.indices), weights=_f(self.weights),
                      ncols=self.ncols, t_ptr=_i(self.t_ptr),
                      t_rows=_i(self.t_rows), t_weights=_f(self.t_weights))

    def replace_weights_dtype(self, dtype):
        """The same interpolant with its weights (both layouts) cast to
        ``dtype`` (parity: interpolation.py:246-247)."""
        def _f(a):
            if isinstance(a, torch.Tensor):
                return a.to(dtype)
            return torch.as_tensor(np.asarray(a), dtype=dtype)

        return self.replace(weights=_f(self.weights),
                            t_weights=_f(self.t_weights))

    def _args(self):
        return (self.indices, self.weights, self.t_ptr, self.t_rows,
                self.t_weights)

    def matvec(self, v):
        """W v: (..., ncols) -> (..., n), kernel K9 gather."""
        return interp_apply(v, *self._args())

    def rmatvec(self, x):
        """W^T x: (..., n) -> (..., ncols), kernel K9 scatter; duplicate
        (clamped-edge) indices accumulate."""
        return interp_apply(x, *self._args(), transpose=True)

    @property
    def T(self):
        """W^T as an operator (parity: interpolation.py:244-246)."""
        return _InterpT(interp=self)

    def as_dense(self):
        """W (n, ncols) in float64 on the host, duplicate indices summed
        (test oracle)."""
        n, m = self.shape
        idx = torch.as_tensor(self.indices).to("cpu", torch.int64)
        w = torch.as_tensor(self.weights).to("cpu", torch.float64)
        rows = torch.arange(n).repeat_interleave(idx.shape[1])
        out = torch.zeros((n, m), dtype=torch.float64)
        return out.index_put_((rows, idx.reshape(-1)), w.reshape(-1),
                              accumulate=True)


@dataclasses.dataclass(frozen=True)
class _InterpT(LinearOperator):
    """W^T of an :class:`Interp` (parity: interpolation.py:259-272)."""

    interp: Interp

    @property
    def shape(self):
        n, m = self.interp.shape
        return (m, n)

    def matvec(self, v):
        return self.interp.rmatvec(v)

    def as_dense(self):
        return self.interp.as_dense().T


@dataclasses.dataclass(frozen=True)
class SKI(LinearOperator):
    """The SKI composition W K_UU W^T of a grid operator ``grid_K`` and a
    placed interpolant ``W`` (parity: interpolation.py:275-298)."""

    grid_K: Any
    W: Interp

    @property
    def shape(self):
        n = self.W.shape[0]
        return (n, n)

    def matvec(self, v):
        return self.W.matvec(self.grid_K.matvec(self.W.rmatvec(v)))

    def as_dense(self):
        Wd = self.W.as_dense().to(self.grid_K.as_dense().dtype)
        return Wd @ self.grid_K.as_dense() @ Wd.T

    def upper_eig_bound(self):
        n, m = self.W.shape
        return self.grid_K.upper_eig_bound() * n / m


def multi_interpolant(Xs, grid_axes):
    """Block-diagonal multi-output interpolant: stacks per-output W_i with
    column offset ``i * m`` into one (n_total, D*m) operator."""
    m = int(np.prod([len(g) for g in grid_axes]))
    idxs, ws = [], []
    for i, X in enumerate(Xs):
        idx, w = interp_nd(grid_axes, X)
        idxs.append(idx + i * m)
        ws.append(w)
    taps = 4 ** len(grid_axes)
    if idxs:
        idx = np.concatenate(idxs, axis=0)
        w = np.concatenate(ws, axis=0)
    else:
        idx = np.zeros((0, taps), np.int32)
        w = np.zeros((0, taps))
    return Interp.from_taps(idx, w, len(Xs) * m)


def interp_output_blocks(Xs, grid_axes):
    """Per-output dense interpolation blocks: list of (n_i, m) arrays W_i
    with W = diag(W_1, ..., W_D)."""
    m = int(np.prod([len(g) for g in grid_axes]))
    blocks = []
    for X in Xs:
        idx, w = interp_nd(grid_axes, X)
        dense = np.zeros((len(idx), m))
        rows = np.repeat(np.arange(len(idx)), idx.shape[1])
        np.add.at(dense, (rows, idx.ravel()), w.ravel())
        blocks.append(dense)
    return blocks


def autogrid(Xs, lo=None, hi=None, m=None):
    """Default interpolation grid: per-dim linspace covering the pooled
    data range, padded by two extra cells on each side, with the per-dim
    size defaulting to the mean series length. Returns a list of P 1-D
    numpy axes."""
    stacked = np.concatenate(
        [np.asarray(X, dtype=float).reshape(len(X), -1) for X in Xs]
    )
    P = stacked.shape[1]
    for name, v in (("lo", lo), ("hi", hi), ("m", m)):
        if v is not None and len(v) != P:
            raise ValueError("%s must have length %d" % (name, P))

    data_lo = stacked.min(axis=0)
    data_hi = stacked.max(axis=0)
    lower = data_lo if lo is None else np.minimum(lo, data_lo)
    upper = data_hi if hi is None else np.maximum(hi, data_hi)
    if m is None:
        mean_len = sum(len(X) for X in Xs) // len(Xs)
        sizes = np.full(P, mean_len)
    else:
        sizes = np.asarray(m)

    cell = (upper - lower) / sizes
    return [
        np.linspace(lower[p] - 2 * cell[p], upper[p] + 2 * cell[p],
                    int(sizes[p]) + 4)
        for p in range(P)
    ]

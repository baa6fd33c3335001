"""Structured linear-operator algebra (parity:
runlmc_tpu/ops/operators.py:44-350).

Every operator's ``matvec`` takes batched operands ``v`` of shape
(..., ncols) and returns (..., nrows); ``as_dense`` is a test oracle.
Operators are plain dataclasses over tensors, so autograd reaches their
tensor fields. The model's SKI covariance (lmc/grid.py) does not build
on these classes; they serve the operator-level API and its tests.

Correspondence with the JAX package: LinearOperator (+ ``wrap``), Dense,
Identity, Diag, BTTB (through the port's ops/bttb.py Fourier helpers),
Toeplitz, Kronecker, BlockDiag, SymmSquareBlock, Sum, Composition.
"""

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch

from runlmc_tpu_torch.ops import bttb as bttb_ops


class LinearOperator:
    """Abstract linear operator with a batched matvec."""

    @property
    def shape(self) -> Tuple[int, int]:
        raise NotImplementedError

    def matvec(self, v):
        raise NotImplementedError

    def matmat(self, m):
        """(ncols, k) -> (nrows, k), through the batched matvec."""
        return self.matvec(m.T).T

    def as_dense(self):
        """Densify by applying the matvec to the identity (test oracle,
        quadratic memory)."""
        n = self.shape[1]
        return self.matvec(torch.eye(n, dtype=torch.float64)).T

    def upper_eig_bound(self):
        """A cheap upper bound on the largest eigenvalue (symmetric
        operators)."""
        raise NotImplementedError

    @staticmethod
    def wrap(shape, mvm: Callable):
        """Adapt a closure into an operator."""
        return _Wrapped(fn=mvm, opshape=tuple(shape))

    def replace(self, **changes):
        """A copy with the named fields changed (the operators are
        frozen dataclasses; the JAX package's pytrees' ``replace``)."""
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class _Wrapped(LinearOperator):
    fn: Callable
    opshape: Tuple[int, int]

    @property
    def shape(self):
        return self.opshape

    def matvec(self, v):
        return self.fn(v)


@dataclasses.dataclass(frozen=True)
class Dense(LinearOperator):
    """Dense matrix operator."""

    a: Any

    @property
    def shape(self):
        return tuple(self.a.shape)

    def matvec(self, v):
        return torch.einsum("ij,...j->...i", self.a, v)

    def as_dense(self):
        return self.a

    def upper_eig_bound(self):
        # Gershgorin: the largest absolute row sum
        return torch.abs(self.a).sum(dim=1).max()


@dataclasses.dataclass(frozen=True)
class Identity(LinearOperator):
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, v):
        return v

    def upper_eig_bound(self):
        return 1.0


@dataclasses.dataclass(frozen=True)
class Diag(LinearOperator):
    d: Any

    @property
    def shape(self):
        return (self.d.shape[0], self.d.shape[0])

    def matvec(self, v):
        return self.d * v

    def as_dense(self):
        return torch.diag(self.d)

    def upper_eig_bound(self):
        return torch.max(self.d)


@dataclasses.dataclass(frozen=True)
class BTTB(LinearOperator):
    """Symmetric block-Toeplitz-of-Toeplitz-blocks operator over a
    P-dim grid: its first row and its Fourier symbol, computed once."""

    top: Any
    symbol_fft: Any
    sizes: Tuple[int, ...]

    @classmethod
    def build(cls, top, sizes):
        sizes = tuple(int(s) for s in sizes)
        top = torch.as_tensor(top)
        if top.ndim != 1:
            raise ValueError("top must be 1-D, got shape %s"
                             % (tuple(top.shape),))
        if int(np.prod(sizes)) != top.shape[0]:
            raise ValueError("sizes %s do not match top length %d"
                             % (sizes, top.shape[0]))
        return cls(top=top, symbol_fft=bttb_ops.bttb_fft(top, sizes),
                   sizes=sizes)

    @property
    def shape(self):
        n = self.top.shape[0]
        return (n, n)

    def matvec(self, v):
        return bttb_ops.bttb_matvec(self.symbol_fft, v, self.sizes)

    def as_dense(self):
        return bttb_ops.bttb_dense(self.top, self.sizes)

    def upper_eig_bound(self):
        return bttb_ops.bttb_eig_upper_bound(self.top.cpu().numpy(),
                                             self.sizes)


def Toeplitz(top):
    """Symmetric Toeplitz operator from its first row: the 1-D case of
    :class:`BTTB`."""
    top = torch.as_tensor(top)
    return BTTB.build(top, (top.shape[0],))


@dataclasses.dataclass(frozen=True)
class Kronecker(LinearOperator):
    """Lazy Kronecker product A (x) B of two square operators, by the
    reshape trick."""

    a: Any
    b: Any

    @property
    def shape(self):
        n = self.a.shape[0] * self.b.shape[0]
        return (n, n)

    def matvec(self, v):
        na, nb = self.a.shape[0], self.b.shape[0]
        batch = v.shape[:-1]
        x = v.reshape(batch + (na, nb))
        x = self.b.matvec(x)  # B along the last axis, batched over na
        x = self.a.matvec(x.transpose(-1, -2)).transpose(-1, -2)
        return x.reshape(batch + (na * nb,))

    def upper_eig_bound(self):
        return self.a.upper_eig_bound() * self.b.upper_eig_bound()


@dataclasses.dataclass(frozen=True)
class BlockDiag(LinearOperator):
    """Direct sum of (possibly rectangular) blocks."""

    blocks: Any

    @property
    def shape(self):
        return (sum(b.shape[0] for b in self.blocks),
                sum(b.shape[1] for b in self.blocks))

    def matvec(self, v):
        outs, off = [], 0
        for b in self.blocks:
            outs.append(b.matvec(v[..., off:off + b.shape[1]]))
            off += b.shape[1]
        return torch.cat(outs, dim=-1)

    def upper_eig_bound(self):
        return max(b.upper_eig_bound() for b in self.blocks)


@dataclasses.dataclass(frozen=True)
class SymmSquareBlock(LinearOperator):
    """A D x D symmetric array of equal-size square blocks
    (``blocks[i][j] == blocks[j][i].T``)."""

    blocks: Any

    @property
    def shape(self):
        d = len(self.blocks)
        m = self.blocks[0][0].shape[0]
        return (d * m, d * m)

    def matvec(self, v):
        d = len(self.blocks)
        m = self.blocks[0][0].shape[0]
        batch = v.shape[:-1]
        x = v.reshape(batch + (d, m))
        outs = []
        for i in range(d):
            acc = 0
            for j in range(d):
                acc = acc + self.blocks[i][j].matvec(x[..., j, :])
            outs.append(acc)
        return torch.stack(outs, dim=-2).reshape(batch + (d * m,))

    def upper_eig_bound(self):
        # the 1-norm of the matrix of per-block bounds
        d = len(self.blocks)
        bounds = np.array([[float(self.blocks[i][j].upper_eig_bound())
                            for j in range(d)] for i in range(d)])
        return float(np.abs(bounds).sum(axis=1).max())


@dataclasses.dataclass(frozen=True)
class Sum(LinearOperator):
    """Lazy sum of operators."""

    terms: Any

    @property
    def shape(self):
        return self.terms[0].shape

    def matvec(self, v):
        acc = self.terms[0].matvec(v)
        for t in self.terms[1:]:
            acc = acc + t.matvec(v)
        return acc

    def upper_eig_bound(self):
        # Weyl: the sum of the bounds
        return sum(t.upper_eig_bound() for t in self.terms)


@dataclasses.dataclass(frozen=True)
class Composition(LinearOperator):
    """The product M_1 M_2 ... M_k, applied right to left."""

    factors: Any

    @property
    def shape(self):
        return (self.factors[0].shape[0], self.factors[-1].shape[1])

    def matvec(self, v):
        for f in reversed(self.factors):
            v = f.matvec(v)
        return v

    def upper_eig_bound(self):
        b = 1.0
        for f in self.factors:
            b = b * f.upper_eig_bound()
        return b

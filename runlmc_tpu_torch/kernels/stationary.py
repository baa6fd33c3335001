"""Stationary kernel functions k(r) as static specs + torch evaluators
(parity: runlmc_tpu/kernels/stationary.py:64-157).

A kernel is a hashable static spec that declares its parameters and
evaluates ``k(dists; params)`` on raw parameter dicts of tensors.
Constrained-space formulas:

  RBF          k(r) = exp(-gamma r^2 / 2)
  Matern32     k(r) = (1 + sqrt(3) gamma r) exp(-sqrt(3) gamma r)
  StdPeriodic  k(r) = exp(-gamma sin^2(pi r / T) / 2)
  IdentityKern k(r) = 1[r = 0]
  Scaled       k(r) = sigma * k_inner(r)

Each kernel describes itself as one row of a small table
(:meth:`StationaryKernel.table_row`): a kind code and its constrained
parameters ``(gamma, period, scale)``. The cross-kernel and K_UU CUDA
kernels (runlmc_tpu_torch/hopper/cross.py, kuu.py) evaluate k(r) from
that table; :func:`eval_kind` and :func:`eval_table` are the torch
version of that evaluation, and ``from_dist`` goes through them.
"""

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from runlmc_tpu_torch.params import POSITIVE

# kind codes of the kernel table (hopper/csrc/common.cuh kern_eval)
KIND_RBF = 0
KIND_MATERN32 = 1
KIND_STD_PERIODIC = 2
KIND_IDENTITY = 3


def eval_kind(kind, r, gamma, period):
    """The unscaled k~(r) of table kind ``kind`` at constrained ``gamma``
    and ``period``, with the operation order of common.cuh's
    ``kern_eval``."""
    if kind == KIND_RBF:
        return torch.exp(-0.5 * torch.square(r) * gamma)
    if kind == KIND_MATERN32:
        s = r * (math.sqrt(3.0) * gamma)
        return (1.0 + s) * torch.exp(-s)
    if kind == KIND_STD_PERIODIC:
        s = torch.sin((math.pi / period) * r)
        return torch.exp(-0.5 * torch.square(s) * gamma)
    return (r == 0.0).to(r.dtype)


def eval_table(kinds, prm, dists):
    """scale_q k~_q(dists), stacked (Q, ...), from the table rows
    ``kinds`` (ints) and ``prm`` (Q, 3): the port's one torch k(r),
    behind :meth:`StationaryKernel.from_dist` and the plain versions of
    the K_UU, cross-kernel and fft first-row kernels."""
    return torch.stack([
        prm[i, 2] * eval_kind(kind, dists, prm[i, 0], prm[i, 1])
        for i, kind in enumerate(kinds)
    ])


@dataclasses.dataclass(frozen=True)
class StationaryKernel:
    """Base spec. ``active_dims``: tuple of input-dimension indices this
    kernel operates on (None = all; resolved by the spec)."""

    name: str = "kern"
    active_dims: Optional[Tuple[int, ...]] = None

    def param_spec(self):
        """-> dict name -> (initial constrained value, Transform)."""
        return {}

    def init_raw_params(self):
        """Raw (unconstrained) initial parameter dict, as numpy."""
        return {
            k: np.asarray(tr.inverse(v), dtype=float)
            for k, (v, tr) in self.param_spec().items()
        }

    def from_dist(self, raw_params, dists):
        """Evaluate k on a distance tensor given raw parameters (through
        the kernel's table row)."""
        kind, row = self.table_row(raw_params, dists)
        return eval_table((kind,), row[None], dists)[0]

    def table_row(self, raw_params, like):
        """``(kind code, tensor [gamma, period, scale])`` with the
        constrained parameters, as tensors shaped and placed like
        ``like``."""
        raise NotImplementedError

    def with_active_dims(self, dims):
        return dataclasses.replace(self, active_dims=tuple(sorted(dims)))


def _row(gamma, period, scale, like):
    return torch.stack([
        torch.as_tensor(v, dtype=like.dtype, device=like.device)
        for v in (gamma, period, scale)
    ])


@dataclasses.dataclass(frozen=True)
class RBF(StationaryKernel):
    name: str = "rbf"
    inv_lengthscale: float = 1.0

    def param_spec(self):
        return {"inv_lengthscale": (self.inv_lengthscale, POSITIVE)}

    def table_row(self, raw_params, like):
        gamma = POSITIVE.forward(raw_params["inv_lengthscale"])
        return KIND_RBF, _row(gamma, 1.0, 1.0, like)


@dataclasses.dataclass(frozen=True)
class Matern32(StationaryKernel):
    name: str = "matern32"
    inv_lengthscale: float = 1.0

    def param_spec(self):
        return {"inv_lengthscale": (self.inv_lengthscale, POSITIVE)}

    def table_row(self, raw_params, like):
        gamma = POSITIVE.forward(raw_params["inv_lengthscale"])
        return KIND_MATERN32, _row(gamma, 1.0, 1.0, like)


@dataclasses.dataclass(frozen=True)
class StdPeriodic(StationaryKernel):
    name: str = "std_periodic"
    inv_lengthscale: float = 1.0
    period: float = 1.0

    def param_spec(self):
        return {
            "inv_lengthscale": (self.inv_lengthscale, POSITIVE),
            "period": (self.period, POSITIVE),
        }

    def table_row(self, raw_params, like):
        gamma = POSITIVE.forward(raw_params["inv_lengthscale"])
        period = POSITIVE.forward(raw_params["period"])
        return KIND_STD_PERIODIC, _row(gamma, period, 1.0, like)


@dataclasses.dataclass(frozen=True)
class IdentityKern(StationaryKernel):
    name: str = "id"

    def table_row(self, raw_params, like):
        return KIND_IDENTITY, _row(1.0, 1.0, 1.0, like)


@dataclasses.dataclass(frozen=True)
class Scaled(StationaryKernel):
    """sigma * k_inner. As in the JAX package, the scale is a trainable
    parameter unless ``trainable_scale=False`` (the reference's frozen
    scale)."""

    name: str = "scaled"
    inner: Optional[StationaryKernel] = None
    scale: float = 1.0
    trainable_scale: bool = True

    def __post_init__(self):
        if self.inner is None:
            raise ValueError("Scaled requires an inner kernel")
        if self.name == "scaled":
            object.__setattr__(self, "name", "scaled_" + self.inner.name)
        if self.active_dims is None:
            object.__setattr__(self, "active_dims", self.inner.active_dims)

    def param_spec(self):
        spec = {
            "inner__" + k: v for k, v in self.inner.param_spec().items()
        }
        if self.trainable_scale:
            spec["scale"] = (self.scale, POSITIVE)
        return spec

    def _split(self, raw_params):
        inner_params = {
            k[len("inner__"):]: v
            for k, v in raw_params.items()
            if k.startswith("inner__")
        }
        if self.trainable_scale:
            sigma = POSITIVE.forward(raw_params["scale"])
        else:
            sigma = self.scale
        return inner_params, sigma

    def table_row(self, raw_params, like):
        inner_params, sigma = self._split(raw_params)
        kind, row = self.inner.table_row(inner_params, like)
        return kind, torch.cat([row[:2], row[2:] * sigma])

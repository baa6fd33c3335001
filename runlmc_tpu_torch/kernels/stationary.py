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

Besides ``from_dist``, each kernel describes itself as one row of a
small table (:meth:`StationaryKernel.table_row`): a kind code and its
constrained parameters ``(gamma, period, scale)``. The cross-kernel
CUDA kernel (runlmc_tpu_torch/hopper/cross.py) evaluates k(r)
from that table.
"""

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from runlmc_tpu_torch.params import POSITIVE

# kind codes of the cross-kernel table (hopper/csrc/cross_kernel.cu)
KIND_RBF = 0
KIND_MATERN32 = 1
KIND_STD_PERIODIC = 2
KIND_IDENTITY = 3


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
        """Evaluate k on a distance tensor given raw parameters."""
        raise NotImplementedError

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

    def from_dist(self, raw_params, dists):
        gamma = POSITIVE.forward(raw_params["inv_lengthscale"])
        return torch.exp(-0.5 * torch.square(dists) * gamma)

    def table_row(self, raw_params, like):
        gamma = POSITIVE.forward(raw_params["inv_lengthscale"])
        return KIND_RBF, _row(gamma, 1.0, 1.0, like)


@dataclasses.dataclass(frozen=True)
class Matern32(StationaryKernel):
    name: str = "matern32"
    inv_lengthscale: float = 1.0

    def param_spec(self):
        return {"inv_lengthscale": (self.inv_lengthscale, POSITIVE)}

    def from_dist(self, raw_params, dists):
        gamma = POSITIVE.forward(raw_params["inv_lengthscale"])
        scaled = dists * (math.sqrt(3.0) * gamma)
        return (1.0 + scaled) * torch.exp(-scaled)

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

    def from_dist(self, raw_params, dists):
        gamma = POSITIVE.forward(raw_params["inv_lengthscale"])
        period = POSITIVE.forward(raw_params["period"])
        sin = torch.sin((math.pi / period) * dists)
        return torch.exp(-0.5 * torch.square(sin) * gamma)

    def table_row(self, raw_params, like):
        gamma = POSITIVE.forward(raw_params["inv_lengthscale"])
        period = POSITIVE.forward(raw_params["period"])
        return KIND_STD_PERIODIC, _row(gamma, period, 1.0, like)


@dataclasses.dataclass(frozen=True)
class IdentityKern(StationaryKernel):
    name: str = "id"

    def from_dist(self, raw_params, dists):
        return (dists == 0.0).to(dists.dtype)

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

    def from_dist(self, raw_params, dists):
        inner_params, sigma = self._split(raw_params)
        return sigma * self.inner.from_dist(inner_params, dists)

    def table_row(self, raw_params, like):
        inner_params, sigma = self._split(raw_params)
        kind, row = self.inner.table_row(inner_params, like)
        return kind, torch.cat([row[:2], row[2:] * sigma])

"""Hyperparameter priors as log-density terms (parity:
runlmc_tpu/priors.py:17-85).

A prior is declared on the *constrained* value of a raw-parameter leaf;
every objective adds ``lnpdf(value) + log|d value / d raw|`` (the change
of variables, :meth:`Transform.log_jacobian`), and autograd carries its
gradient to the raw parameter. ``lnpdf`` takes a tensor and computes in
its dtype and on its device.
"""

import dataclasses
import math

import torch

from runlmc_tpu_torch.params import Softplus


class Prior:
    domain = "real"

    def lnpdf(self, x):
        raise NotImplementedError


def _gammaln(a, like):
    return torch.lgamma(torch.as_tensor(a, dtype=like.dtype,
                                        device=like.device))


@dataclasses.dataclass(frozen=True)
class Gaussian(Prior):
    mu: float
    var: float
    domain = "real"

    def __post_init__(self):
        if self.var <= 0:
            raise ValueError("variance %r should be positive" % (self.var,))

    def lnpdf(self, x):
        c = -0.5 * math.log(2 * math.pi * self.var)
        return c - 0.5 * torch.square(x - self.mu) / self.var


@dataclasses.dataclass(frozen=True)
class Gamma(Prior):
    a: float
    b: float
    domain = "positive"

    def lnpdf(self, x):
        c = -_gammaln(self.a, x) + self.a * math.log(self.b)
        return c + (self.a - 1) * torch.log(x) - self.b * x

    @staticmethod
    def from_EV(E, V):
        """Gamma prior with the given mean and variance (parity:
        runlmc_tpu/priors.py:49-53)."""
        return Gamma(a=float(E) ** 2 / V, b=float(E) / V)


@dataclasses.dataclass(frozen=True)
class InverseGamma(Prior):
    a: float
    b: float
    domain = "positive"

    def lnpdf(self, x):
        c = -_gammaln(self.a, x) + self.a * math.log(self.b)
        return c - (self.a + 1) * torch.log(x) - self.b / x


@dataclasses.dataclass(frozen=True)
class HalfLaplace(Prior):
    b: float
    domain = "positive"

    def lnpdf(self, x):
        return -math.log(self.b) - x / self.b


def check_domain(prior, transform):
    """A positive-domain prior needs a positivity transform (parity:
    runlmc_tpu/priors.py:76-85)."""
    if prior.domain == "positive" and not isinstance(transform, Softplus):
        raise ValueError(
            "prior %r requires a positive parameter domain" % (prior,)
        )

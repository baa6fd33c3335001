"""Parameter transforms: raw (unconstrained) <-> constrained space
(parity: runlmc_tpu/params.py:17-60).

``forward`` runs on tensors; ``inverse`` runs on the host in numpy,
where initial values are made, and gives the same bits as the JAX
package's inverse.
"""

import numpy as np
import torch


class Transform:
    """Bijector from raw (unconstrained) to constrained space."""

    def forward(self, raw):
        raise NotImplementedError

    def inverse(self, value):
        raise NotImplementedError

    def log_jacobian(self, raw):
        """log |d forward / d raw|: the change-of-variables term of a
        prior on the constrained value (runlmc_tpu/params.py:27-31)."""
        raise NotImplementedError


class IdentityTransform(Transform):
    def forward(self, raw):
        return raw

    def inverse(self, value):
        return value

    def log_jacobian(self, raw):
        return torch.zeros_like(raw)


class Softplus(Transform):
    """paramz ``Logexp`` equivalent: value = log(1 + exp(raw)) > 0."""

    def forward(self, raw):
        # logaddexp(raw, 0), as jax.nn.softplus computes it; torch's own
        # softplus returns raw unchanged above a threshold of 20
        raw = torch.as_tensor(raw)
        return torch.logaddexp(raw, torch.zeros_like(raw))

    def inverse(self, value):
        # Numerically stable softplus^-1: log(exp(v) - 1) = v + log1p(-exp(-v))
        value = np.asarray(value, dtype=float)
        return value + np.log1p(-np.exp(-value))

    def log_jacobian(self, raw):
        return torch.log(torch.sigmoid(raw))


IDENTITY = IdentityTransform()
POSITIVE = Softplus()

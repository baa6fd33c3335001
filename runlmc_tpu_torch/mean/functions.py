"""Mean functions (parity: runlmc_tpu/mean/functions.py:16-53).

As in the JAX package, these are defined and tested but not wired into
InterpolatedLLGP, which is zero-mean; 1-D inputs only, as there. The
means are float64 tensors on the CPU."""

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeanFunction:
    """Static spec for a multi-output mean function m_d(x)."""

    input_dim: int = 1
    output_dim: int = 1

    def __post_init__(self):
        if self.input_dim != 1:
            raise ValueError(
                "mean functions only support 1-D inputs (parity with "
                "reference mean_function.py:26)"
            )

    def init_raw_params(self):
        return {}

    def mean(self, raw_params, Xs):
        """Per-output means: list of (n_d,) tensors."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Zero(MeanFunction):
    def mean(self, raw_params, Xs):
        return [torch.zeros(len(X), dtype=torch.float64) for X in Xs]


@dataclasses.dataclass(frozen=True)
class Constant(MeanFunction):
    """Per-output constant offset (parity: runlmc/mean/constant.py)."""

    def init_raw_params(self):
        return {"offsets": np.zeros(self.output_dim)}

    def mean(self, raw_params, Xs):
        c = torch.as_tensor(raw_params["offsets"], dtype=torch.float64)
        return [c[d].expand(len(X)).clone() for d, X in enumerate(Xs)]

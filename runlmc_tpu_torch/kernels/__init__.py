from runlmc_tpu_torch.kernels.stationary import (
    RBF,
    IdentityKern,
    Matern32,
    Scaled,
    StationaryKernel,
    StdPeriodic,
)

__all__ = [
    "StationaryKernel",
    "RBF",
    "Matern32",
    "StdPeriodic",
    "IdentityKern",
    "Scaled",
]

"""
runlmc_tpu_torch — the PyTorch/CUDA port of runlmc_tpu for NVIDIA Hopper
(H100) cards.

It mirrors runlmc_tpu's module tree (``kernels/ lmc/ models/ ops/
utils/``) and imports neither JAX nor runlmc_tpu. Device work that the
JAX package leaves to XLA fusion runs in kernels written by hand for
``sm_90a`` under ``hopper/`` (CUDA C++ built with nvcc at first use,
and Triton); dense GEMMs, Cholesky factorizations and triangular
solves go to cuBLAS/cuSOLVER through torch.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``, where every kernel's plain PyTorch version runs. The
model dtype defaults to float64, which the H100 runs natively.
Importing the package turns TF32 off for float32 matmuls and
convolutions (see :mod:`runlmc_tpu_torch.config`).
"""

from runlmc_tpu_torch import config
from runlmc_tpu_torch.config import disable_tf32

disable_tf32()

from runlmc_tpu_torch.kernels import (  # noqa: E402
    RBF,
    IdentityKern,
    Matern32,
    Scaled,
    StdPeriodic,
)
from runlmc_tpu_torch import mean  # noqa: E402
from runlmc_tpu_torch.lmc.kernel_spec import LMCKernelSpec  # noqa: E402
from runlmc_tpu_torch.metrics import Metrics  # noqa: E402
from runlmc_tpu_torch.models import (  # noqa: E402
    ExactLMC,
    InterpolatedLLGP,
    MultiGP,
)
from runlmc_tpu_torch.models.optimization import AdaDelta  # noqa: E402
from runlmc_tpu_torch.priors import (  # noqa: E402
    Gamma,
    Gaussian,
    HalfLaplace,
    InverseGamma,
)

__all__ = [
    "config",
    "RBF",
    "Matern32",
    "StdPeriodic",
    "IdentityKern",
    "Scaled",
    "LMCKernelSpec",
    "Metrics",
    "MultiGP",
    "InterpolatedLLGP",
    "ExactLMC",
    "AdaDelta",
    "Gaussian",
    "Gamma",
    "InverseGamma",
    "HalfLaplace",
    "mean",
]

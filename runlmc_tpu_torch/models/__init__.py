from runlmc_tpu_torch.models.exact_lmc import ExactLMC
from runlmc_tpu_torch.models.interpolated_llgp import InterpolatedLLGP
from runlmc_tpu_torch.models.multigp import MultiGP
from runlmc_tpu_torch.models.optimization import AdaDelta

__all__ = ["ExactLMC", "InterpolatedLLGP", "MultiGP", "AdaDelta"]

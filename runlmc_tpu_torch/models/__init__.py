from runlmc_tpu_torch.models.interpolated_llgp import InterpolatedLLGP
from runlmc_tpu_torch.models.multigp import MultiGP

__all__ = ["InterpolatedLLGP", "MultiGP"]

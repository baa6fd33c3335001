from runlmc_tpu_torch.mean.functions import Constant, MeanFunction, Zero

__all__ = ["MeanFunction", "Zero", "Constant"]

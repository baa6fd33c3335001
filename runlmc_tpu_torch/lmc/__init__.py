from runlmc_tpu_torch.lmc.kernel_spec import LMCKernelSpec

__all__ = ["LMCKernelSpec"]

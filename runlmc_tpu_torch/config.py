"""Device, dtype and matmul-precision configuration of the PyTorch port.

The port runs on an NVIDIA Hopper card by default. Entry points take an
explicit ``device``; ``None`` means the card, and asking for the card
where none is present raises — the port never drops to the CPU on its
own. Tests pass ``device="cpu"``, where every hand kernel's wrapper
runs its plain PyTorch version instead.

The model dtype defaults to float64: f64 is native on the H100, so the
port follows the JAX package's CPU/f64-native branches throughout.

TF32 is the Hopper analog of the TPU's bfloat16 default matmul
precision, which the JAX package overrides with ``Precision.HIGHEST``
(runlmc_tpu/lmc/grid.py:42-46): a float32 product rounded to TF32 keeps
about three decimal digits, which floors Krylov residuals and ruins the
float32 Woodbury preconditioner. :func:`disable_tf32` turns it off for
cuBLAS matmuls and cuDNN; the package calls it when imported.
"""

import torch

DEFAULT_DTYPE = torch.float64


def disable_tf32():
    """Keep every float32 matmul and convolution at full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_disabled():
    return not (
        torch.backends.cuda.matmul.allow_tf32
        or torch.backends.cudnn.allow_tf32
    )


def default_device():
    """The CUDA device; raises when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "runlmc_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch "
            "versions of its kernels on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device):
    """``None`` -> the CUDA device (raising without one); otherwise the
    given device, which must exist."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but CUDA is unavailable"
                           % (device,))
    return device

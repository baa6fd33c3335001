"""Hand-written Hopper (sm_90a) kernels of the port.

Each kernel sits behind a wrapper that checks its inputs, launches it
for CUDA tensors and counts the launch by dtype (``wrapper.launches``,
``{"f32": n, "f64": n}``); for CPU tensors the wrapper runs the plain
PyTorch version beside it.

  K1  kuu.kuu_dense               CUDA  csrc/kuu_dense.cu
  K6  cg.cg_update_xr / cg_update_p  Triton  triton_cg.py
  K7  cross.cross_kernel          CUDA  csrc/cross_kernel.cu
  K9  interp.interp_gather / interp_scatter  CUDA  csrc/interp.cu
"""

from runlmc_tpu_torch.hopper import build
from runlmc_tpu_torch.hopper.cg import cg_update_p, cg_update_xr
from runlmc_tpu_torch.hopper.cross import cross_kernel
from runlmc_tpu_torch.hopper.interp import interp_gather, interp_scatter
from runlmc_tpu_torch.hopper.kuu import kuu_dense

WRAPPERS = (
    kuu_dense, cross_kernel, interp_gather, interp_scatter, cg_update_xr,
    cg_update_p,
)


# The launches, as ``launch_counts`` keys, that a float64 model's
# 'on-the-fly' predict makes on the card: K_UU for the model-dtype
# operator and the float32 preconditioner, K_*X and the mean in float64,
# the CG passes of the float32 inner cycles.
PREDICT_PATH = (
    "kuu_dense/f64", "kuu_dense/f32", "cross_kernel/f64",
    "interp_gather/f64", "interp_scatter/f64", "cg_update_xr/f32",
    "cg_update_p/f32",
)
# The float64 CG passes, which run only on the certified solve's
# escalation rung (CG preconditioned by the float64 Woodbury factor).
ESCALATION_PATH = ("cg_update_xr/f64", "cg_update_p/f64")


def reset_launches():
    for w in WRAPPERS:
        w.launches = build.counter()


def launch_counts():
    """``{"<wrapper>/<f32|f64>": launches}`` since the last reset."""
    return {"%s/%s" % (w.__name__, sfx): n
            for w in WRAPPERS for sfx, n in w.launches.items()}

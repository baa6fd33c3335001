"""Hand-written Hopper (sm_90a) kernels of the port.

Each kernel sits behind a wrapper that checks its inputs, launches it
for CUDA tensors and counts the launch by dtype (``wrapper.launches``,
``{"f32": n, "f64": n}``); for CPU tensors the wrapper runs the plain
PyTorch version beside it.

  K1 (+K8, k(r) on the grid)  kuu.kuu_dense  CUDA  csrc/kuu_dense.cu
  K1 backward  kuu.kuu_dense_bwd  CUDA  csrc/kuu_dense_bwd.cu
  K6  cg.cg_update_xr / cg_update_p  Triton  triton_cg.py
  K7  cross.cross_kernel          CUDA  csrc/cross_kernel.cu
  K7 backward  cross.cross_kernel_bwd  CUDA  csrc/cross_kernel_bwd.cu
  K9  interp.interp_gather / interp_scatter  CUDA  csrc/interp.cu
  K10 fourier.fourier_contract    CUDA  csrc/fourier.cu
  K10 backward  fourier.fourier_contract_bwd  CUDA  csrc/fourier.cu
  K12 minres.minres_update        CUDA  csrc/minres.cu
  K13 lanczos.lanczos_step        CUDA  csrc/lanczos.cu
      (K12 and K13 share the cluster row reduction csrc/lanczos_core.cuh)
  K5  trsm.trsm_lower (trsm.cho_solve, its backward: trsm.ChoSolve)
                                  CUDA  csrc/trsm.cu
  K2  capacitance.capacitance     CUDA  csrc/capacitance.cu
  K2 backward  capacitance.capacitance_bwd  CUDA  csrc/capacitance.cu
  K4  the W-block applies: K9 through interp.InterpApply
  K3  the jittered Cholesky around cuSOLVER's potrf (potrf.potrf_, in
      place on K3a's M, called on torch's own libcusolver):
      K3a chol_jitter.chol_prologue (equilibrate, jitter)
      K3b chol_jitter.chol_descale (de-scale, the attempt's flag)
      their backward  chol_jitter.chol_prologue_bwd / chol_descale_bwd
                                  CUDA  csrc/chol_jitter.cu
      the factorization's VJP  chol_vjp.chol_vjp (Phi(L^T L-bar),
      symmetrized) and chol_vjp.chol_vjp_solve (L^-T S L^-1, both
      substitutions, exactly symmetric), joined in
      chol_vjp.cholesky_backward (autograd chol_vjp.CholeskyEx)
                                  CUDA  csrc/chol_vjp.cu
  K8 (fft)  kern_rows_fft.kern_rows_fft / kern_rows_fft_bwd (k(r) on
      an fft group's first rows, circulantly embedded for cuFFT)
                                  CUDA  csrc/kern_rows_fft.cu
"""

from runlmc_tpu_torch.hopper import build
from runlmc_tpu_torch.hopper import capacitance as _k2
from runlmc_tpu_torch.hopper import chol_jitter as _k3
from runlmc_tpu_torch.hopper import chol_vjp as _k3v
from runlmc_tpu_torch.hopper import kern_rows_fft as _k8
from runlmc_tpu_torch.hopper.cg import cg_update_p, cg_update_xr
from runlmc_tpu_torch.hopper.cross import cross_kernel, cross_kernel_bwd
from runlmc_tpu_torch.hopper.fourier import (
    fourier_contract,
    fourier_contract_bwd,
)
from runlmc_tpu_torch.hopper.interp import interp_gather, interp_scatter
from runlmc_tpu_torch.hopper.kuu import kuu_dense, kuu_dense_bwd
from runlmc_tpu_torch.hopper.lanczos import lanczos_step
from runlmc_tpu_torch.hopper.minres import minres_update
from runlmc_tpu_torch.hopper.trsm import trsm_lower

WRAPPERS = (
    kuu_dense, kuu_dense_bwd, cross_kernel, interp_gather, interp_scatter,
    cg_update_xr, cg_update_p, fourier_contract, fourier_contract_bwd,
    minres_update, cross_kernel_bwd, lanczos_step, trsm_lower,
    _k2.capacitance, _k2.capacitance_bwd, _k3.chol_prologue,
    _k3.chol_descale, _k3.chol_prologue_bwd, _k3.chol_descale_bwd,
    _k3v.chol_vjp, _k3v.chol_vjp_solve, _k8.kern_rows_fft,
    _k8.kern_rows_fft_bwd,
)

# K3's forward and backward launches at one dtype: the forward wherever
# a Woodbury factorization is built, the backward where its factors are
# differentiated (exact-objective training)
_K3 = {sfx: ("chol_prologue/" + sfx, "chol_descale/" + sfx)
       for sfx in ("f32", "f64")}
_K3_BWD = {sfx: ("chol_prologue_bwd/" + sfx, "chol_descale_bwd/" + sfx,
                 "chol_vjp/" + sfx, "chol_vjp_solve/" + sfx)
           for sfx in ("f32", "f64")}


# The launches, as ``launch_counts`` keys, that a float64 model's
# 'on-the-fly' predict makes on the card: K_UU for the model-dtype
# operator and the float32 preconditioner, its capacitance matrix and
# jittered Cholesky factorizations, K_*X and the mean in float64, the W
# applies of both dtypes, the CG passes of the float32 inner cycles and
# the float32 Woodbury preconditioner's triangular solves.
PREDICT_PATH = (
    "kuu_dense/f64", "kuu_dense/f32", "capacitance/f32", "cross_kernel/f64",
    "interp_gather/f64", "interp_scatter/f64", "interp_gather/f32",
    "interp_scatter/f32", "cg_update_xr/f32", "cg_update_p/f32",
    "trsm_lower/f32",
) + _K3["f32"]
# The float64 CG passes and triangular solves, which run only on the
# certified solve's escalation rung (CG preconditioned by the float64
# Woodbury factor).
ESCALATION_PATH = ("cg_update_xr/f64", "cg_update_p/f64", "trsm_lower/f64")
# The launches of an exact-objective training step with its float32
# factorization (exact_precision='f32'): K_UU forward and backward, the
# capacitance matrix and its backward, the jittered Cholesky
# factorizations and their backward (K3's and the factorization's own
# VJP), the W applies (each direction is the other's backward), the Woodbury solve with C and its backward.
TRAIN_PATH = ("kuu_dense/f32", "kuu_dense_bwd/f32", "capacitance/f32",
              "capacitance_bwd/f32", "interp_gather/f32",
              "interp_scatter/f32", "trsm_lower/f32") + _K3["f32"] \
    + _K3_BWD["f32"]
# The same once training has escalated to exact_precision='model' on a
# float64 model.
MODEL_PRECISION_PATH = ("kuu_dense/f64", "kuu_dense_bwd/f64",
                        "capacitance/f64", "capacitance_bwd/f64",
                        "interp_gather/f64", "interp_scatter/f64",
                        "trsm_lower/f64") + _K3["f64"] + _K3_BWD["f64"]
# One stochastic-objective training step of a model with an fft group:
# the Fourier contraction of the float64 operator (outer residuals and
# the surrogate) and of the float32 inner CG cycles, its float64
# backward (the surrogate's gradient), the first rows' k(r) of both
# operators' symbols and its float64 backward, the W applies of both
# operators,
# K_UU, the capacitance matrix and the jittered Cholesky factorizations
# of the float32 dense preconditioner twin (not differentiated), its
# triangular solves and the float32 CG passes.
STOCHASTIC_PATH = (
    "fourier_contract/f64", "fourier_contract/f32",
    "fourier_contract_bwd/f64", "kern_rows_fft/f64", "kern_rows_fft/f32",
    "kern_rows_fft_bwd/f64", "interp_gather/f64", "interp_scatter/f64",
    "interp_gather/f32", "interp_scatter/f32", "kuu_dense/f32",
    "capacitance/f32", "cg_update_xr/f32", "cg_update_p/f32",
    "trsm_lower/f32",
) + _K3["f32"]
# An 'on-the-fly' predict of a model with an fft group.
FFT_PREDICT_PATH = (
    "fourier_contract/f64", "fourier_contract/f32", "kern_rows_fft/f64",
    "kern_rows_fft/f32", "cross_kernel/f64",
    "interp_gather/f64", "interp_scatter/f64", "interp_gather/f32",
    "interp_scatter/f32", "capacitance/f32", "cg_update_xr/f32",
    "cg_update_p/f32", "trsm_lower/f32",
) + _K3["f32"]
# The plain float64 MINRES rung of the certified solve of a model with
# an fft group.
MINRES_PATH = ("minres_update/f64",)
# A stochastic-objective step of an all-dense model: K_UU and its
# backward at the model dtype, the W applies, the float32 factor's
# capacitance matrix and jittered Cholesky factorizations (built without
# a gradient), its triangular solves and CG passes.
DENSE_STOCHASTIC_PATH = (
    "kuu_dense/f64", "kuu_dense_bwd/f64", "interp_gather/f64",
    "interp_scatter/f64", "kuu_dense/f32", "capacitance/f32",
    "interp_gather/f32", "interp_scatter/f32", "cg_update_xr/f32",
    "cg_update_p/f32", "trsm_lower/f32",
) + _K3["f32"]
# Exact-objective training of the synth configuration (P=2 inputs,
# m=[25, 25] padded to a 29 x 29 grid, Dm=4205) on 2-D grids (a BTTB
# K_UU, block-banded grams, 16 taps per row): the float32 training step's
# kernels and, once a chunk's float32 factorization residual breaches the
# escalation threshold (on the synthetic twin, after its first chunk),
# the float64 ones of the remaining steps.
SYNTH_PATH = TRAIN_PATH + MODEL_PRECISION_PATH

# The exact dense-kernel oracle of a float64 model: its value
# (``log_likelihood(exact=True)``, the 'exact' prediction mode) builds
# K (n, n) through K7 and solves with its Cholesky factor through K5;
# its gradient (``exact_log_likelihood_and_grad``, every step of
# ``metrics=True`` training, ``ExactLMC``) is the closed form: K^-1 by
# cuSOLVER's potri, then K7's backward.
REPORT_PATH = ("cross_kernel/f64", "cross_kernel_bwd/f64", "trsm_lower/f64")
# ``metrics=True`` training of an exact-objective model with its float32
# factorization: the training step's K_UU forward and backward and, once
# per step, the exact dense gradient it is compared with.
METRICS_PATH = TRAIN_PATH + REPORT_PATH
# The SLQ log-determinant of a model with an fft group
# (``log_likelihood(exact=False)``, ``ski_log_det``): the Lanczos steps
# and the float64 operator's symbol (its first rows' k(r)), Fourier
# contraction and W applies.
SLQ_PATH = ("lanczos_step/f64", "fourier_contract/f64", "kern_rows_fft/f64",
            "interp_gather/f64", "interp_scatter/f64")
# The same reports of float32 models: an fft model's SLQ log-det and
# ExactLMC's exact log-likelihood and gradient.
F32_REPORT_PATH = ("lanczos_step/f32", "cross_kernel/f32",
                   "cross_kernel_bwd/f32", "trsm_lower/f32")


def reset_launches():
    for w in WRAPPERS:
        w.launches = build.counter()


def launch_counts():
    """``{"<wrapper>/<f32|f64>": launches}`` since the last reset."""
    return {"%s/%s" % (w.__name__, sfx): n
            for w in WRAPPERS for sfx, n in w.launches.items()}

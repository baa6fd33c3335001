"""LMC likelihood pieces of the prediction path (parity:
runlmc_tpu/lmc/likelihood.py:51-96, 224-345).

- data flattening (host numpy);
- the dense cross-covariance K[a, b], through kernel K7
  (runlmc_tpu_torch/hopper/cross.py);
- the exact SKI marginal log-likelihood's value through the Woodbury
  factorization, and the float32 factorization residual that the
  model's ``objective='auto'`` probe reads. Their gradients come with
  training, in a later slice.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from runlmc_tpu_torch.hopper.cross import cross_kernel as _k7
from runlmc_tpu_torch.lmc.grid import build_kski
from runlmc_tpu_torch.lmc.kernel_spec import LMCKernelSpec
from runlmc_tpu_torch.lmc.woodbury import build_device_woodbury
from runlmc_tpu_torch.utils.carry import cast_params


class FlatData(NamedTuple):
    """Stacked multi-output data."""

    X: np.ndarray  # (n, P)
    y: np.ndarray  # (n,)
    lens: tuple  # per-output lengths
    output_idx: np.ndarray  # (n,) int32, which output each row belongs to


def flatten_data(Xs, Ys):
    Xs = [np.asarray(X, dtype=float) for X in Xs]
    Xs = [X.reshape(-1, 1) if X.ndim == 1 else X for X in Xs]
    lens = tuple(len(X) for X in Xs)
    X = np.concatenate(Xs, axis=0) if Xs else np.zeros((0, 1))
    y = np.concatenate([np.asarray(Y, dtype=float) for Y in Ys])
    oidx = np.repeat(np.arange(len(Xs), dtype=np.int32), lens)
    return FlatData(X=X, y=y, lens=lens, output_idx=oidx)


def cross_kernel(spec: LMCKernelSpec, raw_params, Xa, oidx_a, Xb, oidx_b):
    """Dense LMC cross-covariance K[a, b] (no noise), kernel K7.
    ``oidx_a``/``oidx_b`` are int32 output indices."""
    kinds, masks, prm = spec.kernel_table(raw_params)
    return _k7(Xa, oidx_a, Xb, oidx_b, spec.coreg_mats(raw_params),
               kinds, masks, prm)


class ExactAux(NamedTuple):
    alpha: torch.Tensor  # (n,) K~^-1 y
    solve_error: torch.Tensor  # relative residual of the factorized solve
    quad: torch.Tensor  # y^T alpha


def exact_ski_mll(spec: LMCKernelSpec, raw_params, grid_data, lens, y,
                  jitter=(1e-6, 1e-4, 1e-2), c_jitter=(0.0, 1e-6, 1e-3)):
    """The exact marginal log-likelihood of the dense-grid SKI model
    K~ = sum_g W_g (K_UU_g + delta_g I) W_g^T + diag(eps), through the
    Woodbury factorization (value only). Returns ``(mll, ExactAux)``."""
    K = build_kski(spec, raw_params, grid_data, lens)
    wb = build_device_woodbury(
        K.groups, spec.noise(raw_params), K.noise_n,
        tuple(gd.WtW for gd in grid_data),
        jitter=jitter, c_jitter=c_jitter,
    )
    alpha = wb.solve(y)
    quad = torch.dot(y, alpha)
    n = y.shape[0]
    mll = -0.5 * (wb.logdet + quad + n * math.log(2 * math.pi))
    resid = wb.matvec(alpha) - y
    err = torch.linalg.norm(resid) / torch.clamp(torch.linalg.norm(y),
                                                 min=1e-30)
    return mll, ExactAux(alpha=alpha, solve_error=err, quad=quad)


def f32_factorization_residual(spec, raw_params, grid_data32, lens, y):
    """||K~ (K~^-1 y) - y|| / ||y|| of the FLOAT32 Woodbury factorization
    at the given parameters, with the exact objective's tight jitter
    ladders (parity: likelihood.py:307-345)."""
    params32 = cast_params(raw_params, torch.float32)
    K32 = build_kski(spec, params32, grid_data32, lens)
    wb = build_device_woodbury(
        K32.groups, spec.noise(params32), K32.noise_n,
        tuple(gd.WtW for gd in grid_data32),
        jitter=(1e-6, 1e-4, 1e-2), c_jitter=(0.0, 1e-6, 1e-3),
    )
    y32 = y.to(torch.float32)
    alpha = wb.solve(y32)
    r = wb.matvec(alpha) - y32
    return torch.linalg.norm(r) / torch.clamp(torch.linalg.norm(y32),
                                              min=1e-30)

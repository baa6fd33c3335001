"""LMC likelihood pieces of the prediction, training and reporting paths
(parity: runlmc_tpu/lmc/likelihood.py:51-138, 202-527).

- data flattening (host numpy);
- the dense cross-covariance K[a, b], through kernel K7 and its backward
  (runlmc_tpu_torch/hopper/cross.py ``CrossKernel``), and the exact dense
  path on it: ``exact_dense_K``, ``exact_mll`` (the oracle likelihood,
  differentiable by autograd through cuSOLVER's Cholesky and K7's
  backward) and ``exact_chol``;
- the prior term of every objective (``log_prior_term``);
- the exact SKI marginal log-likelihood through the Woodbury
  factorization, differentiable by torch autograd (the exact training
  objective), and the float32 factorization residual that the model's
  ``objective='auto'`` probe and its in-training flip rung read;
- the stochastic objective's surrogate (kernel K14 of the kernel
  table): with alpha = K^-1 y and z_i = K^-1 r_i for Rademacher probes
  r_i from one batched certified solve, the scalar

      s(theta) = 1/2 alpha^T K(theta) alpha
                 - 1/(2 N) sum_i z_i^T K(theta) r_i

  has the stochastic MLL gradient as its gradient. Autograd runs
  through the model-dtype operator: kernel K10's backward on fft
  grids, K1's on dense ones.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from runlmc_tpu_torch.hopper.cross import CrossKernel
from runlmc_tpu_torch.hopper.trsm import cho_solve
from runlmc_tpu_torch.lmc.grid import build_kski
from runlmc_tpu_torch.lmc.kernel_spec import LMCKernelSpec
from runlmc_tpu_torch.lmc.woodbury import build_device_woodbury, woodbury_pcg
from runlmc_tpu_torch.ops.solvers import batched_cg, batched_minres
from runlmc_tpu_torch.utils.carry import cast_params, unravel_params


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


def pairwise_dists(Xa, Xb, dims):
    """Euclidean distances between the rows of ``Xa`` and ``Xb`` over
    the input dims ``dims`` (parity: likelihood.py:76-82)."""
    dims = list(dims)
    diff = Xa[:, None, dims] - Xb[None, :, dims]
    return torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0))


def cross_kernel(spec: LMCKernelSpec, raw_params, Xa, oidx_a, Xb, oidx_b):
    """Dense LMC cross-covariance K[a, b] (no noise), kernel K7 (parity:
    likelihood.py:85-96); differentiable in the parameters through K7's
    backward. ``oidx_a``/``oidx_b`` are int32 output indices."""
    kinds, masks, prm = spec.kernel_table(raw_params)
    return CrossKernel.apply(Xa, oidx_a, Xb, oidx_b,
                             spec.coreg_mats(raw_params), kinds, masks, prm)


def exact_dense_K(spec: LMCKernelSpec, raw_params, X, oidx):
    """The dense LMC kernel with noise on its diagonal (parity:
    likelihood.py:99-104)."""
    K = cross_kernel(spec, raw_params, X, oidx, X, oidx)
    return K + torch.diag(spec.noise(raw_params)[oidx.long()])


def _chol_or_nan(K):
    """Cholesky factor of ``K`` (cuSOLVER or LAPACK), NaN everywhere
    where the factorization fails (``info > 0``) — what XLA returns, and
    what the JAX package's callers test for — without a host read."""
    L, info = torch.linalg.cholesky_ex(K)
    return L.masked_fill(info != 0, float("nan"))


def exact_chol(spec: LMCKernelSpec, raw_params, X, oidx):
    """Lower Cholesky factor of the dense kernel (parity:
    likelihood.py:122-125); NaN on a factorization failure."""
    return _chol_or_nan(exact_dense_K(spec, raw_params, X, oidx))


def exact_mll(spec: LMCKernelSpec, raw_params, X, oidx, y):
    """The exact marginal log-likelihood
    -1/2 (y^T K^-1 y + log det K + n log 2 pi) of the dense kernel
    (parity: likelihood.py:107-119). Differentiable: autograd runs
    through the Cholesky factorization and K7's backward."""
    L = _chol_or_nan(exact_dense_K(spec, raw_params, X, oidx))
    alpha = cho_solve(L, y[None])[0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    n = y.shape[0]
    return -0.5 * (torch.dot(y, alpha) + logdet + n * math.log(2 * math.pi))


def exact_value_and_grad(spec, like, x_flat, X, oidx, y, prior_specs=()):
    """The negative exact MLL plus the priors' term at the flat raw
    parameters ``x_flat`` (numpy, in ``ravel_params`` order of the tree
    ``like``) and its flat gradient, as ``(float, numpy)``: the oracle of
    ``InterpolatedLLGP`` and the objective of ``ExactLMC`` (parity:
    interpolated_llgp.py:875-886, exact_lmc.py:56-66)."""
    with torch.enable_grad():
        xc = torch.as_tensor(np.asarray(x_flat), dtype=y.dtype,
                             device=y.device).requires_grad_(True)
        params = unravel_params(xc, like)
        val = -(exact_mll(spec, params, X, oidx, y)
                + log_prior_term(prior_specs, params))
        (g,) = torch.autograd.grad(val, xc)
    return val.item(), g.cpu().numpy().astype(float)


def log_prior_term(prior_specs, raw_params):
    """Sum of the prior log-densities and transform log-Jacobians over
    the raw-parameter tree (parity: likelihood.py:509-527).
    ``prior_specs``: ``(path, prior, transform)`` triples, ``path`` a
    tuple of keys addressing a leaf of ``raw_params``."""
    total = 0.0
    for path, prior, transform in prior_specs:
        leaf = raw_params
        for k in path:
            leaf = leaf[k]
        total = (total + torch.sum(prior.lnpdf(transform.forward(leaf)))
                 + torch.sum(transform.log_jacobian(leaf)))
    return total


class ExactAux(NamedTuple):
    alpha: torch.Tensor  # (n,) K~^-1 y
    solve_error: torch.Tensor  # relative residual of the factorized solve
    quad: torch.Tensor  # y^T alpha
    solve_iters: torch.Tensor  # 0: a direct solve (likelihood.py:300)


def exact_ski_mll(spec: LMCKernelSpec, raw_params, grid_data, lens, y,
                  jitter=(1e-6, 1e-4, 1e-2), c_jitter=(0.0, 1e-6, 1e-3),
                  equilibrate=None):
    """The exact marginal log-likelihood of the dense-grid SKI model
    K~ = sum_g W_g (K_UU_g + delta_g I) W_g^T + diag(eps), through the
    Woodbury factorization. Differentiable: with ``raw_params`` leaves
    that require grad, ``torch.autograd.grad(mll, ...)`` is the exact
    gradient of K~'s MLL through the Cholesky factors and K1's backward
    kernel. Returns ``(mll, ExactAux)``; the aux is detached, as the JAX
    package stops its gradient (likelihood.py:293-303)."""
    K = build_kski(spec, raw_params, grid_data, lens)
    wb = build_device_woodbury(
        K.groups, spec.noise(raw_params), K.noise_n,
        grid_data,
        jitter=jitter, c_jitter=c_jitter, equilibrate=equilibrate,
    )
    alpha = wb.solve(y)
    quad = torch.dot(y, alpha)
    n = y.shape[0]
    mll = -0.5 * (wb.logdet + quad + n * math.log(2 * math.pi))
    with torch.no_grad():
        alpha_d = alpha.detach()
        resid = wb.matvec(alpha_d) - y
        err = torch.linalg.norm(resid) / torch.clamp(torch.linalg.norm(y),
                                                     min=1e-30)
    return mll, ExactAux(alpha=alpha_d, solve_error=err, quad=quad.detach(),
                         solve_iters=torch.zeros((), dtype=torch.float32,
                                                 device=y.device))


def f32_factorization_residual(spec, raw_params, grid_data32, lens, y,
                               equilibrate=None):
    """||K~ (K~^-1 y) - y|| / ||y|| of the FLOAT32 Woodbury factorization
    at the given parameters, with the exact objective's tight jitter
    ladders (parity: likelihood.py:307-345). ``equilibrate``: as in
    :func:`build_device_woodbury`."""
    params32 = cast_params(raw_params, torch.float32)
    K32 = build_kski(spec, params32, grid_data32, lens)
    wb = build_device_woodbury(
        K32.groups, spec.noise(params32), K32.noise_n,
        grid_data32,
        jitter=(1e-6, 1e-4, 1e-2), c_jitter=(0.0, 1e-6, 1e-3),
        equilibrate=equilibrate,
    )
    y32 = y.to(torch.float32)
    alpha = wb.solve(y32)
    r = wb.matvec(alpha) - y32
    return torch.linalg.norm(r) / torch.clamp(torch.linalg.norm(y32),
                                              min=1e-30)


def rademacher_probes(generator, n_probes, n, dtype, device):
    """Fresh +-1 probes (parity: likelihood.py:133-138), drawn from an
    explicit ``torch.Generator`` on ``device``."""
    bits = torch.randint(0, 2, (n_probes, n), generator=generator,
                         device=device)
    return bits.to(dtype) * 2.0 - 1.0


class StochasticAux(NamedTuple):
    alpha: torch.Tensor  # (n,) K^-1 y
    solve_iters: torch.Tensor  # mean solver iterations (scalar)
    solve_error: torch.Tensor  # mean absolute residual of the rows
    quad: torch.Tensor  # y^T alpha


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def stochastic_surrogate_from_solves(spec, raw_params, grid_data, lens,
                                     alpha, zs, probes):
    """The differentiable tail of :func:`stochastic_mll_surrogate`
    (parity: likelihood.py:348-383): the surrogate scalar from already
    computed solutions ``alpha = K^-1 y`` and ``zs = K^-1 r_i``, at the
    dtype of the ``grid_data`` artifacts."""
    cdtype = grid_data[0].dists.dtype
    K = build_kski(spec, cast_params(raw_params, cdtype), grid_data, lens)
    operands = torch.cat([alpha.detach()[None], probes], dim=0).to(cdtype)
    applied = K.matvec(operands)
    quad_term = 0.5 * torch.dot(operands[0], applied[0])
    trace_term = torch.sum(zs.detach().to(cdtype) * applied[1:]) \
        / probes.shape[0]
    return quad_term - 0.5 * trace_term


def stochastic_mll_surrogate(spec, raw_params, grid_data, lens, y, probes,
                             tol=1e-4, maxiter=None, method="minres",
                             grid_data32=None, inner_data32=None, cycle=None,
                             stall_ratio=None):
    """Scalar whose autograd gradient is the stochastic MLL gradient, and
    its :class:`StochasticAux` (parity: likelihood.py:386-506).

    The solve of K [y, r_1..r_N] runs without gradients. With
    ``grid_data32`` (float32 dense-mode preconditioner artifacts: the
    fine grid of an all-dense model, or the twin of an fft group) it is
    Woodbury-preconditioned CG with inner float32 cycles through
    ``inner_data32`` (the fine float32 operator; default the
    ``grid_data32`` one) and model-dtype true-residual refinement;
    otherwise plain batched MINRES or CG (``method``). The JAX
    package's ``rhs_sharding`` (multi-device) and ``diff_data`` (its
    TPU float32 gradient twin) are not ported."""
    with torch.no_grad():
        solve_params = _detached(raw_params)
        K_ng = build_kski(spec, solve_params, grid_data, lens)
        rhs = torch.cat([y[None], probes], dim=0)
        if grid_data32 is not None:
            params32 = cast_params(solve_params, torch.float32)
            K32 = build_kski(spec, params32, grid_data32, lens)
            wb = build_device_woodbury(
                K32.groups, spec.noise(params32), K32.noise_n,
                grid_data32,
            )
            inner_mv = (K32.matvec if inner_data32 is None else
                        build_kski(spec, params32, inner_data32, lens).matvec)
            res = woodbury_pcg(
                K_ng.matvec, wb, rhs, tol=tol, maxiter=maxiter,
                inner_matvec=inner_mv,
                cycle=10 if cycle is None else cycle,
                stall_ratio=0.99 if stall_ratio is None else stall_ratio,
            )
        else:
            solver = batched_minres if method == "minres" else batched_cg
            res = solver(
                K_ng.matvec, rhs, tol=tol, maxiter=maxiter,
                cycle=100 if cycle is None else cycle,
                stall_ratio=0.99 if stall_ratio is None else stall_ratio,
            )
    alpha, zs = res.x[0], res.x[1:]
    surrogate = stochastic_surrogate_from_solves(
        spec, raw_params, grid_data, lens, alpha, zs, probes)
    aux = StochasticAux(
        alpha=alpha,
        solve_iters=torch.mean(res.iterations.to(torch.float32)),
        solve_error=torch.mean(res.error),
        quad=torch.dot(y, alpha),
    )
    return surrogate, aux

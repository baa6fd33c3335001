"""InterpolatedLLGP — the SKI LMC multi-output GP, prediction path
(parity: runlmc_tpu/models/interpolated_llgp.py).

This slice of the port serves a model whose parameters were set — by
``param_array``, carried across from a JAX model or set by hand — and
predicts with the 'on-the-fly' variance method: one certified batched
solve of K_SKI against [y; K_*X], preconditioned by a float32 Woodbury
factor. Training (``optimize``) comes in the next slice.

The device path runs the hand kernels of runlmc_tpu_torch/hopper/: K1
builds each grid kernel K_UU, K7 the cross-covariance K_*X, K6 fuses
the CG updates of the solve, and K9 interpolates the predictive mean.
"""

import logging
import math

import numpy as np
import torch

from runlmc_tpu_torch.config import DEFAULT_DTYPE, resolve_device
from runlmc_tpu_torch.lmc import likelihood as lk
from runlmc_tpu_torch.lmc.grid import build_kski, make_grids, to_dense_f32
from runlmc_tpu_torch.lmc.kernel_spec import LMCKernelSpec
from runlmc_tpu_torch.lmc.woodbury import build_device_woodbury, woodbury_pcg
from runlmc_tpu_torch.models.multigp import MultiGP
from runlmc_tpu_torch.ops.interpolation import multi_interpolant
from runlmc_tpu_torch.utils.carry import (
    cast_params,
    from_reference_params,
    ravel_params,
    unravel_params,
)

_LOG = logging.getLogger(__name__)

# The calibrated f32-factorization residual threshold of the 'auto'
# objective (runlmc_tpu/models/interpolated_llgp.py:64).
EXACT_RESIDUAL_THRESHOLD = 0.25

# Iteration budget of one certified-solve rung: the JAX package's 30
# host-driven rounds of at most 100 iterations each
# (interpolated_llgp.py:759, 1853), spent here in one batched solve.
# The rounds and their row slices exist there to bound single TPU
# executions under the runtime watchdog, which the card does not have.
RUNG_MAXITER = 3000


class InterpolatedLLGP(MultiGP):
    """Matrix-free LMC multi-output GP with SKI covariance approximation.

    :param Xs, Ys: per-output ragged data (see :class:`MultiGP`)
    :param functional_kernel: an :class:`LMCKernelSpec`
    :param lo, hi, m: optional per-dim grid bounds / sizes
    :param prediction: 'on-the-fly' (the only method of this slice)
    :param tolerance: absolute residual tolerance of certified solves
    :param seed: seed of the initial parameters (``init_raw_params``)
    :param dtype: model dtype (default float64)
    :param grid_mode: 'auto' | 'dense'; groups past the dense cap raise
        ``NotImplementedError`` (fft mode comes in a later slice)
    :param objective: 'auto' | 'exact' | 'stochastic' — the training
        objective. 'auto' probes the f32 Woodbury factorization residual
        at the initial parameters and picks 'exact' when it certifies
        below ``EXACT_RESIDUAL_THRESHOLD``.
    :param device: ``None`` = the CUDA device (raises without one); pass
        ``"cpu"`` to run the kernels' plain PyTorch versions
    """

    def __init__(
        self,
        Xs,
        Ys,
        normalize=True,
        lo=None,
        hi=None,
        m=None,
        name="lmc",
        prediction="on-the-fly",
        tolerance=1e-4,
        functional_kernel=None,
        seed=0,
        dtype=None,
        grid_mode="auto",
        objective="auto",
        device=None,
    ):
        self.device = resolve_device(device)
        super().__init__(Xs, Ys, normalize=normalize, name=name)
        if functional_kernel is None:
            raise ValueError("functional_kernel must be provided")
        if prediction != "on-the-fly":
            raise NotImplementedError(
                "prediction=%r: the 'exact' and 'precompute' variance "
                "methods come with slice 4 of the PyTorch port" % (prediction,)
            )
        if objective not in ("auto", "exact", "stochastic"):
            raise ValueError("unknown objective %r" % (objective,))
        self.prediction = prediction
        self.spec: LMCKernelSpec = functional_kernel.with_input_dim(
            self.input_dim
        )
        self.dtype = dtype or DEFAULT_DTYPE
        self.tolerance = float(tolerance)

        dev = self.device
        self.data = lk.flatten_data(self.Xs, self.Ys)
        self.y = torch.as_tensor(self.data.y, dtype=self.dtype, device=dev)
        self.X = torch.as_tensor(self.data.X, dtype=self.dtype, device=dev)
        self.oidx = torch.as_tensor(self.data.output_idx, device=dev)
        grid_data, self.grid_axes = make_grids(
            self.spec, self.Xs, lo, hi, m, mode=grid_mode
        )
        self.grid_data = tuple(gd.to(self.dtype, dev) for gd in grid_data)
        # float32 twin: the Woodbury preconditioner factor and the inner
        # operator of the mixed-precision solves
        self.grid_data32 = to_dense_f32(self.grid_data)
        for gd in self.grid_data:
            _LOG.info(
                "InterpolatedLLGP %s generated grid (n=%d, m=%d) for "
                "active dims %s", name, len(self.data.y),
                int(np.prod(gd.plan.sizes)), gd.plan.active_dim,
            )

        self.params = from_reference_params(
            self.spec.init_raw_params(seed=seed), self.dtype, dev
        )
        self.n_params = int(ravel_params(self.params).numel())

        self.objective = objective
        if objective == "auto":
            res = float(lk.f32_factorization_residual(
                self.spec, self.params, self.grid_data32, self.data.lens,
                self.y,
            ))
            self.objective = (
                "exact" if res <= EXACT_RESIDUAL_THRESHOLD else "stochastic"
            )
            _LOG.info(
                "objective='auto': f32 factorization probe residual %.2e "
                "(threshold %g) -> %s objective",
                res, EXACT_RESIDUAL_THRESHOLD, self.objective,
            )
        self._cache = {}
        # per-parameter-setting solve diagnostics of the latest
        # prediction solves
        self.prediction_report = {}

    # --------------------------------------------------------- parameters

    def _bump(self):
        self._cache.clear()
        self.prediction_report = {}

    def set_params(self, params):
        self.params = params
        self._bump()

    @property
    def param_array(self):
        """Flat raw-parameter vector in ``jax.flatten_util.ravel_pytree``
        order — a JAX model's ``param_array`` assigns here as it is."""
        return ravel_params(self.params).cpu().numpy()

    @param_array.setter
    def param_array(self, x):
        flat = torch.tensor(np.asarray(x), dtype=self.dtype)
        self.set_params(unravel_params(flat, self.params))

    # ----------------------------------------------------------- operators

    def _kski(self):
        """K_SKI at the model dtype (K1 builds each group's K_UU)."""
        if "kski" not in self._cache:
            self._cache["kski"] = build_kski(
                self.spec, self.params, self.grid_data, self.data.lens
            )
        return self._cache["kski"]

    def _kski32(self):
        """Float32 K_SKI: the inner operator of the mixed-precision
        solves and the input of the float32 Woodbury factor."""
        if "kski32" not in self._cache:
            self._cache["kski32"] = build_kski(
                self.spec, cast_params(self.params, torch.float32),
                self.grid_data32, self.data.lens,
            )
        return self._cache["kski32"]

    def _woodbury32(self):
        """Float32 Woodbury factor — the prediction-time preconditioner."""
        if "woodbury32" not in self._cache:
            K32 = self._kski32()
            noise32 = self.spec.noise(
                cast_params(self.params, torch.float32)
            )
            self._cache["woodbury32"] = build_device_woodbury(
                K32.groups, noise32, K32.noise_n,
                tuple(gd.WtW for gd in self.grid_data32),
            )
        return self._cache["woodbury32"]

    def _woodbury(self):
        """Model-dtype Woodbury factor with tight jitter — the escalation
        rung (parity: interpolated_llgp.py:706-729)."""
        if "woodbury" not in self._cache:
            K = self._kski()
            if self.dtype == torch.float64:
                tight, c_tight = (1e-12, 1e-9, 1e-6), (0.0, 1e-12, 1e-9)
            else:
                tight, c_tight = (1e-6, 1e-4, 1e-2), (0.0, 1e-6, 1e-3)
            self._cache["woodbury"] = build_device_woodbury(
                K.groups, self.spec.noise(self.params), K.noise_n,
                tuple(gd.WtW for gd in self.grid_data),
                jitter=tight, c_jitter=c_tight,
            )
        return self._cache["woodbury"]

    # -------------------------------------------------------------- solves

    def _solve_certified(self, rhs, what):
        """K^-1 rhs (batched, model dtype), every rung checking TRUE
        residuals (parity: interpolated_llgp.py:1784-1983, f64-native
        branch):

        1. CG preconditioned by the float32 Woodbury factor, float32
           inner cycles, model-dtype outer refinement;
        2. on a stall, CG preconditioned by the model-dtype factor;
        3. a CRITICAL log with the best iterate.

        Returns (solutions, worst absolute residual); records
        ``residual``, ``iterations``, ``escalated`` and ``rhs`` under
        ``prediction_report[what]``."""
        tol = self.tolerance
        budget = RUNG_MAXITER
        K = self._kski()

        def _worst(res):
            w = float(torch.max(res.error))
            # NaN compares False vs thresholds: treat as a breach
            return w if math.isfinite(w) else float("inf")

        res = woodbury_pcg(K.matvec, self._woodbury32(), rhs, tol=tol,
                           maxiter=budget, inner_matvec=self._kski32().matvec)
        x, worst = res.x, _worst(res)
        iters = int(torch.max(res.iterations))
        escalated = worst > tol
        if escalated:
            _LOG.warning(
                "%s: f32-preconditioned solve stalled at residual %e "
                "(tolerance %g) — escalating to the model-dtype "
                "factorization", what, worst, tol,
            )
            res2 = woodbury_pcg(K.matvec, self._woodbury(), rhs, tol=tol,
                                maxiter=budget)
            w2 = _worst(res2)
            iters += int(torch.max(res2.iterations))
            if w2 <= worst:
                x, worst = res2.x, w2
        if worst > tol:
            _LOG.critical(
                "%s (n = %d) did not converge: reconstruction error %e",
                what, self.y.shape[0], worst,
            )
        self.prediction_report[what] = {
            "residual": worst,
            "iterations": float(iters),
            "escalated": escalated,
            "rhs": int(rhs.shape[0]),
        }
        return x, worst

    def _alpha(self):
        if "alpha" not in self._cache:
            sols, _ = self._solve_certified(self.y[None], "alpha")
            self._cache["alpha"] = sols[0]
        return self._cache["alpha"]

    # ---------------------------------------------------------- prediction

    def _test_interps(self, Xs):
        return tuple(
            multi_interpolant(
                [np.asarray(X)[:, list(gd.plan.active_dim)] for X in Xs],
                axes,
            ).to(self.dtype, self.device)
            for gd, axes in zip(self.grid_data, self.grid_axes)
        )

    def _cross_kernel(self, Xs):
        td = lk.flatten_data(Xs, [np.zeros(len(X)) for X in Xs])
        Xt = torch.as_tensor(td.X, dtype=self.dtype, device=self.device)
        ot = torch.as_tensor(td.output_idx, device=self.device)
        return lk.cross_kernel(self.spec, self.params, Xt, ot, self.X,
                               self.oidx)

    def _predict_mean(self, alpha, test_interps):
        """sum_g W*_g K_UU_g W_g^T alpha, through K9's scatter and gather
        (parity: interpolated_llgp.py:865-872)."""
        mean = 0.0
        for g, ti in zip(self._kski().groups, test_interps):
            mean = mean + ti.matvec(g.grid_matvec(g.interp.rmatvec(alpha)))
        return mean

    def _native_variance(self):
        """Per-output prior variance sum_q B_q[d,d] k_q(0) + eps_d
        (parity: interpolated_llgp.py:843-858)."""
        spec, params = self.spec, self.params
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        k0 = torch.stack([spec.eval_kernel(params, q, zero)
                          for q in range(spec.Q)])
        coregs = torch.stack(
            [torch.square(spec.coreg_vec(params, q)).sum(0)
             + spec.coreg_diag(params, q) for q in range(spec.Q)],
            dim=1,
        )  # (D, Q)
        return coregs @ k0 + spec.noise(params)

    def _raw_predict(self, Xs):
        """'on-the-fly' prediction (parity: interpolated_llgp.py:2141-2187):
        the observation solve alpha rides in the same batched certified
        solve as the test columns K_*X."""
        lens = [len(X) for X in Xs]
        test_interps = self._test_interps(Xs)
        K_test_X = self._cross_kernel(Xs)
        if K_test_X.shape[0]:
            rhs = torch.cat([self.y[None], K_test_X], 0)
            sols, _ = self._solve_certified(rhs, "explained-variance")
            alpha = sols[0]
            self._cache["alpha"] = alpha
            explained = torch.sum(K_test_X * sols[1:], dim=1)
        else:
            alpha = self._alpha()
            explained = torch.zeros(0, dtype=self.dtype, device=self.device)
        mean = self._predict_mean(alpha, test_interps)
        native = torch.repeat_interleave(
            self._native_variance(),
            torch.as_tensor(lens, device=self.device),
        )
        var = torch.clamp(native - explained, min=0.0)
        mean = mean.cpu().numpy()
        var = var.cpu().numpy()
        ends = np.cumsum(lens)[:-1]
        return np.split(mean, ends), np.split(var, ends)

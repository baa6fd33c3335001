"""ExactLMC — the dense O(n^3) exact LMC multi-output GP (parity:
runlmc_tpu/models/exact_lmc.py:25-140): the oracle InterpolatedLLGP is
checked against, and a small-data model of its own.

Its value and gradient are the exact marginal log-likelihood
(``likelihood.exact_mll``) through autograd: kernel K7 builds the dense
kernel and K7's backward carries the gradient to the parameters, around
cuSOLVER's Cholesky. ``optimize`` runs scipy's L-BFGS-B on the host.
Prediction is by the same Cholesky. Runs on the CUDA device unless the
caller passes ``device="cpu"``.
"""

import logging

import numpy as np
import scipy.optimize
import torch

from runlmc_tpu_torch.config import DEFAULT_DTYPE, resolve_device
from runlmc_tpu_torch.hopper.trsm import cho_solve
from runlmc_tpu_torch.lmc import likelihood as lk
from runlmc_tpu_torch.models.multigp import MultiGP
from runlmc_tpu_torch.utils.carry import (
    from_reference_params,
    ravel_params,
    unravel_params,
)

_LOG = logging.getLogger(__name__)


class ExactLMC(MultiGP):
    def __init__(
        self,
        Xs,
        Ys,
        functional_kernel=None,
        normalize=True,
        name="exact-lmc",
        seed=0,
        dtype=None,
        device=None,
    ):
        self.device = resolve_device(device)
        super().__init__(Xs, Ys, normalize=normalize, name=name)
        if functional_kernel is None:
            raise ValueError("functional_kernel must be provided")
        self.spec = functional_kernel.with_input_dim(self.input_dim)
        self.dtype = dtype or DEFAULT_DTYPE
        dev = self.device
        self.data = lk.flatten_data(self.Xs, self.Ys)
        self.y = torch.as_tensor(self.data.y, dtype=self.dtype, device=dev)
        self._X = torch.as_tensor(self.data.X, dtype=self.dtype, device=dev)
        self._oidx = torch.as_tensor(self.data.output_idx, device=dev)
        self.seed = seed
        self.params = from_reference_params(
            self.spec.init_raw_params(seed=seed), self.dtype, dev)

    @property
    def param_array(self):
        """Flat raw parameters in ``ravel_pytree`` order, as numpy."""
        return ravel_params(self.params).cpu().numpy()

    @param_array.setter
    def param_array(self, x):
        flat = torch.tensor(np.asarray(x), dtype=self.dtype)
        self.params = unravel_params(flat, self.params)

    def _value_and_grad(self, x_flat):
        """The negative exact MLL at ``x_flat`` and its flat gradient,
        as (float, numpy)."""
        return lk.exact_value_and_grad(self.spec, self.params, x_flat,
                                       self._X, self._oidx, self.y)

    def log_likelihood(self):
        return -self._value_and_grad(self.param_array)[0]

    def optimize(self, max_iters=100, **kwargs):
        """L-BFGS-B (scipy, on the host) on the exact negative MLL with
        its autograd gradient."""
        res = scipy.optimize.minimize(
            self._value_and_grad, self.param_array, jac=True,
            method="L-BFGS-B", options={"maxiter": max_iters},
        )
        self.param_array = res.x
        _LOG.info("%s: L-BFGS done, nll %f", self.name, res.fun)
        return res

    def _raw_predict(self, Xs):
        lens = [len(X) for X in Xs]
        td = lk.flatten_data(Xs, [np.zeros(len(X)) for X in Xs])
        Xt = torch.as_tensor(td.X, dtype=self.dtype, device=self.device)
        ot = torch.as_tensor(td.output_idx, device=self.device)
        L = lk.exact_chol(self.spec, self.params, self._X, self._oidx)
        alpha = cho_solve(L, self.y[None])[0]
        K_star = lk.cross_kernel(self.spec, self.params, Xt, ot, self._X,
                                 self._oidx)
        mean = (K_star @ alpha).cpu().numpy()
        K_star = K_star.contiguous()
        sol = cho_solve(L, K_star)
        explained = torch.sum(K_star * sol, dim=1).cpu().numpy()
        # prior variance of each test point (with noise), minus explained
        prior = np.zeros(sum(lens))
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        k0 = [float(self.spec.eval_kernel(self.params, q, zero))
              for q in range(self.spec.Q)]
        noise = self.spec.noise(self.params).cpu().numpy()
        for d in range(self.output_dim):
            v = noise[d]
            for q in range(self.spec.Q):
                a = self.spec.coreg_vec(self.params, q).cpu().numpy()
                kap = self.spec.coreg_diag(self.params, q).cpu().numpy()
                v += (np.square(a[:, d]).sum() + kap[d]) * k0[q]
            prior[td.output_idx == d] = v
        var = prior - explained
        var[var < 0] = 0
        ends = np.cumsum(lens)[:-1]
        return np.split(mean, ends), np.split(var, ends)

"""Optimization diagnostics recorder (a copy of runlmc_tpu/metrics.py:6-12:
the per-step lists that ``InterpolatedLLGP(metrics=True)`` fills)."""


class Metrics:
    def __init__(self):
        self.iterations = []  # mean Krylov iterations per step
        self.solv_error = []  # mean solve reconstruction error per step
        self.grad_norms = []  # inf-norm of the stochastic gradient
        self.grad_error = []  # relative error vs exact gradient
        self.log_likely = []  # exact log likelihood trace

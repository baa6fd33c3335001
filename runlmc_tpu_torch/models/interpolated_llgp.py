"""InterpolatedLLGP — the SKI LMC multi-output GP: training with the
exact or the stochastic objective, prediction in the three variance
modes, and likelihood reporting (parity:
runlmc_tpu/models/interpolated_llgp.py).

Training (:meth:`InterpolatedLLGP.optimize`) runs AdaDelta on one of two
objectives. The exact objective (all-dense grids) differentiates the
exact marginal likelihood of the factorized SKI model by torch autograd
through a direct Woodbury factorization built every step in float32 (or
at the model dtype after an escalation). The stochastic objective (any
grid, the only one for fft-mode grids) differentiates the Hutchinson
surrogate of lmc/likelihood.py, with the solutions of one certified
batched solve of K against [y; 15 Rademacher probes] per step. Steps
run on the device in chunks of ``chunk_len``; the host replays the
reference's stopping rule once per chunk, and a stochastic chunk whose
solves breach the tolerance is re-run through the rescue rungs.
Prediction ('on-the-fly') is one certified batched solve of K_SKI
against [y; K_*X], preconditioned by a float32 Woodbury factor;
'precompute' solves once for every grid column and 'exact' uses the
dense Cholesky. ``log_likelihood`` reports the exact dense definition
(K7 and cuSOLVER) or the SKI one (the Woodbury log-det on dense grids,
stochastic Lanczos quadrature through kernel K13 on fft grids);
``metrics=True`` training compares every step's gradient with the exact
dense gradient (K7's backward).

The device path runs the hand kernels of runlmc_tpu_torch/hopper/: K1
builds each dense grid kernel K_UU and its backward carries the gradient
to the kernel and coregionalization parameters; on fft grids K10 does
the Fourier-space contraction and its backward; K7 the cross-covariance
K_*X and the exact dense kernel, and its backward the exact gradient;
K6 fuses the CG updates, K12 the MINRES updates of the solves and K13
the Lanczos steps of the SLQ log-det; K9 interpolates the predictive
mean.

With a ``mesh`` (runlmc_tpu_torch/parallel) every rank runs the same
calls on its own device: the first non-'grid' axis shards the
stochastic objective's solve batch (``lk.sharded_solve``) and the exact
objective's data rows, a 'grid' axis the Fourier axis of fft groups;
each step's flat gradient is averaged over the mesh, so that every rank
holds the same bits and takes the same host decisions. Prediction, the
reports and checkpoints run replicated on every rank, as in the JAX
package.
"""

import logging
import math
import time

import dataclasses

import numpy as np
import torch

import runlmc_tpu_torch.lmc.woodbury as wbm
from runlmc_tpu_torch.config import DEFAULT_DTYPE, resolve_device
from runlmc_tpu_torch.hopper.trsm import cho_solve
from runlmc_tpu_torch.lmc import likelihood as lk
from runlmc_tpu_torch.lmc.grid import (
    build_kski,
    fine_fft_f32,
    make_grids,
    precond_dense_f32,
    to_dense_f32,
)
from runlmc_tpu_torch.lmc.kernel_spec import LMCKernelSpec
from runlmc_tpu_torch.models.multigp import MultiGP
from runlmc_tpu_torch.metrics import Metrics
from runlmc_tpu_torch.models.optimization import EVAL_NORM, AdaDelta
from runlmc_tpu_torch.ops.interpolation import multi_interpolant
from runlmc_tpu_torch.ops.slq import slq_logdet_from_probes
from runlmc_tpu_torch.ops.solvers import batched_minres
from runlmc_tpu_torch.parallel.collectives import mesh_mean
from runlmc_tpu_torch.parallel.mesh import Mesh
from runlmc_tpu_torch.params import IDENTITY, POSITIVE
from runlmc_tpu_torch.priors import check_domain
from runlmc_tpu_torch.utils.carry import (
    cast_params,
    from_reference_params,
    ravel_params,
    unravel_params,
)
from runlmc_tpu_torch.utils.checkpoint import is_jax_key, warn_foreign_key

_LOG = logging.getLogger(__name__)

# The calibrated f32-factorization residual threshold of the 'auto'
# objective's probe and of the exact objective's in-training escalation
# (runlmc_tpu/models/interpolated_llgp.py:64).
EXACT_RESIDUAL_THRESHOLD = 0.25

# The 'auto' objective's held-out-block validation guard
# (interpolated_llgp.py:86-104): demote when the twin's held-out z^2 or
# its zero-variance share exceeds these; the twin trains at most
# VALIDATION_GUARD_MAX_IT steps on data with ~VALIDATION_HOLDOUT_FRAC
# of each output held out in two contiguous blocks.
VALIDATION_ZSQ_THRESHOLD = 50.0
VALIDATION_ZEROVAR_THRESHOLD = 0.05
VALIDATION_HOLDOUT_FRAC = 0.06
VALIDATION_GUARD_MAX_IT = 60

# Jitter ladders of the exact objective's float32 factorizations (parity:
# interpolated_llgp.py:537-538)
F32_JITTER = (1e-6, 1e-4, 1e-2)
F32_C_JITTER = (0.0, 1e-6, 1e-3)

# Iteration budget of one certified-solve rung: the JAX package's 30
# host-driven rounds of at most 100 iterations each
# (interpolated_llgp.py:759, 1853), spent here in one batched solve.
# The rounds and their row slices exist there to bound single TPU
# executions under the runtime watchdog, which the card does not have.
RUNG_MAXITER = 3000
# The training rescue's rung budget: the JAX package's 5 rounds of 100
# iterations (interpolated_llgp.py:1656-1659), in one batched solve.
RESCUE_MAXITER = 500
# Plain MINRES cycle of the certified solve's last rung (the JAX
# package's 150-iteration rounds, interpolated_llgp.py:818-821).
KRYLOV_CYCLE = 150


def _worst_of(errs):
    """The largest of ``errs``; NaN reads as a breach (inf)."""
    w = float(np.max(np.asarray(errs, dtype=float)))
    return w if math.isfinite(w) else float("inf")


def _bad_steps(errs, tol):
    errs = np.asarray(errs, dtype=float)
    return (errs > tol) | ~np.isfinite(errs)


def _probe_seed(run_seed, it):
    """The seed of the probe generator of global iteration ``it``: the
    stream depends on (run seed, iteration) only, so chunk boundaries
    and resumes do not change it. The pair is hashed into every bit of
    the seed: the CPU generator keeps only its low 32 bits."""
    state = np.random.SeedSequence([int(run_seed), int(it)])
    return int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def _run_seed_of(key):
    """The int run seed of ``warm_rescue``'s ``key``: ``None`` -> 0, an
    int as it is, a ``uint32[2]`` array (a JAX PRNG key) -> its two words
    as one 64-bit int."""
    if key is None:
        return 0
    k = np.asarray(key)
    if k.shape == ():
        return int(k)
    if k.shape == (2,) and k.dtype == np.uint32:
        return (int(k[0]) << 32) | int(k[1])
    raise ValueError("warm_rescue: key must be None, an int or a uint32[2] "
                     "array, got %r" % (key,))


def _resumed_run_seed(state):
    """The run seed that ``optimize(state=...)`` continues: the int
    ``rng_key`` of an earlier ``info['state']`` (or of a port
    checkpoint's ``opt_state``); None without one, and, with a warning,
    for a JAX package's ``uint32[2]`` key, whose probe stream the port
    cannot continue."""
    if state is None or "rng_key" not in state:
        return None
    if is_jax_key(state["rng_key"]):
        warn_foreign_key("optimize")
        return None
    return int(np.asarray(state["rng_key"]).reshape(()))


class InterpolatedLLGP(MultiGP):
    """Matrix-free LMC multi-output GP with SKI covariance approximation.

    :param Xs, Ys: per-output ragged data (see :class:`MultiGP`)
    :param functional_kernel: an :class:`LMCKernelSpec`
    :param lo, hi, m: optional per-dim grid bounds / sizes
    :param prediction: 'on-the-fly' | 'precompute' | 'exact' — the
        predictive variance method
    :param trace_iterations: Hutchinson probes per stochastic gradient
    :param tolerance: absolute residual tolerance of certified solves
    :param solver: 'minres' | 'cg' — the plain Krylov solver of the
        stochastic objective's rescue rung
    :param seed: seed of the initial parameters (``init_raw_params``)
        and of the probe streams
    :param dtype: model dtype (default float64)
    :param grid_mode: 'auto' | 'dense' | 'fft'; 'auto' runs groups past
        ``DENSE_MAX_GRID`` points in fft mode
    :param objective: 'auto' | 'exact' | 'stochastic' — the training
        objective. 'exact' needs every group in dense mode. 'auto' on
        an all-dense model probes the f32 Woodbury factorization
        residual at the initial parameters (and, on a breach, once more
        with the Jacobi equilibration flipped) and picks 'exact' when it
        certifies below ``EXACT_RESIDUAL_THRESHOLD``, else
        'stochastic'; an auto-selected 'exact' runs the held-out-block
        validation guard before its first training. 'auto' with an fft
        group is 'stochastic'.
    :param exact_precision: 'f32' | 'model' — the dtype of the exact
        objective's per-step factorization (training escalates 'f32' to
        'model' on a residual breach)
    :param metrics: record per-step diagnostics in ``self.metrics``
        (:class:`Metrics`), including each step's gradient error against
        the exact dense gradient; training then runs step by step
    :param mesh: optional :class:`runlmc_tpu_torch.parallel.Mesh`, the
        same on every rank: its first non-'grid' axis shards the
        (1 + trace_iterations)-row solve batch of the stochastic
        objective and the data rows of the exact one, a 'grid' axis the
        Fourier axis of fft-mode groups (parity:
        interpolated_llgp.py:214-276)
    :param device: ``None`` = the CUDA device (the mesh's device with a
        mesh on a card; raises without one); pass ``"cpu"`` to run the
        kernels' plain PyTorch versions
    """

    VALIDATION_GUARD_MAX_IT = VALIDATION_GUARD_MAX_IT
    EVAL_NORM = EVAL_NORM
    # Default size cutoff of log_likelihood(exact=None) (parity:
    # interpolated_llgp.py:2059-2065): above it the exact O(n^3) log-det
    # is a 2 GB Cholesky per parameter setting (weather, n = 15,789) for
    # a reporting-only quantity, so the default switches to the SKI
    # log-det. ``exact=True/False`` pins the definition.
    LARGE_N_EXACT_REPORT = 5000

    def __init__(
        self,
        Xs,
        Ys,
        normalize=True,
        lo=None,
        hi=None,
        m=None,
        name="lmc",
        metrics=False,
        prediction="on-the-fly",
        trace_iterations=15,
        tolerance=1e-4,
        solver="minres",
        functional_kernel=None,
        seed=0,
        dtype=None,
        grid_mode="auto",
        objective="auto",
        exact_precision="f32",
        mesh=None,
        max_procs=None,  # accepted and ignored, as in the JAX package
        device=None,
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError("mesh: expected a runlmc_tpu_torch.parallel "
                             "Mesh, got %r" % (mesh,))
        del max_procs
        if device is None and mesh is not None and mesh.device.type == "cuda":
            device = mesh.device
        self.device = resolve_device(device)
        super().__init__(Xs, Ys, normalize=normalize, name=name)
        if functional_kernel is None:
            raise ValueError("functional_kernel must be provided")
        # raw observations and constructor arguments: the validation
        # guard builds a twin model on block-held-out data
        self._raw_Ys = [np.asarray(Y, dtype=float) for Y in Ys]
        self._ctor = dict(
            normalize=normalize, lo=lo, hi=hi, m=m,
            trace_iterations=trace_iterations, tolerance=tolerance,
            solver=solver, seed=seed, dtype=dtype, grid_mode=grid_mode,
            exact_precision=exact_precision,
            functional_kernel=functional_kernel, device=device,
        )
        if prediction not in ("on-the-fly", "precompute", "exact"):
            raise ValueError(
                "Variance prediction method {} unrecognized".format(
                    prediction))
        if objective not in ("auto", "exact", "stochastic"):
            raise ValueError("unknown objective %r" % (objective,))
        if exact_precision not in ("f32", "model"):
            raise ValueError("unknown exact_precision %r" % (exact_precision,))
        if solver not in ("minres", "cg"):
            raise ValueError("unknown solver %r" % (solver,))
        self.prediction = prediction
        self.spec: LMCKernelSpec = functional_kernel.with_input_dim(
            self.input_dim
        )
        self.dtype = dtype or DEFAULT_DTYPE
        self.n_probes = int(trace_iterations)
        self.tolerance = float(tolerance)
        self.solver = solver
        # optimizer steps per device chunk (interpolated_llgp.py:207-213)
        self.chunk_len = 10
        # The 'grid' axis (if any) shards fft groups' Fourier axis; the
        # first non-grid axis shards the solve batch and, for the exact
        # objective, the data rows (interpolated_llgp.py:214-243). A mesh
        # whose only axis is 'grid' gets neither.
        self.mesh = mesh
        self._rhs_sharding = self._data_shard = None
        if mesh is not None:
            batch_axis = next(
                (a for a in mesh.axis_names if a != "grid"), None)
            if batch_axis is not None:
                self._rhs_sharding = (mesh, batch_axis)
                self._data_shard = (mesh, batch_axis)

        dev = self.device
        self.data = lk.flatten_data(self.Xs, self.Ys)
        self.y = torch.as_tensor(self.data.y, dtype=self.dtype, device=dev)
        self.X = torch.as_tensor(self.data.X, dtype=self.dtype, device=dev)
        self.oidx = torch.as_tensor(self.data.output_idx, device=dev)
        grid_data, self.grid_axes = make_grids(
            self.spec, self.Xs, lo, hi, m, mode=grid_mode
        )
        if mesh is not None and "grid" in mesh.axis_names:
            # fft groups' Fourier axis over 'grid' (dense groups stay
            # replicated; interpolated_llgp.py:266-276): the fine
            # operators of both dtypes, not the dense preconditioner twin
            grid_data = [
                gd.replace(plan=dataclasses.replace(
                    gd.plan, grid_shard=(mesh, "grid")))
                if gd.plan.mode == "fft" else gd
                for gd in grid_data
            ]
        self.grid_data = tuple(gd.to(self.dtype, dev) for gd in grid_data)
        # float32 twins: ``precond_data32`` feeds the Woodbury
        # preconditioner factor, ``inner_data32`` the inner operator of
        # the mixed-precision solves. An all-dense model factorizes its
        # own fine grid (``grid_data32``, the exact objective's input
        # too); an fft group contributes its dense twin to the factor
        # and its fine fft operator to the inner cycles.
        if self._all_dense:
            self.grid_data32 = to_dense_f32(self.grid_data)
            self.precond_data32 = self.inner_data32 = self.grid_data32
        else:
            self.grid_data32 = None
            memo = {}
            self.precond_data32 = precond_dense_f32(grid_data, dev, memo)
            self.inner_data32 = fine_fft_f32(grid_data, dev, memo)
        if objective == "exact" and not self._all_dense:
            raise ValueError(
                "objective='exact' requires every grid group in dense mode "
                "(grid_mode='dense', or grids small enough under 'auto')"
            )
        for gd in self.grid_data:
            _LOG.info(
                "InterpolatedLLGP %s generated grid (n=%d, m=%d) for "
                "active dims %s", name, len(self.data.y),
                int(np.prod(gd.plan.sizes)), gd.plan.active_dim,
            )

        # the seed of the initial parameters and of the run-seed stream;
        # a checkpoint's rng_key is jax.random.PRNGKey(seed)'s layout
        self.seed = seed
        self.params = from_reference_params(
            self.spec.init_raw_params(seed=seed), self.dtype, dev
        )
        self.n_params = int(ravel_params(self.params).numel())

        self.objective = objective
        # 'f32': the per-step factorization runs in float32; 'model': at
        # the model dtype with tight jitter (small-noise regimes)
        self.exact_precision = exact_precision
        # Jacobi-equilibration mode of the Woodbury factorizations (None
        # = woodbury.EQUILIBRATE_DEFAULT); flipped at most once, as a
        # rescue rung, when the float32 factorization breaches and the
        # flipped one certifies (interpolated_llgp.py:366-381)
        self._equilibrate = None
        self._equilibrate_flip_tried = False
        self._auto_exact_guard = False
        if objective == "auto" and not self._all_dense:
            self.objective = "stochastic"
        elif objective == "auto":
            res = self._probe_residual(self.params, None)
            if res > EXACT_RESIDUAL_THRESHOLD:
                flipped = not wbm.EQUILIBRATE_DEFAULT
                res_flip = self._probe_residual(self.params, flipped)
                if res_flip <= EXACT_RESIDUAL_THRESHOLD:
                    _LOG.info(
                        "objective='auto': default-equilibration probe "
                        "residual %.2e breaches but the flipped mode "
                        "certifies at %.2e — using exact with "
                        "equilibrate=%s", res, res_flip, flipped,
                    )
                    self._equilibrate = flipped
                    self._equilibrate_flip_tried = True
                    res = res_flip
            self.objective = (
                "exact" if res <= EXACT_RESIDUAL_THRESHOLD else "stochastic"
            )
            self._auto_exact_guard = self.objective == "exact"
            _LOG.info(
                "objective='auto': f32 factorization probe residual %.2e "
                "(threshold %g) -> %s objective",
                res, EXACT_RESIDUAL_THRESHOLD, self.objective,
            )
        # run seeds of the probe streams (one per optimize call), drawn
        # from the model seed; see _probes
        self._seed_rng = np.random.default_rng(seed)
        # optional ``(run_seed, global_iter) -> (n_probes, n)`` source of
        # the stochastic objective's probes, in place of the seeded
        # generator (tests feed the JAX package's stream through it)
        self.probe_stream = None
        # optional ``(n_probes, n) -> (n_probes, n)`` source of the SLQ
        # log-det's probes, in place of the generator seeded 0 (tests
        # feed the JAX package's PRNGKey(0) probes through it)
        self.slq_probes = None
        self._prior_specs = []
        self.metrics = Metrics() if metrics else None
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

    # ------------------------------------------------------------ priors

    def set_prior(self, path, prior):
        """Place a prior on the constrained value of the raw-parameter
        leaf at ``path`` (a tuple of keys, e.g. ``('noise',)`` or
        ``('kernels', 'q0', 'inv_lengthscale')``); every objective and
        the exact oracle add its log-density and the transform's
        log-Jacobian (parity: interpolated_llgp.py:906-926). A prior adds
        no parameter."""
        transform = self._transform_for_path(path)
        check_domain(prior, transform)
        self._prior_specs.append((tuple(path), prior, transform))
        self._bump()

    def _transform_for_path(self, path):
        if path[0] in ("noise", "coreg_diags"):
            return POSITIVE
        if path[0] == "coreg_vecs":
            return IDENTITY
        if path[0] == "kernels":
            q = int(path[1][1:])
            return self.spec.kernels[q].param_spec()[path[2]][1]
        raise KeyError(path)

    def _log_prior(self, params):
        """The priors' term at ``params`` (0 without priors)."""
        return lk.log_prior_term(self._prior_specs, params)

    def _probe_residual(self, params, equilibrate):
        """The float32 factorization residual at ``params``; NaN reads as
        a breach."""
        res = float(lk.f32_factorization_residual(
            self.spec, params, self.grid_data32, self.data.lens, self.y,
            equilibrate=equilibrate,
        ))
        return res if math.isfinite(res) else float("inf")

    @property
    def _all_dense(self):
        return all(gd.plan.mode == "dense" for gd in self.grid_data)

    @property
    def _gradient_adopt_bound(self):
        """The calibrated gradient-accuracy residual bound of training
        solves (parity: interpolated_llgp.py:1584-1593): the tolerance,
        or an absolute 2e-2 * sqrt(n) (probes have norm sqrt(n), and a
        relative residual of 2e-2 keeps the gradient within 0.4%)."""
        return max(self.tolerance, 2e-2 * math.sqrt(len(self.data.y)))

    # ----------------------------------------------------------- operators

    def _kski(self):
        """K_SKI at the model dtype (K1 builds each group's K_UU)."""
        if "kski" not in self._cache:
            self._cache["kski"] = build_kski(
                self.spec, self.params, self.grid_data, self.data.lens
            )
        return self._cache["kski"]

    def _kski32(self):
        """Float32 K_SKI on ``inner_data32``: the inner operator of the
        mixed-precision solves (and, for an all-dense model, the input
        of the float32 Woodbury factor)."""
        if "kski32" not in self._cache:
            self._cache["kski32"] = build_kski(
                self.spec, cast_params(self.params, torch.float32),
                self.inner_data32, self.data.lens,
            )
        return self._cache["kski32"]

    def _woodbury32(self):
        """Float32 Woodbury factor on ``precond_data32`` — the
        preconditioner of the certified solves: exact at float32 for an
        all-dense model, the dense twin's for an fft group."""
        if "woodbury32" not in self._cache:
            K32 = (self._kski32() if self.precond_data32 is self.inner_data32
                   else build_kski(self.spec,
                                   cast_params(self.params, torch.float32),
                                   self.precond_data32, self.data.lens))
            noise32 = self.spec.noise(
                cast_params(self.params, torch.float32)
            )
            self._cache["woodbury32"] = wbm.build_device_woodbury(
                K32.groups, noise32, K32.noise_n,
                self.precond_data32,
                equilibrate=self._equilibrate,
            )
        return self._cache["woodbury32"]

    def _woodbury(self):
        """Model-dtype Woodbury factor with tight jitter — the escalation
        rung of an all-dense model (parity: interpolated_llgp.py:706-729)."""
        if not self._all_dense:
            raise ValueError("the model-dtype Woodbury factor needs every "
                             "grid group in dense mode")
        if "woodbury" not in self._cache:
            K = self._kski()
            tight, c_tight = self._model_ladders()
            self._cache["woodbury"] = wbm.build_device_woodbury(
                K.groups, self.spec.noise(self.params), K.noise_n,
                self.grid_data,
                jitter=tight, c_jitter=c_tight,
                equilibrate=self._equilibrate,
            )
        return self._cache["woodbury"]

    # -------------------------------------------------------------- solves

    def _solve_certified(self, rhs, what, tol=None, maxiter=None):
        """K^-1 rhs (batched, model dtype), every rung checking TRUE
        residuals (parity: interpolated_llgp.py:1784-1983, f64-native
        branch):

        1. CG preconditioned by the float32 Woodbury factor, float32
           inner cycles, model-dtype outer refinement;
        2. on a stall, for an all-dense model, CG preconditioned by the
           model-dtype factor; for a model with an fft group, model-dtype
           CG cycles with the float32 factor, warm-started (rung 1.5),
           then plain model-dtype MINRES, warm-started from the better
           iterate (rung 2);
        3. a CRITICAL log with the best iterate.

        Every rung's solver aims at the model tolerance; ``tol``
        (default the model tolerance; the training rescue passes its
        looser calibrated bound) decides when to escalate, and
        ``maxiter`` (default ``RUNG_MAXITER``) bounds each rung. Returns
        (solutions, worst absolute residual); records ``residual``,
        ``iterations``, ``escalated`` and ``rhs`` under
        ``prediction_report[what]``."""
        tol = self.tolerance if tol is None else float(tol)
        aim = self.tolerance  # as the JAX package's rounds (:780, :819)
        budget = RUNG_MAXITER if maxiter is None else int(maxiter)
        K = self._kski()

        def _worst(res):
            return _worst_of(torch.max(res.error).item())

        def _from(x0, solve):
            """Warm start: solve K dx = rhs - K x0; (x0 + dx, result)."""
            res = solve(rhs - K.matvec(x0))
            return x0 + res.x, res

        res = wbm.woodbury_pcg(K.matvec, self._woodbury32(), rhs, tol=aim,
                               maxiter=budget,
                               inner_matvec=self._kski32().matvec)
        x, worst = res.x, _worst(res)
        iters = int(torch.max(res.iterations))
        escalated = worst > tol
        if escalated and self._all_dense:
            _LOG.warning(
                "%s: f32-preconditioned solve stalled at residual %e "
                "(tolerance %g) — escalating to the model-dtype "
                "factorization", what, worst, tol,
            )
            res2 = wbm.woodbury_pcg(K.matvec, self._woodbury(), rhs,
                                    tol=aim, maxiter=budget)
            x2, w2 = res2.x, _worst(res2)
            iters += int(torch.max(res2.iterations))
            if w2 <= worst:
                x, worst = x2, w2
        elif escalated:
            _LOG.warning(
                "%s: f32-preconditioned solve stalled at residual %e "
                "(tolerance %g) — escalating to model-dtype cycles with "
                "the f32 factor", what, worst, tol,
            )
            wb32 = self._woodbury32()
            x2, res2 = _from(x, lambda r: wbm.woodbury_pcg(
                K.matvec, wb32, r, tol=aim, maxiter=budget))
            w2 = _worst(res2)
            it2 = int(torch.max(res2.iterations))
            if w2 > tol:
                _LOG.warning(
                    "%s: preconditioned model-dtype cycles still at "
                    "residual %e — final plain-Krylov rung", what, w2,
                )
                x2b, res2b = _from(x2 if w2 <= worst else x,
                                   lambda r: batched_minres(
                                       K.matvec, r, tol=aim, maxiter=budget,
                                       cycle=KRYLOV_CYCLE,
                                       stall_ratio=0.999))
                w2b = _worst(res2b)
                it2 += int(torch.max(res2b.iterations))
                if w2b <= w2:
                    x2, w2 = x2b, w2b
            iters += it2
            if w2 <= worst:
                x, worst = x2, w2
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

    # ----------------------------------------------------------- reporting

    def _chol(self):
        """Lower Cholesky factor of the dense exact kernel (K7, cuSOLVER),
        NaN on a factorization failure."""
        if "chol" not in self._cache:
            self._cache["chol"] = lk.exact_chol(self.spec, self.params,
                                                self.X, self.oidx)
        return self._cache["chol"]

    def K(self):
        """The dense exact kernel with noise, as numpy (O(n^2); reporting
        and debugging only; parity: interpolated_llgp.py:1999-2004)."""
        return lk.exact_dense_K(self.spec, self.params, self.X,
                                self.oidx).cpu().numpy()

    def log_det_K(self):
        """Log determinant of the dense exact kernel by its Cholesky
        factor (O(n^3), reporting only; parity:
        interpolated_llgp.py:2006-2015): ``-inf``, with a CRITICAL log,
        when the factor has a nonpositive or non-finite diagonal."""
        diag = torch.diagonal(self._chol()).cpu().numpy()
        if np.any(diag <= 0) or np.any(~np.isfinite(diag)):
            _LOG.critical("Log determinant nonpositive, returning -inf")
            return -np.inf
        return float(2.0 * np.log(diag).sum())

    def normal_quadratic(self):
        """y^T K_SKI^-1 y, by the certified solve (parity:
        interpolated_llgp.py:2017-2019)."""
        return float(torch.dot(self.y, self._alpha()))

    def ski_log_det(self):
        """Log det of the SKI covariance, never materializing an (n, n)
        matrix (parity: interpolated_llgp.py:2021-2049, the branch of a
        platform that factorizes the model dtype natively, as the card
        does float64): the Woodbury factorization's log-det for an
        all-dense model; otherwise the stochastic Lanczos quadrature
        estimate (ops/slq.py, kernel K13) with ``max(trace_iterations,
        15)`` probes from a generator seeded 0 (or ``slq_probes``) and
        40 steps through the model-dtype operator, cached per parameter
        setting."""
        if self._all_dense:
            return float(self._woodbury().logdet)
        if "slq_logdet" not in self._cache:
            n = len(self.data.y)
            n_probes = max(self.n_probes, 15)
            if self.slq_probes is not None:
                z = torch.as_tensor(
                    np.asarray(self.slq_probes(n_probes, n)),
                    dtype=self.dtype, device=self.device)
            else:
                gen = torch.Generator(device=self.device).manual_seed(0)
                z = lk.rademacher_probes(gen, n_probes, n, self.dtype,
                                         self.device)
            self._cache["slq_logdet"] = float(slq_logdet_from_probes(
                self._kski().matvec, z, k=40))
        return self._cache["slq_logdet"]

    def ski_log_likelihood(self):
        """The SKI model's own marginal log-likelihood
        -1/2 (ski_log_det + y^T K_SKI^-1 y + n log 2 pi) (parity:
        interpolated_llgp.py:2051-2057)."""
        nll = self.ski_log_det() + self.normal_quadratic()
        nll += len(self.data.y) * np.log(2 * np.pi)
        return -0.5 * nll

    def log_likelihood(self, exact=None):
        """-1/2 (log det K + y^T K^-1 y + n log 2 pi) (parity:
        interpolated_llgp.py:2067-2099).

        :param exact: ``True``: the exact dense-kernel Cholesky log-det
            (:meth:`log_det_K`, O(n^3)); ``False``: the SKI log-det
            (:meth:`ski_log_det`); ``None``: ``True`` for n <=
            ``LARGE_N_EXACT_REPORT``, else ``False`` with a WARNING naming
            the definition used."""
        n = len(self.data.y)
        if exact is None:
            exact = n <= self.LARGE_N_EXACT_REPORT
            if not exact:
                _LOG.warning(
                    "log_likelihood: n=%d > %d, reporting the SKI "
                    "logdet (%s) instead of the O(n^3) exact logdet; "
                    "pass exact=True/False to pin the definition",
                    n, self.LARGE_N_EXACT_REPORT,
                    "Woodbury, near-exact" if self._all_dense
                    else "Lanczos-quadrature estimate",
                )
        logdet = self.log_det_K() if exact else self.ski_log_det()
        nll = logdet + self.normal_quadratic() + n * np.log(2 * np.pi)
        return -0.5 * nll

    def _exact_value_and_grad(self, x_flat):
        """The negative exact dense MLL plus priors at ``x_flat`` and its
        flat gradient, as (float, numpy): K7 forward and backward,
        cuSOLVER's Cholesky and its autograd."""
        return lk.exact_value_and_grad(self.spec, self.params, x_flat,
                                       self.X, self.oidx, self.y,
                                       self._prior_specs)

    def exact_log_likelihood_and_grad(self):
        """The exact dense MLL (plus priors) and its flat gradient at the
        current parameters: the oracle (parity:
        interpolated_llgp.py:2101-2108)."""
        val, g = self._exact_value_and_grad(self.param_array)
        return -val, -g

    # ------------------------------------------------------------ training

    def _model_ladders(self):
        """(K_UU jitter, C jitter) of a model-dtype factorization (parity:
        interpolated_llgp.py:541-546, 711-720)."""
        if self.dtype == torch.float64:
            return (1e-12, 1e-9, 1e-6), (0.0, 1e-12, 1e-9)
        return F32_JITTER, F32_C_JITTER

    def _exact_ladders(self):
        """(compute dtype, grid data, K_UU jitter, C jitter) of the exact
        objective's factorization (parity: interpolated_llgp.py:535-546)."""
        if self.exact_precision == "f32":
            return torch.float32, self.grid_data32, F32_JITTER, F32_C_JITTER
        return (self.dtype, self.grid_data) + self._model_ladders()

    def _exact_grad(self, x_flat):
        """Gradient of the negative exact MLL at the flat parameters
        ``x_flat`` (a model-dtype tensor on the device), in
        ``ravel_params`` order and the model dtype, with the objective's
        detached aux (parity: interpolated_llgp.py:525-566). Autograd runs
        through the per-step Woodbury factorization and K1's backward."""
        cdtype, gd, jitter, c_jitter = self._exact_ladders()
        with torch.enable_grad():
            xc = x_flat.detach().to(cdtype).requires_grad_(True)
            params = unravel_params(xc, cast_params(self.params, cdtype))
            mll, aux = lk.exact_ski_mll(
                self.spec, params, gd, self.data.lens, self.y.to(cdtype),
                jitter=jitter, c_jitter=c_jitter,
                data_shard=self._data_shard,
                equilibrate=self._equilibrate,
            )
            (g,) = torch.autograd.grad(-(mll + self._log_prior(params)), xc)
        return mesh_mean(g, self.mesh).to(x_flat.dtype), aux

    def _probes(self, run_seed, it):
        """The (n_probes, n) Rademacher probes of global iteration ``it``
        of the run ``run_seed``, from a device generator seeded with the
        pair (parity of design: interpolated_llgp.py:667-676 folds the
        iteration into the run key), or from ``probe_stream``."""
        if self.probe_stream is not None:
            return torch.as_tensor(
                np.asarray(self.probe_stream(run_seed, it)),
                dtype=self.dtype, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_probe_seed(run_seed, it))
        return lk.rademacher_probes(gen, self.n_probes, len(self.data.y),
                                    self.dtype, self.device)

    def _next_run_seed(self):
        return int(self._seed_rng.integers(2**31 - 1))

    def _stochastic_grad(self, x_flat, probes, rescue=False):
        """Gradient of the negative stochastic surrogate at ``x_flat``
        with ``probes``, and the surrogate's aux (parity:
        interpolated_llgp.py:568-622). The solve is the Woodbury-
        preconditioned one; ``rescue`` selects plain long-cycle Krylov
        at the model dtype instead (budget ``min(4n, 500)``, stall ratio
        0.999, no preconditioner), the first rescue rung. Autograd runs
        through the model-dtype operator (K10's backward, or K1's)."""
        if rescue:
            budget = min(4 * len(self.data.y), 500)
            opts = dict(cycle=budget, stall_ratio=0.999, maxiter=budget)
        else:
            opts = dict(grid_data32=self.precond_data32,
                        inner_data32=self.inner_data32)
        with torch.enable_grad():
            xc = x_flat.detach().to(self.dtype).requires_grad_(True)
            params = unravel_params(xc, self.params)
            s, aux = lk.stochastic_mll_surrogate(
                self.spec, params, self.grid_data, self.data.lens, self.y,
                probes, tol=self.tolerance, method=self.solver,
                rhs_sharding=self._rhs_sharding, **opts)
            (g,) = torch.autograd.grad(-(s + self._log_prior(params)), xc)
        return mesh_mean(g, self.mesh), aux

    def _grad_from_solves(self, x_flat, probes, alpha, zs):
        """Gradient of the negative surrogate from given solutions (parity:
        interpolated_llgp.py:632-652): the contraction half of the
        certified training rescue."""
        with torch.enable_grad():
            xc = torch.as_tensor(np.asarray(x_flat), dtype=self.dtype,
                                 device=self.device).requires_grad_(True)
            params = unravel_params(xc, self.params)
            s = lk.stochastic_surrogate_from_solves(
                self.spec, params, self.grid_data, self.data.lens, alpha,
                zs, probes)
            (g,) = torch.autograd.grad(-(s + self._log_prior(params)), xc)
        return mesh_mean(g, self.mesh)

    def stochastic_grad(self):
        """One stochastic-gradient evaluation of the minimized objective
        (the negative MLL surrogate) at the current parameters, flat,
        with the probes of a fresh run seed (parity:
        interpolated_llgp.py:2110-2121)."""
        x = ravel_params(self.params)
        g, _ = self._stochastic_grad(x, self._probes(self._next_run_seed(),
                                                     0))
        return g.cpu().numpy()

    def _chunk(self, x0, gms0, sms0, stp0, optimizer, n_steps=None, start=0,
               run_seed=0, rescue=False):
        """``n_steps`` (default ``chunk_len``) AdaDelta iterations on the
        device from the host state ``(x0, gms0, sms0, stp0)`` (parity:
        interpolated_llgp.py:656-703), on the model's objective: the
        gradient, the climin-style update at the model dtype and the
        per-step gradient norms stay on the device, and the stacked
        per-step outputs ``(xs, gmss, smss, steps, grad_norms,
        solve_iters, solve_errors)`` cross to the host once, as numpy.
        A stochastic step of global iteration ``start + i`` draws the
        probes of (``run_seed``, ``start + i``); ``rescue`` selects the
        plain-Krylov solve (:meth:`_stochastic_grad`). A Python loop:
        the host reads of each Cholesky's ``info`` (woodbury.chol_jittered)
        and of the solvers' convergence flags rule out capturing it as
        one CUDA graph for now."""
        dev, dt = self.device, self.dtype
        hp = torch.tensor(
            [optimizer.step_rate, optimizer.decay, optimizer.momentum,
             optimizer.offset], dtype=dt, device=dev,
        )
        step_rate, decay, momentum, offset = hp
        x, gms, sms, stp = (torch.as_tensor(np.asarray(a), dtype=dt,
                                            device=dev)
                            for a in (x0, gms0, sms0, stp0))
        stochastic = self.objective == "stochastic"
        outs = []
        for i in range(self.chunk_len if n_steps is None else n_steps):
            step1 = stp * momentum
            x1 = x - step1
            if stochastic:
                g, aux = self._stochastic_grad(
                    x1, self._probes(run_seed, start + i), rescue=rescue)
                iters = aux.solve_iters.to(dt)
            else:
                g, aux = self._exact_grad(x1)
                iters = torch.zeros((), dtype=dt, device=dev)
            gms = decay * gms + (1.0 - decay) * g * g
            step2 = (torch.sqrt(sms + offset) / torch.sqrt(gms + offset)
                     * g * step_rate)
            x = x1 - step2
            stp = step1 + step2
            sms = decay * sms + (1.0 - decay) * stp * stp
            outs.append((x, gms, sms, stp, torch.max(torch.abs(g)), iters,
                         aux.solve_error.to(dt)))
        return tuple(torch.stack(col).cpu().numpy() for col in zip(*outs))

    def optimize(self, optimizer=None, state=None, **kwargs):
        """Train the parameters with an :class:`AdaDelta` (extra kwargs
        construct the default one) on the model's objective (parity:
        interpolated_llgp.py:930-1456).

        With ``metrics=True``, or an optimizer other than
        :class:`AdaDelta`, the steps run one at a time through
        ``optimizer.minimize`` and :meth:`_fprime` (each recording
        ``self.metrics``). Otherwise an auto-selected exact objective first
        runs the held-out-block
        validation guard and demotes to the stochastic objective on a
        breach. Steps run on the device in chunks (:meth:`_chunk`) and
        the host replays the stopping rule
        (``AdaDelta.minimize_chunked``). An exact chunk whose worst
        factorized-solve residual exceeds ``EXACT_RESIDUAL_THRESHOLD``
        escalates the remaining steps: float32 factorizations to the
        model dtype where that is float64, then the Jacobi equilibration
        flip if the flipped float32 probe certifies, then the stochastic
        objective. A stochastic chunk whose solves breach the tolerance
        goes through :meth:`_rescue_chunk`.

        ``state``: an earlier ``info['state']`` to resume from; its
        ``rng_key`` (the run seed of the probe stream) continues the same
        probe stream. Returns the info dict of the optimizer plus
        ``device_seconds``, ``device_steps``, ``mean_solve_iters``,
        ``max_solve_error`` and ``rescued_chunks``."""
        if optimizer is None:
            optimizer = AdaDelta(**kwargs)
        if (self._auto_exact_guard and self.objective == "exact"
                and state is None):
            self._auto_exact_guard = False  # run once
            t0 = time.time()
            z2v, zfrac = self._validate_exact_objective(optimizer)
            _LOG.info(
                "objective='auto': held-out-block validation guard took "
                "%.1fs (one capped twin training run)", time.time() - t0,
            )
            if (z2v > VALIDATION_ZSQ_THRESHOLD
                    or zfrac > VALIDATION_ZEROVAR_THRESHOLD):
                _LOG.warning(
                    "objective='auto': exact objective fails the "
                    "held-out-block calibration check (z^2 %.3g > %g or "
                    "zero-variance fraction %.2f > %g) — using the "
                    "stochastic objective", z2v, VALIDATION_ZSQ_THRESHOLD,
                    zfrac, VALIDATION_ZEROVAR_THRESHOLD,
                )
                self.objective = "stochastic"
            else:
                _LOG.info(
                    "objective='auto': exact objective validates on "
                    "held-out blocks (z^2 %.3g, zero-var %.2f)", z2v, zfrac,
                )
        run_seed = _resumed_run_seed(state)
        if run_seed is None:
            run_seed = self._next_run_seed()
        if self.metrics is not None or not isinstance(optimizer, AdaDelta):
            # step by step on the host (parity: interpolated_llgp.py:
            # 1416-1441): no chunks, escalation or rescue
            start = 0 if state is None else int(state.get("n_iter", 0))
            x_opt, info = optimizer.minimize(
                self.param_array, self._fprime(run_seed, start), state=state)
            info["state"]["rng_key"] = np.asarray(run_seed, dtype=np.int64)
            self.param_array = x_opt
            return info

        stats = {"steps": 0, "seconds": 0.0, "iters": [], "errors": [],
                 "rescued_chunks": 0}
        # the futility latch: once every rescue rung missed the
        # calibrated bound on a chunk, later breached chunks of the run
        # skip the attempts (interpolated_llgp.py:1011-1018)
        futile = [False]

        def run_chunk(x, gms, sms, step, start_iter, stop_probe=None):
            t0 = time.time()
            outs = self._chunk(x, gms, sms, step, optimizer,
                               start=start_iter, run_seed=run_seed)
            if self.objective == "stochastic":
                outs = self._rescue_chunk(
                    outs, (x, gms, sms, step), start_iter, run_seed,
                    optimizer, stop_probe, stats, futile)
            xs, gmss, smss, steps, gns, iters, errs = outs
            stats["seconds"] += time.time() - t0
            stats["steps"] += len(gns)
            stats["iters"].extend(np.asarray(iters, float))
            stats["errors"].extend(np.asarray(errs, float))
            worst = _worst_of(errs)
            if self.objective == "exact" and worst > EXACT_RESIDUAL_THRESHOLD:
                self._escalate(worst, xs[-1])
            return xs, gmss, smss, steps, gns

        x_opt, info = optimizer.minimize_chunked(self.param_array, run_chunk,
                                                 state=state)
        info["state"]["rng_key"] = np.asarray(run_seed, dtype=np.int64)
        info["device_seconds"] = stats["seconds"]
        info["device_steps"] = stats["steps"]
        info["mean_solve_iters"] = float(np.mean(stats["iters"]))
        info["max_solve_error"] = float(np.max(stats["errors"]))
        info["rescued_chunks"] = stats["rescued_chunks"]
        _LOG.info(
            "optimize: %d device steps in %.2fs (%.1f ms/step; mean solve "
            "iters %.1f, worst residual %.2e)", stats["steps"],
            stats["seconds"], 1e3 * stats["seconds"] / max(stats["steps"], 1),
            info["mean_solve_iters"], info["max_solve_error"],
        )
        self.param_array = x_opt
        return info

    def _fprime(self, run_seed, start):
        """The host-side gradient ``fprime(x) -> numpy`` of the minimized
        objective (the negative MLL or surrogate, plus priors) for the
        step-by-step path (parity: interpolated_llgp.py:988-997); a
        stochastic call draws the probes of (``run_seed``, global
        iteration), counted from ``start``. Records ``self.metrics``."""
        it = [start]

        def fprime(x_flat):
            x = torch.as_tensor(np.asarray(x_flat), dtype=self.dtype,
                                device=self.device)
            if self.objective == "stochastic":
                g, aux = self._stochastic_grad(x, self._probes(run_seed,
                                                               it[0]))
            else:
                g, aux = self._exact_grad(x)
            it[0] += 1
            g = g.detach().cpu().numpy().astype(float)
            if self.metrics is not None:
                self._record_metrics(x_flat, g, aux)
            return g

        return fprime

    def _record_metrics(self, x_flat, g, aux):
        """One step's diagnostics (parity: interpolated_llgp.py:1562-1576):
        solver iterations and error, the gradient's ``EVAL_NORM``, its
        relative error against the exact dense gradient at the same
        parameters, and the exact log-likelihood."""
        self.metrics.iterations.append(float(aux.solve_iters))
        self.metrics.solv_error.append(float(aux.solve_error))
        val, exact_g = self._exact_value_and_grad(x_flat)
        exact_norm = float(np.linalg.norm(exact_g, EVAL_NORM))
        diff = float(np.linalg.norm(g - exact_g, EVAL_NORM))
        self.metrics.grad_norms.append(float(np.linalg.norm(g, EVAL_NORM)))
        self.metrics.grad_error.append(diff / max(exact_norm, 1e-300))
        self.metrics.log_likely.append(-val)

    def _rescue_chunk(self, outs, st0, start_iter, run_seed, optimizer,
                      stop_probe, stats, futile):
        """The stochastic objective's in-training escalation for one
        chunk's stacked outputs ``outs`` from the entry state ``st0``
        (parity: interpolated_llgp.py:1061-1291). When the worst solve
        residual exceeds the tolerance:

        - a breach past the stopping point (``stop_probe`` over the
          certified prefix) truncates the chunk there;
        - after a futile rescue on this run, the breach is tolerated;
        - rung 1 re-runs from the first breached step with the plain
          Krylov solve (:meth:`_stochastic_grad` ``rescue``), one step
          at a time, and bails when its first step misses the
          calibrated bound;
        - rung 2 re-runs the breached steps with certified-ladder
          solves (:meth:`_rescue_steps_certified`).

        A rescued stream is adopted only when it meets
        ``_gradient_adopt_bound`` and certifies better than the plain
        one. Returns the (possibly replaced) outputs."""
        tol = self.tolerance
        gns, errs = outs[4], outs[6]
        worst = _worst_of(errs)
        if worst <= tol:
            return outs
        if stop_probe is not None:
            j0 = int(np.argmax(_bad_steps(errs, tol)))
            stop_j = (stop_probe(np.asarray(gns[:j0], dtype=float))
                      if j0 > 0 else None)
            if stop_j is not None:
                _LOG.info(
                    "chunk breach (residual %e) occurs past the stopping "
                    "point (chunk step %d) — discarding the breached tail "
                    "instead of rescuing it", worst, stop_j,
                )
                return tuple(a[:stop_j + 1] for a in outs)
        if futile[0]:
            _LOG.warning(
                "chunk worst solve residual %e exceeds tolerance; rescue "
                "already proved futile on this trajectory — tolerating "
                "inexact gradients", worst,
            )
            return outs
        stats["rescued_chunks"] += 1
        _LOG.warning(
            "chunk worst solve residual %e exceeds the %g tolerance — "
            "re-running with the plain-Krylov rescue", worst, tol,
        )
        adopt = self._gradient_adopt_bound
        j0 = int(np.argmax(_bad_steps(errs, tol)))
        st = st0 if j0 == 0 else tuple(a[j0 - 1] for a in outs[:4])
        pieces = []
        for j in range(j0, len(gns)):
            o = self._chunk(*st, optimizer, n_steps=1, start=start_iter + j,
                            run_seed=run_seed, rescue=True)
            st = tuple(a[-1] for a in o[:4])
            pieces.append(o)
            if j == j0 and _worst_of(o[6]) > adopt:
                _LOG.warning(
                    "plain-Krylov rescue failed the calibrated bound on its "
                    "first step — skipping the remaining re-runs")
                pieces = None
                break
        if pieces:
            r2 = tuple(np.concatenate([outs[k][:j0]] + [p[k] for p in pieces])
                       for k in range(7))
            worst2 = _worst_of(r2[6])
            if worst2 <= adopt and worst2 <= worst:
                outs, worst = r2, worst2
        if worst > tol:
            _LOG.warning(
                "escalated chunk still above tolerance (residual %e) — "
                "re-running breached steps with certified-ladder solves",
                worst)
            r3 = self._rescue_steps_certified(st0, outs, start_iter,
                                              optimizer, run_seed)
            worst3 = _worst_of(r3[6])
            if worst3 <= adopt and worst3 <= worst:
                outs, worst = r3, worst3
        if worst > tol:
            if worst <= adopt:
                _LOG.info(
                    "escalated chunk residual %e is above the %g solve "
                    "tolerance but within the calibrated gradient-accuracy "
                    "bound %g", worst, tol, adopt)
            else:
                _LOG.warning(
                    "escalated chunk still above the calibrated bound %g "
                    "(residual %e) — gradients for those steps are "
                    "inexact", adopt, worst)
                futile[0] = True
        return outs

    def _rescue_steps_certified(self, st0, plain, start_iter, optimizer,
                                run_seed):
        """Rung 2 of the training rescue (parity:
        interpolated_llgp.py:1602-1707): re-run every step of a chunk
        from its first breached step with solves from the certified
        ladder (:meth:`_solve_certified`, bounded by the calibrated
        gradient-accuracy bound and ``RESCUE_MAXITER``), gradients from
        :meth:`_grad_from_solves`, and the AdaDelta update replayed on
        the host in float64 numpy. ``st0``: the chunk-entry state;
        ``plain``: the 7-tuple of stacked chunk outputs. Returns the same
        layout, or ``plain`` as soon as one step misses the bound. The
        model's parameters are restored."""
        xs, gmss, smss, steps, gns, iters, errs = plain
        j0 = int(np.argmax(_bad_steps(errs, self.tolerance)))
        st = st0 if j0 == 0 else tuple(a[j0 - 1] for a in plain[:4])
        x, gms, sms, stp = (np.asarray(a, dtype=float) for a in st)
        step_rate, decay, momentum, offset = (
            optimizer.step_rate, optimizer.decay, optimizer.momentum,
            optimizer.offset)
        adopt = self._gradient_adopt_bound
        params_before = self.param_array
        pieces = []
        try:
            for j in range(j0, len(gns)):
                it_g = start_iter + j
                step1 = stp * momentum
                x1 = x - step1
                probes = self._probes(run_seed, it_g)
                self.param_array = x1
                rhs = torch.cat([self.y[None], probes], dim=0)
                what = "train-rescue[iter %d]" % it_g
                sols, worst_j = self._solve_certified(
                    rhs, what, tol=adopt, maxiter=RESCUE_MAXITER)
                if worst_j > adopt:
                    _LOG.warning(
                        "%s: bounded ladder could not reach the calibrated "
                        "bound %g (residual %e) — abandoning the certified "
                        "re-run for this chunk", what, adopt, worst_j)
                    return plain
                g = self._grad_from_solves(x1, probes, sols[0], sols[1:])
                g = g.cpu().numpy().astype(float)
                gms = decay * gms + (1.0 - decay) * g * g
                step2 = (np.sqrt(sms + offset) / np.sqrt(gms + offset)
                         * g * step_rate)
                x = x1 - step2
                stp = step1 + step2
                sms = decay * sms + (1.0 - decay) * stp * stp
                pieces.append((
                    x, gms, sms, stp, float(np.max(np.abs(g))),
                    self.prediction_report[what]["iterations"],
                    float(worst_j),
                ))
        finally:
            self.param_array = params_before
        return tuple(
            np.concatenate([np.asarray(plain[k][:j0], dtype=float),
                            np.stack([np.asarray(p[k], dtype=float)
                                      for p in pieces])])
            for k in range(7)
        )

    def warm_rescue(self, key=None, ladder=True):
        """Run the escalated rescue path once at the current parameters:
        one rung-1 rescue step (plain Krylov) and, with ``ladder``, one
        certified-ladder solve of [y; probes] and the gradient from its
        solutions (parity: interpolated_llgp.py:1709-1741, where it
        compiles those XLA programs ahead of a breach; on the card there
        is nothing to compile, so it is a dry run of the same path). The
        parameters and ``prediction_report`` are left as they were.

        ``key`` picks the run seed of the probes: ``None`` is run seed 0,
        an int is the run seed, and a ``uint32[2]`` array (the shape of
        a JAX PRNG key) is folded into one int seed."""
        run_seed = _run_seed_of(key)
        x = self.param_array
        z = np.zeros_like(x)
        opt = AdaDelta(step_rate=1.0, decay=0.9, momentum=0.5, offset=1e-4)
        self._chunk(x, z, z, z, opt, n_steps=1, run_seed=run_seed,
                    rescue=True)
        if ladder:
            probes = self._probes(run_seed, 0)
            rhs = torch.cat([self.y[None], probes], dim=0)
            report_before = dict(self.prediction_report)
            try:
                sols, _ = self._solve_certified(rhs, "warm-rescue-ladder")
            finally:
                self.prediction_report = report_before
            self._grad_from_solves(x, probes, sols[0], sols[1:])

    def _escalate(self, worst, x_last):
        """The exact objective's escalation ladder after a chunk whose
        worst residual ``worst`` breached, at the chunk's last
        parameters ``x_last`` (parity: interpolated_llgp.py:1296-1412)."""
        if self.exact_precision == "f32" and self.dtype == torch.float64:
            # float64 is native on the card: factorize at the model dtype
            _LOG.warning(
                "exact-objective residual %e exceeded the calibrated %g "
                "threshold — escalating training to "
                "exact_precision='model' for the remaining steps",
                worst, EXACT_RESIDUAL_THRESHOLD,
            )
            self.exact_precision = "model"
            return
        if not self._equilibrate_flip_tried:
            self._equilibrate_flip_tried = True
            cur = (self._equilibrate if self._equilibrate is not None
                   else wbm.EQUILIBRATE_DEFAULT)
            x = torch.as_tensor(np.asarray(x_last), dtype=self.dtype)
            res_flip = self._probe_residual(
                unravel_params(x, self.params), not cur)
            if res_flip <= EXACT_RESIDUAL_THRESHOLD:
                _LOG.warning(
                    "exact-objective residual %e exceeded the calibrated "
                    "%g threshold, but the equilibration-flipped "
                    "factorization certifies at %e — flipping equilibrate "
                    "to %s and keeping the exact objective",
                    worst, EXACT_RESIDUAL_THRESHOLD, res_flip, not cur,
                )
                self._equilibrate = not cur
                self._bump()
                return
            _LOG.info("equilibration-flipped probe also breaches (%e) — "
                      "demoting", res_flip)
        _LOG.warning(
            "exact-objective residual %e exceeded the calibrated %g "
            "threshold with exact_precision=%r and no certifying "
            "equilibration flip — switching training to the stochastic "
            "objective for the remaining steps",
            worst, EXACT_RESIDUAL_THRESHOLD, self.exact_precision,
        )
        self.objective = "stochastic"

    def _validation_split(self):
        """Per-output train/validation split with two CONTIGUOUS held-out
        blocks per output, at the 1/3 and 2/3 positions, about
        ``VALIDATION_HOLDOUT_FRAC`` of the points (parity:
        interpolated_llgp.py:1458-1477)."""
        Xs_tr, Ys_tr, Xs_va, Ys_va = [], [], [], []
        for X, Y in zip(self.Xs, self._raw_Ys):
            n_i = len(X)
            blk = max(1, int(n_i * VALIDATION_HOLDOUT_FRAC / 2))
            mask = np.ones(n_i, dtype=bool)
            for pos in (n_i // 3, (2 * n_i) // 3):
                mask[pos:pos + blk] = False
            Xs_tr.append(np.asarray(X)[mask])
            Ys_tr.append(Y[mask])
            Xs_va.append(np.asarray(X)[~mask])
            Ys_va.append(Y[~mask])
        return Xs_tr, Ys_tr, Xs_va, Ys_va

    def _validate_exact_objective(self, optimizer):
        """Train a twin with the exact objective on the block-reduced
        data, with the main run's AdaDelta settings capped at
        ``VALIDATION_GUARD_MAX_IT`` steps, and predict the held-out
        blocks. Returns ``(z2, zero_var_frac)``: the mean standardized
        squared error (about 1 when calibrated) and the share of
        held-out variances clamped to zero (parity:
        interpolated_llgp.py:1479-1526)."""
        Xs_tr, Ys_tr, Xs_va, Ys_va = self._validation_split()
        twin = InterpolatedLLGP(Xs_tr, Ys_tr, objective="exact",
                                name=self.name + "-guard", **self._ctor)
        twin.optimize(optimizer=AdaDelta(
            step_rate=optimizer.step_rate, decay=optimizer.decay,
            momentum=optimizer.momentum, offset=optimizer.offset,
            max_it=min(optimizer.max_it, self.VALIDATION_GUARD_MAX_IT),
            min_grad_ratio=optimizer.min_grad_ratio,
            permitted_drops=optimizer.permitted_drops,
        ))
        mus, vs = twin.predict(Xs_va)
        z2s, n_zero, n_tot = [], 0, 0
        for mu, v, yv in zip(mus, vs, Ys_va):
            n_tot += len(v)
            zero = v <= 0
            n_zero += int(zero.sum())
            ok = ~zero
            if ok.any():
                z2s.append(((yv[ok] - mu[ok]) ** 2) / v[ok])
        z2 = float(np.mean(np.concatenate(z2s))) if z2s else float("inf")
        return z2, n_zero / max(n_tot, 1)

    def loo_zsq(self):
        """Mean squared leave-one-out standardized residual of the
        current fit (about 1 when calibrated; woodbury.loo_zsq), from the
        model-dtype factorization where the model is float64 and every
        group dense, and the float32 one otherwise (parity:
        interpolated_llgp.py:1528-1543)."""
        wb = (self._woodbury()
              if self.dtype == torch.float64 and self._all_dense
              else self._woodbury32())
        return float(wbm.loo_zsq(wb, self.y.to(wb.dtype)))

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

    def _precomputed_nu(self):
        """nu_j = [K_UX K^-1 K_XU]_jj for every grid point j, by one
        certified solve of Dm right-hand sides (parity:
        interpolated_llgp.py:2237-2260): K_UU as the grid matvec of the
        identity (K1's matrix on dense grids, K10 on fft grids), its
        interpolated columns K_XU solved at once, cached per parameter
        setting."""
        if "nu" not in self._cache:
            if len(self.grid_data) != 1:
                raise ValueError("precompute prediction mode unavailable "
                                 "for split kernels")
            g = self._kski().groups[0]
            eye = torch.eye(g.interp.ncols, dtype=self.dtype,
                            device=self.device)
            KUU = g.grid_matvec(eye)  # (Dm, Dm), symmetric
            rhs = g.interp.matvec(KUU)  # rows: the columns of K_XU
            sols, _ = self._solve_certified(rhs, "precompute-nu")
            back = g.grid_matvec(g.interp.rmatvec(sols))
            self._cache["nu"] = torch.diagonal(back).contiguous()
        return self._cache["nu"]

    def _var_predict_exact(self, Xs):
        """Explained variance by the dense exact Cholesky (parity:
        interpolated_llgp.py:2210-2218)."""
        K_test_X = self._cross_kernel(Xs).contiguous()
        sol = cho_solve(self._chol(), K_test_X)
        return torch.sum(K_test_X * sol, dim=1)

    def _raw_predict(self, Xs):
        """Prediction in the model's variance mode (parity:
        interpolated_llgp.py:2141-2205). 'on-the-fly': the observation
        solve alpha rides in the same batched certified solve as the test
        columns K_*X; 'precompute': the explained variance interpolates
        the cached per-grid-point ``nu``; 'exact': the dense Cholesky."""
        lens = [len(X) for X in Xs]
        test_interps = self._test_interps(Xs)
        if self.prediction == "exact":
            alpha = self._alpha()
            explained = self._var_predict_exact(Xs)
        elif self.prediction == "precompute":
            alpha = self._alpha()
            nu = self._precomputed_nu()
            explained = test_interps[0].matvec(nu)
        else:
            K_test_X = self._cross_kernel(Xs)
            if K_test_X.shape[0]:
                rhs = torch.cat([self.y[None], K_test_X], 0)
                sols, _ = self._solve_certified(rhs, "explained-variance")
                alpha = sols[0]
                self._cache["alpha"] = alpha
                explained = torch.sum(K_test_X * sols[1:], dim=1)
            else:
                alpha = self._alpha()
                explained = torch.zeros(0, dtype=self.dtype,
                                        device=self.device)
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

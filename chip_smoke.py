#!/usr/bin/env python3
"""Smoke run of the PyTorch port (runlmc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases:

1. print the card's name and power limit (``nvidia-smi``); require a
   CUDA device and TF32 off;
2. build every CUDA kernel from ``runlmc_tpu_torch/hopper/csrc`` (one
   ``nvcc`` per source, all at once);
3. build the model of the slices — ``InterpolatedLLGP`` on an
   fx2007-shaped synthetic problem (D=13 outputs, n=3113 training and
   150 held-out points, Q=1 RBF of rank 2, m=[234] -> 238 grid points,
   Dm=3094) in float64 on the card — and hold each hand kernel against
   its plain PyTorch version on the card at the shapes of those paths, with
   times (CUDA events and profiler device time), the library call's time
   where one PyTorch call computes the same function, and the least time
   the card could take (bytes over 3.35 TB/s, operations over the peak
   rate); then build the fft-mode model of slice 3 — ``InterpolatedLLGP``
   on a weather-shaped synthetic problem (D=4 sensors, n=15768, SLFM
   rank 2 plus a frozen-scale RBF per sensor, m=[2500] -> 2504 grid
   points, Dm=10016 past ``DENSE_MAX_GRID``, one 'slfm' fft group whose
   float32 preconditioner twin keeps the fine grid) with
   ``objective='stochastic'``, print its groups and the device memory of
   its grid artifacts, and hold K10 (float64 and float32 'slfm' at
   (16, 4, 4097) on the model's own symbols; 'sum' and 'bt' at a small
   shape), K10's backward (float64) and K12 (float64, (16, 15768))
   against their plain versions; K7 at the report path's (3113, 3113)
   in float64 and float32 (the pair path, held to the bit against the
   general path on the same inputs as two point sets), K7's backward
   (float64 and float32, a seeded (3113, 3113) cotangent,
   then the mixed table), K13 (float64 and float32 at (15, 15768) and at
   the reduced copy's (15, 790), eight steps on a diagonal operator with
   a row that breaks down, relaunched bit-identical), K7 and its backward
   at the weather oracle's (15768, 15768) with the weather model's Q=6 table (the plain
   versions a slab of rows at a time), and K5 (``trsm_lower``, its
   transposed variant and
   ``cho_solve``) at the shapes of its call sites (the weather model's
   own float32 capacitance factor, seeded well-conditioned factors for
   the rest) in both storage orders, by agreement with its plain version
   and with ``trsm_lower_schedule`` (the kernel's block order in plain
   PyTorch) and by normwise backward error, bit-identical to the
   per-block kernel (the chains' yardstick), plus a stress phase (k in
   ``K5_STRESS_KS``, every c from 1 to 17, both storage orders and
   directions, NaN factors), its float32 ``cho_solve`` error from the
   float64 solve of the same factor within ``K5_F32_FACTOR`` times
   ``cholesky_solve``'s at fx2007's and the weather twin's C, and
   ``ChoSolve``'s backward against autograd through
   ``torch.cholesky_solve``; then build the synth model
   of phase 15 and hold K1 with K8 fused in (k(r) on the grid from the
   kernel table) and its backward (the table's cotangent and d B, on
   seeded asymmetric cotangents), float32 and float64, at the fx2007
   grid (Q=1, m=238, D=13), the weather twin (Q=6, m=2504, D=4) and
   synth's 2-D grid (29 x 29, D=5) on each model's parameters and on a
   mixed table of every kind, each call relaunched bit-identical, with
   ``index_add_`` as the backward's library yardstick; K2 (the
   capacitance matrix, float32 and float64)
   at the fx2007, synth and weather-twin shapes on each model's own
   factors and noise, bit-identical across launches and storage orders,
   K2's backward at the fx2007 and synth shapes on a seeded asymmetric
   cotangent (its library yardstick one ``torch.matmul(T_a, S[:, cols
   of a])`` per group, and autograd through the dense library products
   as a second figure), each K2 row with its device time split by
   kernel (``k2_gram_apply``, ``k2_cap``; ``k2_sym``, ``k2_cap_bwd``,
   ``k2_cap_bwd_finish``, ``k2_eps_reduce``), K2 on a seeded two-group
   model (cross blocks), and K9 at K4's shapes (the W applies of the
   weather step, the fx2007 predict preconditioner, kinv_diag's V = W F
   and the synth step) against
   their plain versions (the scatter's variant, a thread or a warp per
   column, printed; relaunches bit-identical; and a skewed CSR with an
   empty column and one of 50,000 entries in both variants), with the
   dense products (``torch.bmm`` +
   ``matmul``), ``index_add_`` and ``embedding_bag`` as library
   yardsticks; K3 (the jittered Cholesky's prologue, epilogue and their
   backward, around cuSOLVER's potrf in place on the prologue's M) on
   each model's own K_UU and C at the fx2007 (float32, float64),
   weather-twin (float32) and synth (float32, float64) shapes, both
   equilibration modes, the forward bit for bit against its plain
   version (the prologue's lower triangle, zeros above it), the
   in-place chain's factor and de-scaled copy bit for bit torch's
   routes' (cholesky_ex into a new factor, the earlier route, and
   cholesky_ex in place), the factor's upper triangle 0, every relaunch
   bit-identical, one attempt timed by route with the earlier route's
   copy of M and torch's tril_ timed alone, one weather-twin
   ``chol_jittered`` call's peak memory, and its flag on an indefinite
   matrix (the ladder landing where the CPU's does), the backward also
   in the storage orders one exact gradient hands each site (printed);
   K3's VJP
   (``hopper/chol_vjp.py``: the tri kernel, Phi(L^T L-bar) symmetrized, and the solve kernel, L^-T S L^-1 exactly
   symmetric) on the factor where each C's ladder lands at the fx2007
   (float32), synth (float32, float64) and weather-twin (float32, on no
   path) shapes, in both storage orders and bit-identical across
   relaunches, the float32 tri kernel equal to the bit to its route 1
   (the earlier kernel's sum order), the solve kernel timed beside
   cuBLAS's two solves (its plain version and library column) and K5's,
   and the whole VJP against torch's Cholesky backward (the library
   yardstick); K8 on the weather fft group's first
   rows (Q=6, m=2504 embedded in 8192, float64 and float32) and its
   float64 backward (the cluster kernel equal to the bit to the one-CTA
   kernel);
4. reset the launch counters, ``predict`` the 150 held-out points, read
   the counters: every kernel of ``hopper.PREDICT_PATH`` must have launched;
   every mean and variance must be finite, the certified residual
   within tolerance, and the result equal to the same model run on the
   CPU;
5. reset the counters, drive the certified solve's escalation rung (CG
   preconditioned by the float64 Woodbury factor, which ``predict``
   reaches only when the float32 rung stalls) on the same right-hand
   sides, read the counters: the float64 CG passes must have launched
   and the residual must be within tolerance;
6. guard: reset the counters, run the 'auto' objective's held-out-block
   validation guard (``_validate_exact_objective``: a twin trained with
   the exact objective for at most 10 AdaDelta steps, then ``predict`` on
   the held-out blocks), read the counters: every kernel of
   ``hopper.TRAIN_PATH`` and ``hopper.PREDICT_PATH`` must have launched,
   and the guard's z^2 and zero-variance share must be finite;
7. train: a fresh model with ``objective='exact'`` (as bench.py pins
   fx2007), counters reset, ``optimize(AdaDelta(min_grad_ratio=0.2))``
   to its stopping rule, counters read: every kernel of
   ``hopper.TRAIN_PATH`` must have launched, gradient norms and
   parameters must be finite and the objective still exact; the same
   training twice more in the same process under
   ``torch.use_deterministic_algorithms`` (``CUBLAS_WORKSPACE_CONFIG`` is
   set before CUDA starts; the three stopping iterations, whether the
   two deterministic runs are bit-identical, and the calls torch flags
   as nondeterministic printed); one chunk is profiled, by layer and
   inside ``record_function`` ranges around the Woodbury solve with C,
   the jittered Cholesky (no copy on the card may run inside it, phases
   9 and 15 too), the capacitance matrix and the W applies,
   and one more with its elementwise layer split by source
   (:func:`elementwise_sources`), and one more with K3's factorizations,
   attempts and host reads per step (:func:`ladder_log`); then
   ``predict`` on the held-out points must certify its residual within
   tolerance (SMSE and NLPD printed, on synthetic data);
8. card vs CPU: from the same parameters, the first gradient and one
   chunk of float32 exact training (``CPU_CHUNK_STEPS`` steps) agree
   within ``TRAIN_RTOL``, and one chunk at ``exact_precision='model'``
   (counters reset and read: ``hopper.MODEL_PRECISION_PATH`` must have
   launched) agrees within ``MODEL_RTOL``;
8b. reporting on the model phase 7 trained: ``log_likelihood()`` (exact,
   n <= 5000), ``log_likelihood(exact=False)`` (Woodbury) and
   ``exact_log_likelihood_and_grad()`` (``hopper.REPORT_PATH``
   launched), each within ``REPORT_RTOL`` of the CPU run at the same
   parameters; the 'exact' and 'precompute' prediction modes on the 150
   test points within ``PREDICT_RTOL`` of the CPU ('precompute' on a
   reduced copy, and the full-width ``nu`` at ``NU_COLS`` seeded grid
   columns solved on the CPU); ``loo_zsq`` within ``REPORT_RTOL`` of the
   CPU, and a float32 copy's (``kinv_diag`` in float32); a fresh
   ``metrics=True`` model for 3 steps (``hopper.METRICS_PATH``, its
   ``Metrics`` lists printed); ``ExactLMC`` with 10 L-BFGS-B iterations,
   then ``predict``;
9. stochastic training of the weather model: counters reset,
   ``optimize(AdaDelta())`` to its stopping rule, counters read: every
   kernel of ``hopper.STOCHASTIC_PATH`` must have launched, gradients
   and parameters finite, the objective still stochastic, the worst
   solve residual within ``_gradient_adopt_bound`` and PCG iterations per
   solve at most ``WEATHER_PCG_MAX``; chunks profiled and
   K3's attempts and host reads counted, as in phase 7;
10. ``predict`` the two held-out windows: every certified residual
   within the model tolerance and ``hopper.FFT_PREDICT_PATH`` launched
   (SMSE and NLPD printed, on synthetic data);
10b. reporting on the trained weather model: ``log_likelihood()`` (SLQ:
   ``hopper.SLQ_PATH`` launched), ``log_likelihood(exact=True)`` and
   ``exact_log_likelihood_and_grad()`` (K7 and its backward at
   n=15768; counters reset and read around it), with wall and device
   time; the oracle's closed-form gradient (``likelihood.ExactMLL``)
   against the autograd route it replaced (:func:`exact_mll_autograd`)
   within ``ORACLE_GRAD_RTOL``, both timed by layer with their peak
   memory, and the rank-1 term in K7's backward loads against
   ``torch.addr`` before it;
11. the certified solve's plain float64 MINRES rung on its own (16
   right-hand sides): ``hopper.MINRES_PATH`` must have launched and the
   residual end at or under the model tolerance; its first
   ``KRYLOV_CYCLE``-iteration cycle profiled by layer, with a K12 row;
   then one rung-1 rescue step (plain MINRES in ``_chunk``) must be
   finite;
12. one stochastic chunk of the same data on weather's headline dense
   grid (m=[500], Dm=2016): ``hopper.DENSE_STOCHASTIC_PATH`` launched;
13. card vs CPU on the reduced problem of bench.py:146 (every 20th
   point, m=[64], fft mode, tolerance 1e-10, the same fed probes): the
   first gradient and one 3-step chunk's parameters within
   ``STOCH_RTOL``;
13b. the SLQ log-det of that reduced problem, card vs CPU with fed probes
   (within ``SLQ_RTOL`` at ``SLQ_STEPS_TIGHT`` steps and ``SLQ_40_RTOL``
   at 40, with the per-step differences of the Lanczos coefficients
   beside those of a CPU-only witness), and the card's own estimate within
   ``SLQ_ORACLE_RTOL`` of the dense log-det; the float32 report path
   (``hopper.F32_REPORT_PATH``: a float32 copy's SLQ log-det and a
   float32 ``ExactLMC``'s exact gradient, its closed form within
   ``ORACLE_F32_FACTOR`` times the autograd route's error from the
   float64 gradient);
15. synth at full width (bench.py:114-130 on the synthetic twin
   ``datasets.synth_synthetic``: D=5, P=2, n=47,480, m=[25, 25] ->
   Dm=4205, exact objective, tolerance 1e-3): counters reset,
   ``optimize(AdaDelta())`` to its stopping rule, counters read (every
   kernel of ``hopper.SYNTH_PATH``), ms per step, one chunk profiled by
   layer and range, idle share and peak memory; ``predict`` of the
   held-out quadrant with every certified residual within 1e-3 (SMSE and
   NLPD printed, on synthetic data); the float32 chunks from the start
   to the first residual breach, with the jitter-ladder rung each K_UU
   and C factorization landed on beside the chunk's worst residual;
   card vs CPU on bench.py's reduced copy (every 30th point, m=[8, 8]):
   the first gradient and a ``CPU_CHUNK_STEPS`` chunk within
   ``TRAIN_RTOL`` (float32; every factorization on the same rung on both
   sides) and ``MODEL_RTOL`` (``exact_precision='model'``);
16. checkpoint and resume: fx2007 at full width (exact objective,
   float32 factors) and the weather model (stochastic, m=2500), each
   trained 20 steps from a saved start, then restored to it, trained 10
   steps and saved with its optimizer state (``MultiGP.save``); a fresh
   model restores that file and resumes for 10 steps: bit-identical
   parameters, gradient norms and stopping step, the fused K1 launched
   in the resumed run (counters reset and read around it); the fx2007
   file restored into the CPU model of phase 4 predicts within
   ``PREDICT_RTOL`` of the card; an escalated copy of synth's reduced
   model stays escalated across save and restore and resumes in
   float64;
17. the mesh layer (``runlmc_tpu_torch/parallel``): rank processes of
   this script (:func:`mesh_worker`), started together, each loading the
   libraries of phase 2: the weather model (m=2500, stochastic,
   tolerance ``STOCH_TOL``) on 2 Gloo ranks sharing the card
   (``default_mesh(2)``, the probe layout) and, where there is a card per
   rank, on 2 NCCL ranks; fx2007 (exact, float32 factors, the data
   layout) on 2 Gloo ranks and on 1 NCCL rank; the weather model on
   ``probe_grid_mesh(1, 2)`` (the grid layout). Each rank's first-step
   gradient against the single process's from the same start and probes
   (``MESH_STOCH_RTOL``, ``MESH_EXACT_RTOL``), its certified residual,
   the path's kernels launched (counts reset before, read after), the
   grid layout's grid_matvec on seeded vectors equal to the single
   process's to the bit, and after ``MESH_STEPS`` steps the ranks'
   parameters bitwise equal; each rank's rows, local loop iterations,
   walls and the collectives' device µs printed. Meanwhile, on this
   process, K10 and its backward on each rank's Fourier range at the
   weather shape, held against their plain versions and against the
   full range's slice (the bits); any rank that fails or runs past
   ``MESH_SPAWN_S`` fails the script;
14. print each phase's seconds, the kernel table as one JSON line (each
   row's ``launches`` counted on its own path, named in ``path``), the
   card line again, and as the last line ``{"ok": true, "device":
   {...}}``.

Any failure raises and exits non-zero without the last line. Detailed
results also go to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --k3-bwd-times [ROOT]

times only K3a bwd and K3b bwd (:func:`k3_bwd_times`) of the package at
ROOT, a parent's ``git archive`` say, and prints one JSON line;

    python3 chip_smoke.py --bwd-times [ROOT]

does the same for K7 bwd and K1 bwd (:func:`bwd_times`), and

    python3 chip_smoke.py --fwd-times [ROOT]

for K1 and K7 forward, with a sha256 of each output (:func:`fwd_times`);

    python3 chip_smoke.py --k10-k9-times [ROOT]

for K10's forward and K9's gather, with a sha256 of each output, the
wrapper's host µs per call and the card's launch floor
(:func:`k10_k9_times`);

    python3 chip_smoke.py --k13-k8-times [ROOT]

for K13 and K8 (fft)'s backward, the same, and ``ski_log_det``'s wall
on the weather model (:func:`k13_k8_times`); and

    python3 chip_smoke.py --times NAME[,NAME] [ROOT]

the timing rows of each named set (:func:`times`): ``K12`` for K12 at
the MINRES rung's shape, in float32 and at one long row, K13's sha256
and the rung itself on the weather model; ``K8F`` for K8 (fft)'s
forward on the weather group; ``K10R`` for K10 and its backward at the
full range and on each rank's Fourier range of two. Later slices add
names, not modes.

Phase 17 starts its ranks as ``python3 chip_smoke.py --mesh-worker
CONFIG RANK WORLD STORE OUT`` (:func:`mesh_worker`).
"""

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM figures (NVIDIA data sheet): HBM rate and the peak
# rates outside the tensor cores; a float64 matrix product (K2, its
# backward, K5's solves, K3's VJP) may run on the tensor cores (DMMA) at
# 67 TFLOP/s,
# while float32 products keep 67 (TF32 stays off)
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_PRODUCT_FLOPS = {"float32": 67e12, "float64": 67e12}

SEED = 0
TOLERANCE = 1e-8
# CPU vs card agreement of the predictions, relative to the largest
# magnitude: both solves are certified to an absolute residual of
# TOLERANCE, and the f32 inner cycles round differently on each device
PREDICT_RTOL = 1e-6
# CPU vs card agreement of exact-objective training, relative to the
# largest magnitude: float32 factorizations round differently on each
# device (cuSOLVER vs LAPACK); float64 ones agree to about the
# conditioning times float64 rounding
TRAIN_RTOL = 1e-3
MODEL_RTOL = 1e-8
# steps of the CPU side's training chunks (the card runs the same): a
# full-width float64 step takes seconds on the CPU
CPU_CHUNK_STEPS = 3
# the benchmark's optimizer settings for fx2007 (bench.py:74-75)
OPT_KW = {"min_grad_ratio": 0.2}
# the weather configuration past the dense cap (bench.py:78-111 at
# m=2500, benchmarks/profile_m2500.py): the grid, and the headline
# dense-mode grid of the dense stochastic phase
WEATHER_M = [2500]
WEATHER_DENSE_M = [500]
# card vs CPU of stochastic training on the reduced weather problem of
# bench.py:146 (every 20th point, m=[64], fft mode) at tolerance
# STOCH_TOL: the solves certify to that absolute residual on both sides,
# so the gradients and parameters agree to far below it
STOCH_SUBSAMPLE = 20
STOCH_M = [64]
STOCH_TOL = 1e-10
STOCH_RTOL = 1e-6
# card vs CPU of the reports (log-likelihoods, the exact oracle's value
# and gradient), relative: the exact ones are float64 Cholesky
# factorizations on both sides, the quadratic term a certified solve at
# TOLERANCE
REPORT_RTOL = 1e-8
# the SLQ log-det of the reduced weather problem (m=[64]) card vs CPU with
# the same probes, and the card's own estimate vs the dense log-det (the
# JAX package's 15-probe band is 0.3-0.6%, tests/test_slq.py)
SLQ_RTOL = 1e-8
SLQ_ORACLE_RTOL = 0.05
# The 40-step estimate itself runs Lanczos long past convergence without
# reorthogonalization, which amplifies any rounding of the matvec (cuFFT
# against the CPU's FFT): on this problem the per-step differences of
# alpha and beta stay near 1e-14 up to about step 23 and then grow by a
# factor of 20-40 per step, so the card and the CPU agree to about 1e-15
# after 20 steps and only to about 1e-7 after 40. A witness on the CPU
# alone, the same probes through the dense matrix of the same operator
# (another summation order), shows the same growth; the script prints
# both traces. So the recurrence is held to SLQ_RTOL at SLQ_STEPS_TIGHT
# steps and the model's 40-step number to SLQ_40_RTOL.
SLQ_STEPS = 40
SLQ_STEPS_TIGHT = 20
SLQ_40_RTOL = 1e-6
# the reduced fx2007 copy of the 'precompute' card-vs-CPU check, and the
# seeded grid columns of the full-width nu solved on the CPU
PRE_SUBSAMPLE = 3
PRE_M = [78]
NU_COLS = 32
# the synth configuration (bench.py:114-130) on the in-repo synthetic
# twin: m=[25, 25] (29 x 29 grid points after autogrid's padding,
# Dm=4205), the exact objective at tolerance 1e-3, and the reduced copy
# of bench.py's VALIDATE["synth"] (every 30th point, m=[8, 8]) for card
# vs CPU
SYNTH_M = [25, 25]
SYNTH_TOL = 1e-3
SYNTH_SUBSAMPLE = 30
SYNTH_SMALL_M = [8, 8]
# K2 against its plain version, relative to the largest magnitude: the
# forward sums D m products per entry in another order than cuBLAS, all
# of one sign on C's diagonal (its largest entries): 1e-5 in float32;
# the backward sums Dm products of a seeded cotangent of both signs:
# 1e-4; float64 1e-12 both
K2_TOL = {"float32": (1e-5, 1e-4), "float64": (1e-12, 1e-12)}
# K3's VJP against its plain version, relative to the largest magnitude:
# the triangular product sums up to n products in another order than
# cuBLAS (1e-13 in float64, 1e-5 in float32), and the symmetrization is
# one addition per entry. The whole VJP against torch's Cholesky
# backward: in float64 the same formula rounded apart in the product and
# the symmetrization, then amplified by the solves with the factor
# (VJP_F64_TOL); in float32 both are held against the float64 VJP of the
# same factor, the hand one within VJP_F32_FACTOR times torch's own
# error (the card read 1.00-1.09 times at fx2007, synth and the weather
# twin's C: the factor's own rounding dominates both)
VJP_TOL = {"float32": 1e-5, "float64": 1e-13}
VJP_F64_TOL = 1e-8
VJP_F32_FACTOR = 1.25
# The solve kernel (A-bar = L^-T S L^-1) against its plain version
# (cuBLAS's two solves), relative to the largest magnitude: two float32
# routes of the same solves differ by the factor's conditioning times
# float32 rounding (K5's and cuBLAS's 0.8e-6 to 7.4e-6 at these sites),
# float64 by 6e-15; in float32 the kernel's error from the float64 solve
# of the same inputs within SOLVE_F32_FACTOR times cuBLAS's route's
VJP_SOLVE_TOL = {"float32": 1e-4, "float64": 1e-12}
SOLVE_F32_FACTOR = 1.25
# the exact oracle's closed-form gradient against the autograd route it
# replaces (torch's Cholesky backward), float64 at n=15768, relative;
# in float32 (phase 13b, fx2007's ExactLMC) both against the float64
# closed form, the closed form within ORACLE_F32_FACTOR times the
# autograd route's error (the same float32 K enters both, and its
# rounding times K's condition dominates: 0.70-1.25 times on the CPU at
# a condition of 1e5, tests/test_torch_chol_vjp.py)
ORACLE_GRAD_RTOL = 1e-8
ORACLE_F32_FACTOR = 1.5
# operations of one k(r) on the grid (K8, inside K1): a square or a sine
# and an exponential, about 20 floating-point operations
K8_OPS = 20.0
# the ``path`` of a kernel row checked and timed at a shape that no path
# of the port launches (its ``launches`` are 0)
OFF_PATH = "not on a path at this shape"
# K5's float32 solve held against the float64 solve of the same float32
# factor: its error within this many times cholesky_solve's; and PCG
# iterations per weather solve at most this (7.0312 before the chain, +2%;
# K5 sums in the same order as before, so the count should not move)
K5_F32_FACTOR = 1.25
WEATHER_PCG_MAX = 7.17
# K5's stress shapes: around one block, and a ragged multi-block factor
K5_STRESS_KS = (1, 63, 64, 65, 1037)
K5_STRESS_CS = tuple(range(1, 18))
# rows per slab of the plain K7 and K7 backward at the weather shape,
# and their timed calls (the plain backward takes about half a second)
WSLAB = 1024
WPLAIN_REPS = 2


def weather_spec(T, D):
    """The weather configuration's kernel (bench.py:84-94): SLFM rank 2
    plus a frozen-scale RBF per output."""
    return T.LMCKernelSpec.create(
        D=D, slfm_kernels=[T.RBF(name="slfm0"), T.RBF(name="slfm1")],
        indep_gp=[T.Scaled(inner=T.RBF(name="rbf%d" % i),
                           trainable_scale=False) for i in range(D)],
    )


def require(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps=20, warm=3):
    """Mean ms per call over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_time(fn, reps=20, warm=3):
    """Mean device ms per call over ``reps`` calls queued behind a spin
    kernel (``torch.cuda._sleep``, about 10 ms), so that the host has
    enqueued them all before the first starts: CUDA events then time the
    device's span of the calls, launches that overlap (a programmatic
    dependent launch) counted once, the host's own time not at all."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _self_device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


# torch.profiler ranges of a split profile, around the Woodbury solve
# with C (K5's call site), the jittered Cholesky (K3's), the capacitance
# matrix (K2's), the W applies (K4's, through K9), the products with the
# factors F (DeviceWoodbury._vt / _v, cuBLAS GEMMs) and, in the backward,
# the Cholesky VJP (chol_vjp.cholesky_backward: its tri and solve
# kernels)
RANGES = ("range: DeviceWoodbury._cho_solve_C",
          "range: woodbury.chol_jittered",
          "range: woodbury.capacitance_matrix",
          "range: Interp.matvec / rmatvec",
          "range: DeviceWoodbury._vt / _v",
          "range: chol_vjp.cholesky_backward (backward)")


def device_profile(fn, reps=1, ranges=False):
    """(device ms per call, [(kernel, calls, device ms)] by time, wall ms
    per call) of ``fn`` under torch.profiler, counting device-side
    events only; device ms is None when the profiler records none. With
    ``ranges``, ``DeviceWoodbury._cho_solve_C``,
    ``woodbury.chol_jittered``, ``woodbury.capacitance_matrix``, the
    interpolant's ``matvec`` / ``rmatvec``, ``DeviceWoodbury._vt`` /
    ``_v`` and ``chol_vjp.cholesky_backward`` run inside
    ``record_function`` ranges (``RANGES``; the forward ones see only
    their forward kernels: a backward's kernels fall outside them, but
    the Cholesky VJP's range is the backward call itself), and a fourth
    item gives the device ms per call of the kernels launched inside each
    range, by layer (``range_layer_of``: copies on the card and tril_
    apart)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from runlmc_tpu_torch.hopper import chol_vjp as cv
    from runlmc_tpu_torch.lmc import woodbury as wbm
    from runlmc_tpu_torch.ops.interpolation import Interp

    saved = (wbm.DeviceWoodbury._cho_solve_C, wbm.chol_jittered,
             wbm.capacitance_matrix, Interp.matvec, Interp.rmatvec,
             wbm.DeviceWoodbury._vt, wbm.DeviceWoodbury._v,
             cv.cholesky_backward)

    def ranged(name, f):
        def inner(*args, **kwargs):
            with record_function(name):
                return f(*args, **kwargs)
        return inner

    def restore():
        (wbm.DeviceWoodbury._cho_solve_C, wbm.chol_jittered,
         wbm.capacitance_matrix, Interp.matvec, Interp.rmatvec,
         wbm.DeviceWoodbury._vt, wbm.DeviceWoodbury._v,
         cv.cholesky_backward) = saved

    if ranges:
        wbm.DeviceWoodbury._cho_solve_C = ranged(RANGES[0], saved[0])
        wbm.chol_jittered = ranged(RANGES[1], saved[1])
        wbm.capacitance_matrix = ranged(RANGES[2], saved[2])
        Interp.matvec = ranged(RANGES[3], saved[3])
        Interp.rmatvec = ranged(RANGES[3], saved[4])
        wbm.DeviceWoodbury._vt = ranged(RANGES[4], saved[5])
        wbm.DeviceWoodbury._v = ranged(RANGES[4], saved[6])
        cv.cholesky_backward = ranged(RANGES[5], saved[7])
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3 / reps
    finally:
        restore()
    rows = [(e.key, e.count, _self_device_us(e) / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in RANGES
            and _self_device_us(e) > 0]
    rows.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    out = (total / reps if total > 0 else None), rows, wall_ms
    if not ranges:
        return out

    def kernels_under(evt):
        found = [(k.name, k.duration) for k in evt.kernels]
        for child in evt.cpu_children:
            found += kernels_under(child)
        return found

    split = {name: {} for name in RANGES}
    for evt in prof.events():
        if (evt.name in RANGES and evt.device_type == DeviceType.CPU
                and not (evt.cpu_parent is not None
                         and evt.cpu_parent.name == evt.name)):
            acc = split[evt.name]
            for kname, us in kernels_under(evt):
                layer = range_layer_of(kname)
                acc[layer] = acc.get(layer, 0.0) + us / 1e3 / reps
    return out + (split,)


# K9's layer, which the step profiles require, and K8 (fft)'s backward,
# which the weather step's requires
K9_LAYER = "K9 and K4 W applies (hand, interp.cu)"
K8_BWD_LAYER = "K8 fft first rows backward (hand, kern_rows_fft.cu)"
# device kernels by the layer of the kernel table they belong to; the
# library-routed part of K3 (the factorization) is told apart by its
# cuSOLVER kernel names, the hand part around it by its own. Every
# triangular solve of the port is a hand kernel: K5, or the Cholesky
# VJP's solve kernel (cuBLAS's trsm shows only where a yardstick or the
# oracle's potri runs it). K2 and K4 are hand kernels: the GEMMs left are
# the products with the factors F (woodbury.py's _vt/_v) and cuSOLVER's
# own updates.
LAYERS = (
    ("K2 backward (hand, capacitance.cu)",
     lambda k: any(p in k for p in ("cap_bwd_kernel", "cap_sym_kernel",
                                    "cap_bwd_finish_kernel",
                                    "eps_reduce_kernel"))),
    ("K2 capacitance (hand, capacitance.cu)",
     lambda k: "gram_apply_kernel" in k or "::cap_kernel<" in k),
    ("K5 triangular solves (hand, trsm.cu)",
     lambda k: "k5_trsm_" in k),
    ("K7 backward", lambda k: "::k7_bwd_" in k),
    ("K13", lambda k: "::lanczos_step_kernel<" in k),
    ("K10 backward", lambda k: "fourier_bwd_kernel" in k),
    ("K10", lambda k: "::fourier_fwd_kernel<" in k
     or "::fourier_fwd_small_kernel<" in k),
    ("K12", lambda k: "::minres_update_kernel<" in k),
    (K8_BWD_LAYER,
     lambda k: "::rows_fft_bwd_kernel<" in k
     or "::rows_fft_bwd_cluster_kernel<" in k),
    ("K8 fft first rows (hand, kern_rows_fft.cu)",
     lambda k: "::rows_fft_kernel<" in k),
    ("K11 and operand FFTs (cuFFT)", lambda k: "fft" in k.lower()),
    ("K1 backward", lambda k: "::kuu_bwd_" in k),
    ("K1", lambda k: "::kuu_fold_kernel<" in k
     or "::kuu_write_kernel<" in k),
    ("K7", lambda k: "::k7_pair_kernel<" in k
     or "::k7_general_kernel<" in k),
    (K9_LAYER,
     lambda k: any(p in k for p in ("::gather_kernel<", "::scatter_kernel<",
                                    "::scatter_warp_kernel<"))),
    ("K6", lambda k: k in ("xr_kernel", "p_kernel")),
    ("K3 backward (hand, chol_jitter.cu)",
     lambda k: any(p in k for p in ("k3_line_bwd_kernel<",
                                    "k3_tile_bwd_kernel<", "k3_finish_kernel<",
                                    "k3_trace_kernel<",
                                    "k3_add_diag_kernel<"))),
    ("K3 equilibrate, jitter, de-scale (hand, chol_jitter.cu)",
     lambda k: any(p in k for p in ("k3_scale_kernel<", "k3_prologue_kernel<",
                                    "k3_descale_kernel<"))),
    ("K3 VJP (hand, chol_vjp.cu)",
     lambda k: "::vjp_" in k),
    ("trsm (cuBLAS)",
     lambda k: "trsm" in k or "trsv" in k),
    ("K3 Cholesky", lambda k: any(p in k for p in ("getrf", "potrf", "potf2",
                                                   "syrk"))),
    ("potri (cuSOLVER: the exact oracle's K^-1)",
     lambda k: any(p in k for p in ("potri", "trtri", "lauum"))),
    ("GEMM and GEMV (F products)",
     lambda k: "gemm" in k or "gemv" in k),
)


ELEMENTWISE = "elementwise, reductions, copies"
# inside the ranges of a split profile, two kinds of kernel of the
# elementwise layer are told apart: copies on the card (a memcpy from
# device to device, or a copy kernel; not the host reads of a flag), and
# torch's tril_ (cholesky_ex runs it after potrf)
COPY_LAYER = "device copies (memcpy DtoD, copy kernels)"
TRIL_LAYER = "tril_ (cholesky_ex, after potrf)"


def is_device_copy(kernel):
    low = kernel.lower()
    return "dtod" in low or ("copy" in low and "memcpy" not in low)


def range_layer_of(kernel):
    if is_device_copy(kernel):
        return COPY_LAYER
    if "triu_tril" in kernel:
        return TRIL_LAYER
    return layer_of(kernel)


def layer_of(kernel):
    return next((name for name, hit in LAYERS if hit(kernel)), ELEMENTWISE)


# The sources of the elementwise layer: record_function ranges around
# the port's functions that launch elementwise kernels of their own,
# innermost first; a backward kernel is credited to the range of the
# forward op whose autograd node launched it (the profiler's sequence
# numbers join the two).
SOURCES = (
    ("lk", "build_kski", "build_kski (noise expansion, operator)"),
    ("lk", "exact_ski_mll", "exact SKI MLL (the rest)"),
    ("lk", "stochastic_mll_surrogate", "stochastic surrogate (the rest)"),
    ("wbm", "build_device_woodbury", "Woodbury factorization (the rest)"),
    ("wbm", "chol_jittered", "jittered Cholesky (torch ops)"),
    ("spec", "coreg_mats", "B_q = A_q^T A_q + diag(kappa_q)"),
    ("spec", "noise", "noise transform"),
    ("spec", "table_rows", "kernel-table rows (K1's and K8's input)"),
)


def elementwise_sources(fn, per=1):
    """(elementwise device ms and launches per call of ``fn``, divided
    by ``per``, by source: {source: {launches, device_ms}}; the same
    profile's layers) of ``fn`` under torch.profiler, with ``SOURCES``'
    ranges in place. Forward kernels outside every range are the
    optimizer's update and the solves' vector operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from runlmc_tpu_torch.lmc import likelihood as lk
    from runlmc_tpu_torch.lmc import woodbury as wbm
    from runlmc_tpu_torch.lmc.kernel_spec import LMCKernelSpec

    owners = {"lk": lk, "wbm": wbm, "spec": LMCKernelSpec}
    saved = []

    def ranged(name, f):
        def inner(*args, **kwargs):
            with record_function(name):
                return f(*args, **kwargs)
        return inner

    for owner, attr, label in SOURCES:
        f = getattr(owners[owner], attr, None)
        if f is not None:
            saved.append((owners[owner], attr, f))
            setattr(owners[owner], attr, ranged("src: " + label, f))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for owner, attr, f in saved:
            setattr(owner, attr, f)

    def label(e):
        while e is not None:
            if e.name.startswith("src: "):
                return e.name[5:]
            e = e.cpu_parent
        return None

    def node(e):
        while e is not None:
            if "Backward" in e.name and e.sequence_nr >= 0:
                return e
            e = e.cpu_parent
        return None

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    forward = {}
    for e in events:
        if e.sequence_nr >= 0 and node(e) is None:
            forward.setdefault(e.sequence_nr, e)
    out = {}
    for e in events:
        for k in e.kernels:
            if layer_of(k.name) != ELEMENTWISE:
                continue
            nd = node(e)
            if nd is None:
                src = label(e) or "optimizer update, solves' vector ops"
            else:
                fw = forward.get(nd.sequence_nr)
                src = "backward of " + ((label(fw) if fw else None)
                                        or "the rest")
            acc = out.setdefault(src, [0, 0.0])
            acc[0] += 1
            acc[1] += k.duration / 1e3
    rows = [(e.key, e.count, _self_device_us(e) / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _self_device_us(e) > 0
            and not e.key.startswith("src: ")]
    return ({k: {"launches": v[0] / per, "device_ms": v[1] / per}
             for k, v in sorted(out.items(), key=lambda kv: -kv[1][1])},
            by_layer(rows, per=per))


def by_layer(rows, per=1):
    """Profile rows summed by layer: {layer: {launches, device_ms}}, each
    divided by ``per`` (steps in the profiled window)."""
    out = {}
    for key, count, ms in rows:
        layer = layer_of(key)
        acc = out.setdefault(layer, [0, 0.0])
        acc[0] += count
        acc[1] += ms
    return {k: {"launches": v[0] / per, "device_ms": v[1] / per}
            for k, v in sorted(out.items(), key=lambda kv: -kv[1][1])}


def print_split(split, per=1):
    """The device ms (per step, over ``per``) of the kernels launched
    inside each range of a split profile, by layer."""
    for rng, layers in split.items():
        total = sum(layers.values()) / per
        print("  %s: %.4f ms" % (rng, total), flush=True)
        for name, ms in sorted(layers.items(), key=lambda kv: -kv[1]):
            print("    %-38s %8.4f ms" % (name, ms / per), flush=True)


K3_BWD_LAYER = "K3 backward (hand, chol_jitter.cu)"


def print_k3_bwd(what, layers):
    """K3's backward (K3a bwd and K3b bwd) per step of a profiled
    chunk."""
    v = layers.get(K3_BWD_LAYER, {"device_ms": 0.0, "launches": 0.0})
    print("K3 bwd per %s step: %.4f ms device, %.1f launches"
          % (what, v["device_ms"], v["launches"]), flush=True)


@contextlib.contextmanager
def generic_kernels():
    """K10's forward and K9's gather as their generic kernels: K10's
    generic instance, the gather's generic tap count, one batch row a
    thread, a thread a row (the selectors patched, restored on
    exit)."""
    from runlmc_tpu_torch.hopper import fourier, interp

    saved = (fourier.fourier_instance, interp.gather_taps,
             interp.gather_chunk, interp.gather_layout)
    fourier.fourier_instance = lambda rep, D, K: fourier.GENERIC
    interp.gather_taps = lambda taps: 0
    interp.gather_chunk = lambda *args, **kwargs: 1
    interp.gather_layout = lambda sb, sc, nbatch: interp.GATHER_ROWS
    try:
        yield
    finally:
        (fourier.fourier_instance, interp.gather_taps,
         interp.gather_chunk, interp.gather_layout) = saved


def rung_cycle_layers(matvec, rhs, tol):
    """The first cycle of the plain MINRES rung (``KRYLOV_CYCLE``
    iterations of ``_minres_cycle`` on ``rhs`` from zero, as
    ``batched_minres`` starts it), profiled once: {layer: {launches,
    device_ms}} (:func:`by_layer`)."""
    import torch

    from runlmc_tpu_torch.models.interpolated_llgp import KRYLOV_CYCLE
    from runlmc_tpu_torch.ops.solvers import _minres_cycle

    tol_t = torch.full((1,), tol, dtype=rhs.dtype, device=rhs.device)
    _, rows, _ = device_profile(
        lambda: _minres_cycle(matvec, rhs, tol_t, KRYLOV_CYCLE))
    return by_layer(rows)


def require_layers(layers, names, what):
    """Fail unless every layer of ``names`` launched in the profile
    ``layers`` (:func:`by_layer`): a kernel that ``LAYERS`` no longer
    names would be filed under the elementwise layer."""
    for name in names:
        require(layers.get(name, {}).get("launches", 0) > 0,
                "%s: no launch of layer %s in its profile (LAYERS misses "
                "its kernels?)" % (what, name))


def print_layers(layers):
    for name, v in layers.items():
        print("  %-32s %8.4f ms  %7.1f launches" % (name, v["device_ms"],
                                                    v["launches"]),
              flush=True)


def bound_ms(nbytes, flops, dtype, product=False):
    peak = PEAK_PRODUCT_FLOPS if product else PEAK_FLOPS
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / peak[str(dtype).replace("torch.", "")] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _ms(t):
    return "-" if t is None else "%.4f ms" % t


def errors(got, want):
    import torch

    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    abs_err, rel_err = 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        require(bool(torch.isfinite(g).all()), "non-finite kernel output")
        a = float(torch.max(torch.abs(g - w))) if g.numel() else 0.0
        scale = float(torch.max(torch.abs(w))) if w.numel() else 0.0
        abs_err = max(abs_err, a)
        rel_err = max(rel_err, a / scale if scale > 0 else a)
    return abs_err, rel_err


def k5_seeded_factor(k, dtype, dev):
    """Lower Cholesky factor of a seeded SPD (k, k) matrix with condition
    number about 3: I + (G + G^T) / (4 sqrt(2k)), G standard normal, whose
    spectrum lies in about [0.5, 1.5]; factored in float64, then cast."""
    import math

    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + k)
    A = torch.randn(k, k, generator=g, dtype=torch.float64, device=dev)
    A = A + A.T
    A /= 4.0 * math.sqrt(2.0 * k)
    A.diagonal().add_(1.0)
    L = torch.linalg.cholesky(A)
    del A
    return L.to(dtype)


def k5_other_storage(L):
    """The same factor in the other storage order (row-major <->
    column-major)."""
    return L.mT.contiguous().mT if L.is_contiguous() else L.contiguous()


def k5_apply(trsm, op, L, B, plain=False):
    """One K5 op on the rows of B: ``trsm_lower``, ``trsm_lower_t`` (the
    transposed variant) or ``cho_solve``; the plain versions with
    ``plain``."""
    solve = trsm.trsm_lower_plain if plain else trsm.trsm_lower
    if op == "cho_solve":
        return solve(L, solve(L, B), trans=True)
    return solve(L, B, trans=(op == "trsm_lower_t"))


def k5_schedule(trsm, op, L, B):
    """One K5 op in the kernel's block order (``trsm_lower_schedule``)."""
    solve = trsm.trsm_lower_schedule
    if op == "cho_solve":
        return solve(L, solve(L, B), trans=True)
    return solve(L, B, trans=(op == "trsm_lower_t"))


def k5_per_block(trsm, op, L, B):
    """One K5 op through the per-block kernel at any c (route 1): the
    chain sums in its order, so the two agree to the bit."""
    if op == "cho_solve":
        return trsm._launch(L, trsm._launch(L, B, False, 1), True, 1)
    return trsm._launch(L, B, op == "trsm_lower_t", 1)


def k5_backward_error(L, B, X, op):
    """Normwise backward error ||A X - B|| / (||A|| ||X|| + ||B||) in
    float64, infinity norms of the column-notation matrices (right-hand
    sides as columns), with A = L, L^T or L L^T (then ||L|| ||L^T||)."""
    import torch

    Lt = torch.tril(L.double())
    X, B = X.double(), B.double()

    def norm_inf(rows):  # ||rows^T||_inf
        return float(rows.abs().sum(0).max())

    nL, nLt = float(Lt.abs().sum(1).max()), float(Lt.abs().sum(0).max())
    if op == "trsm_lower":
        R, nA = X @ Lt.T - B, nL
    elif op == "trsm_lower_t":
        R, nA = X @ Lt - B, nLt
    else:
        R, nA = (X @ Lt) @ Lt.T - B, nL * nLt
    return norm_inf(R) / (nA * norm_inf(X) + norm_inf(B))


def k2_grams(gds):
    """{(a, b): host (D, m_a, m_b) gram} of a Woodbury set of placed or
    host dense-mode GridData."""
    import numpy as np

    def host(t):
        return np.asarray(t.cpu() if hasattr(t, "cpu") else t)

    out = {}
    for a, gd in enumerate(gds):
        out[a, a] = host(gd.WtW)
        for j, (g_ab, g_ba) in enumerate(gd.cross):
            out[a, a + 1 + j] = host(g_ab.G)
            out[a + 1 + j, a] = host(g_ba.G)
    return out


def k2_work(gds, esize):
    """(forward bytes, forward operations, backward bytes, backward
    operations, dense operations) of K2 on the Woodbury set ``gds``,
    counted over what these inputs need. Stage 1 multiplies each nonzero
    G_{ab,d}[p, r] by the d m_b + r + 1 entries of F_b's row d m_b + r
    left of its diagonal; stage 2 each lower entry (k, l) of C by the
    rows of each F_{a,d} that are nonzero in column k; the backward each
    entry (i, c <= d m_a + i) of Y_{a,d} by the columns of T_{a.,d} that
    are not zero. Bytes: every input read once (F's lower triangle, the
    grams' nonzeros; the backward also T, Cbar), every output written
    once. The dense count is the XLA formula's, 2 D m_a m_b Dm_b +
    2 Dm_a^2 Dm_b per block (a, b <= a)."""
    import numpy as np

    grams = k2_grams(gds)
    ms = [grams[a, a].shape[1] for a in range(len(gds))]
    D = grams[0, 0].shape[0]
    ks = [D * m for m in ms]
    k = sum(ks)
    fwd = dense = 0.0
    nnz = 0
    for (a, b), G in grams.items():
        for d in range(D):
            r = np.nonzero(G[d])[1]
            nnz += len(r)
            fwd += 2.0 * float(np.sum(np.minimum(d * ms[b] + r + 1, ks[b])))
    for a in range(len(gds)):
        kk = np.arange(ks[a])
        rows = sum(np.clip((d + 1) * ms[a] - kk, 0, ms[a]) for d in range(D))
        for b in range(a + 1):
            cols = kk + 1 if a == b else np.full(ks[a], ks[b])
            fwd += 2.0 * float(np.sum(rows * cols))
            dense += 2.0 * D * ms[a] * ms[b] * ks[b] + 2.0 * ks[a] ** 2 * ks[b]
    bwd = 0.0
    for a in range(len(gds)):
        i = np.arange(ms[a])
        for d in range(D):
            width = sum(min(ks[g], (d + 1) * ms[g]) for g in range(len(gds)))
            bwd += 2.0 * width * float(np.sum(np.minimum(d * ms[a] + i + 1,
                                                         ks[a])))
    tri = sum(kk * (kk + 1) // 2 for kk in ks)
    fwd_bytes = esize * (tri + nnz + D + k * k)
    bwd_bytes = esize * (tri + sum(kk * k for kk in ks) + k * k + D
                         + sum(kk * kk for kk in ks) + D)
    return fwd_bytes, fwd, bwd_bytes, bwd, dense


# K2's kernels by the name the profiler gives them: the forward's two
# stages, then the backward's S = C-bar + C-bar^T pass, its tiles, the
# pass that scales F-bar and sums the d(eps^-1) partials, and their
# fixed-order reduction
K2_KERNELS = (("k2_gram_apply", "gram_apply_kernel"),
              ("k2_cap", "::cap_kernel<"),
              ("k2_sym", "cap_sym_kernel"),
              ("k2_cap_bwd", "cap_bwd_kernel"),
              ("k2_cap_bwd_finish", "cap_bwd_finish_kernel"),
              ("k2_eps_reduce", "eps_reduce_kernel"))


def k2_split(fn, reps=10):
    """{kernel: {"us_per_launch", "launches_per_call"}} of ``fn`` (K2 or
    its backward) by kernel name, from the profiler over ``reps`` calls.
    The time is per launch counted: the profiler can drop a launch from
    its window (0.67-0.9 counted per call in one run), which would read
    low as a sum per call."""
    rows_ = device_profile(fn, reps=reps)[1]
    out = {}
    for key, count, ms in rows_:
        for tag, pat in K2_KERNELS:
            if pat in key:
                acc = out.setdefault(tag, [0, 0.0])
                acc[0] += count
                acc[1] += ms
    return {tag: {"us_per_launch": v[1] * 1e3 / v[0],
                  "launches_per_call": v[0] / reps}
            for tag, v in out.items()}


def k2_split_text(split):
    return ", ".join("%s %.1f us a launch (%g per call)"
                     % (t, v["us_per_launch"], v["launches_per_call"])
                     for t, v in split.items())


def k2_matmul_yardstick(Ts, Cbar, offs, ks):
    """The backward's library yardstick: one ``torch.matmul(T_a, S[:,
    cols of a])`` per group, S = C-bar + C-bar^T formed outside the
    timed call; never called by the port."""
    import torch

    S = Cbar + Cbar.T

    def run():
        return [torch.matmul(T_a, S[:, o:o + k_])
                for T_a, o, k_ in zip(Ts, offs, ks)]
    return run


def k2_library(grams, inv_eps, Fs):
    """The capacitance matrix by the dense products of the JAX package's
    formula (woodbury.py:260-298: a batched gram product and one large
    GEMM per block, cuBLAS here), C_ba mirrored from C_ab: the library
    yardstick of K2, never called by the port."""
    import torch

    D = inv_eps.shape[0]
    ms = [F.shape[0] // D for F in Fs]
    n = len(Fs)
    Fd = [torch.tril(F).reshape(D, m, -1) for F, m in zip(Fs, ms)]
    rows = [[None] * n for _ in range(n)]
    for a in range(n):
        for b in range(a, n):
            T1 = torch.bmm(grams[a][b][0], Fd[b])
            rows[a][b] = (Fd[a] * inv_eps[:, None, None]).reshape(
                D * ms[a], -1).T @ T1.reshape(D * ms[a], -1)
            if b > a:
                rows[b][a] = rows[a][b].T
    C = torch.cat([torch.cat(r, dim=1) for r in rows], dim=0)
    return C + torch.eye(C.shape[0], dtype=C.dtype, device=C.device)


@contextlib.contextmanager
def library_capacitance(wbm):
    """Inside: the port's Woodbury factorizations form C by
    :func:`k2_library` (cuBLAS, differentiated by autograd) in place of
    K2, to hold C's float32 rounding against the dense products' in the
    same run; K2 again on exit."""
    orig = wbm.capacitance_matrix
    wbm.capacitance_matrix = k2_library
    try:
        yield
    finally:
        wbm.capacitance_matrix = orig


@contextlib.contextmanager
def ladder_log(wbm):
    """Inside: each ``chol_jittered`` call appends ``{"kind", "dtype",
    "rung", "scale", "reads"}`` to the yielded list: ``kind`` "C" for the
    capacitance ladder (its first scale is 0), else "K_UU"; ``rung`` the
    first scale whose flag was read as set (the last when none was);
    ``reads`` the host reads of its flags."""
    real, real_acc = wbm.chol_jittered, wbm._accepted
    log, reads = [], []

    def accepted(flag):
        ok = real_acc(flag)
        reads.append(ok)
        return ok

    def jittered(A, scales=(1e-6, 1e-4, 1e-2), equilibrate=None):
        start = len(reads)
        L = real(A, scales=scales, equilibrate=equilibrate)
        mine = reads[start:]
        rung = mine.index(True) if True in mine else len(scales) - 1
        log.append({"kind": "C" if scales[0] == 0.0 else "K_UU",
                    "dtype": str(A.dtype).replace("torch.", ""),
                    "rung": rung, "scale": scales[rung],
                    "reads": len(mine)})
        return L

    wbm.chol_jittered, wbm._accepted = jittered, accepted
    try:
        yield log
    finally:
        wbm.chol_jittered, wbm._accepted = real, real_acc


def ladder_summary(log, steps):
    """Factorizations, attempts and host reads per step of a
    :func:`ladder_log` list, and how many landed on each rung by kind."""
    rungs = {}
    for e in log:
        key = "%s %s" % (e["kind"], e["dtype"])
        rungs.setdefault(key, {})
        rungs[key][e["scale"]] = rungs[key].get(e["scale"], 0) + 1
    return {"factorizations_per_step": len(log) / steps,
            "attempts_per_step": sum(e["rung"] + 1 for e in log) / steps,
            "host_reads_per_step": sum(e["reads"] for e in log) / steps,
            "landed": {k: {str(c): n for c, n in sorted(v.items())}
                       for k, v in rungs.items()}}


def vjp_solve_k5(L, S):
    """A-bar = L^-T S L^-1 (S symmetric) by two solves on K5 and the
    symmetrization, a yardstick of the solve kernel (chol_vjp_solve):
    rows of S L^-1, then rows of (S L^-1)^T L^-1, one transposed copy
    between."""
    from runlmc_tpu_torch.hopper.trsm import trsm_lower

    W = trsm_lower(L, S, trans=True)
    X = trsm_lower(L, W.mT.contiguous(), trans=True)
    return 0.5 * (X + X.mT)


def exact_mll_autograd(spec, raw_params, X, oidx, y):
    """The exact MLL as the port computed it before its closed-form
    gradient (likelihood.ExactMLL): autograd through torch's Cholesky
    backward (cuBLAS GEMM and trsm) and K7's backward. Kept here only as
    the yardstick the closed form is held against and timed beside."""
    import math

    import torch

    from runlmc_tpu_torch.hopper.trsm import cho_solve
    from runlmc_tpu_torch.lmc import likelihood as lk

    L = lk._chol_or_nan(lk.exact_dense_K(spec, raw_params, X, oidx))
    alpha = cho_solve(L, y[None])[0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return -0.5 * (torch.dot(y, alpha) + logdet
                   + y.shape[0] * math.log(2 * math.pi))


def synth_spec(T, D):
    """The synth configuration's kernel (bench.py:114-130): SLFM rank 2
    plus an RBF per output."""
    return T.LMCKernelSpec.create(
        D=D, slfm_kernels=[T.RBF(name="slfm0"), T.RBF(name="slfm1")],
        indep_gp=[T.RBF(name="rbf%d" % i) for i in range(D)],
    )


# ---------------------------------------------------------------- phase 17
# The mesh layer (runlmc_tpu_torch/parallel): every rank is a process of
# this script (``--mesh-worker CONFIG RANK WORLD STORE OUT``), all started
# together once phase 2 has built every library (a worker loads them and
# builds nothing); the ranks of a configuration meet at a FileStore.
# CONFIG -> (ranks, backend, model, layout): 'probe' is default_mesh(ranks)
# (the stochastic objective's solve rows, the exact objective's data
# rows), 'grid' probe_grid_mesh(1, ranks) (the fft group's Fourier axis).
# Gloo runs ranks that share one card; 'weather-nccl' runs only where
# there is a card per rank.
MESH_CONFIGS = {
    "weather": (2, "gloo", "weather", "probe"),
    "weather-nccl": (2, "nccl", "weather", "probe"),
    "fx2007": (2, "gloo", "fx2007", "probe"),
    "fx2007-nccl": (1, "nccl", "fx2007", "probe"),
    "grid": (2, "gloo", "weather", "grid"),
}
# the weather configurations solve to STOCH_TOL: rows solved in another
# batch then certify to the same absolute residual, so the first-step
# gradient agrees with the single process within the stochastic bound
# (PERF.md section 2); fx2007 keeps its float32 factors (TRAIN_RTOL)
MESH_STOCH_RTOL = STOCH_RTOL
MESH_EXACT_RTOL = TRAIN_RTOL
# AdaDelta steps after the first gradient (the ranks' bits compared), a
# spawn's time limit, the probe stream's run seed, the seeded grid_matvec
# operands of the grid layout, and each rank's CPU threads (7 ranks on the
# host's 8 cores)
MESH_STEPS = 3
MESH_SPAWN_S = 180
MESH_RUN_SEED = 7
MESH_VECS = 16
MESH_VEC_SEED = 23
MESH_THREADS = "2"
# the kernel rows of the grid layout's path, and their launches
MESH_GRID_PATH = "mesh (grid)"


def mesh_model(T, which, dev, mesh=None):
    """The phase's model, ``which`` 'weather' (m=2500, stochastic, solves
    to STOCH_TOL) or 'fx2007' (exact, float32 factors), on ``mesh``."""
    from runlmc_tpu_torch.datasets import fx2007_synthetic, weather_synthetic

    if which == "weather":
        x, y, _, _, _ = weather_synthetic(SEED)
        return T.InterpolatedLLGP(
            x, y, functional_kernel=weather_spec(T, len(x)), m=WEATHER_M,
            objective="stochastic", tolerance=STOCH_TOL, seed=SEED,
            mesh=mesh, device=dev)
    x, y, _, _ = fx2007_synthetic(SEED)
    spec = T.LMCKernelSpec.create(D=len(x), lmc_kernels=[T.RBF(name="rbf0")],
                                  lmc_ranks=[2])
    return T.InterpolatedLLGP(x, y, functional_kernel=spec, m=[234],
                              objective="exact", tolerance=TOLERANCE,
                              seed=SEED, mesh=mesh, device=dev)


def mesh_first_grad(m, x):
    """The first step's gradient at ``x`` (the stochastic one on the
    probes of MESH_RUN_SEED's iteration 0), averaged over the mesh."""
    if m.objective == "stochastic":
        return m._stochastic_grad(x, m._probes(MESH_RUN_SEED, 0))
    return m._exact_grad(x)


def mesh_vectors(cols, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(MESH_VEC_SEED)
    return torch.randn((MESH_VECS, cols), generator=gen, device=dev,
                       dtype=torch.float64)


def collective_us(prof):
    """(device µs, calls) inside the collectives' profiler range."""
    from runlmc_tpu_torch.parallel.collectives import RANGE

    for evt in prof.key_averages():
        if evt.key == RANGE:
            dev_us = getattr(evt, "device_time_total", None)
            if dev_us is None:
                dev_us = evt.cuda_time_total
            return float(dev_us), int(evt.count)
    return 0.0, 0


# FourierContract.backward's parts, each the range of the function it
# calls (``k10_bwd_ranges``): the H kernel, symbol_grads' einsums and the
# adjoint forward; what else runs inside the backward (a Fourier range's
# zero-filled operand cotangent, its copy) is the rest
K10_BWD_PARTS = (("H kernel", "fourier_contract_bwd"),
                 ("symbol_grads einsums", "symbol_grads"),
                 ("adjoint forward", "fourier_contract"))
K10_BWD_REST = "operand cotangent (zero fill, copy) and the rest"
K10_PART = "K10 part: "
K10_WINDOW = "K10 backward window"


@contextlib.contextmanager
def k10_bwd_ranges():
    """FourierContract.backward inside a ``record_function`` range
    ``K10_WINDOW`` and the functions it calls each inside a range
    ``K10_PART + part``, every range opened and closed on an idle device
    (a ``torch.cuda.synchronize`` before it and at its end), so that a
    kernel runs inside the host span of the range that launched it; for
    a profile read by :func:`k10_bwd_split`."""
    import torch
    from torch.profiler import record_function

    from runlmc_tpu_torch.hopper import fourier

    saved = {attr: getattr(fourier, attr) for _, attr in K10_BWD_PARTS}
    saved_bwd = fourier.FourierContract.__dict__["backward"]

    def ranged(name, f):
        def inner(*args, **kwargs):
            torch.cuda.synchronize()
            with record_function(name):
                out = f(*args, **kwargs)
                torch.cuda.synchronize()
            return out
        if hasattr(f, "launches"):  # a wrapper counts on its own name
            inner.launches = f.launches
        return inner

    for part, attr in K10_BWD_PARTS:
        setattr(fourier, attr, ranged(K10_PART + part, saved[attr]))
    fourier.FourierContract.backward = staticmethod(
        ranged(K10_WINDOW, saved_bwd.__func__))
    try:
        yield
    finally:
        for attr, f in saved.items():
            setattr(fourier, attr, f)
        fourier.FourierContract.backward = saved_bwd


def k10_bwd_split(prof, per=1):
    """Device µs per step (``per`` steps profiled) of the device work
    that ran inside FourierContract.backward under
    :func:`k10_bwd_ranges`: in all, by part (the ``K10_BWD_PARTS`` range
    whose host span holds the kernel's start; the rest of the window
    outside them) and by kernel name, with the backward's calls (the
    package's range ``fourier.BWD_RANGE`` where it has one)."""
    from torch.autograd import DeviceType

    from runlmc_tpu_torch.hopper import fourier

    events = prof.events()

    def spans(name):
        return [(e.time_range.start, e.time_range.end) for e in events
                if e.name == name and e.device_type == DeviceType.CPU]

    rng = getattr(fourier, "BWD_RANGE", None)
    windows = spans(K10_WINDOW)
    inner = [(part, span) for part, _ in K10_BWD_PARTS
             for span in spans(K10_PART + part)]
    ranges = {rng, K10_WINDOW} | {K10_PART + p for p, _ in K10_BWD_PARTS}
    parts = {part: 0.0 for part, _ in K10_BWD_PARTS}
    parts[K10_BWD_REST] = 0.0
    kernels = {}
    for e in events:
        # the ranges' own device-side spans are not work
        if e.device_type != DeviceType.CUDA or e.name in ranges:
            continue
        t = e.time_range.start
        if not any(a <= t <= b for a, b in windows):
            continue
        part = next((p for p, (a, b) in inner if a <= t <= b), K10_BWD_REST)
        us = e.time_range.end - e.time_range.start
        parts[part] += us
        kernels[e.name[:60]] = kernels.get(e.name[:60], 0.0) + us
    calls = len(spans(rng)) or len(windows)
    return {"calls": calls / per,
            "device_us": sum(parts.values()) / per,
            "parts_us": {k: v / per for k, v in parts.items()},
            "kernels_us": {k: v / per for k, v in sorted(
                kernels.items(), key=lambda kv: -kv[1])}}


def mesh_worker(config, rank, world, store, out):
    """``--mesh-worker``: one rank of phase 17. Starts the process group
    (``parallel.initialize`` on the FileStore ``store``), builds the
    configuration's model on its mesh, takes the first step's gradient
    (launch counts reset before and read after), times it warm and
    profiles it (the collectives' device time), for the grid layout
    applies the group's grid_matvec to MESH_VECS seeded vectors, trains
    MESH_STEPS steps, and writes ``OUT.rank<RANK>.json`` and ``.npz``."""
    import hashlib

    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import runlmc_tpu_torch as T
    import runlmc_tpu_torch.parallel as par
    from runlmc_tpu_torch import hopper
    from runlmc_tpu_torch.lmc import likelihood as lk
    from runlmc_tpu_torch.parallel.mesh import shard_range

    rank, world = int(rank), int(world)
    _, backend, which, layout = MESH_CONFIGS[config]
    dev = torch.device("cuda", rank % torch.cuda.device_count()
                       if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    t0 = time.time()
    require(par.initialize("file://" + store, world, rank, backend=backend,
                           timeout=MESH_SPAWN_S), "no process group")
    mesh = (par.probe_grid_mesh(1, world) if layout == "grid"
            else par.default_mesh(world))
    init_s = time.time() - t0
    t0 = time.time()
    m = mesh_model(T, which, dev, mesh)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    x0 = torch.as_tensor(m.param_array, dtype=m.dtype, device=dev)
    solves = []
    plain = lk.sharded_solve

    def recording(*args, **kwargs):
        res = plain(*args, **kwargs)
        solves.append(res)
        return res

    lk.sharded_solve = recording
    hopper.reset_launches()
    g, aux = mesh_first_grad(m, x0)
    torch.cuda.synchronize()
    launches = hopper.launch_counts()
    t0 = time.time()
    mesh_first_grad(m, x0)
    torch.cuda.synchronize()
    grad_s = time.time() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with k10_bwd_ranges(), torch.profiler.profile(activities=acts) as prof:
        mesh_first_grad(m, x0)
        torch.cuda.synchronize()
    coll_us, coll_calls = collective_us(prof)
    res = {"config": config, "rank": rank, "world": world,
           "backend": backend, "device": str(dev), "layout": layout,
           "init_s": init_s, "build_s": build_s, "grad_s": grad_s,
           "collective_device_us": coll_us, "collective_calls": coll_calls,
           "k10_bwd": k10_bwd_split(prof),
           "solve_error": float(aux.solve_error),
           "solve_iters_mean": float(aux.solve_iters), "launches": launches}
    arrays = {"grad": g.cpu().numpy()}
    if which == "weather":
        it = solves[0].iterations.cpu().numpy()
        shards = mesh.shape["probe"]
        per = -(-len(it) // shards)
        lo = mesh.index("probe") * per
        mine = it[lo:lo + per]
        res["rows"] = [int(lo), int(lo + len(mine))]
        res["loop_iterations"] = int(mine.max())
        res["row_iterations"] = mine.tolist()
    else:
        res["rows"] = list(shard_range(len(m.data.y), world, rank))
    if layout == "grid":
        grp = m._kski().groups[0]
        F = int(np.prod(grp.fourier_shape()))
        res["fourier_range"] = list(shard_range(F, world, rank)) + [F]
        mv = grp.grid_matvec(mesh_vectors(grp.interp.ncols, dev))
        arrays["matvec"] = mv.cpu().numpy()
        res["matvec_sha256"] = hashlib.sha256(
            arrays["matvec"].tobytes()).hexdigest()
    m.chunk_len = MESH_STEPS
    torch.cuda.synchronize()
    t0 = time.time()
    info = m.optimize(T.AdaDelta(max_it=MESH_STEPS))
    torch.cuda.synchronize()
    res["steps_s"] = time.time() - t0
    res["n_iter"] = int(info["n_iter"])
    arrays["params"] = m.param_array
    res["params_sha256"] = hashlib.sha256(
        np.ascontiguousarray(arrays["params"]).tobytes()).hexdigest()
    np.savez("%s.rank%d.npz" % (out, rank), **arrays)
    with open("%s.rank%d.json" % (out, rank), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def mesh_spawn(configs, tmp):
    """Start every rank of ``configs`` (one process each, logs under
    ``tmp``); returns ``[(config, rank, process, log)]``."""
    env = dict(os.environ, OMP_NUM_THREADS=MESH_THREADS,
               MKL_NUM_THREADS=MESH_THREADS)
    # the ranks talk over the loopback device: the machine has no network
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    procs = []
    for cfg in configs:
        world = MESH_CONFIGS[cfg][0]
        store = os.path.join(tmp, cfg + ".store")
        for r in range(world):
            log = open(os.path.join(tmp, "%s.rank%d.log" % (cfg, r)), "w")
            p = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-worker",
                 cfg, str(r), str(world), store, os.path.join(tmp, cfg)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=HERE)
            procs.append((cfg, r, p, log))
    return procs


def mesh_wait(procs, start, tmp):
    """Wait for every rank, each within MESH_SPAWN_S of ``start``; any
    rank that fails or runs out of time fails the phase (every rank is
    killed and the tails of the logs under ``tmp`` printed)."""
    bad = []
    for cfg, r, p, log in procs:
        try:
            rc = p.wait(timeout=max(1.0, start + MESH_SPAWN_S - time.time()))
        except subprocess.TimeoutExpired:
            rc = "timed out after %d s" % MESH_SPAWN_S
        log.close()
        if rc != 0:
            bad.append((cfg, r, rc))
    if bad:
        mesh_kill(procs)
        for cfg, r, rc in bad:
            with open(os.path.join(tmp, "%s.rank%d.log" % (cfg, r))) as f:
                tail = f.read()[-3000:]
            print("mesh %s rank %d: %s\n%s" % (cfg, r, rc, tail), flush=True)
        raise RuntimeError("chip_smoke: mesh ranks failed: %s" % (bad,))


def mesh_kill(procs):
    for _, _, p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def mesh_phase(T, dev, record, path_launches):
    """Phase 17: spawn the ranks of MESH_CONFIGS, meanwhile take the
    single-process references on this card (the weather model's
    first-step gradient and grid_matvec, fx2007's first-step gradient)
    and hold K10's range kernel and its backward at the weather shape
    against their plain versions and against the slice of the full
    range's output (the bits); then hold every rank against the
    references. Returns the phase's results; the grid layout's launches
    go to ``path_launches[MESH_GRID_PATH]``."""
    import hashlib

    import numpy as np
    import torch

    from runlmc_tpu_torch import hopper
    from runlmc_tpu_torch.hopper import fourier
    from runlmc_tpu_torch.models.interpolated_llgp import (
        EXACT_RESIDUAL_THRESHOLD,
    )
    from runlmc_tpu_torch.parallel.mesh import shard_range

    card = card_line()
    configs = [c for c in MESH_CONFIGS
               if MESH_CONFIGS[c][1] != "nccl" or MESH_CONFIGS[c][0] == 1
               or torch.cuda.device_count() >= MESH_CONFIGS[c][0]]
    skipped = [c for c in MESH_CONFIGS if c not in configs]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    start = time.time()
    procs = mesh_spawn(configs, tmp)
    try:
        ref = {}
        t0 = time.time()
        sw = mesh_model(T, "weather", dev)
        xw = torch.as_tensor(sw.param_array, dtype=sw.dtype, device=dev)
        ref["weather"] = mesh_first_grad(sw, xw)[0].cpu().numpy()
        grp = sw._kski().groups[0]
        mv = grp.grid_matvec(mesh_vectors(grp.interp.ncols, dev))
        ref["matvec"] = mv.cpu().numpy()
        sf = mesh_model(T, "fx2007", dev)
        xf = torch.as_tensor(sf.param_array, dtype=sf.dtype, device=dev)
        ref["fx2007"] = mesh_first_grad(sf, xf)[0].cpu().numpy()
        ref_s = time.time() - t0
        # K10 on rank 1's Fourier range of two, at the weather group
        gen = torch.Generator(device="cpu").manual_seed(MESH_VEC_SEED)

        def crandn(*shape, dtype):
            return torch.randn(*shape, generator=gen, dtype=dtype).to(dev)

        cplx = {torch.float64: torch.complex128,
                torch.float32: torch.complex64}
        # timed once the ranks are done: the profiler takes the card's
        # counters for one process at a time
        timings = []
        k10 = {}
        gen32 = torch.Generator(device="cpu").manual_seed(MESH_VEC_SEED + 1)
        for dtype, gs in ((torch.float64, sw._kski().groups[0]),
                          (torch.float32, sw._kski32().groups[0])):
            D, F = gs.diag_That.shape
            R = gs.That_rep.shape[0]
            vf = crandn(MESH_VECS, D, F, dtype=cplx[dtype])
            full = fourier.fourier_contract("slfm", vf, gs.A, gs.That_rep,
                                            gs.diag_That)
            for r in range(2):
                f0, f1 = shard_range(F, 2, r)
                cut = ("slfm", vf, gs.A, gs.That_rep[:, f0:f1].contiguous(),
                       gs.diag_That[:, f0:f1].contiguous())
                got = fourier.fourier_contract(*cut, f0=f0)
                require(torch.equal(got, full[..., f0:f1]),
                        "K10 on the range [%d, %d) is not the full range's "
                        "slice to the bit" % (f0, f1))
                with generic_kernels():
                    require(torch.equal(
                        fourier.fourier_contract(*cut, f0=f0), got),
                        "K10's generic kernel on a range differs in bits")
            k10[str(dtype)] = hashlib.sha256(
                full.cpu().numpy().tobytes()).hexdigest()
            want = fourier.fourier_contract_plain(*cut, f0=f0)
            nf = f1 - f0
            timings.append((
                ("fourier_contract (range)", dtype, "cuda",
                 "runlmc_tpu_torch/hopper/csrc/fourier.cu",
                 "runlmc_tpu/lmc/grid.py:398", torch.view_as_real(got),
                 torch.view_as_real(want),
                 1e-12 if dtype == torch.float64 else 1e-5,
                 lambda cut=cut, f0=f0: fourier.fourier_contract(*cut, f0=f0),
                 lambda cut=cut, f0=f0: fourier.fourier_contract_plain(
                     *cut, f0=f0),
                 nbytes(vf[..., f0:f1], got, gs.A, cut[3], cut[4]),
                 (8.0 * D * R + 6.0 * R + 8.0 * D) * MESH_VECS * nf),
                {"path": MESH_GRID_PATH,
                 "extra": {"counter": "fourier_contract", "range": [f0, nf],
                           "F": F, "instance": fourier.fourier_instance(
                               "slfm", D, R)}}))
            # the backward on both ranges (rank 1's first: its inputs are
            # drawn as before); float32's (no path runs it) from a
            # generator of its own, so that float64's inputs stay the same
            for r in (1, 0):
                f0, f1 = shard_range(F, 2, r)
                nf = f1 - f0
                G = (crandn(MESH_VECS, D, nf, dtype=cplx[dtype])
                     if dtype == torch.float64 else
                     torch.randn(MESH_VECS, D, nf, generator=gen32,
                                 dtype=cplx[dtype]).to(dev))
                Gfull = torch.zeros_like(vf)
                Gfull[..., f0:f1] = G
                H = fourier.fourier_contract_bwd(G, vf, f0=f0)
                require(torch.equal(
                    H, fourier.fourier_contract_bwd(Gfull, vf)[..., f0:f1]),
                    "K10's backward on a range is not the full range's "
                    "slice to the bit")
                require(torch.equal(H, fourier.fourier_contract_bwd(
                    G, vf, f0=f0)), "K10's backward on a range: a relaunch "
                    "is not bit-identical")
                vr = vf[..., f0:f1]
                timings.append((
                    ("fourier_contract_bwd (range)", dtype, "cuda",
                     "runlmc_tpu_torch/hopper/csrc/fourier.cu",
                     "runlmc_tpu/lmc/grid.py:398", torch.view_as_real(H),
                     torch.view_as_real(
                         fourier.fourier_contract_bwd_plain(G, vf, f0)),
                     1e-12 if dtype == torch.float64 else 1e-5,
                     lambda G=G, vf=vf, f0=f0: fourier.fourier_contract_bwd(
                         G, vf, f0=f0),
                     lambda G=G, vf=vf, f0=f0:
                         fourier.fourier_contract_bwd_plain(G, vf, f0),
                     nbytes(G, vr, H), 8.0 * MESH_VECS * D * D * nf),
                    {"library_fn": lambda G=G, vr=vr: torch.matmul(
                        G.permute(2, 1, 0), vr.conj().permute(2, 0, 1)),
                     "path": (MESH_GRID_PATH if dtype == torch.float64
                              else OFF_PATH),
                     "extra": {"counter": "fourier_contract_bwd",
                               "range": [f0, nf], "F": F}}))
        del sw, sf
        mesh_wait(procs, start, tmp)
    finally:
        mesh_kill(procs)
    wall_s = time.time() - start
    for args, kwargs in timings:
        record(*args, **kwargs)
    del timings
    # every rank against the references
    runs = {}
    for cfg, r, _, _ in procs:
        with open(os.path.join(tmp, "%s.rank%d.json" % (cfg, r))) as f:
            res = json.load(f)
        res.update(dict(np.load(os.path.join(tmp, "%s.rank%d.npz"
                                             % (cfg, r)))))
        runs.setdefault(cfg, []).append(res)
    summary = {"card": card, "wall_s": wall_s, "reference_s": ref_s,
               "not_run": skipped, "k10_full_sha256": k10, "configs": {}}
    for cfg, ranks in runs.items():
        _, backend, which, layout = MESH_CONFIGS[cfg]
        want = ref[which]
        rtol = MESH_STOCH_RTOL if which == "weather" else MESH_EXACT_RTOL
        path = (hopper.STOCHASTIC_PATH if which == "weather"
                else hopper.TRAIN_PATH)
        out = []
        for res in ranks:
            err = float(np.max(np.abs(res["grad"] - want))
                        / np.max(np.abs(want)))
            print("mesh %-12s rank %d/%d (%s, %s, %s): rows %s, local loop "
                  "iterations %s, init %.2f s, build %.2f s, first gradient "
                  "%.3f s warm, %d steps %.3f s, collectives %.1f us device "
                  "in %d calls, gradient rel err %.3e (tol %.0e), residual "
                  "%.3e"
                  % (cfg, res["rank"], res["world"], backend, res["device"],
                     layout, res["rows"], res.get("loop_iterations", "-"),
                     res["init_s"], res["build_s"], res["grad_s"],
                     res["n_iter"], res["steps_s"],
                     res["collective_device_us"], res["collective_calls"],
                     err, rtol, res["solve_error"]), flush=True)
            require(err <= rtol, "mesh %s rank %d: the first-step gradient "
                    "disagrees with the single process" % (cfg, res["rank"]))
            missing = [k for k in path if res["launches"][k] == 0]
            require(not missing, "mesh %s rank %d never launched %s"
                    % (cfg, res["rank"], missing))
            if which == "fx2007":
                require(res["solve_error"] < EXACT_RESIDUAL_THRESHOLD,
                        "mesh %s: certified residual %.3e" % (
                            cfg, res["solve_error"]))
            if layout == "grid":
                require(np.array_equal(res["matvec"], ref["matvec"]),
                        "mesh %s rank %d: grid_matvec differs in bits from "
                        "the single process" % (cfg, res["rank"]))
                for k in ("fourier_contract/f64", "fourier_contract/f32",
                          "fourier_contract_bwd/f64"):
                    require(res["launches"][k] > 0, "mesh %s rank %d: no "
                            "%s launch on its range" % (cfg, res["rank"], k))
                print("mesh %s rank %d: K10 backward %.2f us device in %.0f "
                      "call(s) a step, by part %s" % (
                          cfg, res["rank"], res["k10_bwd"]["device_us"],
                          res["k10_bwd"]["calls"],
                          json.dumps(res["k10_bwd"]["parts_us"])),
                      flush=True)
            require(res["n_iter"] == MESH_STEPS, "mesh %s: %d steps"
                    % (cfg, res["n_iter"]))
            out.append({k: v for k, v in res.items()
                        if not isinstance(v, np.ndarray)}
                       | {"grad_rel_err": err})
        same = all(np.array_equal(r["params"], ranks[0]["params"])
                   for r in ranks)
        print("mesh %s: after %d steps the %d ranks' parameters are %s "
              "(sha256 %s)" % (cfg, MESH_STEPS, len(ranks),
                               "bitwise equal" if same else "DIFFERENT",
                               ranks[0]["params_sha256"][:16]), flush=True)
        require(same, "mesh %s: the ranks' parameters differ" % cfg)
        summary["configs"][cfg] = out
    grid0 = [r for r in runs["grid"] if r["rank"] == 0][0]
    path_launches[MESH_GRID_PATH] = grid0["launches"]
    print("mesh: grid_matvec of the grid layout sha256 %s, the single "
          "process's %s" % (grid0["matvec_sha256"][:16], hashlib.sha256(
              ref["matvec"].tobytes()).hexdigest()[:16]), flush=True)
    for c in skipped:
        print("mesh %s: not run (%d card(s); it takes a card a rank)"
              % (c, torch.cuda.device_count()), flush=True)
    print("mesh: phase wall %.1f s (references %.1f s), on %s; the walls "
          "of ranks that share one card measure contention, not scaling"
          % (wall_s, ref_s, card), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return summary


def main():
    # cuBLAS reads its workspace setting when CUDA starts: phase 7's
    # deterministic reruns need it (torch.use_deterministic_algorithms)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import runlmc_tpu_torch as T
    from runlmc_tpu_torch import config, hopper
    from runlmc_tpu_torch.datasets import (
        fx2007_synthetic,
        synth_synthetic,
        weather_synthetic,
    )
    from runlmc_tpu_torch.hopper import (
        build,
        capacitance as cap,
        cg,
        chol_jitter,
        chol_vjp as cv,
        cross,
        interp,
        kern_rows_fft as k8f,
        kuu,
        lanczos,
        potrf,
        trsm,
    )
    from runlmc_tpu_torch.kernels.stationary import eval_table
    from runlmc_tpu_torch.lmc import grid as tgrid
    from runlmc_tpu_torch.lmc import woodbury as wbm
    from runlmc_tpu_torch.lmc.woodbury import woodbury_pcg
    from runlmc_tpu_torch.models.interpolated_llgp import (
        EXACT_RESIDUAL_THRESHOLD,
        KRYLOV_CYCLE,
        RUNG_MAXITER,
    )
    from runlmc_tpu_torch.ops import slq
    from runlmc_tpu_torch.ops.solvers import batched_minres
    from runlmc_tpu_torch.ops.bttb import bttb_index_map
    from runlmc_tpu_torch.utils.carry import (
        cast_params,
        from_reference_params,
        unravel_params,
    )
    from runlmc_tpu_torch.utils.evaluation import nlpd, smse

    phase_s = {}
    mark = [time.time()]

    def phase_done(name):
        """Print and keep the seconds since the previous phase ended."""
        now = time.time()
        phase_s[name] = now - mark[0]
        mark[0] = now
        print("phase %s: %.2f s" % (name, phase_s[name]), flush=True)

    # ------------------------------------------------------------ phase 1
    card = card_line()
    print("card:", card, flush=True)
    require(config.tf32_disabled(), "TF32 is on")
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0), flush=True)

    # ------------------------------------------------------------ phase 2
    t0 = time.time()
    built = build.build_all()
    print("build: %d CUDA sources (%s) in %.2f s"
          % (len(built), ", ".join(built), time.time() - t0), flush=True)
    phase_done("1-2 card and build")

    # ------------------------------------------------------------ phase 3
    dev = torch.device("cuda")
    xss, yss, txs, tys = fx2007_synthetic(SEED)
    spec = T.LMCKernelSpec.create(
        D=len(xss), lmc_kernels=[T.RBF(name="rbf0")], lmc_ranks=[2]
    )
    t0 = time.time()
    model = T.InterpolatedLLGP(xss, yss, functional_kernel=spec, m=[234],
                               tolerance=TOLERANCE, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print("model: n=%d, grid %s, Dm=%d, objective %s, built in %.2f s"
          % (len(model.data.y), model.grid_data[0].plan.sizes,
             model.grid_data[0].interp.ncols, model.objective,
             time.time() - t0), flush=True)
    spec = model.spec  # with its input dim resolved
    # initial parameters plus a fixed deterministic perturbation
    params = model.param_array
    params = params + 0.1 * np.sin(np.arange(len(params)))
    model.param_array = params

    rows = []

    def record(name, dtype, route, source, replaces, got, want, tol, fn,
               plain_fn, moved, flops, library_fn=None, path=None,
               plain_reps=20, extra=None, product=False):
        torch.cuda.synchronize()
        abs_err, rel_err = errors(got, want)
        ms = cuda_time(fn)
        plain_ms = cuda_time(plain_fn, reps=plain_reps,
                             warm=min(3, plain_reps))
        device_ms = device_profile(fn, reps=10)[0]
        plain_device_ms = device_profile(plain_fn,
                                         reps=min(10, plain_reps))[0]
        library_ms = cuda_time(library_fn) if library_fn else None
        library_device_ms = (device_profile(library_fn, reps=10)[0]
                             if library_fn else None)
        bms, by = bound_ms(moved, flops, dtype, product)
        row = {
            "name": name, "dtype": str(dtype).replace("torch.", ""),
            "route": route, "source": source, "replaces": replaces,
            "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms,
            "library_device_ms": library_device_ms,
            "bound_ms": bms, "bound_by": by,
        }
        if path is not None:
            row["path"] = path  # the path whose launches the row reports
        row.update(extra or {})
        print("kernel %-15s %-7s rel err %.3e (tol %.0e)  %.4f ms (device "
              "%s)  plain %.4f ms (device %s)  library %s (device %s)  "
              "bound %.4f ms (%s)"
              % (name, row["dtype"], rel_err, tol, ms, _ms(device_ms),
                 plain_ms, _ms(plain_device_ms), _ms(library_ms),
                 _ms(library_device_ms), bms, by), flush=True)
        require(rel_err <= tol, "%s %s disagrees with its plain version"
                % (name, row["dtype"]))
        rows.append(row)

    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=gen, dtype=dtype).to(dev)

    # K7: K_*X of the prediction path (f64), then a mixed table of all
    # five kernel kinds on a 2-D input
    from runlmc_tpu_torch.lmc import likelihood as lk

    td = lk.flatten_data(txs, [np.zeros(len(x)) for x in txs])
    xa = torch.as_tensor(td.X, dtype=torch.float64, device=dev)
    oa = torch.as_tensor(td.output_idx, device=dev)
    Bq = spec.coreg_mats(model.params)
    table = spec.kernel_table(model.params)
    args = (xa, oa, model.X, model.oidx, Bq) + table

    def k7_bound(args, out):
        """(bytes, operations) of K7's forward: every input read once, K
        written once; per element and kernel (per unordered pair on the
        pair path: k~ is symmetric), 3 operations per active input dim
        for the distance and about 12 for k~ and the sum."""
        pair = cross._pair_plan(*args[:4], args[4].shape[1]) is not None
        elems = (out.shape[0] * (out.shape[0] + 1) / 2.0 if pair
                 else float(out.numel()))
        return nbytes(out, *args), elems * sum(
            3.0 * bin(int(mk)).count("1") + 12.0
            for mk in args[6].tolist())

    out = cross.cross_kernel(*args)
    record("cross_kernel", torch.float64, "cuda",
           "runlmc_tpu_torch/hopper/csrc/cross_kernel.cu",
           "runlmc_tpu/lmc/likelihood.py:85", out,
           cross.cross_kernel_plain(*args), 1e-12,
           lambda: cross.cross_kernel(*args),
           lambda: cross.cross_kernel_plain(*args), *k7_bound(args, out))

    mixed = T.LMCKernelSpec.create(
        D=3,
        lmc_kernels=[T.RBF(name="r", active_dims=(0,)),
                     T.Matern32(name="m", active_dims=(1,))],
        lmc_ranks=[1, 2],
        slfm_kernels=[T.StdPeriodic(name="p", period=2.0)],
        indep_gp=[T.IdentityKern(),
                  T.Scaled(inner=T.RBF(name="s"), scale=1.5),
                  T.Scaled(inner=T.Matern32(name="f"),
                           trainable_scale=False, scale=0.7)],
        indep_gp_index=[0, 1, 2],
    ).with_input_dim(2)
    mp = from_reference_params(mixed.init_raw_params(seed=SEED + 1),
                               torch.float64, dev)
    xa2 = randn(150, 2)
    xb2 = torch.cat([xa2[:50], randn(350, 2)])
    oa2 = torch.randint(0, 3, (150,), generator=gen,
                        dtype=torch.int32).to(dev)
    ob2 = torch.cat([oa2[:50], torch.randint(0, 3, (350,), generator=gen,
                                             dtype=torch.int32).to(dev)])
    margs = (xa2, oa2, xb2, ob2, mixed.coreg_mats(mp)) + \
        mixed.kernel_table(mp)
    out = cross.cross_kernel(*margs)
    want = cross.cross_kernel_plain(*margs)
    abs_err, rel_err = errors(out, want)
    print("kernel cross_kernel mixed table (5 kinds, P=2): rel err %.3e"
          % rel_err, flush=True)
    require(rel_err <= 1e-12, "cross_kernel mixed table disagrees")

    # K7 at (n, n): the dense exact kernel of the fx2007 report path, in
    # float64 and (the float32 ExactLMC's) float32, on the pair path (the
    # model's one point set, sorted by output); that path against the
    # general path (the same inputs as two point sets: X.clone()) to the
    # bit, and relaunched to the bit
    k7_pair_checks = []
    n_k7 = model.X.shape[0]
    for dtype in (torch.float64, torch.float32):
        xk = model.X.to(dtype)
        sargs = (xk, model.oidx, xk, model.oidx, Bq.to(dtype), table[0],
                 table[1], table[2].to(dtype))
        require(cross._pair_plan(*sargs[:4], Bq.shape[1]) is not None,
                "the fx2007 model's points do not take K7's pair path")
        out = cross.cross_kernel(*sargs)
        general = cross.cross_kernel(xk, model.oidx, xk.clone(),
                                     model.oidx.clone(), *sargs[4:])
        chk = {"dtype": str(dtype).replace("torch.", ""), "n": n_k7,
               "pair_equals_general": bool(torch.equal(out, general)),
               "relaunch_bit_identical": bool(torch.equal(
                   out, cross.cross_kernel(*sargs)))}
        k7_pair_checks.append(chk)
        print("K7 fx2007 (n=%d) %s: pair path equals the general path to "
              "the bit %s, relaunch bit-identical %s"
              % (n_k7, chk["dtype"], chk["pair_equals_general"],
                 chk["relaunch_bit_identical"]), flush=True)
        require(chk["pair_equals_general"] and chk["relaunch_bit_identical"],
                "K7's pair path is not its general path's bits")
        del general
        record("cross_kernel", dtype, "cuda",
               "runlmc_tpu_torch/hopper/csrc/cross_kernel.cu",
               "runlmc_tpu/lmc/likelihood.py:85", out,
               cross.cross_kernel_plain(*sargs),
               1e-12 if dtype == torch.float64 else 1e-5,
               lambda: cross.cross_kernel(*sargs),
               lambda: cross.cross_kernel_plain(*sargs),
               *k7_bound(sargs, out),
               path=("report (fx2007)" if dtype == torch.float64
                     else "float32 report"))
        del out

    # K7 backward: the cotangents of B and [gamma, period, scale] from a
    # seeded (n, n) cotangent at the fx2007 shape (Q=1, D=13), float64
    # (the exact oracle) and float32 (a float32 model's), one point set as
    # the paths pass it (the pair path); then the mixed six-kernel table
    # above (two point sets, unsorted outputs: the general path), both
    # dtypes
    def k7_bwd_bound(args):
        """(bytes, operations) of K7's backward: every input read once,
        dB and dprm written once; per element and kernel (per unordered
        pair where the two point sets are one: k~ is symmetric), 3
        operations per active input dim for the distance and about 18
        for k~, its two derivatives and the three accumulations."""
        B_, masks_, prm_, G_ = args[4], args[6], args[7], args[8]
        na_ = G_.shape[0]
        elems = (na_ * (na_ + 1) / 2.0 if args[0] is args[2]
                 and args[1] is args[3] else float(G_.numel()))
        flops_ = elems * sum(3.0 * bin(int(mk)).count("1") + 18.0
                             for mk in masks_.tolist())
        return nbytes(*args) + nbytes(B_, prm_), flops_

    n_fx = model.X.shape[0]
    for dtype in (torch.float64, torch.float32):
        xd = model.X.to(dtype)
        bargs = (xd, model.oidx, xd, model.oidx) + tuple(
            t.to(dtype) if t.is_floating_point() else t
            for t in sargs[4:]) + (randn(n_fx, n_fx, dtype=dtype),)
        got = cross.cross_kernel_bwd(*bargs)
        want = cross.cross_kernel_bwd_plain(*bargs)
        again = cross.cross_kernel_bwd(*bargs)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                "cross_kernel_bwd is not deterministic")
        moved, flops = k7_bwd_bound(bargs)
        record("cross_kernel_bwd", dtype, "cuda",
               "runlmc_tpu_torch/hopper/csrc/cross_kernel_bwd.cu",
               "runlmc_tpu/lmc/likelihood.py:85", got, want,
               1e-12 if dtype == torch.float64 else 1e-5,
               lambda bargs=bargs: cross.cross_kernel_bwd(*bargs),
               lambda bargs=bargs: cross.cross_kernel_bwd_plain(*bargs),
               moved, flops,
               path=("report (fx2007)" if dtype == torch.float64
                     else "float32 report"))
        margs_d = tuple(t.to(dtype) if t.is_floating_point() else t
                        for t in margs) + (randn(150, 400, dtype=dtype),)
        got_m = cross.cross_kernel_bwd(*margs_d)
        err = errors(got_m, cross.cross_kernel_bwd_plain(*margs_d))[1]
        same_m = all(torch.equal(a, b) for a, b in
                     zip(got_m, cross.cross_kernel_bwd(*margs_d)))
        print("kernel cross_kernel_bwd mixed table (6 kernels, 5 kinds, "
              "P=2, two point sets, unsorted outputs) %s: rel err %.3e, "
              "relaunch bit-identical %s"
              % (str(dtype).replace("torch.", ""), err, same_m), flush=True)
        require(err <= (1e-12 if dtype == torch.float64 else 1e-5),
                "cross_kernel_bwd mixed table disagrees")
        require(same_m, "cross_kernel_bwd mixed table relaunch differs")
        del bargs, got, want, again

    # K9 at the shapes of the predictive mean: W^T alpha for the training
    # interpolant on one (3113,) vector, then W_* u for the 150-row test
    # interpolant on one (3094,) vector
    W = model.grid_data[0].interp
    x = randn(W.shape[0])
    csr = (W.t_ptr, W.t_rows, W.t_weights)
    out = interp.interp_scatter(*csr, x)
    flat_idx = W.indices.reshape(-1).long()
    vals = (x[:, None] * W.weights).reshape(-1)
    lib_out = torch.zeros(W.ncols, dtype=x.dtype, device=dev)
    record("interp_scatter", torch.float64, "cuda",
           "runlmc_tpu_torch/hopper/csrc/interp.cu",
           "runlmc_tpu/ops/interpolation.py:229", out,
           interp.interp_scatter_plain(*csr, x), 1e-12,
           lambda: interp.interp_scatter(*csr, x),
           lambda: interp.interp_scatter_plain(*csr, x),
           nbytes(out, x, *csr), 2.0 * W.t_rows.numel(),
           library_fn=lambda: lib_out.zero_().index_add_(0, flat_idx, vals))
    Wt = model._test_interps(model._pad_dims(txs))[0]
    v = randn(Wt.ncols)
    out = interp.interp_gather(Wt.indices, Wt.weights, v)
    idx_l = Wt.indices.long()
    v_col = v[:, None]
    record("interp_gather", torch.float64, "cuda",
           "runlmc_tpu_torch/hopper/csrc/interp.cu",
           "runlmc_tpu/ops/interpolation.py:219", out,
           interp.interp_gather_plain(Wt.indices, Wt.weights, v), 1e-12,
           lambda: interp.interp_gather(Wt.indices, Wt.weights, v),
           lambda: interp.interp_gather_plain(Wt.indices, Wt.weights, v),
           nbytes(out, v, Wt.indices, Wt.weights),
           2.0 * Wt.indices.numel(),
           library_fn=lambda: torch.nn.functional.embedding_bag(
               idx_l, v_col, per_sample_weights=Wt.weights, mode="sum"))

    # K6: the two CG passes on a (151, 3113) state, f32 (inner cycles)
    # and f64 (escalation rung)
    nb = 151
    n = len(model.data.y)
    for dtype in (torch.float32, torch.float64):
        p = randn(nb, n, dtype=dtype)
        Ap = p * (1.0 + torch.rand(nb, n, generator=gen).to(dev, dtype)) \
            + 0.01 * randn(nb, n, dtype=dtype)
        x0, r0 = randn(nb, n, dtype=dtype), randn(nb, n, dtype=dtype)
        rz0 = torch.rand(nb, generator=gen).to(dev, dtype) + 0.5
        act0 = (torch.rand(nb, generator=gen) < 0.8).to(dev, torch.int32)
        tol = torch.full((1,), 1e-3, dtype=dtype, device=dev)

        def state():
            return ([t.clone() for t in (x0, r0, rz0)], act0.clone(),
                    torch.zeros(nb, dtype=torch.int32, device=dev))

        (xk, rk, rzk), actk, itk = state()
        (xp, rp, rzp), actp, itp = state()
        pAp_k, rn_k = cg.cg_update_xr(p, Ap, xk, rk, rzk, actk)
        pAp_p, rn_p = cg.cg_update_xr_plain(p, Ap, xp, rp, rzp, actp)
        ftol = 1e-12 if dtype == torch.float64 else 1e-5
        (xs, rs, rzs), acts, _ = state()
        record("cg_update_xr", dtype, "triton",
               "runlmc_tpu_torch/hopper/triton_cg.py",
               "runlmc_tpu/ops/solvers.py:176", (xk, rk, pAp_k, rn_k),
               (xp, rp, pAp_p, rn_p), ftol,
               lambda: cg.cg_update_xr(p, Ap, xs, rs, rzs, acts),
               lambda: cg.cg_update_xr_plain(p, Ap, xs, rs, rzs, acts),
               nbytes(p, Ap, x0, r0) + nbytes(x0, r0),
               6.0 * p.numel())
        z = randn(nb, n, dtype=dtype)
        pk, pp = p.clone(), p.clone()
        cg.cg_update_p(rk, z, pk, rzk, actk, itk, pAp_k, rn_k, tol)
        cg.cg_update_p_plain(rp, z, pp, rzp, actp, itp, pAp_p, rn_p, tol)
        torch.cuda.synchronize()
        require(torch.equal(actk, actp) and torch.equal(itk, itp),
                "cg_update_p masks disagree")
        ps = p.clone()
        (_, _, rzs), acts, its = state()
        record("cg_update_p", dtype, "triton",
               "runlmc_tpu_torch/hopper/triton_cg.py",
               "runlmc_tpu/ops/solvers.py:183", (pk, rzk), (pp, rzp), ftol,
               lambda: cg.cg_update_p(rk, z, ps, rzs, acts, its, pAp_k,
                                      rn_k, tol),
               lambda: cg.cg_update_p_plain(rk, z, ps, rzs, acts, its,
                                            pAp_k, rn_k, tol),
               nbytes(rk, z, p) + nbytes(p), 4.0 * p.numel())

    # the fft-mode model of slice 3: weather-shaped, m=2500 (fft grid of
    # 2504 points, Dm=10016 past DENSE_MAX_GRID), stochastic objective
    wx, wy, wtx, wty, _ = weather_synthetic(SEED)
    wspec = weather_spec(T, len(wx))
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.time()
    wm = T.InterpolatedLLGP(wx, wy, functional_kernel=wspec, m=WEATHER_M,
                            objective="stochastic", seed=SEED, device=dev)
    torch.cuda.synchronize()
    wbuild_s = time.time() - t0
    wmem_mb = (torch.cuda.memory_allocated() - mem0) / 1e6
    wgroups = [{"mode": g.plan.mode, "rep": g.plan.rep,
                "sizes": list(g.plan.sizes), "Dm": g.interp.ncols,
                "W_blocks": g.W_blocks is not None}
               for g in wm.grid_data]
    wtwin = [list(g.plan.sizes) for g in wm.precond_data32]
    print("weather model: n=%d, groups %s, preconditioner twin sizes %s, "
          "objective %s, built in %.2f s, grid artifacts %.1f MB on the card"
          % (len(wm.data.y), json.dumps(wgroups), wtwin, wm.objective,
             wbuild_s, wmem_mb), flush=True)
    require(all(g["mode"] == "fft" and g["rep"] == "slfm" for g in wgroups),
            "the weather model's grid is not an fft 'slfm' group")
    require(wm.objective == "stochastic", "weather objective")

    # K10 at the weather shapes: the model's own 'slfm' symbols (float64
    # operator and float32 inner twin) on 16 seeded operand spectra
    from runlmc_tpu_torch.hopper import fourier, minres

    wgs = {torch.float64: wm._kski().groups[0],
           torch.float32: wm._kski32().groups[0]}
    nrhs = wm.n_probes + 1
    cplx = {torch.float64: torch.complex128, torch.float32: torch.complex64}
    for dtype in (torch.float64, torch.float32):
        gs = wgs[dtype]
        Dw, Fw = gs.diag_That.shape
        R = gs.That_rep.shape[0]
        vf = randn(nrhs, Dw, Fw, dtype=cplx[dtype])
        kargs = ("slfm", vf, gs.A, gs.That_rep, gs.diag_That)
        out = fourier.fourier_contract(*kargs)
        again = fourier.fourier_contract(*kargs)
        torch.cuda.synchronize()
        require(torch.equal(out, again), "fourier_contract is not "
                "deterministic at the weather shape")
        with generic_kernels():
            require(torch.equal(out, fourier.fourier_contract(*kargs)),
                    "fourier_contract's instance and its generic kernel "
                    "differ in bits at the weather shape")
        want = fourier.fourier_contract_plain(*kargs)
        record("fourier_contract", dtype, "cuda",
               "runlmc_tpu_torch/hopper/csrc/fourier.cu",
               "runlmc_tpu/lmc/grid.py:398", torch.view_as_real(out),
               torch.view_as_real(want),
               1e-12 if dtype == torch.float64 else 1e-5,
               lambda kargs=kargs: fourier.fourier_contract(*kargs),
               lambda kargs=kargs: fourier.fourier_contract_plain(*kargs),
               nbytes(vf, out, gs.A, gs.That_rep, gs.diag_That),
               (8.0 * Dw * R + 6.0 * R + 8.0 * Dw) * nrhs * Fw,
               extra={"instance": fourier.fourier_instance("slfm", Dw, R)})
    # 'sum' and 'bt' at a small shape, both dtypes
    for dtype in (torch.float64, torch.float32):
        vs = randn(5, 3, 257, dtype=cplx[dtype])
        for rep, rargs in (
                ("sum", (randn(2, 3, 3, dtype=dtype),
                         randn(2, 257, dtype=cplx[dtype]), None)),
                ("bt", (None, randn(3, 3, 257, dtype=cplx[dtype]), None))):
            err = errors(torch.view_as_real(
                fourier.fourier_contract(rep, vs, *rargs)),
                torch.view_as_real(
                    fourier.fourier_contract_plain(rep, vs, *rargs)))[1]
            print("kernel fourier_contract %s %s (5, 3, 257): rel err %.3e"
                  % (rep, str(dtype).replace("torch.", ""), err), flush=True)
            require(err <= (1e-12 if dtype == torch.float64 else 1e-5),
                    "fourier_contract %s disagrees" % rep)
    # K10 backward at float64: the surrogate's gradient; the library
    # route is one batched complex GEMM over the frequencies. Float32
    # (no path runs it) on inputs of a generator of its own, relaunched
    # bit-identical like float64
    gen32 = torch.Generator(device="cpu").manual_seed(SEED + 10)
    for dtype in (torch.float64, torch.float32):
        gs = wgs[dtype]
        Dw, Fw = gs.diag_That.shape
        if dtype == torch.float64:
            vf = randn(nrhs, Dw, Fw, dtype=torch.complex128)
            Gc = randn(nrhs, Dw, Fw, dtype=torch.complex128)
        else:
            vf, Gc = (torch.randn(nrhs, Dw, Fw, generator=gen32,
                                  dtype=torch.complex64).to(dev)
                      for _ in range(2))
        got = fourier.fourier_contract_bwd(Gc, vf)
        require(torch.equal(got, fourier.fourier_contract_bwd(Gc, vf)),
                "fourier_contract_bwd %s relaunch is not bit-identical"
                % dtype)
        want = fourier.fourier_contract_bwd_plain(Gc, vf)
        Gp, vp = Gc.permute(2, 1, 0), vf.conj().permute(2, 0, 1)
        tol = 1e-12 if dtype == torch.float64 else 1e-5

        def library_bwd(Gp=Gp, vp=vp):
            return torch.matmul(Gp, vp)

        require(errors(torch.view_as_real(library_bwd().permute(1, 2, 0)),
                       torch.view_as_real(want))[1] <= tol,
                "the batched-GEMM route disagrees with the plain K10 "
                "backward")
        record("fourier_contract_bwd", dtype, "cuda",
               "runlmc_tpu_torch/hopper/csrc/fourier.cu",
               "runlmc_tpu/lmc/grid.py:398", torch.view_as_real(got),
               torch.view_as_real(want), tol,
               lambda Gc=Gc, vf=vf: fourier.fourier_contract_bwd(Gc, vf),
               lambda Gc=Gc, vf=vf: fourier.fourier_contract_bwd_plain(
                   Gc, vf),
               nbytes(Gc, vf, got), 8.0 * nrhs * Dw * Dw * Fw,
               library_fn=library_bwd,
               path=None if dtype == torch.float64 else OFF_PATH,
               extra={"tile_chunk": list(fourier.bwd_tile(
                   nrhs, Dw, Fw, Gc.dtype,
                   sms=build.sm_count(Gc.get_device())))})
    del vf, Gc, got, want, Gp, vp

    # K8 on the fft group's first rows at the weather shape (Q=6 kernels,
    # m=2504 grid points embedded in 8192): the float64 operator's and
    # the float32 inner twin's embedding (each stochastic step builds
    # both) and the float64 backward (the surrogate's gradient) on a
    # seeded cotangent, against their plain versions (k(r) by torch ops,
    # the flips and concats; autograd through them), each relaunched
    # bit-identical. No PyTorch call evaluates a kernel table into a
    # circulant embedding: no library column.
    wgd = wm.grid_data[0]
    wkidx, wsizes = wgd.plan.kidxs, wgd.plan.sizes
    k8_checks = []
    for dtype, dists_ in ((torch.float64, wgd.dists),
                          (torch.float32, wm.inner_data32[0].dists)):
        kinds_, prm_ = wm.spec.table_rows(cast_params(wm.params, dtype),
                                          wkidx)
        prm_ = prm_.detach()
        E_ = k8f.kern_rows_fft(kinds_, prm_, dists_, wsizes)
        Ep = k8f.kern_rows_fft_plain(kinds_, prm_, dists_, wsizes)
        same = torch.equal(E_, k8f.kern_rows_fft(kinds_, prm_, dists_,
                                                 wsizes))
        tol = 1e-12 if dtype == torch.float64 else 1e-6
        Q_, m_ = len(kinds_), dists_.numel()
        esz = E_.element_size()
        chk = {"dtype": str(dtype).replace("torch.", ""), "Q": Q_, "m": m_,
               "shape": list(E_.shape), "rel_err": errors(E_, Ep)[1],
               "bit_identical": bool(same)}
        require(same, "kern_rows_fft relaunch is not bit-identical")
        record("kern_rows_fft", dtype, "cuda",
               "runlmc_tpu_torch/hopper/csrc/kern_rows_fft.cu",
               "runlmc_tpu/lmc/grid.py:535", E_, Ep, tol,
               lambda k=kinds_, p_=prm_, d_=dists_:
               k8f.kern_rows_fft(k, p_, d_, wsizes),
               lambda k=kinds_, p_=prm_, d_=dists_:
               k8f.kern_rows_fft_plain(k, p_, d_, wsizes),
               esz * (E_.numel() + m_ + 3 * Q_), K8_OPS * Q_ * m_,
               path="train (stochastic, fft)",
               extra={"site": "weather fft group, Q=%d, m=%d" % (Q_, m_)})
        if dtype == torch.float64:
            gk = torch.Generator(device=dev).manual_seed(SEED + 8)
            Gk = torch.randn(E_.shape, generator=gk, dtype=dtype,
                             device=dev)
            got = k8f.kern_rows_fft_bwd(kinds_, prm_, dists_, wsizes, Gk)
            want = k8f.kern_rows_fft_bwd_plain(kinds_, prm_, dists_, wsizes,
                                               Gk)
            same_b = torch.equal(got, k8f.kern_rows_fft_bwd(
                kinds_, prm_, dists_, wsizes, Gk))
            chk["bwd_rel_err"] = errors(got, want)[1]
            chk["bwd_bit_identical"] = bool(same_b)
            require(same_b, "kern_rows_fft_bwd relaunch is not "
                    "bit-identical")
            # the cluster kernel against the one-CTA kernel: the same bits
            chk["bwd_cluster"] = k8f.bwd_cluster(Q_, m_, dtype)
            saved = k8f.bwd_cluster
            try:
                k8f.bwd_cluster = lambda *args, **kwargs: 0
                one_cta = k8f.kern_rows_fft_bwd(kinds_, prm_, dists_, wsizes,
                                                Gk)
            finally:
                k8f.bwd_cluster = saved
            chk["bwd_equals_one_cta_kernel"] = bool(torch.equal(got,
                                                                one_cta))
            require(chk["bwd_equals_one_cta_kernel"], "kern_rows_fft_bwd's "
                    "cluster kernel does not give the one-CTA kernel's bits")
            images = 2 ** len(wsizes)
            record("kern_rows_fft_bwd", dtype, "cuda",
                   "runlmc_tpu_torch/hopper/csrc/kern_rows_fft.cu",
                   "runlmc_tpu/lmc/grid.py:535", got, want, tol,
                   lambda: k8f.kern_rows_fft_bwd(kinds_, prm_, dists_,
                                                 wsizes, Gk),
                   lambda: k8f.kern_rows_fft_bwd_plain(kinds_, prm_, dists_,
                                                       wsizes, Gk),
                   esz * (Gk.numel() + m_ + 6 * Q_),
                   (images + K8_OPS + 6.0) * Q_ * m_,
                   path="train (stochastic, fft)",
                   extra={"site": "weather fft group, Q=%d, m=%d"
                          % (Q_, m_)})
            del Gk, got, want
        k8_checks.append(chk)
        del E_, Ep

    # K12: one MINRES iteration's update of a (16, n) float64 state, as
    # on the plain-MINRES rung of the weather model's certified solve: a
    # relaunch from the same state gives the same bits and the inactive
    # rows (row 0 and a seeded fifth of the rest) keep theirs; timed on
    # the same state with every row active and tol 0, so that every row
    # moves its eleven arrays in each timed call
    wn = len(wm.data.y)
    mvecs = [randn(nrhs, wn) for _ in range(6)]
    mscal = [torch.rand(nrhs, generator=gen, dtype=torch.float64).to(dev)
             + 0.1 for _ in range(6)]
    mact = (torch.rand(nrhs, generator=gen) < 0.8).to(dev, torch.int32)
    mact[0] = 0
    mtol = torch.full((1,), 1e-8, dtype=torch.float64, device=dev)

    def mstate(act):
        return ([t.clone() for t in mvecs + mscal]
                + [act.clone(), torch.zeros_like(act)])

    mk, mk2, mp_ = mstate(mact), mstate(mact), mstate(mact)
    minres.minres_update(*mk, mtol)
    minres.minres_update(*mk2, mtol)
    minres.minres_update_plain(*mp_, mtol)
    torch.cuda.synchronize()
    require(torch.equal(mk[12], mp_[12]) and torch.equal(mk[13], mp_[13]),
            "minres_update masks disagree")
    require(all(torch.equal(a, b) for a, b in zip(mk, mk2)),
            "minres_update relaunch is not bit-identical")
    idle_rows = mact == 0
    require(all(torch.equal(a[idle_rows], b[idle_rows])
                for a, b in zip(mk[:12], mvecs + mscal)),
            "minres_update changed an inactive row")
    mtol0 = torch.zeros_like(mtol)
    mall = torch.ones_like(mact)
    ms_k, ms_p = mstate(mall), mstate(mall)
    record("minres_update", torch.float64, "cuda",
           "runlmc_tpu_torch/hopper/csrc/minres.cu",
           "runlmc_tpu/ops/solvers.py:103", mk[1:12], mp_[1:12], 1e-12,
           lambda: minres.minres_update(*ms_k, mtol0),
           lambda: minres.minres_update_plain(*ms_p, mtol0),
           11 * nbytes(mvecs[0]), 19.0 * mvecs[0].numel(),
           extra={"bit_identical_relaunch": True,
                  "inactive_rows_kept": True,
                  "cluster": lanczos.lanczos_cluster(nrhs, wn,
                                                     torch.float64)})
    require(bool(ms_k[12].all()), "a timed minres_update row stopped")
    del mvecs, mk, mk2, mp_, ms_k, ms_p, mall

    # K13: the Lanczos steps of an SLQ log-det on (15, n) rows, on a
    # diagonal operator; row 0 starts on an eigenvector and breaks down at
    # the first step. Each step is held against the plain step from the
    # same state. The shapes: the weather model's n in float64 (its
    # log_likelihood) and float32, and the reduced copy's n (phase 13's
    # every STOCH_SUBSAMPLE-th point, n < one block of a row) in float32
    # (the float32 report path) and float64 (the card-vs-CPU SLQ)
    nslq = max(wm.n_probes, 15)
    sn = sum(len(x[::STOCH_SUBSAMPLE]) for x in wx)
    for dtype, ln, path in ((torch.float64, wn, "slq (weather)"),
                            (torch.float32, wn, None),
                            (torch.float32, sn, "float32 report"),
                            (torch.float64, sn, None)):
        dg = (torch.rand(ln, generator=gen, dtype=dtype) + 0.5).to(dev)
        lv = torch.sign(randn(nslq, ln, dtype=dtype)) / float(np.sqrt(ln))
        lv[0] = 0.0
        lv[0, 11] = 1.0
        leps = torch.full((1,), lanczos.breakdown_eps(dtype), dtype=dtype,
                          device=dev)
        lvp = torch.zeros_like(lv)
        lbeta = torch.zeros(nslq, dtype=dtype, device=dev)
        lalive = torch.ones(nslq, dtype=torch.int32, device=dev)
        worst = 0.0
        for _ in range(8):
            lw = lv * dg
            want = lanczos.lanczos_step_plain(lw, lvp, lv, lbeta, lalive,
                                              leps)
            got = lanczos.lanczos_step(lw.clone(), lvp.clone(), lv.clone(),
                                       lbeta, lalive, leps)
            worst = max(worst, errors(got[:4], want[:4])[1])
            require(torch.equal(got[4], want[4]),
                    "lanczos_step breakdown masks disagree")
            lvp, lv, _, lbeta, lalive = want
        require(int(lalive[0]) == 0 and int(lalive.sum()) == nslq - 1,
                "the breakdown row did not break down alone")
        ltol = 1e-12 if dtype == torch.float64 else 1e-5
        print("kernel lanczos_step %s (%d, %d): 8 steps, rel err %.3e (tol "
              "%.0e), row 0 broke down" % (str(dtype).replace("torch.", ""),
                                           nslq, ln, worst, ltol),
              flush=True)
        require(worst <= ltol, "lanczos_step disagrees with its plain "
                "version at (%d, %d)" % (nslq, ln))
        if path is None:
            del dg, lv, lvp
            continue
        lw = lv * dg
        vps = lvp.clone()  # the kernel writes v' into v_prev's storage
        once = lanczos.lanczos_step(lw, lvp.clone(), lv, lbeta, lalive,
                                    leps)
        again = lanczos.lanczos_step(lw, lvp.clone(), lv, lbeta, lalive,
                                     leps)
        require(all(torch.equal(a, b) for a, b in zip(once, again)),
                "lanczos_step relaunch is not bit-identical at (%d, %d)"
                % (nslq, ln))
        record("lanczos_step", dtype, "cuda",
               "runlmc_tpu_torch/hopper/csrc/lanczos.cu",
               "runlmc_tpu/ops/slq.py:41", once[:4],
               lanczos.lanczos_step_plain(lw, lvp, lv, lbeta, lalive,
                                          leps)[:4],
               ltol,
               lambda lw=lw, vps=vps, lv=lv, lbeta=lbeta, lalive=lalive,
               leps=leps: lanczos.lanczos_step(lw, vps, lv, lbeta, lalive,
                                               leps),
               lambda lw=lw, lvp=lvp, lv=lv, lbeta=lbeta, lalive=lalive,
               leps=leps: lanczos.lanczos_step_plain(lw, lvp, lv, lbeta,
                                                     lalive, leps),
               4 * nbytes(lv) + 5 * nbytes(lbeta), 9.0 * lv.numel(),
               path=path)
        del dg, lv, lvp, lw, vps

    # K7 and its backward at the weather oracle's shape: the weather
    # model's own table (Q=6 kernels, D=4 outputs) over all its n points,
    # (n, n) in float64 with a seeded (n, n) cotangent, as
    # exact_log_likelihood_and_grad runs them (the backward: a warp per
    # (row, output) pair, 63k warps over column segments of about 3.9k).
    # The plain versions go WSLAB rows at a time: K's rows are
    # independent and the backward's cotangents are sums over rows.
    wspec_r = wm.spec
    wB = wspec_r.coreg_mats(wm.params)
    wargs = (wm.X, wm.oidx, wm.X, wm.oidx, wB) + \
        wspec_r.kernel_table(wm.params)
    wslabs = [slice(i, min(i + WSLAB, wn)) for i in range(0, wn, WSLAB)]

    def k7_plain_slabs(args=wargs):
        return torch.cat([cross.cross_kernel_plain(args[0][s], args[1][s],
                                                   *args[2:])
                          for s in wslabs])

    out = cross.cross_kernel(*wargs)
    record("cross_kernel", torch.float64, "cuda",
           "runlmc_tpu_torch/hopper/csrc/cross_kernel.cu",
           "runlmc_tpu/lmc/likelihood.py:85", out, k7_plain_slabs(), 1e-12,
           lambda: cross.cross_kernel(*wargs), k7_plain_slabs,
           *k7_bound(wargs, out), path="weather oracle",
           plain_reps=WPLAIN_REPS)
    del out
    gdev = torch.Generator(device=dev).manual_seed(SEED)
    wbargs = wargs + (torch.randn(wn, wn, generator=gdev,
                                  dtype=torch.float64, device=dev),)

    def k7_bwd_plain_slabs(args=wbargs):
        acc = None
        for s in wslabs:
            part = cross.cross_kernel_bwd_plain(args[0][s], args[1][s],
                                                *args[2:8], args[8][s])
            acc = part if acc is None else tuple(a + b for a, b in
                                                 zip(acc, part))
        return acc

    got = cross.cross_kernel_bwd(*wbargs)
    again = cross.cross_kernel_bwd(*wbargs)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            "cross_kernel_bwd is not deterministic at the weather shape")
    moved, flops = k7_bwd_bound(wbargs)
    record("cross_kernel_bwd", torch.float64, "cuda",
           "runlmc_tpu_torch/hopper/csrc/cross_kernel_bwd.cu",
           "runlmc_tpu/lmc/likelihood.py:85", got, k7_bwd_plain_slabs(),
           1e-12, lambda: cross.cross_kernel_bwd(*wbargs),
           k7_bwd_plain_slabs, moved, flops, path="weather oracle",
           plain_reps=WPLAIN_REPS)
    del wbargs, got, again, k7_bwd_plain_slabs  # the (n, n) cotangent

    # K5: the triangular solves with a Cholesky factor at the shapes of
    # its call sites. Each factor is held in both storage orders (the
    # kernel reads L row-major or column-major, as cuSOLVER leaves it);
    # trsm_lower, its transposed variant and cho_solve against their
    # plain versions (agreement relative to the largest magnitude) and
    # by their normwise backward error in float64; a second launch must
    # be bit-identical. The timed row is the op its call site runs.
    dm_fx = model.grid_data[0].interp.ncols
    wL32 = wm._woodbury32().L_C
    wm._cache.pop("woodbury32")
    k5_shapes = (
        # (what, dtype, k, c, op, path, factor)
        ("weather f32 preconditioner apply", torch.float32, wL32.shape[0],
         nrhs, "cho_solve", "train (stochastic, fft)", wL32),
        ("fx2007 exact step", torch.float32, dm_fx, 1, "cho_solve", "train",
         None),
        ("fx2007 exact step, model precision", torch.float64, dm_fx, 1,
         "cho_solve", "train (model precision)", None),
        ("fx2007 predict preconditioner apply", torch.float32, dm_fx,
         1 + sum(len(t) for t in txs), "cho_solve", "predict", None),
        ("fx2007 kinv_diag", torch.float32, dm_fx, n, "trsm_lower",
         "loo_zsq (float32)", None),
        ("weather oracle exact_mll", torch.float64, wn, 1, "cho_solve",
         "weather oracle", None),
    )
    k5_checks = []
    for what, dtype, kk, cc, op, path, Lf in k5_shapes:
        if Lf is None:
            Lf = k5_seeded_factor(kk, dtype, dev)
        Bk = randn(cc, kk, dtype=dtype)
        worst = {"agree": 0.0, "backward": 0.0}
        for Ls in (Lf, k5_other_storage(Lf)):
            for kop in ("trsm_lower", "trsm_lower_t", "cho_solve"):
                got = k5_apply(trsm, kop, Ls, Bk)
                again = k5_apply(trsm, kop, Ls, Bk)
                torch.cuda.synchronize()
                require(torch.equal(got, again), "%s is not deterministic "
                        "at %s" % (kop, what))
                agree = errors(got, k5_apply(trsm, kop, Ls, Bk, plain=True))[1]
                berr = k5_backward_error(Ls, Bk, got, kop)
                worst["agree"] = max(worst["agree"], agree)
                worst["backward"] = max(worst["backward"], berr)
                require(torch.equal(got, k5_per_block(trsm, kop, Ls, Bk)),
                        "%s at %s differs from the per-block kernel"
                        % (kop, what))
                del got, again
        # the kernel's block order in plain PyTorch, on the timed op
        worst["schedule"] = errors(k5_apply(trsm, op, Lf, Bk),
                                   k5_schedule(trsm, op, Lf, Bk))[1]
        atol_, btol_ = ((1e-12, 1e-13) if dtype == torch.float64
                        else (1e-4, 1e-5))
        print("kernel trsm_lower %s (%s, k=%d, c=%d, both storages, three "
              "ops, bit-identical to the per-block kernel): agreement %.3e "
              "(tol %.0e), with trsm_lower_schedule %.3e, backward error "
              "%.3e (tol %.0e)" % (what, str(dtype).replace("torch.", ""),
                                   kk, cc, worst["agree"], atol_,
                                   worst["schedule"], worst["backward"],
                                   btol_), flush=True)
        require(worst["agree"] <= atol_, "trsm_lower disagrees with its "
                "plain version at %s" % what)
        require(worst["schedule"] <= atol_, "trsm_lower disagrees with "
                "trsm_lower_schedule at %s" % what)
        require(worst["backward"] <= btol_, "trsm_lower's backward error "
                "at %s" % what)
        k5_checks.append(dict(what=what, dtype=str(dtype), k=kk, c=cc,
                              **worst))
        esz = Lf.element_size()
        tri = (2 if op == "cho_solve" else 1) * kk * (kk + 1) // 2 * esz
        flops = (2.0 if op == "cho_solve" else 1.0) * kk * kk * cc
        library = ((lambda Lf=Lf, Bk=Bk: torch.cholesky_solve(Bk.mT, Lf))
                   if op == "cho_solve" else
                   (lambda Lf=Lf, Bk=Bk: torch.linalg.solve_triangular(
                       Lf, Bk.mT, upper=False)))
        record("trsm_lower", dtype, "cuda",
               "runlmc_tpu_torch/hopper/csrc/trsm.cu",
               ("runlmc_tpu/lmc/likelihood.py:116" if path == "weather oracle"
                else "runlmc_tpu/lmc/woodbury.py:%d"
                % (192 if op == "cho_solve" else 334)),
               k5_apply(trsm, op, Lf, Bk),
               k5_apply(trsm, op, Lf, Bk, plain=True),
               1e-12 if dtype == torch.float64 else 1e-4,
               lambda Lf=Lf, Bk=Bk, op=op: k5_apply(trsm, op, Lf, Bk),
               lambda Lf=Lf, Bk=Bk, op=op: k5_apply(trsm, op, Lf, Bk,
                                                    plain=True),
               tri + 2 * nbytes(Bk), flops, library_fn=library, path=path,
               product=True, extra={"op": op, "site": what, "k": kk, "c": cc,
                      "backward_error": worst["backward"],
                      "schedule_rel_err": worst["schedule"]})
        del Lf, Bk, Ls, library
    del wL32, k5_shapes
    # a NaN-masked factor (a failed exact Cholesky, likelihood._chol_or_nan)
    # must come back NaN and must not stall a CTA
    for dtype in (torch.float64, torch.float32):
        Lnan = torch.full((dm_fx, dm_fx), float("nan"), dtype=dtype,
                          device=dev)
        for cc in (1, 151):
            out = trsm.cho_solve(Lnan, randn(cc, dm_fx, dtype=dtype))
            torch.cuda.synchronize()
            require(bool(torch.isnan(out).all()), "a NaN factor gave a "
                    "non-NaN solve")
        del Lnan
    # K5 stress: k around one block and a ragged multi-block factor,
    # every c through the chain's widths and one past them, both storage
    # orders, both directions: agreement with the plain version, a
    # relaunch and the per-block kernel bit-identical; a NaN factor at
    # each k and c gives NaN
    k5_stress = {"cases": 0, "worst": {}}
    for dtype in (torch.float64, torch.float32):
        tol_ = 1e-12 if dtype == torch.float64 else 1e-4
        worst_ = 0.0
        for kk in K5_STRESS_KS:
            Ls_ = k5_seeded_factor(kk, dtype, dev)
            Lnan = torch.full((kk, kk), float("nan"), dtype=dtype,
                              device=dev)
            for cc in K5_STRESS_CS:
                Bs_ = randn(cc, kk, dtype=dtype)
                for Lq in (Ls_, k5_other_storage(Ls_)):
                    for kop in ("trsm_lower", "trsm_lower_t"):
                        got = k5_apply(trsm, kop, Lq, Bs_)
                        require(torch.equal(got, k5_apply(trsm, kop, Lq,
                                                          Bs_))
                                and torch.equal(got, k5_per_block(
                                    trsm, kop, Lq, Bs_)),
                                "%s is not bit-identical (k=%d, c=%d)"
                                % (kop, kk, cc))
                        err_ = errors(got, k5_apply(trsm, kop, Lq, Bs_,
                                                    plain=True))[1]
                        require(err_ <= tol_, "%s disagrees with its plain "
                                "version (k=%d, c=%d, %s)" % (kop, kk, cc,
                                                              dtype))
                        worst_ = max(worst_, err_)
                        k5_stress["cases"] += 1
                out = trsm.cho_solve(Lnan, Bs_)
                torch.cuda.synchronize()
                require(bool(torch.isnan(out).all()), "a NaN factor gave a "
                        "non-NaN solve (k=%d, c=%d)" % (kk, cc))
            del Ls_, Lnan
        k5_stress["worst"][str(dtype)] = worst_
    print("kernel trsm_lower stress (k %s, c 1..17, both storages and "
          "directions, %d cases): worst agreement %s, bit-identical across "
          "relaunches and with the per-block kernel, NaN factors give NaN"
          % (K5_STRESS_KS, k5_stress["cases"], k5_stress["worst"]),
          flush=True)

    # K5's float32 error: the float32 cho_solve against the float64 solve
    # of the same float32 factor, beside cholesky_solve's, on fx2007's and
    # the weather twin's own float32 capacitance factors
    k5_f32 = {}
    for what, Lq, cc in (("fx2007", model._woodbury32().L_C, 1),
                         ("weather twin", wm._woodbury32().L_C, nrhs)):
        Bq = randn(cc, Lq.shape[0], dtype=torch.float32)
        want = torch.cholesky_solve(Bq.double().mT, Lq.double()).mT
        e_k5 = errors(trsm.cho_solve(Lq, Bq), want)[1]
        e_lib = errors(torch.cholesky_solve(Bq.mT, Lq).mT, want)[1]
        k5_f32[what] = {"k": Lq.shape[0], "c": cc, "k5": e_k5,
                        "cholesky_solve": e_lib, "ratio": e_k5 / e_lib}
        print("kernel trsm_lower float32 cho_solve at %s's C (k=%d, c=%d): "
              "error from the float64 solve %.3e, cholesky_solve's %.3e "
              "(ratio %.3f, at most %.2f)" % (what, Lq.shape[0], cc, e_k5,
                                             e_lib, e_k5 / e_lib,
                                             K5_F32_FACTOR), flush=True)
        require(e_k5 <= K5_F32_FACTOR * e_lib, "K5's float32 error at %s's "
                "C exceeds %.2f times cholesky_solve's" % (what,
                                                          K5_F32_FACTOR))
        del Lq, Bq, want
    for mdl in (model, wm):
        mdl._cache.pop("woodbury32")

    # ChoSolve's backward against autograd through torch.cholesky_solve
    # at the fx2007 float64 shape
    Lg = k5_seeded_factor(dm_fx, torch.float64, dev).contiguous()
    Sg = randn(1, dm_fx)
    Gg = randn(1, dm_fx)
    grads = []
    for fn in (trsm.cho_solve,
               lambda L_, S_: torch.cholesky_solve(S_.mT, L_).mT):
        L_ = Lg.clone().requires_grad_(True)
        S_ = Sg.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(L_, S_), (L_, S_), Gg))
    k5_grad_err = errors(grads[0], grads[1])[1]
    print("kernel trsm_lower ChoSolve backward (S-bar, full L-bar) vs "
          "autograd through torch.cholesky_solve (float64, k=%d, c=1): rel "
          "err %.3e (tol 1e-10)" % (dm_fx, k5_grad_err), flush=True)
    require(k5_grad_err <= 1e-10, "ChoSolve's backward disagrees")
    del Lg, grads

    # the synth model of phase 15 (full width, Dm=4205, 2-D grids)
    sxs, sys_, stxs, stys = synth_synthetic(SEED)
    t0 = time.time()
    sm = T.InterpolatedLLGP(sxs, sys_, functional_kernel=synth_spec(T, 5),
                            m=SYNTH_M, tolerance=SYNTH_TOL,
                            objective="exact", seed=SEED, device=dev)
    torch.cuda.synchronize()
    sbuild_s = time.time() - t0
    print("synth model: n=%d, grid %s, Dm=%d, objective %s, built in %.2f s"
          % (len(sm.data.y), sm.grid_data[0].plan.sizes,
             sm.grid_data[0].interp.ncols, sm.objective, sbuild_s),
          flush=True)
    require(len(sm.grid_data) == 1 and sm.grid_data[0].plan.mode == "dense",
            "the synth grid is not one dense group")

    # K1 (+K8): K_UU with k(r) evaluated on the grid inside the launch,
    # and its backward (the offset sums H, then the table's cotangent and
    # d B), against their plain versions (k(r) by torch ops, the index-map
    # gather and the einsum; autograd through them), in float32 and
    # float64 at the shapes of the fx2007 grid (Q=1, m=238, D=13), the
    # weather twin (Q=6, m=2504, D=4: the float32 preconditioner's K_UU,
    # built once per stochastic step) and synth's 2-D grid (29 x 29, D=5),
    # each on its model's own parameters and a seeded asymmetric
    # cotangent, then on a mixed table of every kind on a 2-D grid. Every
    # call is repeated and must be bit-identical. The backward's library
    # route: one index_add_ of G into H through a full (Dm, Dm) offset
    # map, then the table's cotangent by autograd through torch's k(r) and
    # d B by one einsum.
    k1_checks = []

    def k1_inputs(mdl, dists64, kidxs, dtype):
        p = cast_params(mdl.params, dtype)
        kinds, prm = mdl.spec.table_rows(p, kidxs)
        return kinds, prm, dists64.to(dtype), mdl.spec.coreg_mats(p, kidxs)

    def k1_library(kinds, prm, dists, B, sizes, G):
        """(H by one index_add_, then d prm and d B by torch ops)"""
        Q, m, D = len(kinds), dists.shape[0], B.shape[1]
        idx = torch.as_tensor(bttb_index_map(sizes), dtype=torch.int64,
                              device=dev)
        ar = torch.arange(D, device=dev)
        full = (ar[:, None, None, None] * (D * m) + ar[None, None, :, None]
                * m + idx[None, :, None, :]).reshape(-1)
        H_lib = torch.zeros(D * D * m, dtype=G.dtype, device=dev)

        def library():
            H = H_lib.zero_().index_add_(0, full, G.reshape(-1))
            H = H.view(D, D, m)
            with torch.enable_grad():
                p_ = prm.detach().requires_grad_(True)
                tops = eval_table(kinds, p_, dists)
                (dprm,) = torch.autograd.grad(
                    tops, p_, torch.einsum("qde,deo->qo", B, H))
            return dprm, torch.einsum("qo,deo->qde", tops.detach(), H)

        return library

    def k1_check(what, kinds, prm, dists, B, sizes, dtype, paths=None,
                 plain_reps=20):
        """K1 and its backward against their plain versions (and
        bit-identical relaunches); with ``paths`` (forward's, backward's)
        as kernel rows, timed."""
        Q, m, D = len(kinds), dists.shape[0], B.shape[1]
        args = (kinds, prm, dists, B, sizes)
        out = kuu.kuu_dense(*args)
        want = kuu.kuu_dense_plain(*args)
        G = randn(D * m, D * m, dtype=dtype)
        got_b = kuu.kuu_dense_bwd(*args, G)
        want_b = kuu.kuu_dense_bwd_plain(*args, G)
        same = (torch.equal(out, kuu.kuu_dense(*args))
                and all(torch.equal(a, b) for a, b in
                        zip(got_b, kuu.kuu_dense_bwd(*args, G))))
        tol_f, tol_b = ((1e-12, 1e-12) if dtype == torch.float64
                        else (1e-6, 1e-5))
        chk = {"site": what, "dtype": str(dtype).replace("torch.", ""),
               "Q": Q, "m": m, "D": D, "sizes": list(sizes),
               "rel_err": errors(out, want)[1],
               "bwd_rel_err": errors(got_b, want_b)[1],
               "bwd_prm_rel_err": errors(got_b[0], want_b[0])[1],
               "bwd_B_rel_err": errors(got_b[1], want_b[1])[1],
               "bit_identical": same}
        k1_checks.append(chk)
        print("K1 (+K8) %s %s (Q=%d, m=%d, D=%d): forward rel err %.3e (tol "
              "%.0e), backward d prm %.3e, d B %.3e (tol %.0e), relaunch "
              "bit-identical %s" % (what, chk["dtype"], Q, m, D,
                                    chk["rel_err"], tol_f,
                                    chk["bwd_prm_rel_err"],
                                    chk["bwd_B_rel_err"], tol_b, same),
              flush=True)
        require(same, "K1 %s %s relaunch is not bit-identical"
                % (what, chk["dtype"]))
        require(chk["bwd_rel_err"] <= tol_b, "K1 backward %s %s disagrees "
                "with its plain version" % (what, chk["dtype"]))
        if paths is None:
            require(chk["rel_err"] <= tol_f, "K1 %s %s disagrees with its "
                    "plain version" % (what, chk["dtype"]))
            return
        site = {"site": "%s, Dm=%d" % (what, D * m)}
        record("kuu_dense", dtype, "cuda",
               "runlmc_tpu_torch/hopper/csrc/kuu_dense.cu",
               "runlmc_tpu/lmc/grid.py:535", out, want, tol_f,
               lambda: kuu.kuu_dense(*args),
               lambda: kuu.kuu_dense_plain(*args),
               nbytes(out, prm, dists, B),
               2.0 * out.numel() * Q + K8_OPS * Q * m, path=paths[0],
               plain_reps=plain_reps, extra=site)
        library = k1_library(*args, G)
        require(errors(library(), want_b)[1] <= tol_b,
                "the index_add_ route disagrees with the plain backward")
        record("kuu_dense_bwd", dtype, "cuda",
               "runlmc_tpu_torch/hopper/csrc/kuu_dense_bwd.cu",
               "runlmc_tpu/lmc/grid.py:535", got_b, want_b, tol_b,
               lambda: kuu.kuu_dense_bwd(*args, G),
               lambda: kuu.kuu_dense_bwd_plain(*args, G),
               nbytes(G, prm, dists, B, *got_b),
               G.numel() + 4.0 * Q * D * D * m + K8_OPS * Q * m,
               library_fn=library, path=paths[1], plain_reps=plain_reps,
               extra=site)

    # the weather twin keeps the fine grid: its float64 distances are the
    # fft group's own
    wtw32 = wm.precond_data32[0]
    require(wtw32.plan.sizes == wm.grid_data[0].plan.sizes and torch.equal(
        wtw32.dists, wm.grid_data[0].dists.float()),
        "the weather twin is not the fine grid")
    for what, mdl, dists64, kidxs, sizes, paths, reps in (
            ("fx2007", model, model.grid_data[0].dists,
             model.grid_data[0].plan.kidxs, model.grid_data[0].plan.sizes,
             {torch.float32: ("train", "train"),
              torch.float64: ("predict", "train (model precision)")}, 20),
            # the twin's float32 K_UU is built without a gradient, and
            # no path builds it in float64
            ("weather twin", wm, wm.grid_data[0].dists,
             wtw32.plan.kidxs, wtw32.plan.sizes,
             {torch.float32: ("train (stochastic, fft)", OFF_PATH),
              torch.float64: (OFF_PATH, OFF_PATH)}, 3),
            ("synth", sm, sm.grid_data[0].dists, sm.grid_data[0].plan.kidxs,
             sm.grid_data[0].plan.sizes,
             {torch.float32: ("synth", "synth"),
              torch.float64: ("synth", "synth")}, 10)):
        for dtype in (torch.float32, torch.float64):
            k1_check(what, *k1_inputs(mdl, dists64, kidxs, dtype), sizes,
                     dtype, paths=paths[dtype], plain_reps=reps)
        # K8's own work, now inside K1: Q x m values from m distances
        q_, m_ = len(kidxs), dists64.numel()
        print("bound K8 k(r) on the grid (%s, Q=%d, m=%d, float32): %.6f ms "
              "(%s)" % ((what, q_, m_) + bound_ms(
                  4.0 * m_ * (1 + q_), K8_OPS * q_ * m_, torch.float32)),
              flush=True)
    mixed_k1 = T.LMCKernelSpec.create(
        D=3, lmc_kernels=[T.RBF(name="r"), T.Matern32(name="m")],
        lmc_ranks=[1, 2], slfm_kernels=[T.StdPeriodic(name="p", period=0.6)],
        indep_gp=[T.IdentityKern(),
                  T.Scaled(inner=T.RBF(name="s"), scale=1.5),
                  T.Scaled(inner=T.Matern32(name="f"),
                           trainable_scale=False, scale=0.7)],
        indep_gp_index=[0, 1, 2],
    ).with_input_dim(2)
    mk_sizes = (20, 17)
    mk_grid = np.stack(np.meshgrid(np.linspace(0, 1, 20),
                                   np.linspace(0, 2, 17), indexing="ij"),
                       -1).reshape(-1, 2)
    mk_dists = torch.as_tensor(np.linalg.norm(mk_grid - mk_grid[0], axis=-1),
                               device=dev)
    for dtype in (torch.float32, torch.float64):
        mkp = from_reference_params(mixed_k1.init_raw_params(seed=SEED + 2),
                                    dtype, dev)
        kinds_, prm_ = mixed_k1.table_rows(mkp, range(mixed_k1.Q))
        k1_check("mixed table (5 kinds, 2-D)", kinds_, prm_,
                 mk_dists.to(dtype), mixed_k1.coreg_mats(mkp), mk_sizes,
                 dtype)

    # K2: the capacitance matrix at its call sites, each model's own
    # factors and noise: the fx2007 and synth models' float32 factors
    # (training) and float64 ones (model precision), the weather twin's
    # float32 preconditioner factor, and that factor in float64; each
    # launch is relaunched (bit-identical) and run on the factor in the
    # other storage order. K2's backward at the fx2007 and synth shapes
    # on a seeded asymmetric cotangent, against its plain version and
    # against autograd through the dense library products.
    def noise_inv(mdl, dtype):
        return 1.0 / mdl.spec.noise(cast_params(mdl.params, dtype))

    k2_sites = []
    for what, mdl, path32, path64 in (
            ("fx2007", model, "train", "train (model precision)"),
            ("synth", sm, "synth", "synth")):
        k2_sites.append((what, torch.float32, path32, mdl.grid_data32,
                         noise_inv(mdl, torch.float32),
                         mdl._woodbury32().Fs))
        k2_sites.append((what, torch.float64, path64,
                         mdl.grid_data, noise_inv(mdl, torch.float64),
                         mdl._woodbury().Fs))
        mdl._cache.pop("woodbury32")
        mdl._cache.pop("woodbury")
    wFs = wm._woodbury32().Fs
    wm._cache.pop("woodbury32")
    wtwin64 = tuple(dataclasses.replace(g, WtW=g.WtW.double(), cross=())
                    for g in wm.precond_data32)
    k2_sites.append(("weather preconditioner twin", torch.float32,
                     "train (stochastic, fft)", wm.precond_data32,
                     noise_inv(wm, torch.float32), wFs))
    k2_sites.append(("weather preconditioner twin", torch.float64,
                     "train (model precision)", wtwin64,
                     noise_inv(wm, torch.float64),
                     tuple(F.double() for F in wFs)))
    del wFs
    k2_checks = []
    for what, dtype, path, grids_, inv_e, Fs_ in k2_sites:
        dts = str(dtype).replace("torch.", "")
        ftol, btol = K2_TOL[dts]
        nest = tgrid.gram_nest(grids_)
        C, Ts = cap.capacitance(nest, inv_e, Fs_)
        again = cap.capacitance(nest, inv_e, Fs_)[0]
        other = cap.capacitance(nest, inv_e,
                                [k5_other_storage(F) for F in Fs_])[0]
        torch.cuda.synchronize()
        require(torch.equal(C, again) and torch.equal(C, other),
                "capacitance is not bit-identical across launches and "
                "storage orders at %s %s" % (what, dts))
        del again, other
        fb, fo, bb, bo, dense = k2_work(grids_, C.element_size())
        weather = what.startswith("weather")
        lib = (lambda nest=nest, inv_e=inv_e, Fs_=Fs_:
               k2_library(nest, inv_e, Fs_))
        require(errors(lib(), cap.capacitance_plain(nest, inv_e, Fs_)[0])[1]
                <= ftol, "the dense library products disagree with K2's "
                "plain version")
        fwd_fn = (lambda nest=nest, inv_e=inv_e, Fs_=Fs_:
                  cap.capacitance(nest, inv_e, Fs_))
        split = k2_split(fwd_fn, reps=3 if weather else 10)
        print("kernel capacitance %s %s split: %s"
              % (what, dts, k2_split_text(split)), flush=True)
        record("capacitance", dtype, "cuda",
               "runlmc_tpu_torch/hopper/csrc/capacitance.cu",
               "runlmc_tpu/lmc/woodbury.py:260", C,
               cap.capacitance_plain(nest, inv_e, Fs_)[0], ftol,
               lambda nest=nest, inv_e=inv_e, Fs_=Fs_:
               cap.capacitance(nest, inv_e, Fs_),
               lambda nest=nest, inv_e=inv_e, Fs_=Fs_:
               cap.capacitance_plain(nest, inv_e, Fs_),
               fb, fo, library_fn=lib, path=path,
               plain_reps=5 if weather else 20, product=True,
               extra={"site": what, "k": C.shape[0], "split": split,
                      "structured_operations": fo,
                      "dense_operations": dense,
                      "dense_bound_ms": bound_ms(0, dense, dtype,
                                                 product=True)[0]})
        check = {"site": what, "dtype": dts, "k": C.shape[0]}
        if weather and dtype == torch.float32:
            w32 = (C.clone(), lib())
        elif weather:
            # the float32 rounding of K2 (blocked sums) and of cuBLAS's
            # dense products against float64 on the same inputs
            scale = float(C.abs().max())
            check["float32_vs_float64"] = {
                "k2": float((w32[0].double() - C).abs().max()) / scale,
                "library": float((w32[1].double() - C).abs().max()) / scale}
            print("kernel capacitance weather twin float32 against float64 "
                  "(of max |C|): K2 %.3e, dense cuBLAS products %.3e"
                  % (check["float32_vs_float64"]["k2"],
                     check["float32_vs_float64"]["library"]), flush=True)
            del w32
        if not weather:
            k = C.shape[0]
            gdev = torch.Generator(device=dev).manual_seed(SEED + k)
            Cbar = torch.randn(k, k, generator=gdev, dtype=dtype,
                               device=dev)
            got = cap.capacitance_bwd(nest, inv_e, Fs_, Ts, Cbar)
            got = (got[0], *got[1])
            again = cap.capacitance_bwd(nest, inv_e, Fs_, Ts, Cbar)
            require(all(torch.equal(a, b) for a, b in
                        zip(got, (again[0], *again[1]))),
                    "capacitance_bwd is not bit-identical at %s" % what)
            Tp = cap.capacitance_plain(nest, inv_e, Fs_)[1]
            want = cap.capacitance_bwd_plain(nest, inv_e, Fs_, Tp, Cbar)
            want = (want[0], *want[1])

            def lib_bwd(nest=nest, inv_e=inv_e, Fs_=Fs_, Cbar=Cbar):
                ie = inv_e.detach().requires_grad_(True)
                Fr = [F.detach().requires_grad_(True) for F in Fs_]
                return torch.autograd.grad(k2_library(nest, ie, Fr),
                                           [ie] + Fr, Cbar)

            check["library_bwd_rel_err"] = errors(lib_bwd(), want)[1]
            require(check["library_bwd_rel_err"] <= btol, "autograd "
                    "through the dense library products disagrees with "
                    "K2's plain backward at %s" % what)
            ks_ = [int(F.shape[0]) for F in Fs_]
            offs_ = [sum(ks_[:a]) for a in range(len(ks_))]
            lib_mm = k2_matmul_yardstick(Ts, Cbar, offs_, ks_)
            autograd = {"library_autograd_ms": cuda_time(lib_bwd),
                        "library_autograd_device_ms":
                        device_profile(lib_bwd, reps=10)[0]}
            bwd_fn = (lambda nest=nest, inv_e=inv_e, Fs_=Fs_, Ts=Ts,
                      Cbar=Cbar: cap.capacitance_bwd(nest, inv_e, Fs_, Ts,
                                                     Cbar))
            bsplit = k2_split(bwd_fn)
            print("kernel capacitance_bwd %s %s split: %s; autograd "
                  "through the dense products %.4f ms (device %s)"
                  % (what, dts, k2_split_text(bsplit),
                     autograd["library_autograd_ms"],
                     _ms(autograd["library_autograd_device_ms"])),
                  flush=True)
            record("capacitance_bwd", dtype, "cuda",
                   "runlmc_tpu_torch/hopper/csrc/capacitance.cu",
                   "runlmc_tpu/lmc/woodbury.py:260", got, want, btol,
                   lambda nest=nest, inv_e=inv_e, Fs_=Fs_, Ts=Ts,
                   Cbar=Cbar: cap.capacitance_bwd(nest, inv_e, Fs_, Ts,
                                                  Cbar),
                   lambda nest=nest, inv_e=inv_e, Fs_=Fs_, Tp=Tp,
                   Cbar=Cbar: cap.capacitance_bwd_plain(nest, inv_e, Fs_,
                                                        Tp, Cbar),
                   bb, bo, library_fn=lib_mm, path=path, product=True,
                   extra=dict(autograd, site=what, k=k, split=bsplit))
            del Cbar, got, again, want, Tp, lib_mm
        k2_checks.append(check)
        del C, Ts
    del k2_sites, wtwin64
    # K2 on a two-group model (cross blocks, a 2-D and a 1-D grid over a
    # 3-D input, 3 outputs; seeded factors), forward and backward
    rng3 = np.random.RandomState(SEED)
    x3 = [rng3.uniform(0, 1, (1500, 3)) for _ in range(3)]
    spec3 = T.LMCKernelSpec.create(
        D=3, lmc_kernels=[T.RBF(name="a", active_dims=(0, 1))],
        lmc_ranks=[1], indep_gp=[T.RBF(name="b", active_dims=(2,))],
    ).with_input_dim(3)
    g3, _ = tgrid.make_grids(spec3, x3, m=[16, 16, 200])
    require(len(g3) == 2, "the two-group K2 check has one group")
    for dtype in (torch.float32, torch.float64):
        dts = str(dtype).replace("torch.", "")
        ftol, btol = K2_TOL[dts]
        gds3 = tuple(g.to(dtype, dev) for g in g3)
        nest = tgrid.gram_nest(gds3)
        inv_e = torch.rand(3, generator=gen, dtype=torch.float64).to(
            dev, dtype) + 0.5
        Fs_ = [k5_seeded_factor(g.interp.ncols, dtype, dev) for g in gds3]
        C, Ts = cap.capacitance(nest, inv_e, Fs_)
        Cp, Tp = cap.capacitance_plain(nest, inv_e, Fs_)
        Cbar = randn(*C.shape, dtype=dtype)
        got = cap.capacitance_bwd(nest, inv_e, Fs_, Ts, Cbar)
        want = cap.capacitance_bwd_plain(nest, inv_e, Fs_, Tp, Cbar)
        e_f = errors(C, Cp)[1]
        e_b = errors((got[0], *got[1]), (want[0], *want[1]))[1]
        print("kernel capacitance two groups (Dm %s, cross blocks) %s: "
              "forward rel err %.3e (tol %.0e), backward %.3e (tol %.0e)"
              % ([g.interp.ncols for g in gds3], dts, e_f, ftol, e_b, btol),
              flush=True)
        require(e_f <= ftol and e_b <= btol,
                "capacitance disagrees on two groups")
        k2_checks.append({"site": "two groups", "dtype": dts,
                          "forward_rel_err": e_f, "backward_rel_err": e_b})
        del C, Ts, Cp, Tp, Cbar, got, want, Fs_

    # K3: the jittered Cholesky's prologue (equilibrate and jitter; the
    # first attempt, which computes the kept scale), the factorization in
    # place (potrf.potrf_: cuSOLVER's potrf on the prologue's column-major
    # M), epilogue (de-scale and the attempt's flag) and their backward at
    # the call sites of chol_jittered: each model's own K_UU and C,
    # captured while its Woodbury factorization is built (fx2007 and synth
    # in float32, as training factors, and float64, as at model precision;
    # the weather twin's float32 preconditioner), at the scale where the
    # ladder lands. The backward on seeded cotangents (O-bar row-major,
    # M-bar column-major: the kernel table's earlier rows) and, at the timed
    # sites, on the same values in the storage orders that one exact
    # gradient of the model hands each site's backward (k3_bwd_orders:
    # M-bar row-major from the VJP's solve, O-bar as the factor's users
    # leave it), each printed. Every launch is repeated and must be
    # bit-identical; the prologue (the plain version's lower triangle,
    # zeros above it) and the epilogue must equal their plain versions bit
    # for bit; the factor's strict upper triangle must be 0; and the
    # in-place chain's L and O must equal, bit for bit, those of the
    # earlier route (cholesky_ex into a new factor, then its tril_) and of
    # torch's in-place call (cholesky_ex(M, out=(M, info)): no copy, but
    # its tril_). At the timed sites (each C; both sites share the shape)
    # one attempt is timed by route, with the earlier route's copy of M
    # and the tril_ that both torch routes run timed alone. The
    # unequilibrated mode (the flip rung) is held, untimed, at fx2007 and
    # synth. No PyTorch call computes any of the four functions: no
    # library column.
    k3_checks = []

    def k3_sites(build_fn):
        """[(kind, A, scales, equilibrate)] of the chol_jittered calls of
        one Woodbury build."""
        seen, real = [], wbm.chol_jittered

        def spy(A, scales=(1e-6, 1e-4, 1e-2), equilibrate=None):
            seen.append(("C" if scales[0] == 0.0 else "K_UU", A.detach(),
                         tuple(scales), wbm.EQUILIBRATE_DEFAULT
                         if equilibrate is None else equilibrate))
            return real(A, scales=scales, equilibrate=equilibrate)

        wbm.chol_jittered = spy
        try:
            build_fn()
        finally:
            wbm.chol_jittered = real
        return seen

    def order_of(X):
        if X.is_contiguous():
            return "row"
        return "column" if X.mT.is_contiguous() else "strided"

    def stored(X, order):
        return X.mT.contiguous().mT if order == "column" else X.contiguous()

    def k3_bwd_orders(mdl, dtype):
        """{"C": {...}, "K_UU": {...}}: the storage orders (O-bar, L,
        M-bar, A) that one exact gradient of ``mdl``, its factorizations
        in ``dtype``, hands K3's backward at each site. C's backward runs
        first: K_UU's cotangents come through it."""
        seen = {"descale": [], "prologue": []}
        real_d = chol_jitter.chol_descale_bwd
        real_p = chol_jitter.chol_prologue_bwd

        def spy_d(L, s, Obar):
            seen["descale"].append({"O-bar": order_of(Obar),
                                    "L": order_of(L)})
            return real_d(L, s, Obar)

        def spy_p(A, sd, Mbar, sbar, scale, equilibrate):
            seen["prologue"].append({"M-bar": order_of(Mbar),
                                     "A": order_of(A)})
            return real_p(A, sd, Mbar, sbar, scale, equilibrate)

        # the wrappers count on their own module-level names
        spy_d.launches, spy_p.launches = real_d.launches, real_p.launches
        prec = mdl.exact_precision
        mdl.exact_precision = "f32" if dtype == torch.float32 else "model"
        chol_jitter.chol_descale_bwd = spy_d
        chol_jitter.chol_prologue_bwd = spy_p
        try:
            x = torch.as_tensor(mdl.param_array, dtype=mdl.dtype,
                                device=dev)
            mdl._exact_grad(x)
            torch.cuda.synchronize()
        finally:
            chol_jitter.chol_descale_bwd = real_d
            chol_jitter.chol_prologue_bwd = real_p
            mdl.exact_precision = prec
        out = {}
        for i, site in enumerate(("C", "K_UU")):
            out[site] = {}
            for key in ("descale", "prologue"):
                if i < len(seen[key]):
                    out[site].update(seen[key][i])
        return out

    def k3_attempt(A, scale, equil, sd, route):
        """One attempt of the chain, (L, O, flag), the factor by
        ``route``: "in place" (the port's potrf, no tril_), "torch in
        place" (cholesky_ex(M, out=(M, info)), then its tril_) or "new
        factor" (cholesky_ex into a new matrix, the earlier route)."""
        M, s, _ = chol_jitter.chol_prologue(A, scale, equil, sd)
        if route == "in place":
            L, info = potrf.potrf_(M)
        elif route == "new factor":
            L, info = torch.linalg.cholesky_ex(M)
        else:
            info = torch.empty((), dtype=torch.int32, device=dev)
            L, info = torch.linalg.cholesky_ex(M, out=(M, info))
        O, flag = chol_jitter.chol_descale(L, info, s if equil else None)
        return L, O, flag

    def k3_check(what, kind, A, scales, equil, paths=None, reps=20,
                 orders=None):
        """K3's four kernels at one site; its backward with seeded
        cotangents (O-bar row-major, M-bar column-major) and, where
        ``orders`` gives the training path's storage orders at each site
        ({"C": ..., "K_UU": ...}), also in those."""
        dtype, n = A.dtype, A.shape[0]
        dts = str(dtype).replace("torch.", "")
        tol = 1e-14 if dtype == torch.float64 else 1e-6
        sd = None
        for scale in scales:  # the rung the ladder lands on
            M, s, sd = chol_jitter.chol_prologue(A, scale, equil, sd)
            Mw = M.clone()  # what the prologue writes
            L, info = potrf.potrf_(M)
            O, flag = chol_jitter.chol_descale(L, info.clone(),
                                               s if equil else None)
            if int(flag) == 0:
                break
        rung = scales.index(scale)
        sd1 = chol_jitter.chol_prologue(A, scale, equil)[2]
        sd_p = chol_jitter.chol_scale_plain(A, equil)
        Mp, sp = chol_jitter.chol_prologue_plain(A, scale, equil, sd_p)
        Mp = torch.tril(Mp)
        # without equilibration d is a sum, in another order than
        # torch.mean's: M's bits are held from the plain version's d
        Mq = (Mw if equil else chol_jitter.chol_prologue(
            A, scale, equil, sd_p)[0])
        Op, flag_p = chol_jitter.chol_descale_plain(L, info, sp)
        # the earlier route on the same rung
        old_route_equal = True
        for route in ("new factor", "torch in place"):
            L_old, O_old, flag_old = k3_attempt(A, scale, equil, sd, route)
            old_route_equal &= bool(torch.equal(L, L_old)
                                    and torch.equal(O, O_old)
                                    and int(flag_old) == int(flag))
            del L_old, O_old
        upper_zero = bool(torch.count_nonzero(torch.triu(L, 1)) == 0)
        gk = torch.Generator(device=dev).manual_seed(SEED + n)
        Ob = torch.randn(n, n, generator=gk, dtype=dtype, device=dev)
        Mb = torch.randn(n, n, generator=gk, dtype=dtype, device=dev).mT
        bwd_d = bwd_dp = None
        if equil:
            bwd_d = chol_jitter.chol_descale_bwd(L, s, Ob)
            bwd_dp = chol_jitter.chol_descale_bwd_plain(L, s, Ob)
        sb = bwd_d[1] if equil else None
        Ab = chol_jitter.chol_prologue_bwd(A, sd, Mb, sb, scale, equil)
        Ab_p = chol_jitter.chol_prologue_bwd_plain(A, sd, Mb, sb, scale,
                                                   equil)
        same = (torch.equal(Mw, chol_jitter.chol_prologue(A, scale, equil,
                                                          sd)[0])
                and torch.equal(sd1, sd)
                and torch.equal(O, chol_jitter.chol_descale(
                    L, info.clone(), s if equil else None)[0])
                and torch.equal(Ab, chol_jitter.chol_prologue_bwd(
                    A, sd, Mb, sb, scale, equil))
                and (not equil or all(torch.equal(a, b) for a, b in zip(
                    bwd_d, chol_jitter.chol_descale_bwd(L, s, Ob)))))
        chk = {"site": what, "factor": kind, "dtype": dts, "n": n,
               "equilibrate": equil, "rung": rung, "scale": scale,
               "flag": int(flag), "plain_flag": int(flag_p),
               "prologue_equal_to_plain": bool(torch.equal(Mq, Mp)),
               "kept_scale_equal_to_plain": bool(torch.equal(sd, sd_p)),
               "descale_equal_to_plain": bool(torch.equal(O, Op)),
               "equal_to_torch_routes": old_route_equal,
               "factor_upper_zero": upper_zero,
               "prologue_rel_err": errors((Mw, sd), (Mp, sd_p))[1],
               "descale_rel_err": errors(O, Op)[1],
               "prologue_bwd_rel_err": errors(Ab, Ab_p)[1],
               "descale_bwd_rel_err": (errors(bwd_d, bwd_dp)[1] if equil
                                       else None),
               "bit_identical": bool(same)}
        k3_checks.append(chk)
        print("K3 %s %s %s (n=%d, equilibrate %s): lands on rung %d (scale "
              "%g), flag %d (plain %d); prologue (lower triangle) rel err "
              "%.3e (equal %s; kept scale equal %s), descale %.3e (equal "
              "%s), L and O equal to torch's routes' (a new factor, in "
              "place) %s, L's strict upper triangle 0 %s; "
              "backward prologue %.3e, descale %s (tol %.0e); relaunch "
              "bit-identical %s"
              % (what, kind, dts, n, equil, rung, scale, chk["flag"],
                 chk["plain_flag"], chk["prologue_rel_err"],
                 chk["prologue_equal_to_plain"],
                 chk["kept_scale_equal_to_plain"], chk["descale_rel_err"],
                 chk["descale_equal_to_plain"], old_route_equal, upper_zero,
                 chk["prologue_bwd_rel_err"],
                 "-" if not equil else "%.3e" % chk["descale_bwd_rel_err"],
                 tol, same), flush=True)
        require(same, "K3 %s %s relaunch is not bit-identical" % (what, dts))
        require(chk["flag"] == chk["plain_flag"] == 0,
                "K3 %s %s: the ladder landed on a failed factor" % (what,
                                                                   dts))
        require(chk["prologue_equal_to_plain"]
                and chk["descale_equal_to_plain"]
                and (chk["kept_scale_equal_to_plain"] or not equil),
                "K3 %s %s %s: the forward is not its plain version's to the "
                "bit" % (what, kind, dts))
        require(old_route_equal and upper_zero, "K3 %s %s %s: the in-place "
                "chain differs from the earlier route, or L's upper triangle "
                "is not 0" % (what, kind, dts))
        for key in ("prologue_rel_err", "descale_rel_err",
                    "prologue_bwd_rel_err", "descale_bwd_rel_err"):
            require(chk[key] is None or chk[key] <= tol, "K3 %s %s %s: %s "
                    "above %g" % (what, kind, dts, key, tol))
        # the backward in the orders the training path gives each site,
        # on the same values
        path_bwd = {}
        for site, od in (orders or {}).items():
            if not equil:
                break
            Ob2 = stored(Ob, od.get("O-bar", "row"))
            Mb2 = stored(Mb, od.get("M-bar", "row"))
            d2 = chol_jitter.chol_descale_bwd(L, s, Ob2)
            a2 = chol_jitter.chol_prologue_bwd(A, sd, Mb2, d2[1], scale,
                                               equil)
            e_d = errors(d2, chol_jitter.chol_descale_bwd_plain(L, s,
                                                                Ob2))[1]
            e_a = errors(a2, chol_jitter.chol_prologue_bwd_plain(
                A, sd, Mb2, d2[1], scale, equil))[1]
            same2 = (all(torch.equal(a, b) for a, b in zip(
                d2, chol_jitter.chol_descale_bwd(L, s, Ob2)))
                and torch.equal(a2, chol_jitter.chol_prologue_bwd(
                    A, sd, Mb2, d2[1], scale, equil)))
            path_bwd[site] = {"orders": od, "L_here": order_of(L),
                              "descale_bwd_rel_err": e_d,
                              "prologue_bwd_rel_err": e_a,
                              "bit_identical": bool(same2),
                              "args": (Ob2, Mb2, d2[1])}
            print("K3 bwd %s %s %s in the training path's orders of its %s "
                  "site (O-bar %s, L %s there, %s here; M-bar %s, A %s): "
                  "descale bwd rel err %.3e, prologue bwd %.3e (tol %.0e); "
                  "relaunch bit-identical %s"
                  % (what, kind, dts, site, od.get("O-bar"), od.get("L"),
                     order_of(L), od.get("M-bar"), od.get("A"), e_d, e_a,
                     tol, same2), flush=True)
            require(same2 and e_d <= tol and e_a <= tol, "K3 bwd %s %s %s "
                    "in the %s site's orders: above %g or not bit-identical"
                    % (what, kind, dts, site, tol))
        chk["path_orders_bwd"] = {k: {kk: vv for kk, vv in v.items()
                                      if kk != "args"}
                                  for k, v in path_bwd.items()}
        if paths is None:
            return
        # one attempt by route, and the earlier route's copy and tril_
        # alone
        treps = max(3, reps // 4)
        routes = {}
        for route in ("in place", "torch in place", "new factor"):
            fn = (lambda r=route: k3_attempt(A, scale, equil, sd, r))
            routes[route] = {"ms": cuda_time(fn, reps=treps, warm=1),
                             "device_ms": device_profile(fn, reps=3)[0]}
        Lc = torch.empty_like(L)
        copy_fn = (lambda: Lc.copy_(L))
        tril_fn = (lambda: Lc.tril_())
        chk["attempt_by_route"] = routes
        chk["copy_ms"] = cuda_time(copy_fn, reps=reps)
        chk["copy_device_ms"] = device_profile(copy_fn, reps=10)[0]
        chk["tril_ms"] = cuda_time(tril_fn, reps=reps)
        chk["tril_device_ms"] = device_profile(tril_fn, reps=10)[0]
        del Lc
        e = A.element_size()
        tri = n * (n + 1) // 2
        chk["copy_bound_ms"] = bound_ms(2 * n * n * e, 0.0, dtype)[0]
        chk["tril_bound_ms"] = bound_ms((n * n - tri) * e, 0.0, dtype)[0]
        print("K3 %s %s %s: one attempt (prologue, potrf, epilogue) by "
              "route: %s; the earlier route's copy of M %.4f ms (device %s, "
              "bound %.4f ms), tril_ %.4f ms (device %s, bound %.4f ms)"
              % (what, kind, dts, json.dumps(routes), chk["copy_ms"],
                 _ms(chk["copy_device_ms"]), chk["copy_bound_ms"],
                 chk["tril_ms"], _ms(chk["tril_device_ms"]),
                 chk["tril_bound_ms"]), flush=True)
        site = {"site": "%s %s, n=%d" % (what, kind, n)}
        src = "runlmc_tpu_torch/hopper/csrc/chol_jitter.cu"
        # the prologue: A's lower triangle read, M written (zeros above
        # the diagonal), s and the kept sd written, A's diagonal read
        record("chol_prologue", dtype, "cuda", src,
               "runlmc_tpu/lmc/woodbury.py:91",
               chol_jitter.chol_prologue(A, scale, equil)[:3:2],
               (Mp, sd_p), tol,
               lambda: chol_jitter.chol_prologue(A, scale, equil),
               lambda: chol_jitter.chol_prologue_plain(
                   A, scale, equil, chol_jitter.chol_scale_plain(A, equil)),
               e * (tri + n * n + 3 * n), 3.0 * tri, path=paths[0],
               plain_reps=reps, extra=site)
        info0 = info.clone()
        record("chol_descale", dtype, "cuda", src,
               "runlmc_tpu/lmc/woodbury.py:123", O, Op, tol,
               lambda: chol_jitter.chol_descale(L, info0, s),
               lambda: chol_jitter.chol_descale_plain(L, info, sp),
               e * (tri + n * n + n) + 4, 2.0 * tri, path=paths[0],
               plain_reps=reps, extra=site)
        record("chol_descale_bwd", dtype, "cuda", src,
               "runlmc_tpu/lmc/woodbury.py:123", bwd_d, bwd_dp, tol,
               lambda: chol_jitter.chol_descale_bwd(L, s, Ob),
               lambda: chol_jitter.chol_descale_bwd_plain(L, s, Ob),
               e * (tri + 2 * n * n + 2 * n), 3.0 * tri + n * n,
               path=paths[1], plain_reps=reps,
               extra=dict(site, orders="seeded: O-bar row"))
        record("chol_prologue_bwd", dtype, "cuda", src,
               "runlmc_tpu/lmc/woodbury.py:91", Ab, Ab_p, tol,
               lambda: chol_jitter.chol_prologue_bwd(A, sd, Mb, sb, scale,
                                                     equil),
               lambda: chol_jitter.chol_prologue_bwd_plain(
                   A, sd, Mb, sb, scale, equil),
               e * (3 * n * n + 3 * n), 7.0 * n * n, path=paths[1],
               plain_reps=reps, extra=dict(site, orders="seeded: M-bar "
                                           "column"))
        for where, pb in path_bwd.items():
            Ob2, Mb2, sb2 = pb["args"]
            od = pb["orders"]
            tag = dict(site, orders="training path's %s site: O-bar %s, "
                       "M-bar %s" % (where, order_of(Ob2), order_of(Mb2)))
            record("chol_descale_bwd", dtype, "cuda", src,
                   "runlmc_tpu/lmc/woodbury.py:123",
                   chol_jitter.chol_descale_bwd(L, s, Ob2),
                   chol_jitter.chol_descale_bwd_plain(L, s, Ob2), tol,
                   lambda: chol_jitter.chol_descale_bwd(L, s, Ob2),
                   lambda: chol_jitter.chol_descale_bwd_plain(L, s, Ob2),
                   e * (tri + 2 * n * n + 2 * n), 3.0 * tri + n * n,
                   path=paths[1], plain_reps=reps, extra=tag)
            record("chol_prologue_bwd", dtype, "cuda", src,
                   "runlmc_tpu/lmc/woodbury.py:91",
                   chol_jitter.chol_prologue_bwd(A, sd, Mb2, sb2, scale,
                                                 equil),
                   chol_jitter.chol_prologue_bwd_plain(A, sd, Mb2, sb2,
                                                       scale, equil), tol,
                   lambda: chol_jitter.chol_prologue_bwd(A, sd, Mb2, sb2,
                                                         scale, equil),
                   lambda: chol_jitter.chol_prologue_bwd_plain(
                       A, sd, Mb2, sb2, scale, equil),
                   e * (3 * n * n + 3 * n), 7.0 * n * n, path=paths[1],
                   plain_reps=reps, extra=tag)
            del od

    # K3's VJP (the Cholesky factorization's backward) at the same sites:
    # the factor each ladder lands on (column-major, as cuSOLVER leaves
    # it) and a seeded row-major L-bar. The tri kernel (Phi(L^T L-bar),
    # symmetrized) against its plain version (torch ops), in both storage
    # orders of L and L-bar, bit-identical across relaunches and storage
    # orders, and in float32 equal to the bit to its route 1 (a thread an
    # entry, the sum order of the earlier kernel); the solve kernel
    # (chol_vjp_solve: A-bar = L^-T S L^-1) against its plain version
    # (cuBLAS's two triangular solves and the symmetrization, also its
    # library column), bit-identical across relaunches and both storage
    # orders of L, exactly symmetric, and in float32 no less accurate than
    # cuBLAS's route against the float64 solve of the same inputs (within
    # SOLVE_F32_FACTOR); the solves also timed on K5 (vjp_solve_k5); the
    # whole VJP against torch's own Cholesky backward (autograd of
    # torch.linalg.cholesky, timed as the library call: the backward
    # alone, on a graph built once).
    vjp_checks = []

    def vjp_check(what, kind, A, scales, equil, path, reps):
        dtype = A.dtype
        dts = str(dtype).replace("torch.", "")
        sd = None
        for scale in scales:  # the rung the ladder lands on
            M, s_, sd = chol_jitter.chol_prologue(A, scale, equil, sd)
            L, info = torch.linalg.cholesky_ex(M)
            if int(chol_jitter.chol_descale(L, info.clone(), None)[1]) == 0:
                break
        n = L.shape[0]
        gk = torch.Generator(device=dev).manual_seed(SEED + 7 * n)
        Lb = torch.randn(n, n, generator=gk, dtype=dtype, device=dev)
        S = cv.chol_vjp(L, Lb)
        Sp = cv.chol_vjp_plain(L, Lb)
        same = all(torch.equal(S, cv.chol_vjp(a, b)) for a in
                   (L, k5_other_storage(L)) for b in
                   (Lb, k5_other_storage(Lb)))
        route1 = (bool(torch.equal(S, cv.chol_vjp(L, Lb, route=1)))
                  if dtype == torch.float32 else None)
        routes = {"kernel": cv.chol_vjp_solve,
                  "cublas": cv.chol_vjp_solve_plain, "k5": vjp_solve_k5}
        X = {r: f(L, S) for r, f in routes.items()}
        solve_same = (torch.equal(X["kernel"], X["kernel"].mT)
                      and torch.equal(X["kernel"], cv.chol_vjp_solve(L, S))
                      and torch.equal(X["kernel"], cv.chol_vjp_solve(
                          k5_other_storage(L), S)))
        route_err = errors(X["k5"], X["cublas"])[1]
        solve_acc = None
        if dtype == torch.float32:
            X64 = cv.chol_vjp_solve_plain(L.double(), S.double())
            solve_acc = {r: errors(x, X64)[1] for r, x in X.items()}
            del X64
        # the whole VJP against torch's Cholesky backward on the same
        # matrix (torch.linalg.cholesky refactors M: the same factor)
        a = M.detach().clone().requires_grad_(True)
        Lt = torch.linalg.cholesky(a)
        require(torch.equal(Lt, L), "torch.linalg.cholesky and cholesky_ex "
                "factor apart at %s" % what)

        def torch_bwd(Lt=Lt, a=a, Lb=Lb):
            return torch.autograd.grad(Lt, a, Lb, retain_graph=True)[0]

        whole = cv.cholesky_backward(L, Lb)
        ref = torch_bwd()
        ref = 0.5 * (ref + ref.mT)
        # float32: both against the float64 VJP of the same factor
        if dtype == torch.float32:
            a64 = M.detach().double().requires_grad_(True)
            ref64 = torch.autograd.grad(torch.linalg.cholesky(a64), a64,
                                        Lb.double())[0]
            ref64 = 0.5 * (ref64 + ref64.mT)
            whole_err = errors(whole, ref64)[1]
            torch_err = errors(ref, ref64)[1]
            ok_whole = whole_err <= VJP_F32_FACTOR * torch_err
            del a64, ref64
        else:
            whole_err = errors(whole, ref)[1]
            torch_err = None
            ok_whole = whole_err <= VJP_F64_TOL
        solve_ms = {r: cuda_time(lambda f=f: f(L, S), reps=reps, warm=1)
                    for r, f in routes.items()}
        solve_dev = {r: device_profile(lambda f=f: f(L, S), reps=3)[0]
                     for r, f in routes.items()}
        whole_ms = cuda_time(lambda: cv.cholesky_backward(L, Lb), reps=reps,
                             warm=1)
        whole_dev = device_profile(lambda: cv.cholesky_backward(L, Lb),
                                   reps=3)[0]
        torch_dev = device_profile(torch_bwd, reps=3)[0]
        e = A.element_size()
        # the two solves' operations (2 n^3) at the rate of their products
        solve2_bound = bound_ms(2 * n * n * e, 2.0 * n ** 3, dtype, True)[0]
        chk = {"site": what, "factor": kind, "dtype": dts, "n": n,
               "rel_err": errors(S, Sp)[1], "bit_identical": bool(same),
               "tri_equal_to_route1": route1,
               "solve_rel_err": errors(X["kernel"], X["cublas"])[1],
               "solve_exact_and_identical": bool(solve_same),
               "solve_err_vs_float64": solve_acc,
               "solve_routes_rel_err": route_err,
               "solves_ms": solve_ms, "solves_device_ms": solve_dev,
               "two_solves_bound_ms": solve2_bound,
               "whole_ms": whole_ms, "whole_device_ms": whole_dev,
               "torch_backward_device_ms": torch_dev,
               "whole_vs_reference_rel_err": whole_err,
               "torch_vs_reference_rel_err": torch_err}
        vjp_checks.append(chk)
        tol, stol = VJP_TOL[dts], VJP_SOLVE_TOL[dts]
        print("K3 VJP %s %s %s (n=%d): tri rel err %.3e (tol %.0e), "
              "relaunch and storage orders bit-identical %s, equal to route "
              "1 %s; solve rel err %.3e (tol %.0e), exact and bit-identical "
              "%s; error from the float64 solve %s; solves: kernel %.4f ms "
              "(device %s), cuBLAS %.4f ms (device %s), K5 %.4f ms (device "
              "%s), two solves' bound %.4f ms, K5 and cuBLAS differ by "
              "%.3e; whole VJP %.4f ms (device %s) against torch's backward "
              "device %s: rel err %.3e%s"
              % (what, kind, dts, n, chk["rel_err"], tol, same, route1,
                 chk["solve_rel_err"], stol, solve_same, solve_acc,
                 solve_ms["kernel"], _ms(solve_dev["kernel"]),
                 solve_ms["cublas"], _ms(solve_dev["cublas"]),
                 solve_ms["k5"], _ms(solve_dev["k5"]), solve2_bound,
                 route_err, whole_ms, _ms(whole_dev), _ms(torch_dev),
                 whole_err, "" if torch_err is None else
                 " from the float64 VJP (torch's float32: %.3e)" % torch_err),
              flush=True)
        require(same and solve_same and route1 is not False,
                "K3 VJP %s %s: a relaunch or a storage order is not "
                "bit-identical, the float32 product not route 1's, or the "
                "result not symmetric" % (what, dts))
        require(chk["rel_err"] <= tol and chk["solve_rel_err"] <= stol,
                "K3 VJP %s %s disagrees with its plain version" % (what,
                                                                  dts))
        require(solve_acc is None or solve_acc["kernel"]
                <= SOLVE_F32_FACTOR * solve_acc["cublas"],
                "K3 VJP %s %s: the solve kernel is less accurate than "
                "cuBLAS's route" % (what, dts))
        require(ok_whole, "K3 VJP %s %s: the whole VJP disagrees with "
                "torch's Cholesky backward" % (what, dts))
        site = {"site": "%s %s, n=%d" % (what, kind, n)}
        src = "runlmc_tpu_torch/hopper/csrc/chol_vjp.cu"
        record("chol_vjp", dtype, "cuda", src,
               "runlmc_tpu/lmc/woodbury.py:121", S, Sp, tol,
               lambda: cv.chol_vjp(L, Lb), lambda: cv.chol_vjp_plain(L, Lb),
               3 * n * n * e, n ** 3 / 3.0, library_fn=torch_bwd, path=path,
               product=True, plain_reps=reps,
               extra=dict(site, whole_vjp_ms=whole_ms,
                          whole_vjp_device_ms=whole_dev,
                          solves_ms=solve_ms))
        plain = routes["cublas"]
        record("chol_vjp_solve", dtype, "cuda", src,
               "runlmc_tpu/lmc/woodbury.py:121", X["kernel"], X["cublas"],
               stol, lambda: cv.chol_vjp_solve(L, S), lambda: plain(L, S),
               (n * n // 2 + 2 * n * n) * e,
               # float64 forms all of X (2 n^3), float32 its lower block
               # triangle (4 n^3 / 3)
               (2.0 if dtype == torch.float64 else 4.0 / 3.0) * n ** 3,
               library_fn=lambda: plain(L, S), path=path, product=True,
               plain_reps=reps,
               extra=dict(site, k5_route_ms=solve_ms["k5"],
                          two_solves_bound_ms=solve2_bound))
        del X

    k3_memory = {}

    def k3_peak(what, A, scales, equil):
        """The device memory one chol_jittered call holds beyond what
        was allocated before it, in (n, n) matrices of A's dtype: the
        prologue's M (factored in place) and the de-scaled copy, plus
        cuSOLVER's workspace."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with ladder_log(wbm) as lad, torch.no_grad():
            L_ = wbm.chol_jittered(A, scales=scales, equilibrate=equil)
        torch.cuda.synchronize()
        mats = ((torch.cuda.max_memory_allocated() - base)
                / (A.numel() * A.element_size()))
        k3_memory[what] = {"matrices": mats, "rung": lad[0]["rung"],
                           "equilibrate": equil}
        print("K3 %s: one chol_jittered call (rung %d, equilibrate %s) "
              "peaks at %.4f (n, n) matrices beyond its input"
              % (what, lad[0]["rung"], equil, mats), flush=True)
        del L_
        require(mats <= 2.1, "chol_jittered holds more than the "
                "prologue's matrix (factored in place) and the epilogue's")

    for what, mdl, dtype, build_fn, paths, reps in (
            ("fx2007", model, torch.float32, model._woodbury32,
             ("train", "train"), 20),
            ("fx2007", model, torch.float64, model._woodbury,
             ("train (model precision)", "train (model precision)"), 20),
            ("weather twin", wm, torch.float32, wm._woodbury32,
             ("train (stochastic, fft)", OFF_PATH), 3),
            ("synth", sm, torch.float32, sm._woodbury32, ("synth", "synth"),
             10),
            ("synth", sm, torch.float64, sm._woodbury, ("synth", "synth"),
             10)):
        mdl._cache.pop("woodbury32", None)
        mdl._cache.pop("woodbury", None)
        sites = k3_sites(build_fn)
        mdl._cache.pop("woodbury32", None)
        mdl._cache.pop("woodbury", None)
        # the storage orders the training path hands K3's backward (the
        # weather twin's factors take no gradient)
        bwd_orders = (None if what == "weather twin"
                      else k3_bwd_orders(mdl, dtype))
        require([k for k, *_ in sites] == ["K_UU", "C"] and all(
            A.dtype == dtype for _, A, _, _ in sites),
            "the %s %s factorization is not one K_UU and one C" % (what,
                                                                   dtype))
        for kind, A, scales, equil in sites:
            k3_check(what, kind, A, scales, equil,
                     paths if kind == "C" else None, reps,
                     orders=bwd_orders if kind == "C" else None)
            if kind == "C" and (what, dtype) != ("fx2007", torch.float64):
                vjp_check(what, kind, A, scales, equil, paths[1], reps)
            if what != "weather twin":
                k3_check(what, kind, A, scales, not equil)
            else:
                k3_peak("%s %s %s" % (what, kind, dtype), A, scales, equil)
        del sites
    # the flag on an indefinite input: a graded D A D (n=1024) whose
    # lowest eigenvalue is -5e-5 fails the first rung of the K_UU ladder;
    # the first attempt's flag must be set and the ladder land where the
    # CPU's does, each attempt but the last read once
    rng_i = np.random.RandomState(SEED + 3)
    U_i, _ = np.linalg.qr(rng_i.standard_normal((1024, 1024)))
    d_i = np.exp(rng_i.uniform(-1, 1, 1024))
    A_ind = d_i[:, None] * ((U_i * np.concatenate(
        [[-5e-5], np.linspace(1.0, 2.0, 1023)])) @ U_i.T) * d_i[None, :]
    k3_flag = {}
    for dtype in (torch.float32, torch.float64):
        for equil in (True, False):
            At = torch.as_tensor(A_ind, dtype=dtype)
            M1 = chol_jitter.chol_prologue(At.to(dev), 1e-6, equil)[0]
            first = int(chol_jitter.chol_descale(*potrf.potrf_(M1),
                                                 None)[1])
            lands = {}
            for where in ("card", "cpu"):
                with ladder_log(wbm) as lad:
                    wbm.chol_jittered(At.to(dev if where == "card"
                                            else "cpu"), equilibrate=equil)
                lands[where] = (lad[0]["rung"], lad[0]["reads"])
            key = "%s equilibrate=%s" % (str(dtype).replace("torch.", ""),
                                         equil)
            k3_flag[key] = {"first_flag": first, "card": lands["card"],
                            "cpu": lands["cpu"]}
            print("K3 flag on an indefinite matrix (n=1024, %s): first "
                  "attempt's flag %d; (rung, host reads) card %s, CPU %s"
                  % (key, first, lands["card"], lands["cpu"]), flush=True)
            require(first != 0 and lands["card"] == lands["cpu"]
                    and lands["card"][0] > 0, "K3's flag or ladder on an "
                    "indefinite matrix (%s)" % key)
    del A_ind, U_i

    # K9 at K4's shapes: the W applies of the weather step (16 columns:
    # y and 15 probes, float32 inner cycles and the float64 operator),
    # of the fx2007 predict preconditioner (151 columns) and of synth
    # (one column), and the gather of kinv_diag's V = W F (3094 columns);
    # the library routes are index_add_ (scatter) and embedding_bag
    # (gather) on the columns as rows
    def k9_rows(W, nb, dtype, path, site, which=("scatter", "gather"),
                transposed=False):
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        n_, taps = W.indices.shape
        if "scatter" in which:
            x = randn(nb, n_, dtype=dtype)
            csr = (W.t_ptr, W.t_rows, W.t_weights)
            out = interp.interp_scatter(*csr, x)
            flat = W.indices.reshape(-1).long()
            wcol = W.weights.reshape(-1, 1)
            rowsx = torch.arange(n_, device=dev).repeat_interleave(taps)
            xT = x.T.contiguous()
            acc = torch.zeros(W.ncols, nb, dtype=dtype, device=dev)
            again = interp.interp_scatter(*csr, x)
            torch.cuda.synchronize()
            require(torch.equal(out, again), "interp_scatter is not "
                    "deterministic at %s" % site)
            variant = interp.scatter_variant(W.ncols, W.t_rows.shape[0], nb)
            record("interp_scatter", dtype, "cuda",
                   "runlmc_tpu_torch/hopper/csrc/interp.cu",
                   "runlmc_tpu/lmc/woodbury.py:141", out,
                   interp.interp_scatter_plain(*csr, x), tol,
                   lambda csr=csr, x=x: interp.interp_scatter(*csr, x),
                   lambda csr=csr, x=x: interp.interp_scatter_plain(*csr, x),
                   nbytes(out, x, *csr), 2.0 * flat.numel() * nb,
                   library_fn=lambda acc=acc, flat=flat, xT=xT, rowsx=rowsx,
                   wcol=wcol: acc.zero_().index_add_(0, flat,
                                                     xT[rowsx] * wcol),
                   path=path, extra={"site": site, "columns": nb,
                                     "variant": ("warp" if variant ==
                                                 interp.SCATTER_WARP
                                                 else "thread")})
        if "gather" in which:
            # kinv_diag's operand is F^T, a transposed view: so here
            v = (randn(W.ncols, nb, dtype=dtype).T if transposed
                 else randn(nb, W.ncols, dtype=dtype))
            out = interp.interp_gather(W.indices, W.weights, v)
            again = interp.interp_gather(W.indices, W.weights, v)
            torch.cuda.synchronize()
            require(torch.equal(out, again), "interp_gather is not "
                    "deterministic at %s" % site)
            with generic_kernels():
                require(torch.equal(out, interp.interp_gather(
                    W.indices, W.weights, v)), "interp_gather's instance "
                    "and its generic kernel differ in bits at %s" % site)
            idx_l = W.indices.long()
            vT = v.T.contiguous()
            lay = interp.gather_layout(*v.stride(), nb)
            record("interp_gather", dtype, "cuda",
                   "runlmc_tpu_torch/hopper/csrc/interp.cu",
                   "runlmc_tpu/lmc/woodbury.py:151", out,
                   interp.interp_gather_plain(W.indices, W.weights, v), tol,
                   lambda W=W, v=v: interp.interp_gather(W.indices,
                                                         W.weights, v),
                   lambda W=W, v=v: interp.interp_gather_plain(
                       W.indices, W.weights, v),
                   nbytes(out, v, W.indices, W.weights),
                   2.0 * W.indices.numel() * nb,
                   library_fn=lambda idx_l=idx_l, vT=vT, W=W:
                   torch.nn.functional.embedding_bag(
                       idx_l, vT, per_sample_weights=W.weights, mode="sum"),
                   path=path, extra={
                       "site": site, "columns": nb,
                       "operand": "transposed" if transposed else "rows",
                       "chunk": interp.gather_chunk(n_, nb, lay),
                       "layout": lay,
                       "taps_instance": interp.gather_taps(taps)})

    k9_rows(wm.inner_data32[0].interp, nrhs, torch.float32,
            "train (stochastic, fft)", "weather step, float32 inner cycles")
    k9_rows(wm.grid_data[0].interp, nrhs, torch.float64,
            "train (stochastic, fft)", "weather step, float64 operator")
    k9_rows(model.grid_data32[0].interp, 1 + sum(len(t) for t in txs),
            torch.float32, "predict", "fx2007 predict preconditioner")
    k9_rows(model.grid_data32[0].interp, dm_fx, torch.float32,
            "loo_zsq (float32)", "fx2007 kinv_diag V = W F",
            which=("gather",), transposed=True)
    k9_rows(sm.grid_data32[0].interp, 1, torch.float32, "synth",
            "synth exact step")

    # K9's scatter on a skewed CSR: an empty column, one column of 50,000
    # entries and 198 of 100, over 50,000 rows, in both variants (1 and
    # 16 batch rows take the warp variant, 1400 the thread variant):
    # agreement with the plain version and with the warp variant's order
    # in plain PyTorch (both pad every column to the longest, so on at
    # most 16 batch rows), and bit-identical relaunches
    k9_skew = {}
    sk_gen = torch.Generator(device="cpu").manual_seed(SEED + 9)
    sk_deg = torch.full((200,), 100, dtype=torch.int64)
    sk_deg[0], sk_deg[1] = 0, 50000
    sk_ptr = torch.zeros(201, dtype=torch.int64)
    sk_ptr[1:] = torch.cumsum(sk_deg, 0)
    sk_nnz = int(sk_ptr[-1])
    sk_rows = torch.randint(0, 50000, (sk_nnz,), generator=sk_gen,
                            dtype=torch.int32).to(dev)
    sk_csr = (sk_ptr.to(torch.int32).to(dev), sk_rows)
    for dtype in (torch.float32, torch.float64):
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        sk_wt = randn(sk_nnz, dtype=dtype)
        for nb in (1, 16, 1400):
            x = randn(nb, 50000, dtype=dtype)
            out = interp.interp_scatter(*sk_csr, sk_wt, x)
            again = interp.interp_scatter(*sk_csr, sk_wt, x)
            torch.cuda.synchronize()
            variant = interp.scatter_variant(200, sk_nnz, nb)
            e_plain = errors(out[:16], interp.interp_scatter_plain(
                *sk_csr, sk_wt, x[:16]))[1]
            e_lanes = errors(out[:16], interp.interp_scatter_lanes(
                *sk_csr, sk_wt, x[:16]))[1]
            require(torch.equal(out, again), "interp_scatter is not "
                    "deterministic on the skewed CSR")
            require(e_plain <= tol and e_lanes <= tol, "interp_scatter "
                    "disagrees on the skewed CSR (%s, %d batch rows)"
                    % (dtype, nb))
            require(bool((out[:, 0] == 0).all()), "the empty column is "
                    "not zero")
            k9_skew["%s/%d" % (str(dtype).replace("torch.", ""), nb)] = {
                "variant": "warp" if variant == interp.SCATTER_WARP
                else "thread", "plain": e_plain, "lanes": e_lanes}
        del sk_wt, x, out, again
    require({v["variant"] for v in k9_skew.values()} == {"warp", "thread"},
            "the skewed CSR did not run both scatter variants")
    print("kernel interp_scatter on a skewed CSR (200 columns: one empty, "
          "one of 50000 entries): %s, relaunches bit-identical"
          % json.dumps(k9_skew), flush=True)
    del sk_csr, sk_rows
    phase_done("3 models and kernels")

    # ------------------------------------------------------------ phase 4
    model.param_array = params  # fresh caches: the run builds everything
    hopper.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    mu, var = model.predict(txs)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = hopper.launch_counts()
    print("predict (first, builds K_UU, factors, solve): %.3f s, launches %s"
          % (first_s, json.dumps(launches)), flush=True)
    report = dict(model.prediction_report)
    for name in hopper.PREDICT_PATH:
        require(launches[name] > 0, "kernel %s never launched on the path"
                % name)

    t0 = time.time()
    model.predict(txs)
    torch.cuda.synchronize()
    cached_s = time.time() - t0
    model.param_array = params
    t0 = time.time()
    model.predict(txs)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    print("predict (same parameters, factors cached): %.3f s; (parameters "
          "set again, compiled): %.3f s" % (cached_s, warm_s), flush=True)

    def fresh_predict():
        model.param_array = params
        model.predict(txs)

    predict_device_ms, breakdown, profiled_ms = device_profile(fresh_predict)
    idle = (None if predict_device_ms is None
            else 1 - predict_device_ms / profiled_ms)
    print("predict under the profiler: device busy %s of %.3f ms wall "
          "(idle share %s); top device kernels:" % (
              _ms(predict_device_ms), profiled_ms,
              "-" if idle is None else "%.3f" % idle), flush=True)
    for key, count, ms in breakdown[:12]:
        print("  %9.4f ms %5d x  %s" % (ms, count, key[:90]), flush=True)
    predict_layers = by_layer(breakdown)
    print("predict device time by layer:", flush=True)
    print_layers(predict_layers)

    lens = [len(t) for t in txs]
    require([len(a) for a in mu] == lens and [len(a) for a in var] == lens,
            "prediction shapes")
    require(all(np.all(np.isfinite(a)) for a in mu + var),
            "non-finite predictions")
    res = report["explained-variance"]
    print("prediction report:", json.dumps(res), flush=True)
    require(res["residual"] <= TOLERANCE, "certified residual %g > %g"
            % (res["residual"], TOLERANCE))

    t0 = time.time()
    cpu = T.InterpolatedLLGP(xss, yss, functional_kernel=spec, m=[234],
                             tolerance=TOLERANCE, seed=SEED, device="cpu")
    cpu.param_array = params
    mu_c, var_c = cpu.predict(txs)
    cpu_s = time.time() - t0
    mean_err = max(float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))
                   for a, b in zip(mu, mu_c) if len(b))
    var_err = max(float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))
                  for a, b in zip(var, var_c) if len(b))
    smse_untrained = [float(np.mean((a - b) ** 2) / np.var(b))
                      for a, b in zip(mu, tys) if len(b)]
    print("card vs CPU (CPU run %.1f s): mean rel err %.3e, variance rel "
          "err %.3e (tol %g); SMSE per held-out output %s"
          % (cpu_s, mean_err, var_err, PREDICT_RTOL, smse_untrained),
          flush=True)
    require(mean_err <= PREDICT_RTOL and var_err <= PREDICT_RTOL,
            "card and CPU predictions disagree")

    phase_done("4 predict")

    # ------------------------------------------------------------ phase 5
    K_test_X = model._cross_kernel(model._pad_dims(txs))
    rhs = torch.cat([model.y[None], K_test_X], 0)
    wb64 = model._woodbury()
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.time()
    esc = woodbury_pcg(model._kski().matvec, wb64, rhs, tol=TOLERANCE,
                       maxiter=RUNG_MAXITER)
    esc_worst = float(torch.max(esc.error))
    esc_iters = int(torch.max(esc.iterations))
    torch.cuda.synchronize()
    esc_s = time.time() - t0
    esc_launches = hopper.launch_counts()
    print("escalation rung (float64-preconditioned CG, %d rhs): %.3f s, "
          "%d iterations, residual %.3e, launches %s"
          % (rhs.shape[0], esc_s, esc_iters, esc_worst,
             json.dumps(esc_launches)), flush=True)
    for name in hopper.ESCALATION_PATH:
        require(esc_launches[name] > 0,
                "kernel %s never launched on the escalation rung" % name)
    require(esc_worst <= TOLERANCE, "escalation rung residual %g > %g"
            % (esc_worst, TOLERANCE))

    phase_done("5 escalation rung")

    # ------------------------------------------------------------ phase 6
    guard_opt = T.AdaDelta(max_it=10, **OPT_KW)
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.time()
    z2, zfrac = model._validate_exact_objective(guard_opt)
    torch.cuda.synchronize()
    guard_s = time.time() - t0
    guard_launches = hopper.launch_counts()
    print("guard (twin trained <= 10 steps, held-out predict): %.3f s, "
          "z^2 %.6g, zero-variance share %.6g, launches %s"
          % (guard_s, z2, zfrac, json.dumps(guard_launches)), flush=True)
    require(np.isfinite(z2) and np.isfinite(zfrac),
            "guard statistics are not finite")
    for name in hopper.TRAIN_PATH + hopper.PREDICT_PATH:
        require(guard_launches[name] > 0,
                "kernel %s never launched in the guard" % name)

    phase_done("6 guard")

    # ------------------------------------------------------------ phase 7
    tm = T.InterpolatedLLGP(xss, yss, functional_kernel=spec, m=[234],
                            tolerance=TOLERANCE, seed=SEED,
                            objective="exact", device=dev)
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.time()
    info = tm.optimize(T.AdaDelta(**OPT_KW))
    torch.cuda.synchronize()
    train_s = time.time() - t0
    train_launches = hopper.launch_counts()
    step_ms = 1e3 * info["device_seconds"] / info["device_steps"]
    print("train (exact objective, AdaDelta min_grad_ratio=0.2): n_iter "
          "%d (%d device steps), %.3f s wall, %.3f ms per step, max solve "
          "error %.3e, exact_precision %s, launches %s"
          % (info["n_iter"], info["device_steps"], train_s, step_ms,
             info["max_solve_error"], tm.exact_precision,
             json.dumps(train_launches)), flush=True)
    for name in hopper.TRAIN_PATH:
        require(train_launches[name] > 0,
                "kernel %s never launched in training" % name)
    require(np.all(np.isfinite(info["grad_norms"])), "non-finite gradients")
    require(np.all(np.isfinite(tm.param_array)), "non-finite parameters")
    require(tm.objective == "exact", "training left the exact objective")

    # the same training twice more, same process and tree, under
    # torch.use_deterministic_algorithms (CUBLAS_WORKSPACE_CONFIG was set
    # before CUDA started): do the card's float32 trajectories stop at the
    # same iteration, and which library calls does torch still flag as
    # nondeterministic? (a report: the CPU stops at 39)
    import warnings

    reruns, flagged = [], set()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for _ in range(2):
            tm2 = T.InterpolatedLLGP(xss, yss, functional_kernel=spec,
                                     m=[234], tolerance=TOLERANCE, seed=SEED,
                                     objective="exact", device=dev)
            t0 = time.time()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                info2 = tm2.optimize(T.AdaDelta(**OPT_KW))
            torch.cuda.synchronize()
            flagged.update(str(w.message).split("\n")[0][:160]
                           for w in caught)
            reruns.append((int(info2["n_iter"]), time.time() - t0,
                           tm2.param_array))
            del tm2
    finally:
        torch.use_deterministic_algorithms(False)
    stops = [int(info["n_iter"])] + [r[0] for r in reruns]
    det_same = bool(np.array_equal(reruns[0][2], reruns[1][2]))
    print("train again twice under use_deterministic_algorithms: n_iter %s "
          "in %s s; stopping iterations %s on the card (the first without "
          "the setting), 39 on the CPU; the two deterministic runs' "
          "parameters bit-identical: %s (differ by %.3e relative), the "
          "first run's differ from the second's by %.3e; calls torch "
          "flags as nondeterministic: %s"
          % ([r[0] for r in reruns], ["%.3f" % r[1] for r in reruns], stops,
             det_same,
             float(np.max(np.abs(reruns[1][2] - reruns[0][2]))
                   / np.max(np.abs(reruns[0][2]))),
             float(np.max(np.abs(reruns[0][2] - tm.param_array))
                   / np.max(np.abs(tm.param_array))),
             json.dumps(sorted(flagged))), flush=True)
    del reruns

    x_now = tm.param_array
    z0 = np.zeros_like(x_now)
    chunk_ms, chunk_rows, chunk_wall, chunk_split = device_profile(
        lambda: tm._chunk(x_now, z0, z0, z0, T.AdaDelta(**OPT_KW)),
        ranges=True)
    chunk_idle = None if chunk_ms is None else 1 - chunk_ms / chunk_wall
    print("one training chunk (%d steps, exact_precision %s) under the "
          "profiler: device busy %s of %.3f ms wall (idle share %s); top "
          "device kernels:" % (tm.chunk_len, tm.exact_precision,
                               _ms(chunk_ms), chunk_wall,
                               "-" if chunk_idle is None
                               else "%.3f" % chunk_idle), flush=True)
    for key, count, ms in chunk_rows[:12]:
        print("  %9.4f ms %5d x  %s" % (ms, count, key[:90]), flush=True)
    step_layers = by_layer(chunk_rows, per=tm.chunk_len)
    print("training step device time by layer (per step):", flush=True)
    print_layers(step_layers)
    print_k3_bwd("fx2007 training", step_layers)
    require_layers(step_layers, ("K1", "K1 backward", K9_LAYER),
                   "an fx2007 training step")
    require("trsm (cuBLAS)" not in step_layers, "an fx2007 training step "
            "ran cuBLAS's trsm: a solve left the hand kernels")
    print("training step device time inside the Woodbury solve with C and "
          "the jittered Cholesky (per step):", flush=True)
    print_split(chunk_split, per=tm.chunk_len)
    require(COPY_LAYER not in chunk_split[RANGES[1]], "an fx2007 training "
            "step copied on the card inside chol_jittered")
    chunk_sources = elementwise_sources(
        lambda: tm._chunk(x_now, z0, z0, z0, T.AdaDelta(**OPT_KW)),
        per=tm.chunk_len)[0]
    print("training step elementwise layer by source (per step):",
          flush=True)
    print_layers(chunk_sources)
    with ladder_log(wbm) as lad:
        tm._chunk(x_now, z0, z0, z0, T.AdaDelta(**OPT_KW))
    train_ladder = ladder_summary(lad, tm.chunk_len)
    print("training step jittered Cholesky (K3): %s" % json.dumps(
        train_ladder), flush=True)
    # least times of the library-routed layers per call, from this cell's
    # shapes (one group, float32): K2 the capacitance assembly, K3 the
    # two Cholesky factorizations (K_UU and C), K4 one W or W^T apply of
    # one vector, K5 one solve with C on 1 (training) and 151 (predict)
    # columns. A training step runs each forward once and its backward,
    # about twice the forward's operations, through the same libraries.
    gd0 = tm.grid_data[0]
    Dg, mg = len(xss), int(np.prod(gd0.plan.sizes))
    dmg, ng = Dg * mg, len(tm.data.y)
    f32 = torch.float32
    k2fb, k2fo, k2bb, k2bo, _ = k2_work(tm.grid_data32, 4)
    taps = tm.grid_data[0].interp.indices.shape[1]
    layer_bounds = {
        "K2 capacitance (structured)": bound_ms(k2fb, k2fo, f32),
        "K2 backward (structured)": bound_ms(k2bb, k2bo, f32),
        "K3 Cholesky (K_UU and C)": bound_ms(
            4 * dmg * dmg * 4, 2 * dmg ** 3 / 3.0, f32),
        "K4 W apply through K9 (one vector)": bound_ms(
            (ng * taps * 2 + ng + dmg) * 4, 2.0 * ng * taps, f32),
        "K4 W apply through K9 (151 vectors)": bound_ms(
            (ng * taps * 2 + 151 * (ng + dmg)) * 4, 2.0 * ng * taps * 151,
            f32),
        "K5 solve with C (1 column)": bound_ms(
            (dmg * dmg + 2 * dmg) * 4, 2.0 * dmg * dmg, f32),
        "K5 solve with C (151 columns)": bound_ms(
            (dmg * dmg + 2 * dmg * 151) * 4, 2.0 * dmg * dmg * 151, f32),
    }
    for name, (bms, by) in layer_bounds.items():
        print("bound %-30s %.4f ms (%s)" % (name, bms, by), flush=True)

    t0 = time.time()
    mu_t, var_t = tm.predict(txs)
    torch.cuda.synchronize()
    trained_predict_s = time.time() - t0
    trained_res = tm.prediction_report["explained-variance"]
    require(all(np.all(np.isfinite(a)) for a in mu_t + var_t),
            "non-finite predictions after training")
    require(trained_res["residual"] <= TOLERANCE,
            "trained model's certified residual %g > %g"
            % (trained_res["residual"], TOLERANCE))
    trained_smse = smse(tys, mu_t, yss)
    trained_nlpd = nlpd(tys, mu_t, var_t)
    print("trained predict: %.3f s, report %s; on the synthetic "
          "fx2007-shaped data: SMSE %.6g, NLPD %.6g"
          % (trained_predict_s, json.dumps(trained_res), trained_smse,
             trained_nlpd), flush=True)

    phase_done("7 train")

    # ------------------------------------------------------------ phase 8
    t0 = time.time()
    gm = T.InterpolatedLLGP(xss, yss, functional_kernel=spec, m=[234],
                            tolerance=TOLERANCE, seed=SEED,
                            objective="exact", device=dev)
    cm = T.InterpolatedLLGP(xss, yss, functional_kernel=spec, m=[234],
                            tolerance=TOLERANCE, seed=SEED,
                            objective="exact", device="cpu")
    x0 = np.asarray(params, dtype=float)
    z0 = np.zeros_like(x0)

    def rel(a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        require(np.all(np.isfinite(a)) and np.all(np.isfinite(b)),
                "non-finite training output")
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    g_card = gm._exact_grad(torch.as_tensor(x0, device=dev))[0].cpu()
    g_cpu = cm._exact_grad(torch.as_tensor(x0))[0]
    grad_err = rel(g_card.numpy(), g_cpu.numpy())
    opt = T.AdaDelta(**OPT_KW)
    f32_card = gm._chunk(x0, z0, z0, z0, opt, n_steps=CPU_CHUNK_STEPS)
    f32_cpu = cm._chunk(x0, z0, z0, z0, opt, n_steps=CPU_CHUNK_STEPS)
    f32_err = rel(f32_card[0][-1], f32_cpu[0][-1])
    gm.exact_precision = cm.exact_precision = "model"
    torch.cuda.synchronize()
    hopper.reset_launches()
    f64_card = gm._chunk(x0, z0, z0, z0, opt, n_steps=CPU_CHUNK_STEPS)
    torch.cuda.synchronize()
    mp_launches = hopper.launch_counts()
    f64_cpu = cm._chunk(x0, z0, z0, z0, opt, n_steps=CPU_CHUNK_STEPS)
    f64_err = rel(f64_card[0][-1], f64_cpu[0][-1])
    print("card vs CPU training (%.1f s; %d-step chunks): first gradient "
          "rel err %.3e, f32 chunk parameters %.3e (tol %g), "
          "model-precision chunk parameters %.3e (tol %g); "
          "model-precision launches %s"
          % (time.time() - t0, CPU_CHUNK_STEPS, grad_err, f32_err,
             TRAIN_RTOL, f64_err, MODEL_RTOL, json.dumps(mp_launches)),
          flush=True)
    for name in hopper.MODEL_PRECISION_PATH:
        require(mp_launches[name] > 0,
                "kernel %s never launched at model precision" % name)
    require(grad_err <= TRAIN_RTOL and f32_err <= TRAIN_RTOL,
            "card and CPU float32 training disagree")
    require(f64_err <= MODEL_RTOL,
            "card and CPU model-precision training disagree")

    phase_done("8 card vs CPU training")

    # ----------------------------------------------------------- phase 8b
    # reporting on the model phase 7 trained, each against the port's CPU
    # run at the same parameters: the exact log-likelihood (K7, cuSOLVER;
    # n <= LARGE_N_EXACT_REPORT), the Woodbury one, the exact oracle's
    # value and gradient (K7's backward), the 'exact' and 'precompute'
    # prediction modes; then a fresh metrics=True model for 3 steps and
    # ExactLMC
    tx = tm.param_array
    ct = T.InterpolatedLLGP(xss, yss, functional_kernel=spec, m=[234],
                            tolerance=TOLERANCE, seed=SEED,
                            objective="exact", device="cpu")
    ct.param_array = tx
    tm.param_array = tx  # fresh caches: the calls below build everything
    torch.cuda.synchronize()
    hopper.reset_launches()
    report_s = {}
    t0 = time.time()
    ll_exact = tm.log_likelihood()
    torch.cuda.synchronize()
    report_s["log_likelihood_exact"] = time.time() - t0
    t0 = time.time()
    ll_ski = tm.log_likelihood(exact=False)
    torch.cuda.synchronize()
    report_s["log_likelihood_woodbury"] = time.time() - t0
    t0 = time.time()
    ev, eg = tm.exact_log_likelihood_and_grad()
    torch.cuda.synchronize()
    report_s["exact_log_likelihood_and_grad"] = time.time() - t0
    rep_launches = hopper.launch_counts()
    for name in hopper.REPORT_PATH:
        require(rep_launches[name] > 0,
                "kernel %s never launched on the report path" % name)
    report_dev = {
        "exact_log_likelihood_and_grad": device_profile(
            tm.exact_log_likelihood_and_grad)[0],
        "log_det_K": device_profile(
            lambda: (tm._cache.pop("chol", None), tm.log_det_K()))[0],
    }
    t0 = time.time()
    cpu_vals = (ct.log_likelihood(), ct.log_likelihood(exact=False),
                ct.exact_log_likelihood_and_grad())
    cpu_report_s = time.time() - t0
    report_err = {
        "log_likelihood_exact": abs(ll_exact - cpu_vals[0])
        / abs(cpu_vals[0]),
        "log_likelihood_woodbury": abs(ll_ski - cpu_vals[1])
        / abs(cpu_vals[1]),
        "exact_value": abs(ev - cpu_vals[2][0]) / abs(cpu_vals[2][0]),
        "exact_grad": rel(eg, cpu_vals[2][1]),
    }
    print("report (fx2007, trained): log_likelihood exact %.10g (%.3f s), "
          "Woodbury %.10g (%.3f s), exact value %.10g and gradient (%.3f s,"
          " device %s and log_det_K device %s); card vs CPU (%.1f s) %s "
          "(tol %g); launches %s"
          % (ll_exact, report_s["log_likelihood_exact"], ll_ski,
             report_s["log_likelihood_woodbury"], ev,
             report_s["exact_log_likelihood_and_grad"],
             _ms(report_dev["exact_log_likelihood_and_grad"]),
             _ms(report_dev["log_det_K"]), cpu_report_s,
             json.dumps(report_err), REPORT_RTOL, json.dumps(rep_launches)),
          flush=True)
    require(all(v <= REPORT_RTOL for v in report_err.values()),
            "card and CPU reports disagree")
    # loo_zsq at the trained parameters (kinv_diag: one K5 triangle of
    # n right-hand sides): the model-dtype factor's against the CPU, then
    # a float32 copy's, whose float32 factor is kinv_diag's float32 path
    loo = {"card": tm.loo_zsq(), "cpu": ct.loo_zsq()}
    loo["rel_err"] = abs(loo["card"] - loo["cpu"]) / abs(loo["cpu"])
    t32 = T.InterpolatedLLGP(xss, yss, functional_kernel=spec, m=[234],
                             tolerance=TOLERANCE, seed=SEED,
                             objective="exact", dtype=torch.float32,
                             device=dev)
    t32.param_array = tx
    torch.cuda.synchronize()
    hopper.reset_launches()
    loo["float32"] = t32.loo_zsq()
    torch.cuda.synchronize()
    loo32_launches = hopper.launch_counts()
    del t32
    print("loo_zsq (fx2007, trained): card %.12g, CPU %.12g (rel err %.3e, "
          "tol %g); float32 copy %.8g, launches %s"
          % (loo["card"], loo["cpu"], loo["rel_err"], REPORT_RTOL,
             loo["float32"], json.dumps(loo32_launches)), flush=True)
    require(loo["rel_err"] <= REPORT_RTOL and np.isfinite(loo["float32"]),
            "loo_zsq: card and CPU disagree, or a non-finite float32 one")

    def pred_err(card_out, cpu_out):
        return max(float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))
                   for a, b in zip(card_out[0] + card_out[1],
                                   cpu_out[0] + cpu_out[1]) if len(b))

    mode_err = {}
    for mode in ("exact", "precompute"):
        tm.prediction = mode
        t0 = time.time()
        out_m = tm.predict(txs)
        torch.cuda.synchronize()
        report_s["predict_" + mode] = time.time() - t0
        require(all(np.all(np.isfinite(a)) for a in out_m[0] + out_m[1]),
                "non-finite %s predictions" % mode)
        for what, rep_ in tm.prediction_report.items():
            require(rep_["residual"] <= TOLERANCE, "%s: residual %g > %g"
                    % (what, rep_["residual"], TOLERANCE))
        if mode == "exact":
            ct.prediction = mode
            mode_err[mode] = pred_err(out_m, ct.predict(txs))
    nu_report = dict(tm.prediction_report["precompute-nu"])
    # the full-width nu of 'precompute' (nu_j = c_j^T K^-1 c_j, c_j the
    # j-th column of K_XU) against NU_COLS seeded grid columns solved on
    # the CPU by the same certified solve
    nu_card = tm._precomputed_nu().cpu()
    tm.prediction = "on-the-fly"
    cgrp = ct._kski().groups[0]
    Dm_fx = cgrp.interp.ncols
    js = np.sort(np.random.RandomState(SEED).choice(Dm_fx, NU_COLS,
                                                    replace=False))
    E = torch.zeros(NU_COLS, Dm_fx, dtype=torch.float64)
    E[np.arange(NU_COLS), js] = 1.0
    cols = cgrp.interp.matvec(cgrp.grid_matvec(E))
    nu_sols, _ = ct._solve_certified(cols, "nu-check")
    nu_cpu = torch.sum(cols * nu_sols, dim=1)
    mode_err["precompute nu (%d grid columns)" % NU_COLS] = float(
        torch.max(torch.abs(nu_card[js] - nu_cpu)) / torch.max(nu_cpu.abs()))
    del ct, cgrp, E, cols, nu_sols
    # 'precompute' card vs CPU on a reduced copy (every PRE_SUBSAMPLE-th
    # training point, m=PRE_M): its solve of Dm=3094 right-hand sides
    # takes the CPU about 100 s at full width
    rxs = [x[::PRE_SUBSAMPLE] for x in xss]
    rys = [y[::PRE_SUBSAMPLE] for y in yss]
    pkw = dict(functional_kernel=spec, m=PRE_M, tolerance=TOLERANCE,
               seed=SEED, objective="exact", prediction="precompute")
    pg = T.InterpolatedLLGP(rxs, rys, device=dev, **pkw)
    pc = T.InterpolatedLLGP(rxs, rys, device="cpu", **pkw)
    pg.param_array = pc.param_array = tx
    mode_err["precompute (reduced)"] = pred_err(pg.predict(txs),
                                                pc.predict(txs))
    print("predict modes (fx2007, trained, 150 points): exact %.3f s, "
          "precompute %.3f s (Dm=%d right-hand sides, report %s); card vs "
          "CPU rel err %s (precompute on 1/%d of the training points, m=%s,"
          " Dm=%d; tol %g)"
          % (report_s["predict_exact"], report_s["predict_precompute"],
             tm.grid_data[0].interp.ncols, json.dumps(nu_report),
             json.dumps(mode_err), PRE_SUBSAMPLE, PRE_M,
             pg.grid_data[0].interp.ncols, PREDICT_RTOL), flush=True)
    require(all(v <= PREDICT_RTOL for v in mode_err.values()),
            "card and CPU prediction modes disagree")
    del pg, pc

    mm = T.InterpolatedLLGP(xss, yss, functional_kernel=spec, m=[234],
                            tolerance=TOLERANCE, seed=SEED,
                            objective="exact", metrics=True, device=dev)
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.time()
    minfo = mm.optimize(T.AdaDelta(max_it=3, **OPT_KW))
    torch.cuda.synchronize()
    report_s["metrics_3_steps"] = time.time() - t0
    met_launches = hopper.launch_counts()
    met = {k: list(map(float, getattr(mm.metrics, k)))
           for k in ("iterations", "solv_error", "grad_norms", "grad_error",
                     "log_likely")}
    print("metrics=True training (3 steps, %.3f s): %s, launches %s"
          % (report_s["metrics_3_steps"], json.dumps(met),
             json.dumps(met_launches)), flush=True)
    for name in hopper.METRICS_PATH:
        require(met_launches[name] > 0,
                "kernel %s never launched in metrics training" % name)
    require(minfo["n_iter"] == 3 and all(
        len(v) == 3 and np.all(np.isfinite(v)) for v in met.values()),
        "metrics lists")
    del mm

    el = T.ExactLMC(xss, yss, functional_kernel=spec, seed=SEED, device=dev)
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.time()
    el_ll0 = el.log_likelihood()
    el_res = el.optimize(max_iters=10)
    el_mu, el_var = el.predict(txs)
    torch.cuda.synchronize()
    report_s["exact_lmc"] = time.time() - t0
    el_launches = hopper.launch_counts()
    el_ll = el.log_likelihood()
    el_smse = smse(tys, el_mu, yss)
    print("ExactLMC (L-BFGS-B, 10 iterations: nit %d, nfev %d; %.3f s): "
          "log-likelihood %.10g -> %.10g; predict SMSE %.6g on the "
          "synthetic data; launches %s"
          % (el_res.nit, el_res.nfev, report_s["exact_lmc"], el_ll0, el_ll,
             el_smse, json.dumps(el_launches)), flush=True)
    for name in hopper.REPORT_PATH:
        require(el_launches[name] > 0,
                "kernel %s never launched by ExactLMC" % name)
    require(np.isfinite(el_ll) and el_ll >= el_ll0
            and all(np.all(np.isfinite(a)) for a in el_mu + el_var),
            "ExactLMC fit or predict")
    del el
    phase_done("8b fx2007 reporting")

    # ------------------------------------------------------------ phase 9
    # stochastic training of the weather fft model to its stopping rule
    w_init = wm.param_array
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.time()
    winfo = wm.optimize(T.AdaDelta())
    torch.cuda.synchronize()
    wtrain_s = time.time() - t0
    st_launches = hopper.launch_counts()
    wstep_ms = 1e3 * winfo["device_seconds"] / winfo["device_steps"]
    adopt = wm._gradient_adopt_bound
    print("train (stochastic objective, fft, AdaDelta defaults): n_iter %d "
          "(%d device steps), %.3f s wall, %.3f ms per step, mean solve "
          "iters %.2f (with cuBLAS solves: 257.3 ms per step, 7.56 "
          "iterations), "
          "max solve error %.3e (adopt bound %.3g), rescued chunks %d, "
          "launches %s"
          % (winfo["n_iter"], winfo["device_steps"], wtrain_s, wstep_ms,
             winfo["mean_solve_iters"], winfo["max_solve_error"], adopt,
             winfo["rescued_chunks"], json.dumps(st_launches)), flush=True)
    for name in hopper.STOCHASTIC_PATH:
        require(st_launches[name] > 0,
                "kernel %s never launched in stochastic training" % name)
    require(np.all(np.isfinite(winfo["grad_norms"])), "non-finite gradients")
    require(np.all(np.isfinite(wm.param_array)), "non-finite parameters")
    require(wm.objective == "stochastic", "training left the stochastic "
            "objective")
    require(winfo["max_solve_error"] <= adopt, "training solves above the "
            "adopt bound")
    wx_now = wm.param_array
    wz = np.zeros_like(wx_now)
    wchunk_ms, wchunk_rows, wchunk_wall, wchunk_split = device_profile(
        lambda: wm._chunk(wx_now, wz, wz, wz, T.AdaDelta(), run_seed=SEED),
        ranges=True)
    wchunk_idle = None if wchunk_ms is None else 1 - wchunk_ms / wchunk_wall
    print("one stochastic chunk (%d steps) under the profiler: device busy "
          "%s of %.3f ms wall (idle share %s); top device kernels:"
          % (wm.chunk_len, _ms(wchunk_ms), wchunk_wall,
             "-" if wchunk_idle is None else "%.3f" % wchunk_idle),
          flush=True)
    for key, count, ms in wchunk_rows[:12]:
        print("  %9.4f ms %5d x  %s" % (ms, count, key[:90]), flush=True)
    wstep_layers = by_layer(wchunk_rows, per=wm.chunk_len)
    print("stochastic step device time by layer (per step):", flush=True)
    print_layers(wstep_layers)
    require_layers(wstep_layers, ("K1", "K10", K9_LAYER, K8_BWD_LAYER),
                   "a weather stochastic step")
    print("stochastic step device time inside the Woodbury solve with C "
          "and the jittered Cholesky (per step):", flush=True)
    print_split(wchunk_split, per=wm.chunk_len)
    require(COPY_LAYER not in wchunk_split[RANGES[1]], "a weather training "
            "step copied on the card inside chol_jittered")
    wchunk_sources = elementwise_sources(
        lambda: wm._chunk(wx_now, wz, wz, wz, T.AdaDelta(), run_seed=SEED),
        per=wm.chunk_len)[0]
    print("stochastic step elementwise layer by source (per step):",
          flush=True)
    print_layers(wchunk_sources)
    with ladder_log(wbm) as lad:
        wm._chunk(wx_now, wz, wz, wz, T.AdaDelta(), run_seed=SEED)
    stoch_ladder = ladder_summary(lad, wm.chunk_len)
    print("stochastic step jittered Cholesky (K3): %s" % json.dumps(
        stoch_ladder), flush=True)
    # the same training (same start, same probe stream) with the float32
    # preconditioner's C by the dense cuBLAS products instead of K2: the
    # PCG iterations follow C's rounding. The wall per step is the host's
    # clock over the chunks (info's device_seconds / device_steps)
    wopt = T.AdaDelta()
    wz0 = np.zeros_like(w_init)
    wm.param_array = w_init
    with library_capacitance(wbm):
        linfo = wm.optimize(wopt, state=dict(
            gms=wz0, sms=wz0, step=wz0, rolling_max=0.0,
            drops=wopt.permitted_drops, n_iter=0,
            rng_key=winfo["state"]["rng_key"]))
    wm.param_array = wx_now
    wab = {}
    for what, inf_ in (("k2", winfo), ("library", linfo)):
        wab[what] = {
            "n_iter": int(inf_["n_iter"]),
            "mean_solve_iters": float(inf_["mean_solve_iters"]),
            "chunk_wall_ms_per_step": 1e3 * inf_["device_seconds"]
            / inf_["device_steps"]}
        print("weather training, preconditioner C by %-7s: n_iter %d, "
              "mean PCG iterations per solve %.4f, chunk wall %.3f ms per "
              "step" % (what, wab[what]["n_iter"],
                        wab[what]["mean_solve_iters"],
                        wab[what]["chunk_wall_ms_per_step"]), flush=True)
    require(wab["k2"]["mean_solve_iters"] <= WEATHER_PCG_MAX,
            "PCG iterations per weather solve %.4f above %.2f"
            % (wab["k2"]["mean_solve_iters"], WEATHER_PCG_MAX))
    require(np.all(np.isfinite(linfo["grad_norms"])),
            "non-finite gradients with the library capacitance")

    phase_done("9 stochastic training")

    # ----------------------------------------------------------- phase 10
    # predict the two held-out windows with the trained fft model
    hopper.reset_launches()
    t0 = time.time()
    wmu, wvar = wm.predict(wtx)
    torch.cuda.synchronize()
    wpredict_s = time.time() - t0
    fp_launches = hopper.launch_counts()
    wreport = dict(wm.prediction_report)
    print("predict (fft, %d held-out points): %.3f s, report %s, launches %s"
          % (sum(len(t) for t in wtx), wpredict_s, json.dumps(wreport),
             json.dumps(fp_launches)), flush=True)
    for name in hopper.FFT_PREDICT_PATH:
        require(fp_launches[name] > 0,
                "kernel %s never launched in the fft predict" % name)
    require(all(np.all(np.isfinite(a)) for a in wmu + wvar),
            "non-finite fft predictions")
    for what, rep in wreport.items():
        require(rep["residual"] <= wm.tolerance, "%s: certified residual %g "
                "> %g" % (what, rep["residual"], wm.tolerance))
    wsmse = smse(wty, wmu, wy)
    wnlpd = nlpd(wty, wmu, wvar)
    print("on the synthetic weather-shaped data: SMSE %.6g, NLPD %.6g"
          % (wsmse, wnlpd), flush=True)

    phase_done("10 fft predict")

    # ----------------------------------------------------------- phase 10b
    # reporting on the trained weather model (n=15768 > 5000): the default
    # log-likelihood is the SKI one, the SLQ log-det of the fft operator
    # (15 probes, 40 Lanczos steps: K13 and K10); then the exact dense one
    # (K7 at (n, n), a 2 GB float64 Cholesky) and the exact oracle's
    # value and gradient (K7 and its backward at (n, n)); wall and device
    # time of each
    wrep_s, wrep_dev = {}, {}
    wx_tr = wm.param_array
    wm.param_array = wx_tr  # fresh caches
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.time()
    wll_slq = wm.log_likelihood()
    torch.cuda.synchronize()
    wrep_s["log_likelihood_slq"] = time.time() - t0
    slq_launches = hopper.launch_counts()
    for name in hopper.SLQ_PATH:
        require(slq_launches[name] > 0,
                "kernel %s never launched by the SLQ log-det" % name)
    wslq = wm.ski_log_det()
    t0 = time.time()
    wm._cache.pop("slq_logdet")
    wm.ski_log_det()
    torch.cuda.synchronize()
    wrep_s["ski_log_det_slq"] = time.time() - t0
    wrep_dev["ski_log_det_slq"], slq_rows, slq_wall = device_profile(
        lambda: (wm._cache.pop("slq_logdet"), wm.ski_log_det()))
    slq_layers = by_layer(slq_rows)
    t0 = time.time()
    wll_exact = wm.log_likelihood(exact=True)
    torch.cuda.synchronize()
    wrep_s["log_likelihood_exact"] = time.time() - t0
    wrep_dev["log_det_K"] = device_profile(
        lambda: (wm._cache.pop("chol"), wm.log_det_K()))[0]
    wm._cache.pop("chol")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.time()
    wev, weg = wm.exact_log_likelihood_and_grad()
    torch.cuda.synchronize()
    wrep_s["exact_log_likelihood_and_grad"] = time.time() - t0
    wexact_launches = hopper.launch_counts()
    for name in hopper.REPORT_PATH:
        require(wexact_launches[name] > 0,
                "kernel %s never launched by the exact oracle at n=%d"
                % (name, wn))
    wexact_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wrep_dev["exact_log_likelihood_and_grad"], wexact_rows, _ = \
        device_profile(wm.exact_log_likelihood_and_grad)
    wexact_layers = by_layer(wexact_rows)
    require_layers(wexact_layers, ("K7", "K7 backward"), "the weather exact "
                   "value and gradient")
    require(all(np.isfinite(v) for v in (wll_slq, wll_exact, wev))
            and np.all(np.isfinite(weg)), "non-finite weather reports")
    print("report (weather, trained, n=%d): log_likelihood (SLQ) %.10g "
          "(%.3f s; SLQ log-det %.10g alone %.3f s, device %s of %.3f ms "
          "profiled), exact %.10g (%.3f s; log_det_K device %s), exact "
          "value %.10g and gradient (%.3f s, device %s, peak %.2f GB)"
          % (wn, wll_slq, wrep_s["log_likelihood_slq"], wslq,
             wrep_s["ski_log_det_slq"], _ms(wrep_dev["ski_log_det_slq"]),
             slq_wall, wll_exact, wrep_s["log_likelihood_exact"],
             _ms(wrep_dev["log_det_K"]), wev,
             wrep_s["exact_log_likelihood_and_grad"],
             _ms(wrep_dev["exact_log_likelihood_and_grad"]),
             wexact_peak_gb), flush=True)
    print("SLQ log-det device time by layer:", flush=True)
    print_layers(slq_layers)
    require_layers(slq_layers, ("K13",), "the weather SLQ log-det")
    print("exact value and gradient (n=%d) device time by layer:" % wn,
          flush=True)
    print_layers(wexact_layers)
    wm.param_array = wx_tr  # drop the (n, n) factors

    # the oracle's gradient in closed form (likelihood.ExactMLL: potri,
    # then K7's backward with the rank-1 term in its loads) against the
    # autograd route it replaces (exact_mll_autograd: torch's Cholesky
    # backward), at the trained parameters, n=15768, float64: value,
    # gradient, wall, device time by layer and peak memory of each
    def oracle_grad(fn):
        x_ = torch.as_tensor(wm.param_array, dtype=wm.dtype,
                             device=dev).requires_grad_(True)
        with torch.enable_grad():
            v_ = fn(wm.spec, unravel_params(x_, wm.params), wm.X, wm.oidx,
                    wm.y)
            (g_,) = torch.autograd.grad(v_, x_)
        return float(v_.detach()), g_.cpu().numpy()

    oracle = {}
    for what, fn in (("closed_form", lk.exact_mll),
                     ("autograd_route", exact_mll_autograd)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        v_, g_ = oracle_grad(fn)
        torch.cuda.synchronize()
        o_wall = time.time() - t0
        o_peak = torch.cuda.max_memory_allocated() / 1e9
        o_dev, o_rows, _ = device_profile(lambda fn=fn: oracle_grad(fn))
        oracle[what] = {"value": v_, "grad": g_, "wall_s": o_wall,
                        "device_ms": o_dev, "peak_gb": o_peak,
                        "layers": by_layer(o_rows)}
    oracle_err = {
        "value": abs(oracle["closed_form"]["value"]
                     - oracle["autograd_route"]["value"])
        / abs(oracle["autograd_route"]["value"]),
        "grad": rel(oracle["closed_form"]["grad"],
                    oracle["autograd_route"]["grad"])}
    for what in oracle:
        print("oracle gradient (n=%d) by the %s: %.3f s wall, device %s, "
              "peak %.2f GB; device time by layer:"
              % (wn, what.replace("_", " "), oracle[what]["wall_s"],
                 _ms(oracle[what]["device_ms"]), oracle[what]["peak_gb"]),
              flush=True)
        print_layers(oracle[what]["layers"])
        require_layers(oracle[what]["layers"], ("K7",),
                       "the oracle gradient by the " + what)
        oracle[what].pop("grad")
    print("oracle closed form against the autograd route: value rel err "
          "%.3e, gradient rel err %.3e (tol %g)"
          % (oracle_err["value"], oracle_err["grad"], ORACLE_GRAD_RTOL),
          flush=True)
    require(oracle_err["grad"] <= ORACLE_GRAD_RTOL
            and oracle_err["value"] <= ORACLE_GRAD_RTOL,
            "the oracle's closed-form gradient disagrees with the autograd "
            "route")
    # where the rank-1 term is formed: in K7's backward loads (the port's)
    # or by one elementwise pass, torch.addr, before it
    with torch.no_grad():
        kin = (wm.X, wm.oidx, wm.X, wm.oidx, wm.spec.coreg_mats(wm.params)) \
            + wm.spec.kernel_table(wm.params)
        Lo = lk._chol_or_nan(lk.exact_dense_K(wm.spec, wm.params, wm.X,
                                              wm.oidx))
        ao = trsm.cho_solve(Lo, wm.y[None])[0]
        Kinv = torch.cholesky_inverse(Lo)
        fused = cross.cross_kernel_bwd(*kin, Kinv, alpha=ao)
        apart = cross.cross_kernel_bwd(*kin, torch.addr(Kinv, ao, ao,
                                                        alpha=-1.0))
        rank1_err = errors(fused, apart)[1]
        rank1_same = all(torch.equal(a, b) for a, b in zip(
            fused, cross.cross_kernel_bwd(*kin, Kinv, alpha=ao)))
        require(rank1_same, "K7 bwd's rank-1 form relaunch differs")
        rank1 = {
            "rel_err": rank1_err, "bit_identical": rank1_same,
            "potri_ms": cuda_time(lambda: torch.cholesky_inverse(Lo), reps=3,
                                  warm=1),
            "fused_ms": cuda_time(lambda: cross.cross_kernel_bwd(
                *kin, Kinv, alpha=ao), reps=3, warm=1),
            "addr_then_k7_ms": cuda_time(lambda: cross.cross_kernel_bwd(
                *kin, torch.addr(Kinv, ao, ao, alpha=-1.0)), reps=3, warm=1),
            "addr_ms": cuda_time(lambda: torch.addr(Kinv, ao, ao,
                                                    alpha=-1.0), reps=3,
                                 warm=1)}
        del Lo, ao, Kinv, fused, apart, kin
    print("oracle rank-1 term: in K7's backward loads %.3f ms, by torch.addr "
          "then K7's backward %.3f ms (addr alone %.3f ms); potri %.3f ms; "
          "results rel err %.3e (tol 1e-12)"
          % (rank1["fused_ms"], rank1["addr_then_k7_ms"], rank1["addr_ms"],
             rank1["potri_ms"], rank1_err), flush=True)
    require(rank1_err <= 1e-12, "the rank-1 term in K7's loads disagrees "
            "with the explicit cotangent")
    oracle["rank1"] = rank1
    oracle["rel_err"] = oracle_err
    phase_done("10b weather reporting")

    # ----------------------------------------------------------- phase 11
    # the plain float64 MINRES rung of the certified solve, on its own,
    # then one step of the training rescue's first rung
    wrhs = torch.cat([wm.y[None], wm._probes(SEED, 0)], 0)
    wK = wm._kski()
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.time()
    mres = batched_minres(wK.matvec, wrhs, tol=wm.tolerance,
                          maxiter=RUNG_MAXITER, cycle=KRYLOV_CYCLE,
                          stall_ratio=0.999)
    mres_worst = float(torch.max(mres.error))
    mres_iters = int(torch.max(mres.iterations))
    torch.cuda.synchronize()
    mres_s = time.time() - t0
    mr_launches = hopper.launch_counts()
    print("MINRES rung (plain float64, %d rhs): %.3f s, %d iterations, "
          "residual %.3e (tolerance %g), launches %s"
          % (wrhs.shape[0], mres_s, mres_iters, mres_worst, wm.tolerance,
             json.dumps(mr_launches)), flush=True)
    for name in hopper.MINRES_PATH:
        require(mr_launches[name] > 0,
                "kernel %s never launched on the MINRES rung" % name)
    require(mres_worst <= wm.tolerance, "MINRES rung residual %g > %g"
            % (mres_worst, wm.tolerance))
    # the rung's first cycle, profiled: K12 must show as its own layer
    mres_layers = rung_cycle_layers(wK.matvec, wrhs, wm.tolerance)
    print("MINRES rung, first %d-iteration cycle by layer:" % KRYLOV_CYCLE,
          flush=True)
    print_layers(mres_layers)
    require_layers(mres_layers, ("K12",), "the MINRES rung's first cycle")
    t0 = time.time()
    rsc = wm._chunk(wx_now, wz, wz, wz, T.AdaDelta(), n_steps=1,
                    run_seed=SEED, rescue=True)
    rescue_s = time.time() - t0
    require(all(np.all(np.isfinite(a)) for a in rsc),
            "non-finite rescue step")
    print("rescue rung-1 step (plain MINRES, budget %d): %.3f s, %d "
          "iterations, residual %.3e" % (min(4 * wn, 500), rescue_s,
                                         int(rsc[5][0]), float(rsc[6][0])),
          flush=True)

    phase_done("11 MINRES rung and rescue step")

    # ----------------------------------------------------------- phase 12
    # the same objective on a dense grid (weather's headline m=500)
    dm_ = T.InterpolatedLLGP(wx, wy, functional_kernel=wspec,
                             m=WEATHER_DENSE_M, objective="stochastic",
                             seed=SEED, device=dev)
    require(all(g.plan.mode == "dense" for g in dm_.grid_data),
            "the m=500 grid is not dense")
    dx0 = dm_.param_array
    dz = np.zeros_like(dx0)
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.time()
    dout = dm_._chunk(dx0, dz, dz, dz, T.AdaDelta(), run_seed=SEED)
    torch.cuda.synchronize()
    dense_s = time.time() - t0
    ds_launches = hopper.launch_counts()
    print("dense stochastic chunk (m=500, Dm=%d, %d steps): %.3f s, solve "
          "iters %s, residuals max %.3e, launches %s"
          % (dm_.grid_data[0].interp.ncols, len(dout[0]), dense_s,
             np.asarray(dout[5]).tolist(), float(np.max(dout[6])),
             json.dumps(ds_launches)), flush=True)
    for name in hopper.DENSE_STOCHASTIC_PATH:
        require(ds_launches[name] > 0,
                "kernel %s never launched in the dense stochastic chunk"
                % name)
    require(all(np.all(np.isfinite(a)) for a in dout),
            "non-finite dense stochastic chunk")
    del dm_

    phase_done("12 dense stochastic chunk")

    # ----------------------------------------------------------- phase 13
    # card vs CPU, stochastic objective on fft grids, with fed probes
    t0 = time.time()
    sx = [x[::STOCH_SUBSAMPLE] for x in wx]
    sy = [y[::STOCH_SUBSAMPLE] for y in wy]
    skw = dict(functional_kernel=wspec, m=STOCH_M, grid_mode="fft",
               objective="stochastic", tolerance=STOCH_TOL, seed=SEED)
    sg = T.InterpolatedLLGP(sx, sy, device=dev, **skw)
    sc = T.InterpolatedLLGP(sx, sy, device="cpu", **skw)
    require(len(sc.data.y) == sn, "the reduced copy's n is not phase 3's")

    def fed(run_seed, it):
        r = np.random.RandomState(1000 + it)
        return np.where(r.uniform(size=(sc.n_probes, sn)) < 0.5, -1.0, 1.0)

    sg.probe_stream = sc.probe_stream = fed
    sx0 = sc.param_array + 0.1 * np.sin(np.arange(sc.n_params))
    sz = np.zeros_like(sx0)
    g_card = sg._stochastic_grad(torch.as_tensor(sx0, device=dev),
                                 sg._probes(0, 0))[0].cpu().numpy()
    g_cpu = sc._stochastic_grad(torch.as_tensor(sx0),
                                sc._probes(0, 0))[0].numpy()
    sgrad_err = rel(g_card, g_cpu)
    s_card = sg._chunk(sx0, sz, sz, sz, T.AdaDelta(), n_steps=CPU_CHUNK_STEPS)
    s_cpu = sc._chunk(sx0, sz, sz, sz, T.AdaDelta(), n_steps=CPU_CHUNK_STEPS)
    sparam_err = rel(s_card[0][-1], s_cpu[0][-1])
    print("card vs CPU stochastic training (n=%d, m=%s fft, tolerance %g, "
          "fed probes; %.1f s): first gradient rel err %.3e, %d-step chunk "
          "parameters %.3e (tol %g); residuals card %s CPU %s"
          % (sn, STOCH_M, STOCH_TOL, time.time() - t0, sgrad_err,
             CPU_CHUNK_STEPS, sparam_err, STOCH_RTOL,
             np.asarray(s_card[6]).tolist(), np.asarray(s_cpu[6]).tolist()),
          flush=True)
    require(sgrad_err <= STOCH_RTOL and sparam_err <= STOCH_RTOL,
            "card and CPU stochastic training disagree")

    phase_done("13 card vs CPU stochastic")

    # ----------------------------------------------------------- phase 13b
    # SLQ on the reduced weather copy of phase 13: card vs CPU with the
    # same fed probes, and the card's own estimate (its generator seeded
    # 0) against the dense SKI log-det; then the float32 report path: the
    # SLQ log-det of a float32 copy (K13 in float32) and the exact oracle
    # of a float32 ExactLMC on the fx2007-shaped data (K7's backward in
    # float32)
    sg.param_array = sx0
    sc.param_array = sx0
    zr = np.random.RandomState(77).uniform(size=(max(sc.n_probes, 15), sn))
    zfed = np.where(zr < 0.5, -1.0, 1.0)
    sg.slq_probes = sc.slq_probes = lambda N, n: zfed
    slq_card = sg.ski_log_det()
    slq_cpu = sc.ski_log_det()
    slq_err = abs(slq_card - slq_cpu) / abs(slq_cpu)
    zg = torch.as_tensor(zfed, device=dev)
    slq20 = [float(slq.slq_logdet_from_probes(m_._kski().matvec,
                                              z_.to(m_.dtype),
                                              SLQ_STEPS_TIGHT))
             for m_, z_ in ((sg, zg), (sc, zg.cpu()))]
    slq20_err = abs(slq20[0] - slq20[1]) / abs(slq20[1])
    sg.slq_probes = None
    sg.param_array = sx0
    slq_own = sg.ski_log_det()
    sK = sc._kski()
    sKd = sK.matvec(torch.eye(sn, dtype=torch.float64))
    slq_dense = float(np.linalg.slogdet(sKd.numpy())[1])
    slq_oracle_err = abs(slq_own - slq_dense) / abs(slq_dense)
    # where the 40-step card and CPU numbers part: the per-step max
    # |d alpha| and |d beta| over the probes, card against CPU, and the
    # witness on the CPU alone, the fft matvec against the dense matrix
    # of the same operator (another summation order)
    v0 = zg.cpu() / float(np.sqrt(sn))
    tri_card = [t.cpu() for t in slq.lanczos_tridiag(
        sg._kski().matvec, v0.to(dev), SLQ_STEPS)]
    tri_cpu = slq.lanczos_tridiag(sK.matvec, v0, SLQ_STEPS)
    tri_dense = slq.lanczos_tridiag(lambda v: v @ sKd, v0, SLQ_STEPS)

    def step_diffs(a, b):
        return [[float(x) for x in torch.amax(torch.abs(p - q), dim=0)]
                for p, q in zip(a, b)]

    slq_trace = {"card_vs_cpu": step_diffs(tri_card, tri_cpu),
                 "cpu_fft_vs_dense": step_diffs(tri_cpu, tri_dense)}
    slq_witness = float(slq.slq_logdet_from_probes(
        lambda v: v @ sKd, zg.cpu(), SLQ_STEPS))
    slq_witness_err = abs(slq_witness - slq_cpu) / abs(slq_cpu)
    print("SLQ (reduced weather, n=%d, m=%s fft), fed probes: %d steps card "
          "%.15g, CPU %.15g (rel err %.3e, tol %g); %d steps card %.12g, "
          "CPU %.12g (rel err %.3e, tol %g), CPU through the dense matrix "
          "%.12g (rel err %.3e to the CPU's fft matvec); own probes %.10g "
          "vs dense log-det %.10g (rel err %.3e, tol %g)"
          % (sn, STOCH_M, SLQ_STEPS_TIGHT, slq20[0], slq20[1], slq20_err,
             SLQ_RTOL, SLQ_STEPS, slq_card, slq_cpu, slq_err, SLQ_40_RTOL,
             slq_witness, slq_witness_err, slq_own, slq_dense,
             slq_oracle_err, SLQ_ORACLE_RTOL), flush=True)
    print("SLQ Lanczos per-step max |d alpha| / |d beta| over the probes "
          "(step: card vs CPU | CPU fft vs CPU dense):", flush=True)
    for j in range(SLQ_STEPS):
        cb = [tr[1][j] if j < SLQ_STEPS - 1 else float("nan")
              for tr in (slq_trace["card_vs_cpu"],
                         slq_trace["cpu_fft_vs_dense"])]
        print("  %2d  %.2e %.2e | %.2e %.2e"
              % (j + 1, slq_trace["card_vs_cpu"][0][j], cb[0],
                 slq_trace["cpu_fft_vs_dense"][0][j], cb[1]), flush=True)
    require(slq20_err <= SLQ_RTOL and slq_err <= SLQ_40_RTOL,
            "card and CPU SLQ log-dets disagree")
    require(slq_oracle_err <= SLQ_ORACLE_RTOL,
            "the SLQ log-det misses the dense log-det")
    s32 = T.InterpolatedLLGP(sx, sy, device=dev, dtype=torch.float32, **skw)
    el32 = T.ExactLMC(xss, yss, functional_kernel=spec, seed=SEED,
                      dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    hopper.reset_launches()
    slq32 = s32.ski_log_det()
    el32_ll = el32.log_likelihood()
    el32_g = el32._value_and_grad(el32.param_array)[1]
    torch.cuda.synchronize()
    f32_launches = hopper.launch_counts()
    print("float32 report path: SLQ log-det %.8g (float64 own probes "
          "%.8g), ExactLMC log-likelihood %.8g, launches %s"
          % (slq32, slq_own, el32_ll, json.dumps(f32_launches)), flush=True)
    for name in hopper.F32_REPORT_PATH:
        require(f32_launches[name] > 0,
                "kernel %s never launched on the float32 report path" % name)
    require(np.isfinite(slq32) and np.isfinite(el32_ll)
            and np.all(np.isfinite(el32_g)), "non-finite float32 reports")
    # the float32 ExactLMC's closed-form gradient (ExactMLL: an explicit
    # float32 K^-1) and the autograd route's (torch's Cholesky backward),
    # both from the same float32 K, against the float64 closed form at
    # the same parameters
    el64 = T.ExactLMC(xss, yss, functional_kernel=spec, seed=SEED,
                      dtype=torch.float64, device=dev)
    el64.param_array = el32.param_array

    def el_grad(m, fn):
        x_ = torch.as_tensor(m.param_array, dtype=m.dtype,
                             device=dev).requires_grad_(True)
        with torch.enable_grad():
            (g_,) = torch.autograd.grad(
                fn(m.spec, unravel_params(x_, m.params), m._X, m._oidx,
                   m.y), x_)
        return g_.double().cpu().numpy()

    g64 = el_grad(el64, lk.exact_mll)
    f32_oracle = {"closed_form_rel_err": rel(el_grad(el32, lk.exact_mll),
                                             g64),
                  "autograd_route_rel_err": rel(
                      el_grad(el32, exact_mll_autograd), g64),
                  # _value_and_grad reports the negative MLL's gradient
                  "reported_rel_err": rel(-el32_g, g64)}
    print("float32 ExactLMC gradient (n=%d) against the float64 closed "
          "form: closed form rel err %.3e (as reported: %.3e), autograd "
          "route %.3e (tol: %g times the autograd route's)"
          % (len(el32.y), f32_oracle["closed_form_rel_err"],
             f32_oracle["reported_rel_err"],
             f32_oracle["autograd_route_rel_err"], ORACLE_F32_FACTOR),
          flush=True)
    require(max(f32_oracle["closed_form_rel_err"],
                f32_oracle["reported_rel_err"]) <= ORACLE_F32_FACTOR
            * f32_oracle["autograd_route_rel_err"],
            "the float32 closed-form oracle gradient is less accurate than "
            "the autograd route's")
    del s32, el32, el64
    phase_done("13b SLQ and float32 reports")

    # ----------------------------------------------------------- phase 15
    # the synth configuration at full width (bench.py:114-130 on the
    # in-repo synthetic twin: D=5, P=2, n=47,480, SLFM rank 2 plus an RBF
    # per output, m=[25, 25] -> Dm=4205, exact objective, tolerance 1e-3,
    # AdaDelta's reference defaults): train to the stopping rule (every
    # kernel of hopper.SYNTH_PATH launched), one chunk profiled by layer
    # and inside the K2 / K4 / Cholesky / solve ranges, predict the held-
    # out quadrant (every certified residual within the tolerance); then
    # card vs CPU on bench.py's reduced copy (every 30th point, m=[8, 8])
    s_init = sm.param_array
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hopper.reset_launches()
    t0 = time.time()
    sinfo = sm.optimize(T.AdaDelta())
    torch.cuda.synchronize()
    strain_s = time.time() - t0
    sy_launches = hopper.launch_counts()
    speak_gb = torch.cuda.max_memory_allocated() / 1e9
    sstep_ms = 1e3 * sinfo["device_seconds"] / sinfo["device_steps"]
    print("train synth (exact objective, AdaDelta defaults): n_iter %d (%d "
          "device steps), %.3f s wall, %.3f ms per step, max solve error "
          "%.3e, exact_precision %s, objective %s, peak %.2f GB, launches %s"
          % (sinfo["n_iter"], sinfo["device_steps"], strain_s, sstep_ms,
             sinfo["max_solve_error"], sm.exact_precision, sm.objective,
             speak_gb, json.dumps(sy_launches)), flush=True)
    for name in hopper.SYNTH_PATH:
        require(sy_launches[name] > 0,
                "kernel %s never launched in synth training" % name)
    require(np.all(np.isfinite(sinfo["grad_norms"]))
            and np.all(np.isfinite(sm.param_array)),
            "non-finite synth training")
    sprec = sm.exact_precision
    sx_now = sm.param_array
    sz0 = np.zeros_like(sx_now)
    schunk_ms, schunk_rows, schunk_wall, schunk_split = device_profile(
        lambda: sm._chunk(sx_now, sz0, sz0, sz0, T.AdaDelta()), ranges=True)
    schunk_idle = None if schunk_ms is None else 1 - schunk_ms / schunk_wall
    print("one synth chunk (%d steps, exact_precision %s) under the "
          "profiler: device busy %s of %.3f ms wall (idle share %s)"
          % (sm.chunk_len, sm.exact_precision, _ms(schunk_ms), schunk_wall,
             "-" if schunk_idle is None else "%.3f" % schunk_idle),
          flush=True)
    sstep_layers = by_layer(schunk_rows, per=sm.chunk_len)
    print("synth step device time by layer (per step):", flush=True)
    print_layers(sstep_layers)
    print_k3_bwd("synth training", sstep_layers)
    require_layers(sstep_layers, ("K1", "K1 backward", K9_LAYER),
                   "a synth training step")
    require("trsm (cuBLAS)" not in sstep_layers, "a synth training step "
            "ran cuBLAS's trsm: a solve left the hand kernels")
    print("synth step device time inside the ranges (per step; forward "
          "calls only):", flush=True)
    print_split(schunk_split, per=sm.chunk_len)
    require(COPY_LAYER not in schunk_split[RANGES[1]], "a synth training "
            "step copied on the card inside chol_jittered")
    sm.param_array = sx_now
    t0 = time.time()
    smu, svar = sm.predict(stxs)
    torch.cuda.synchronize()
    spredict_s = time.time() - t0
    sreport = dict(sm.prediction_report)
    require(all(np.all(np.isfinite(a)) for a in smu + svar),
            "non-finite synth predictions")
    for what, rep_ in sreport.items():
        require(rep_["residual"] <= SYNTH_TOL, "synth %s: certified residual "
                "%g > %g" % (what, rep_["residual"], SYNTH_TOL))
    ssmse = smse(stys, smu, sys_)
    snlpd = nlpd(stys, smu, svar)
    print("synth predict (%d held-out points): %.3f s, report %s; on the "
          "synthetic synth-shaped data: SMSE %.6g, NLPD %.6g; share of "
          "held-out variances clipped to 0: %.4f"
          % (len(stys[-1]), spredict_s, json.dumps(sreport), ssmse, snlpd,
             float(np.mean(svar[-1] == 0))), flush=True)
    # the escalation to float64 against C's float32 rounding: float32
    # training from the initial parameters, C by K2 and by the dense
    # cuBLAS products, chunk by chunk until a step's factorization
    # residual breaches the threshold (optimize escalates at the end of
    # that chunk); then the float32 factorization residual of both at the
    # parameters K2's run reached at its first breaching step
    # (with K2: where each float32 factorization of a chunk lands on its
    # jitter ladder, K_UU and C apart, beside the chunk's worst residual)
    def f32_until_breach(max_chunks=5):
        sm.exact_precision = "f32"
        sz = np.zeros_like(s_init)
        st_, errs, xs_, rungs = (s_init, sz, sz, sz), [], [], []
        for _ in range(max_chunks):
            with ladder_log(wbm) as lad:
                out = sm._chunk(*st_, T.AdaDelta())
            errs.extend(float(e) for e in out[6])
            xs_.extend(out[0])
            rungs.append({"worst_residual": float(max(out[6])),
                          **ladder_summary(lad, len(out[6]))})
            if max(out[6]) > EXACT_RESIDUAL_THRESHOLD:
                break
            st_ = tuple(o[-1] for o in out[:4])
        first = next((i for i, e in enumerate(errs)
                      if e > EXACT_RESIDUAL_THRESHOLD), None)
        return errs, first, xs_, rungs

    def f32_residual(x):
        return sm._probe_residual(unravel_params(torch.as_tensor(
            x, dtype=sm.dtype, device=dev), sm.params), sm._equilibrate)

    sab = {}
    errs_k2, first_k2, xs_k2, rungs_k2 = f32_until_breach()
    with library_capacitance(wbm):
        errs_lib, first_lib, _, _ = f32_until_breach()
    x_at = xs_k2[len(xs_k2) - 1 if first_k2 is None else first_k2]
    sab["k2"] = {"residuals": errs_k2, "first_breach_step": first_k2,
                 "residual_at_k2_breach": f32_residual(x_at),
                 "chunk_ladders": rungs_k2}
    for i, r in enumerate(rungs_k2):
        print("synth float32 chunk %d: worst factorization residual %.4g; "
              "K3 rungs landed (scale: count) %s" % (
                  i, r["worst_residual"], json.dumps(r["landed"])),
              flush=True)
    with library_capacitance(wbm):
        sab["library"] = {"residuals": errs_lib,
                          "first_breach_step": first_lib,
                          "residual_at_k2_breach": f32_residual(x_at)}
    # is the ladder the cause? the float32 factorization residual at the
    # parameters of K2's first breach with C factored at each scale of its
    # ladder in turn (the reference's ladder takes the first that factors)
    real_bdw = lk.build_device_woodbury
    sab["k2"]["residual_at_k2_breach_by_c_scale"] = {}
    for c in (0.0, 1e-6, 1e-3, 1e-1):
        lk.build_device_woodbury = (
            lambda *a, c=c, **kw: real_bdw(*a, **{**kw, "c_jitter": (c,)}))
        try:
            sab["k2"]["residual_at_k2_breach_by_c_scale"][str(c)] = \
                f32_residual(x_at)
        finally:
            lk.build_device_woodbury = real_bdw
    print("synth float32 residual at K2's first breach with C factored at "
          "each scale of its ladder: %s" % json.dumps(
              sab["k2"]["residual_at_k2_breach_by_c_scale"]), flush=True)
    for what, ab in sab.items():
        print("synth float32 training, C by %-7s: factorization residual "
              "per step %s; first step above %g: %s; float32 residual at "
              "the parameters of K2's first breach %.4g"
              % (what, " ".join("%.3g" % e for e in ab["residuals"]),
                 EXACT_RESIDUAL_THRESHOLD, ab["first_breach_step"],
                 ab["residual_at_k2_breach"]), flush=True)
    require(np.isfinite(sab["k2"]["residuals"][0]),
            "non-finite synth float32 residual")
    del sm
    # card vs CPU on the reduced copy: the first gradient and one chunk in
    # float32 (TRAIN_RTOL) and at exact_precision='model' (MODEL_RTOL)
    t0 = time.time()
    rx = [x[::SYNTH_SUBSAMPLE] for x in sxs]
    ry = [y[::SYNTH_SUBSAMPLE] for y in sys_]
    rkw = dict(functional_kernel=synth_spec(T, 5), m=SYNTH_SMALL_M,
               tolerance=SYNTH_TOL, objective="exact", seed=SEED)
    rg = T.InterpolatedLLGP(rx, ry, device=dev, **rkw)
    rc = T.InterpolatedLLGP(rx, ry, device="cpu", **rkw)
    rx0 = rc.param_array + 0.1 * np.sin(np.arange(rc.n_params))
    rz = np.zeros_like(rx0)
    # predictions of the held-out quadrant at rx0 (the full-width trained
    # twin's variances all clip to 0; these do not): every solve is
    # certified to SYNTH_TOL, so the two agree to about that
    rg.param_array = rc.param_array = rx0
    rmu_g, rvar_g = rg.predict(stxs)
    rmu_c, rvar_c = rc.predict(stxs)
    rmean_err = rel(np.concatenate(rmu_g), np.concatenate(rmu_c))
    rvar_err = rel(np.concatenate(rvar_g), np.concatenate(rvar_c))
    rpos = float(np.mean(rvar_c[-1] > 0))
    print("card vs CPU synth predict of the reduced copy (%d held-out "
          "points): mean rel err %.3e, variance rel err %.3e (tol %g); "
          "share of CPU variances above 0: %.4f; residuals card %.3g, CPU "
          "%.3g"
          % (len(stys[-1]), rmean_err, rvar_err, SYNTH_TOL, rpos,
             rg.prediction_report["explained-variance"]["residual"],
             rc.prediction_report["explained-variance"]["residual"]),
          flush=True)
    require(rmean_err <= SYNTH_TOL and rvar_err <= SYNTH_TOL,
            "card and CPU synth predictions disagree")
    require(rpos > 0.5, "the reduced synth copy's variances clip to 0")
    sg_card = rg._exact_grad(torch.as_tensor(rx0, device=dev))[0].cpu()
    sg_cpu = rc._exact_grad(torch.as_tensor(rx0))[0]
    sgrad_err32 = rel(sg_card.numpy(), sg_cpu.numpy())
    sopt = T.AdaDelta()
    rladder = {}
    for where, mdl in (("card", rg), ("cpu", rc)):
        with ladder_log(wbm) as lad:
            rladder[where] = mdl._chunk(rx0, rz, rz, rz, sopt,
                                        n_steps=CPU_CHUNK_STEPS)
        rladder[where + " rungs"] = [(e["kind"], e["rung"]) for e in lad]
        rladder[where + " landed"] = ladder_summary(lad, CPU_CHUNK_STEPS)[
            "landed"]
    s32_err = rel(rladder["card"][0][-1], rladder["cpu"][0][-1])
    print("reduced synth copy, float32 chunk: K3 rungs landed on the card "
          "%s, on the CPU %s; worst residual card %.4g, CPU %.4g"
          % (json.dumps(rladder["card landed"]),
             json.dumps(rladder["cpu landed"]),
             max(rladder["card"][6]), max(rladder["cpu"][6])), flush=True)
    require(rladder["card rungs"] == rladder["cpu rungs"],
            "the reduced synth copy's factorizations land on other rungs "
            "of their ladders on the card than on the CPU")
    sab["reduced_copy_ladder"] = {k: rladder[k] for k in (
        "card landed", "cpu landed")}
    del rladder
    rg.exact_precision = rc.exact_precision = "model"
    s64_err = rel(rg._chunk(rx0, rz, rz, rz, sopt,
                            n_steps=CPU_CHUNK_STEPS)[0][-1],
                  rc._chunk(rx0, rz, rz, rz, sopt,
                            n_steps=CPU_CHUNK_STEPS)[0][-1])
    print("card vs CPU synth training (n=%d, m=%s, Dm=%d; %.1f s): first "
          "gradient rel err %.3e, f32 %d-step chunk parameters %.3e (tol "
          "%g), model-precision chunk parameters %.3e (tol %g)"
          % (len(rc.data.y), SYNTH_SMALL_M, rc.grid_data[0].interp.ncols,
             time.time() - t0, sgrad_err32, CPU_CHUNK_STEPS, s32_err,
             TRAIN_RTOL, s64_err, MODEL_RTOL), flush=True)
    require(sgrad_err32 <= TRAIN_RTOL and s32_err <= TRAIN_RTOL,
            "card and CPU float32 synth training disagree")
    require(s64_err <= MODEL_RTOL,
            "card and CPU model-precision synth training disagree")
    del rg, rc
    phase_done("15 synth")

    # ----------------------------------------------------------- phase 16
    # checkpoint and resume on the card. Each configuration: a fresh model
    # is saved (MultiGP.save) before training, trained 20 steps (the
    # uninterrupted run), restored from that file, trained 10 steps and
    # saved with its optimizer state; a second fresh model restores the
    # 10-step file and resumes for 10 steps (counters reset and read
    # around the resume). The resumed run must give bit-identical
    # parameters, gradient norms and stopping step, and the fused K1 must
    # have launched in it. fx2007 at full width (exact objective, float32
    # factors, n=3113, Dm=3094), then one weather stochastic chunk pair
    # (m=2500). The fx2007 file then loads into the phase-4 CPU model,
    # whose predictions agree with the card's within PREDICT_RTOL; an
    # escalated copy of synth's reduced model stays escalated across save
    # and restore, and its resumed steps run at float64.
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ckpt_res = {}
    try:
        cfgs = (
            ("fx2007 exact", lambda: T.InterpolatedLLGP(
                xss, yss, functional_kernel=spec, m=[234],
                tolerance=TOLERANCE, seed=SEED, objective="exact",
                device=dev), OPT_KW, ("kuu_dense/f32", "kuu_dense_bwd/f32")),
            ("weather stochastic", lambda: T.InterpolatedLLGP(
                wx, wy, functional_kernel=wspec, m=WEATHER_M,
                objective="stochastic", seed=SEED, device=dev), {},
             ("kuu_dense/f32",)))
        for what, make, okw, k1_keys in cfgs:
            t0 = time.time()
            ma = make()
            f0 = os.path.join(ck_dir, "start.npz")
            f10 = os.path.join(ck_dir, "step10.npz")
            ma.save(f0)
            info_all = ma.optimize(T.AdaDelta(max_it=20, **okw))
            x_all = ma.param_array
            ma.restore(f0)
            info_10 = ma.optimize(T.AdaDelta(max_it=10, **okw))
            require(info_10["n_iter"] == 10, "%s: the first half stopped at "
                    "%d" % (what, info_10["n_iter"]))
            ma.save(f10, opt_state=info_10["state"])
            mb = make()
            ck = mb.restore(f10)
            torch.cuda.synchronize()
            hopper.reset_launches()
            info_res = mb.optimize(T.AdaDelta(max_it=20, **okw),
                                   state=ck["opt_state"])
            torch.cuda.synchronize()
            res_launches = hopper.launch_counts()
            same = (np.array_equal(mb.param_array, x_all)
                    and info_res["n_iter"] == info_all["n_iter"]
                    and info_res["grad_norms"] == info_all["grad_norms"][10:])
            diff = float(np.max(np.abs(mb.param_array - x_all)))
            ckpt_res[what] = {
                "n_iter": [int(info_all["n_iter"]), int(info_res["n_iter"])],
                "bit_identical": same, "max_abs_diff": diff,
                "s": time.time() - t0,
                "k1_launches": {k: res_launches[k] for k in k1_keys},
                "objective": mb.objective,
                "exact_precision": mb.exact_precision}
            print("checkpoint %s: uninterrupted n_iter %d, resumed n_iter "
                  "%d, parameters bit-identical %s (max abs diff %.3e), "
                  "fused K1 launches in the resumed run %s, %.2f s"
                  % (what, info_all["n_iter"], info_res["n_iter"], same,
                     diff, json.dumps(ckpt_res[what]["k1_launches"]),
                     ckpt_res[what]["s"]), flush=True)
            require(same, "%s: the resumed run differs from the "
                    "uninterrupted one" % what)
            for k in k1_keys:
                require(res_launches[k] > 0, "%s: %s never launched in the "
                        "resumed run" % (what, k))
            if what.startswith("fx2007"):
                f20 = os.path.join(ck_dir, "fx2007_end.npz")
                mb.save(f20, opt_state=info_res["state"])
                mu_g, var_g = mb.predict(txs)
                t0 = time.time()
                cpu.restore(f20)
                mu_c2, var_c2 = cpu.predict(txs)
                ck_mean = rel(np.concatenate(mu_g), np.concatenate(mu_c2))
                ck_var = rel(np.concatenate(var_g), np.concatenate(var_c2))
                ckpt_res[what]["cpu_predict"] = {
                    "mean_rel_err": ck_mean, "var_rel_err": ck_var,
                    "s": time.time() - t0}
                print("checkpoint fx2007: the file restored on the CPU "
                      "predicts within %.3e (means) and %.3e (variances) of "
                      "the card (tol %g), CPU %.1f s"
                      % (ck_mean, ck_var, PREDICT_RTOL,
                         time.time() - t0), flush=True)
                require(ck_mean <= PREDICT_RTOL and ck_var <= PREDICT_RTOL,
                        "the restored CPU model disagrees with the card")
            del ma, mb
        # an escalated synth reduced copy: one chunk, escalated by the
        # ladder's own step when the chunk did not breach
        t0 = time.time()
        se = T.InterpolatedLLGP(rx, ry, device=dev, **rkw)
        se_info = se.optimize(T.AdaDelta(max_it=10))
        natural = se.exact_precision != "f32"
        if not natural:
            se._escalate(2.0 * EXACT_RESIDUAL_THRESHOLD, se.param_array)
        want_state = (se.objective, se.exact_precision, se._equilibrate,
                      se._equilibrate_flip_tried)
        require(want_state[1] == "model", "synth reduced copy not escalated")
        fesc = os.path.join(ck_dir, "synth_escalated.npz")
        se.save(fesc, opt_state=se_info["state"])
        se2 = T.InterpolatedLLGP(rx, ry, device=dev, **rkw)
        ck = se2.restore(fesc)
        got_state = (se2.objective, se2.exact_precision, se2._equilibrate,
                     se2._equilibrate_flip_tried)
        hopper.reset_launches()
        se2.optimize(T.AdaDelta(max_it=13), state=ck["opt_state"])
        esc_launches = hopper.launch_counts()
        ckpt_res["synth escalated"] = {
            "escalated_in_training": natural, "saved": list(want_state),
            "restored": list(got_state), "s": time.time() - t0,
            "resumed_launches": {k: esc_launches[k] for k in
                                 ("kuu_dense/f64", "kuu_dense_bwd/f64")}}
        print("checkpoint synth reduced copy: escalated %s, state %s, "
              "restored %s, resumed float64 K1 launches %s"
              % ("in training" if natural else "by the ladder's step",
                 want_state, got_state,
                 json.dumps(ckpt_res["synth escalated"]["resumed_launches"])),
              flush=True)
        require(got_state == want_state, "the restored synth copy lost its "
                "escalation")
        require(esc_launches["kuu_dense_bwd/f64"] > 0,
                "the restored escalated copy did not train in float64")
        del se, se2
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    phase_done("16 checkpoint and resume")

    # ------------------------------------------------------------ phase 17
    path_launches = {}
    mesh_res = mesh_phase(T, dev, record, path_launches)
    phase_done("17 mesh")

    # ------------------------------------------------------------ phase 14
    path_launches.update({
        "report (fx2007)": rep_launches, "slq (weather)": slq_launches,
        "weather oracle": wexact_launches, "float32 report": f32_launches,
        "train (stochastic, fft)": st_launches, "train": train_launches,
        "train (model precision)": mp_launches, "predict": launches,
        "loo_zsq (float32)": loo32_launches, "synth": sy_launches,
    })
    for row in rows:
        key = "%s/%s" % (row.get("counter", row["name"]),
                         row["dtype"].replace("float", "f"))
        row["train_launches"] = train_launches[key]
        row["stochastic_launches"] = st_launches[key]
        row["predict_fft_launches"] = fp_launches[key]
        if row.get("path") == OFF_PATH:
            row["launches"] = 0
        elif "path" in row:  # named where the row was recorded
            row["launches"] = path_launches[row["path"]][key]
            require(row["launches"] > 0, "%s never launched on its path %s"
                    % (key, row["path"]))
        elif key == "fourier_contract/f32":
            # the float32 inner cycles, in training and in the fft predict
            require(key in hopper.FFT_PREDICT_PATH, "%s is on no path" % key)
            row["path"], row["launches"] = "predict (fft)", fp_launches[key]
        elif row["name"].startswith("fourier_contract"):
            require(key in hopper.STOCHASTIC_PATH, "%s is on no path" % key)
            row["path"] = "train (stochastic, fft)"
            row["launches"] = st_launches[key]
        elif row["name"] == "minres_update":
            require(key in hopper.MINRES_PATH, "%s is on no path" % key)
            row["path"], row["launches"] = "minres rung", mr_launches[key]
        elif key in hopper.PREDICT_PATH:
            row["path"], row["launches"] = "predict", launches[key]
        else:
            require(key in hopper.ESCALATION_PATH, "%s is on no path" % key)
            row["path"] = "escalation rung"
            row["launches"] = esc_launches[key]
    name = torch.cuda.get_device_name(0)
    result = {
        "card": card, "torch": torch.__version__,
        "kernels": rows, "predict_first_s": first_s,
        "predict_cached_s": cached_s, "predict_warm_s": warm_s,
        "predict_device_ms": predict_device_ms,
        "predict_profiled_ms": profiled_ms, "predict_idle_share": idle,
        "predict_breakdown": [
            {"name": k, "calls": c, "device_ms": t} for k, c, t in breakdown
        ],
        "predict_layers": predict_layers,
        "launches": launches, "report": res,
        "escalation": {"s": esc_s, "iterations": esc_iters,
                       "residual": esc_worst, "launches": esc_launches},
        "card_vs_cpu": {"mean_rel_err": mean_err, "var_rel_err": var_err},
        "smse": smse_untrained,
        "guard": {"s": guard_s, "z2": z2, "zero_var_frac": zfrac,
                  "launches": guard_launches},
        "train": {
            "n_iter": info["n_iter"], "device_steps": info["device_steps"],
            "wall_s": train_s, "ms_per_step": step_ms,
            "max_solve_error": info["max_solve_error"],
            "exact_precision": tm.exact_precision,
            "launches": train_launches, "grad_norms": info["grad_norms"],
            "chunk_device_ms": chunk_ms, "chunk_profiled_ms": chunk_wall,
            "chunk_idle_share": chunk_idle,
            "step_layers": step_layers,
            "layer_bounds_ms": {k: v[0] for k, v in layer_bounds.items()},
            "chunk_breakdown": [
                {"name": k, "calls": c, "device_ms": t}
                for k, c, t in chunk_rows
            ],
            "predict_s": trained_predict_s, "report": trained_res,
            "smse_synthetic": trained_smse, "nlpd_synthetic": trained_nlpd,
        },
        "card_vs_cpu_train": {
            "steps": CPU_CHUNK_STEPS, "grad_rel_err": grad_err,
            "f32_param_rel_err": f32_err, "model_param_rel_err": f64_err,
            "model_precision_launches": mp_launches,
        },
        "weather": {
            "n": len(wm.data.y), "groups": wgroups, "twin_sizes": wtwin,
            "build_s": wbuild_s, "grid_artifacts_mb": wmem_mb,
            "train": {
                "n_iter": winfo["n_iter"],
                "device_steps": winfo["device_steps"], "wall_s": wtrain_s,
                "ms_per_step": wstep_ms,
                "mean_solve_iters": winfo["mean_solve_iters"],
                "max_solve_error": winfo["max_solve_error"],
                "adopt_bound": adopt,
                "rescued_chunks": winfo["rescued_chunks"],
                "launches": st_launches, "grad_norms": winfo["grad_norms"],
                "chunk_device_ms": wchunk_ms,
                "chunk_profiled_ms": wchunk_wall,
                "chunk_idle_share": wchunk_idle,
                "step_layers": wstep_layers,
                "chunk_breakdown": [
                    {"name": k, "calls": c, "device_ms": t}
                    for k, c, t in wchunk_rows
                ],
            },
            "train_capacitance_k2_vs_library": wab,
            "predict": {"s": wpredict_s, "report": wreport,
                        "launches": fp_launches,
                        "smse_synthetic": wsmse, "nlpd_synthetic": wnlpd},
            "minres_rung": {"s": mres_s, "iterations": mres_iters,
                            "first_cycle_layers": mres_layers,
                            "residual": mres_worst,
                            "launches": mr_launches},
            "rescue_step": {"s": rescue_s, "iterations": float(rsc[5][0]),
                            "residual": float(rsc[6][0])},
            "dense_stochastic": {"s": dense_s,
                                 "steps": int(len(dout[0])),
                                 "launches": ds_launches},
            "card_vs_cpu": {"n": sn, "grad_rel_err": sgrad_err,
                            "param_rel_err": sparam_err,
                            "steps": CPU_CHUNK_STEPS},
            "report": {
                "log_likelihood_slq": wll_slq, "ski_log_det_slq": wslq,
                "log_likelihood_exact": wll_exact, "exact_value": wev,
                "wall_s": wrep_s, "device_ms": wrep_dev,
                "slq_layers": slq_layers, "exact_layers": wexact_layers,
                "exact_peak_gb": wexact_peak_gb,
                "slq_launches": slq_launches,
            },
            "slq_reduced": {"card": slq_card, "cpu": slq_cpu,
                            "rel_err": slq_err, "steps_tight": slq20,
                            "steps_tight_rel_err": slq20_err,
                            "cpu_dense_matvec": slq_witness,
                            "cpu_dense_matvec_rel_err": slq_witness_err,
                            "step_diffs_alpha_beta": slq_trace,
                            "own": slq_own,
                            "dense": slq_dense,
                            "oracle_rel_err": slq_oracle_err},
        },
        "report": {
            "log_likelihood_exact": ll_exact,
            "log_likelihood_woodbury": ll_ski, "exact_value": ev,
            "wall_s": report_s, "device_ms": report_dev,
            "card_vs_cpu": report_err, "cpu_s": cpu_report_s,
            "predict_modes_rel_err": mode_err, "launches": rep_launches,
            "metrics": met, "metrics_launches": met_launches,
            "exact_lmc": {"nit": int(el_res.nit), "nfev": int(el_res.nfev),
                          "log_likelihood": [el_ll0, el_ll],
                          "smse_synthetic": el_smse,
                          "launches": el_launches},
            "float32_launches": f32_launches,
            "float32_exact_lmc_grad": f32_oracle,
        },
        "k5_checks": k5_checks, "k5_grad_rel_err": k5_grad_err,
        "k5_stress": k5_stress, "k5_f32_error": k5_f32,
        "k9_skewed": k9_skew,
        "k2_checks": k2_checks,
        "synth": {
            "n": sum(len(y) for y in sys_),
            "build_s": sbuild_s,
            "train": {"n_iter": sinfo["n_iter"],
                      "device_steps": sinfo["device_steps"],
                      "wall_s": strain_s, "ms_per_step": sstep_ms,
                      "max_solve_error": sinfo["max_solve_error"],
                      "exact_precision_after": sprec,
                      "grad_norms": sinfo["grad_norms"],
                      "launches": sy_launches, "peak_gb": speak_gb,
                      "chunk_device_ms": schunk_ms,
                      "chunk_profiled_ms": schunk_wall,
                      "chunk_idle_share": schunk_idle,
                      "step_layers": sstep_layers, "split": schunk_split},
            "predict": {"s": spredict_s, "report": sreport,
                        "smse_synthetic": ssmse, "nlpd_synthetic": snlpd},
            "f32_escalation_k2_vs_library": sab,
            "card_vs_cpu": {"grad_rel_err": sgrad_err32,
                            "f32_param_rel_err": s32_err,
                            "model_param_rel_err": s64_err,
                            "steps": CPU_CHUNK_STEPS,
                            "predict_mean_rel_err": rmean_err,
                            "predict_var_rel_err": rvar_err,
                            "predict_var_positive_share": rpos},
        },
        "train_deterministic": {"stops": stops,
                                "deterministic_runs_identical": det_same,
                                "flagged": sorted(flagged)},
        "train_split": chunk_split, "train_stops": stops,
        "train_elementwise_sources": chunk_sources,
        "stochastic_split": wchunk_split,
        "stochastic_elementwise_sources": wchunk_sources, "loo_zsq": loo,
        "k1_checks": k1_checks, "k7_pair_checks": k7_pair_checks,
        "k3_checks": k3_checks,
        "vjp_checks": vjp_checks, "k8_fft_checks": k8_checks,
        "oracle": oracle,
        "k3_flag_indefinite": k3_flag, "k3_memory": k3_memory,
        "train_ladder": train_ladder,
        "stochastic_ladder": stoch_ladder, "checkpoint": ckpt_res,
        "mesh": mesh_res, "phase_s": phase_s,
    }
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    print("phase times (s): %s; total %.1f s"
          % (json.dumps({k: round(v, 2) for k, v in phase_s.items()}),
             sum(phase_s.values())), flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


# K3's backward at the C shapes of the training paths and the weather
# twin (n, dtype)
K3_BWD_SHAPES = ((3094, "float32"), (3094, "float64"), (4205, "float32"),
                 (4205, "float64"), (10016, "float32"))


def k3_bwd_times(root):
    """``--k3-bwd-times [ROOT]``: K3a bwd's and K3b bwd's times (profiler
    device ms and CUDA events) in the package at ROOT (this checkout by
    default) at ``K3_BWD_SHAPES``, the cotangent row-major and
    column-major against L column-major (potrf's storage) and a row-major
    A, on seeded operands; one JSON line. To compare two checkouts on one
    card, run it for each in one call, in turns."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    from runlmc_tpu_torch.hopper import build, chol_jitter

    build.build_all(["chol_jitter"])
    dev = torch.device("cuda")
    rows = []
    for n, dts in K3_BWD_SHAPES:
        dtype = getattr(torch, dts)
        g = torch.Generator(device=dev).manual_seed(SEED + n)

        def randn(*shape):
            return torch.randn(*shape, generator=g, dtype=dtype, device=dev)

        A = randn(n, n)
        A.diagonal().abs_().add_(1.0)
        L = randn(n, n).tril_().mT.contiguous().mT
        s = torch.rand(n, generator=g, dtype=dtype, device=dev) + 0.5
        G, sb = randn(n, n), randn(n)
        for order in ("row", "column"):
            X = G.mT.contiguous().mT if order == "column" else G
            for name, fn in (
                    ("chol_descale_bwd",
                     lambda X=X: chol_jitter.chol_descale_bwd(L, s, X)),
                    ("chol_prologue_bwd",
                     lambda X=X: chol_jitter.chol_prologue_bwd(
                         A, s, X, sb, 1e-4, True))):
                dms, krows, _ = device_profile(fn, reps=10)
                rows.append({"name": name, "n": n, "dtype": dts,
                             "cotangent": order, "device_ms": dms,
                             "ms": cuda_time(fn),
                             "by_kernel": [[k[:60], c / 10, ms / 10]
                                           for k, c, ms in krows]})
            del X
        # the same bytes through PyTorch's own elementwise kernels: a
        # product (two reads, one write: K3a bwd's 3 n^2) and a copy
        C = torch.empty_like(G)
        for name, fn in (("torch.mul", lambda: torch.mul(G, A, out=C)),
                         ("copy_", lambda: C.copy_(G))):
            rows.append({"name": name, "n": n, "dtype": dts,
                         "device_ms": device_profile(fn, reps=10)[0],
                         "ms": cuda_time(fn)})
        del A, L, G, C
    print(json.dumps({"k3_bwd_times": rows, "root": os.path.abspath(root),
                      "card": card_line()}))
    return 0


# K7 bwd at the exact paths' shapes: (site, n, outputs, kernels, dtype,
# with the rank-1 form); K1 bwd at the dense grids': (site, grid sizes,
# outputs, kernels, dtype)
K7_BWD_SHAPES = (("fx2007", 3113, 13, 1, "float64", False),
                 ("fx2007", 3113, 13, 1, "float32", False),
                 ("weather oracle", 15768, 4, 6, "float64", True))
K1_BWD_SHAPES = (("fx2007", (238,), 13, 1, "float32"),
                 ("fx2007", (238,), 13, 1, "float64"),
                 ("synth", (29, 29), 5, 7, "float32"),
                 ("synth", (29, 29), 5, 7, "float64"),
                 ("weather twin", (2504,), 4, 6, "float32"))


def bwd_times(root):
    """``--bwd-times [ROOT]``: K7 bwd's and K1 bwd's times (profiler
    device ms, CUDA events, and the events' device span with the calls
    queued, :func:`queued_time`) in the package at ROOT (this checkout by
    default) at ``K7_BWD_SHAPES`` and ``K1_BWD_SHAPES`` on seeded inputs
    of the paths' shapes: one point set sorted by output (as the models
    hold it) of RBF kernels on one input dim, a seeded asymmetric
    cotangent; K7 bwd also in the rank-1 form (alpha in its loads, and
    ``torch.addr`` first). One JSON line; to compare two checkouts on one
    card, run it for each in one call, in turns."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    from runlmc_tpu_torch.hopper import build, cross, kuu

    build.build_all(["cross_kernel_bwd", "kuu_dense_bwd"])
    dev = torch.device("cuda")
    rows = []

    def timed(fn, **row):
        dms, krows, _ = device_profile(fn, reps=10)
        row.update(device_ms=dms, ms=cuda_time(fn), queued_ms=queued_time(fn),
                   by_kernel=[[k[:60], c / 10, ms / 10] for k, c, ms in krows])
        rows.append(row)

    for site, n, D, Q, dts, rank1 in K7_BWD_SHAPES:
        dtype = getattr(torch, dts)
        g = torch.Generator(device=dev).manual_seed(SEED + n)
        f = dict(dtype=dtype, device=dev)
        counts = np.diff(np.linspace(0, n, D + 1).astype(int))
        o = torch.as_tensor(np.repeat(np.arange(D), counts),
                            dtype=torch.int32, device=dev)
        # each output's inputs sorted, as a model holds a time series
        x = torch.rand(n, generator=g, **f) * 10.0
        ends = np.cumsum(counts)
        x = torch.cat([torch.sort(x[e - c:e])[0]
                       for c, e in zip(counts, ends)])[:, None]
        B = torch.randn(Q, D, D, generator=g, **f)
        kinds = torch.zeros(Q, dtype=torch.int32, device=dev)
        masks = torch.ones(Q, dtype=torch.int32, device=dev)
        prm = torch.rand(Q, 3, generator=g, **f) + 0.5
        G = torch.randn(n, n, generator=g, **f)
        args = (x, o, x, o, B, kinds, masks, prm, G)
        timed(lambda: cross.cross_kernel_bwd(*args), name="cross_kernel_bwd",
              site=site, dtype=dts, form="G")
        if rank1:
            a = torch.randn(n, generator=g, **f)
            timed(lambda: cross.cross_kernel_bwd(*args, alpha=a),
                  name="cross_kernel_bwd", site=site, dtype=dts,
                  form="rank-1")
            timed(lambda: cross.cross_kernel_bwd(
                *args[:8], torch.addr(G, a, a, alpha=-1.0)),
                name="cross_kernel_bwd", site=site, dtype=dts,
                form="torch.addr, then K7 bwd")
        del args, G
    for site, sizes, D, Q, dts in K1_BWD_SHAPES:
        dtype = getattr(torch, dts)
        m = int(np.prod(sizes))
        g = torch.Generator(device=dev).manual_seed(SEED + m)
        f = dict(dtype=dtype, device=dev)
        axes = [np.arange(s) * 0.05 for s in sizes]
        pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(m, -1)
        dists = torch.as_tensor(np.linalg.norm(pts - pts[0], axis=-1), **f)
        prm = torch.rand(Q, 3, generator=g, **f) + 0.5
        B = torch.randn(Q, D, D, generator=g, **f)
        G = torch.randn(D * m, D * m, generator=g, **f)
        args = ((0,) * Q, prm, dists, B, sizes, G)
        timed(lambda: kuu.kuu_dense_bwd(*args), name="kuu_dense_bwd",
              site=site, dtype=dts, sizes=list(sizes), D=D, Q=Q)
        del args, G
    print(json.dumps({"bwd_times": rows, "root": os.path.abspath(root),
                      "card": card_line()}))
    return 0


# K1 forward at the dense grids' shapes (K1_BWD_SHAPES); K7 forward at
# the paths' shapes: (site, rows of a second point set or None for one
# point set, n, outputs, kernels, dtype)
K7_FWD_SHAPES = (("predict", 150, 3113, 13, 1, "float64"),
                 ("fx2007", None, 3113, 13, 1, "float64"),
                 ("fx2007", None, 3113, 13, 1, "float32"),
                 ("weather oracle", None, 15768, 4, 6, "float64"))


def fwd_times(root):
    """``--fwd-times [ROOT]``: K1's and K7's forward times (profiler device
    ms, CUDA events, and the events' device span with the calls queued,
    :func:`queued_time`) in the package at ROOT (this checkout by default)
    at ``K1_BWD_SHAPES`` and ``K7_FWD_SHAPES``, on seeded inputs of the
    paths' shapes (RBF kernels; for K7 one input dim, the points of each
    output sorted, as the models hold them), with a sha256 of each
    output's bytes. K1 runs with its fold in each CTA's prologue and as a
    launch of its own where the package has both; K7 on one point set
    (the pair path) and, at fx2007, on the same inputs as two point sets
    (the general path). Beside each shape, ``fill_`` of a tensor of the
    output's size: what writing those bytes takes on this card. One JSON
    line; to compare two checkouts on one card, run it for each in one
    call, in turns."""
    import hashlib

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    from runlmc_tpu_torch.hopper import build, cross, kuu

    build.build_all(["cross_kernel", "kuu_dense"])
    dev = torch.device("cuda")
    rows = []

    def timed(fn, **row):
        out = fn()
        torch.cuda.synchronize()
        row["sha256"] = hashlib.sha256(
            out.cpu().numpy().tobytes()).hexdigest()
        del out
        dms, krows, _ = device_profile(fn, reps=10)
        row.update(device_ms=dms, ms=cuda_time(fn), queued_ms=queued_time(fn),
                   by_kernel=[[k[:60], c / 10, ms / 10] for k, c, ms in krows])
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "by_kernel"}),
              flush=True)

    # the fold's placement, set through the threshold that picks it
    saved_min = getattr(kuu, "FOLD_LAUNCH_MIN", None)
    folds = ((("prologue", 1 << 62), ("launch", 0)) if saved_min is not None
             else (("the package's only", None),))
    for site, sizes, D, Q, dts in K1_BWD_SHAPES:
        dtype = getattr(torch, dts)
        m = int(np.prod(sizes))
        g = torch.Generator(device=dev).manual_seed(SEED + m)
        f = dict(dtype=dtype, device=dev)
        axes = [np.arange(s) * 0.05 for s in sizes]
        pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(m, -1)
        dists = torch.as_tensor(np.linalg.norm(pts - pts[0], axis=-1), **f)
        prm = torch.rand(Q, 3, generator=g, **f) + 0.5
        B = torch.randn(Q, D, D, generator=g, **f)
        args = ((0,) * Q, prm, dists, B, sizes)
        for fold, fold_launch_min in folds:
            if fold_launch_min is not None:
                kuu.FOLD_LAUNCH_MIN = fold_launch_min
            timed(lambda: kuu.kuu_dense(*args), name="kuu_dense", site=site,
                  dtype=dts, sizes=list(sizes), D=D, Q=Q, fold=fold)
        if saved_min is not None:
            kuu.FOLD_LAUNCH_MIN = saved_min
        fill = torch.empty((D * m, D * m), **f)
        timed(lambda: fill.fill_(1.0), name="fill_ (K1's bytes)", site=site,
              dtype=dts)
        del fill
    for site, nt, n, D, Q, dts in K7_FWD_SHAPES:
        dtype = getattr(torch, dts)
        g = torch.Generator(device=dev).manual_seed(SEED + n)
        f = dict(dtype=dtype, device=dev)
        counts = np.diff(np.linspace(0, n, D + 1).astype(int))
        o = torch.as_tensor(np.repeat(np.arange(D), counts),
                            dtype=torch.int32, device=dev)
        x = torch.rand(n, generator=g, **f) * 10.0
        ends = np.cumsum(counts)
        x = torch.cat([torch.sort(x[e - c:e])[0]
                       for c, e in zip(counts, ends)])[:, None]
        B = torch.randn(Q, D, D, generator=g, **f)
        table = (torch.zeros(Q, dtype=torch.int32, device=dev),
                 torch.ones(Q, dtype=torch.int32, device=dev),
                 torch.rand(Q, 3, generator=g, **f) + 0.5)
        if nt is not None:  # K_*X: test points of random outputs
            xt = torch.rand(nt, 1, generator=g, **f) * 10.0
            ot = torch.randint(0, D, (nt,), generator=g, device=dev,
                               dtype=torch.int32)
            forms = {"two point sets": (xt, ot, x, o)}
        else:
            forms = {"one point set": (x, o, x, o)}
            if n < 10000:
                forms["the same as two point sets"] = (x, o, x.clone(),
                                                       o.clone())
        for form, pts in forms.items():
            timed(lambda: cross.cross_kernel(*pts, B, *table),
                  name="cross_kernel", site=site, dtype=dts,
                  shape=[len(pts[0]), n], D=D, Q=Q, form=form)
        fill = torch.empty((len(pts[0]), n), **f)
        timed(lambda: fill.fill_(1.0), name="fill_ (K7's bytes)", site=site,
              dtype=dts)
        del fill
    print(json.dumps({"fwd_times": rows, "root": os.path.abspath(root),
                      "card": card_line()}))
    return 0


# K10's forward at the weather shape and 'sum' / 'bt' at a small one:
# (rep, batch rows, outputs D, K = Q or R (0 for 'bt'), frequencies F,
# dtype of the real parts)
K10_SHAPES = (("slfm", 16, 4, 2, 4097, "float32"),
              ("slfm", 16, 4, 2, 4097, "float64"),
              ("sum", 5, 3, 2, 257, "float32"),
              ("sum", 5, 3, 2, 257, "float64"),
              ("bt", 5, 3, 0, 257, "float32"),
              ("bt", 5, 3, 0, 257, "float64"))
# K9's gather at the paths' shapes: (site, outputs, grid points per input
# dim, input dims, data rows, batch rows, dtype, operand layout); the
# kinv_diag operand is F^T, a transposed view
K9_GATHER_SHAPES = (
    ("weather", 4, 2504, 1, 15768, 16, "float32", "rows"),
    ("weather", 4, 2504, 1, 15768, 16, "float64", "rows"),
    ("fx2007 predict preconditioner", 13, 238, 1, 3113, 151, "float32",
     "rows"),
    ("synth", 5, 29, 2, 47480, 1, "float32", "rows"),
    ("fx2007 kinv_diag V = W F", 13, 238, 1, 3113, 3094, "float32",
     "transposed"),
)
HOST_CALLS = 300


def timing_rows(rows):
    """The helpers of the ``--*-times`` modes that append to ``rows``:
    ``sha(fn)``, the sha256 of the bytes of ``fn()``'s tensors;
    ``host_us(fn)``, the host µs per call over ``HOST_CALLS`` calls with
    no sync inside; ``emit(row)``, which keeps a row and prints it; and
    ``timed(fn, host=True, **row)``, which emits a row with ``fn``'s
    sha256, profiler device ms, CUDA-event ms, queued ms
    (:func:`queued_time`), kernels and, with ``host``, host µs."""
    import hashlib

    import torch

    def sha(fn):
        out = fn()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / HOST_CALLS * 1e6

    def emit(row):
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "by_kernel"}),
              flush=True)

    def timed(fn, host=True, **row):
        row["sha256"] = sha(fn)
        dms, krows, _ = device_profile(fn, reps=10)
        row.update(device_ms=dms, ms=cuda_time(fn), queued_ms=queued_time(fn),
                   by_kernel=[[k[:60], c / 10, ms / 10] for k, c, ms in krows])
        if host:
            row["host_us"] = host_us(fn)
        emit(row)

    return sha, host_us, emit, timed


def k10_k9_times(root):
    """``--k10-k9-times [ROOT]``: K10's forward and K9's gather in the
    package at ROOT (this checkout by default) at ``K10_SHAPES`` and
    ``K9_GATHER_SHAPES`` on seeded inputs (the interpolants of seeded
    sorted points on each output's grid): profiler device ms, CUDA
    events, the events' device span with the calls queued
    (:func:`queued_time`), a sha256 of the output's bytes, ``fill_`` of
    a tensor of the output's size, and the wrapper's host µs per call
    (``perf_counter`` over ``HOST_CALLS`` calls, no sync inside); then
    ``fill_`` of one element, the card's launch floor, and parts of a
    wrapper's host time. Where the package has the selectors, K10's
    generic kernel, the gather's generic taps and every gather layout
    and chunk are timed as well (queued, with their sha256). One
    JSON line at the end; to compare two checkouts on one card, run it
    for each in one call, in turns."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    from runlmc_tpu_torch.hopper import build, fourier, interp
    from runlmc_tpu_torch.ops.interpolation import multi_interpolant

    build.build_all(["fourier", "interp"])
    dev = torch.device("cuda")
    rows = []
    sha, host_us, emit, timed = timing_rows(rows)

    def variant(fn, **row):  # a selector's choice overridden
        emit(dict(row, sha256=sha(fn), queued_ms=queued_time(fn)))

    sweeps = hasattr(fourier, "fourier_instance")
    cplx = {"float32": torch.complex64, "float64": torch.complex128}
    for rep, nb, D, K, F, dts in K10_SHAPES:
        g = torch.Generator(device=dev).manual_seed(SEED + nb * F + D)
        f = dict(dtype=getattr(torch, dts), device=dev)
        c = dict(dtype=cplx[dts], device=dev)
        vf = torch.randn(nb, D, F, generator=g, **c)
        if rep == "slfm":
            args = (torch.randn(D, K, generator=g, **f),
                    torch.randn(K, F, generator=g, **c),
                    torch.randn(D, F, generator=g, **c))
        elif rep == "sum":
            args = (torch.randn(K, D, D, generator=g, **f),
                    torch.randn(K, F, generator=g, **c), None)
        else:
            args = (None, torch.randn(D, D, F, generator=g, **c), None)
        run = (lambda rep=rep, vf=vf, args=args:
               fourier.fourier_contract(rep, vf, *args))
        shape = dict(name="fourier_contract", rep=rep, dtype=dts,
                     shape=[nb, D, F], K=K)
        timed(run, **shape)
        if sweeps:
            saved = fourier.fourier_instance
            try:
                fourier.fourier_instance = lambda rep, D, K: fourier.GENERIC
                variant(run, instance="generic", **shape)
            finally:
                fourier.fourier_instance = saved
        fill = torch.empty_like(vf)
        timed(lambda: fill.fill_(1.0), host=False,
              name="fill_ (K10's bytes)", dtype=dts, shape=[nb, D, F])
        del vf, args, fill
    for site, D, m, dims, n, nb, dts, layout in K9_GATHER_SHAPES:
        rng = np.random.RandomState(SEED + n)
        axes = [np.linspace(0.0, 1.0, m) for _ in range(dims)]
        counts = np.diff(np.linspace(0, n, D + 1).astype(int))
        Xs = [rng.uniform(0.0, 1.0, (c, dims)) for c in counts]
        Xs = [X[np.argsort(X[:, 0], kind="stable")] for X in Xs]
        W = multi_interpolant(Xs, axes).to(getattr(torch, dts), dev)
        g = torch.Generator(device=dev).manual_seed(SEED + n + nb)
        f = dict(dtype=getattr(torch, dts), device=dev)
        v = (torch.randn(W.ncols, nb, generator=g, **f).T
             if layout == "transposed"
             else torch.randn(nb, W.ncols, generator=g, **f))
        run = (lambda W=W, v=v:
               interp.interp_gather(W.indices, W.weights, v))
        taps = W.indices.shape[1]
        shape = dict(name="interp_gather", site=site, dtype=dts,
                     shape=[nb, n], ncols=W.ncols, taps=taps, operand=layout)
        timed(run, **shape)
        if sweeps:
            saved = (interp.gather_taps, interp.gather_chunk,
                     interp.gather_layout)
            try:
                interp.gather_taps = lambda taps: 0
                variant(run, instance="generic taps", **shape)
                interp.gather_taps = saved[0]
                layouts = {"rows": interp.GATHER_ROWS}
                if layout == "transposed":
                    layouts["column tiles"] = interp.GATHER_COLS
                for lname, lay in layouts.items():
                    interp.gather_layout = (lambda sb, sc, nbatch, lay=lay:
                                            lay)
                    for chunk in interp.GATHER_CHUNKS[lay]:
                        interp.gather_chunk = (lambda *args, chunk=chunk,
                                               **kwargs: chunk)
                        variant(run, chunk=chunk, layout=lname, **shape)
            finally:
                (interp.gather_taps, interp.gather_chunk,
                 interp.gather_layout) = saved
        fill = torch.empty((nb, n), **f)
        timed(lambda: fill.fill_(1.0), host=False,
              name="fill_ (the gather's bytes)", site=site, dtype=dts,
              shape=[nb, n])
        del v, W, fill
    one = torch.empty(1, device=dev)
    for _ in range(2):
        timed(lambda: one.fill_(1.0), name="fill_ (one element)")
    # the parts of a wrapper's host time: the stream handle (also of a
    # tensor's device, where the package's stream_ptr takes one), an
    # output allocation
    parts = [("build.stream_ptr()", build.stream_ptr)]
    if build.stream_ptr.__code__.co_argcount:
        parts.append(("build.stream_ptr(cuda:0)",
                      lambda: build.stream_ptr(one.device)))
    parts += [("torch.cuda.current_stream().cuda_stream",
               lambda: torch.cuda.current_stream().cuda_stream),
              ("torch._C._cuda_getCurrentRawStream(0)",
               lambda: torch._C._cuda_getCurrentRawStream(0)),
              ("torch.cuda.current_device()", torch.cuda.current_device),
              ("torch.empty((16, 15768))",
               lambda: torch.empty((16, 15768), device=dev))]
    for what, fn in parts:
        emit(dict(name="host part", part=what, host_us=host_us(fn)))
    print(json.dumps({"k10_k9_times": rows, "root": os.path.abspath(root),
                      "card": card_line()}))
    return 0


# K13 at the SLQ paths' shapes: (rows, n, dtype) of the weather model's
# SLQ log-det and of the float32 report path's reduced copy
K13_SHAPES = ((15, 15768, "float64"), (15, 790, "float32"))
SKI_LOG_DET_RUNS = 3


def k13_state(lanczos, B, n, dts, dev):
    """K13's seeded mid-run state at (B, n) in ``dts``: a diagonal
    operator d, unit rows v, a unit v_prev, w = d v, beta, alive and
    eps."""
    import torch

    dtype = getattr(torch, dts)
    g = torch.Generator(device=dev).manual_seed(SEED + B * n)
    f = dict(dtype=dtype, device=dev)
    d = torch.rand(n, generator=g, **f) + 0.5
    v = torch.sign(torch.randn(B, n, generator=g, **f)) / float(n ** 0.5)
    vp = torch.randn(B, n, generator=g, **f)
    vp /= torch.linalg.vector_norm(vp, dim=1, keepdim=True)
    beta = torch.rand(B, generator=g, **f) + 0.1
    alive = torch.ones(B, dtype=torch.int32, device=dev)
    eps = torch.full((1,), lanczos.breakdown_eps(dtype), **f)
    return d, v, vp, v * d, beta, alive, eps


def k13_k8_times(root):
    """``--k13-k8-times [ROOT]``: K13 (the Lanczos step) and K8 (fft)'s
    backward in the package at ROOT (this checkout by default). K13 at
    ``K13_SHAPES`` on seeded state (a diagonal operator, unit rows, beta
    and alive as mid-run), K8's backward at the weather model's fft
    group (its table rows and distances, a seeded cotangent): profiler
    device ms, CUDA events, queued ms, a sha256 of the outputs (K13's
    from fresh copies of the state: v', alpha, beta, alive), ``fill_``
    of the output's bytes and the wrapper's host µs per call (300
    calls; K13 also as ``lanczos_tridiag`` calls it, into columns of
    (B, k) outputs, where the package takes ``out=``); then ``fill_`` of
    one element, the launch floor, and the wall of ``ski_log_det`` on
    the weather model (``SKI_LOG_DET_RUNS`` runs, caches dropped). One
    JSON line at the end; to compare two checkouts on one card, run it
    for each in one call, in turns."""
    import inspect

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    from runlmc_tpu_torch.hopper import build
    from runlmc_tpu_torch.hopper import kern_rows_fft as k8f
    from runlmc_tpu_torch.hopper import lanczos

    build.build_all([n for n in ("lanczos", "kern_rows_fft")
                     if n in build.source_names()])
    dev = torch.device("cuda")
    rows = []
    sha, host_us, emit, timed = timing_rows(rows)
    takes_out = "out" in inspect.signature(lanczos.lanczos_step).parameters
    for B, n, dts in K13_SHAPES:
        dtype = getattr(torch, dts)
        f = dict(dtype=dtype, device=dev)
        d, v, vp, w, beta, alive, eps = k13_state(lanczos, B, n, dts, dev)
        shape = dict(name="lanczos_step", dtype=dts, shape=[B, n])
        # the scratch copies are fresh at the first call, which the sha256
        # hashes; later calls overwrite them (v' into vps, and in a
        # package whose kernels update w in place, ws)
        ws, vps = w.clone(), vp.clone()
        run = (lambda ws=ws, vps=vps, v=v, beta=beta, alive=alive, eps=eps:
               lanczos.lanczos_step(ws, vps, v, beta, alive, eps))
        timed(run, form="new outputs", **shape)
        if takes_out:
            cols = torch.zeros((B, 41), **f)
            acols = torch.empty((B, 40), **f)
            alive_c = alive.clone()
            outs = (acols[:, 7], cols[:, 8], alive_c)
            run_out = (lambda vps=vps, v=v, eps=eps, cols=cols, outs=outs,
                       alive_c=alive_c, ws=ws:
                       lanczos.lanczos_step(ws, vps, v, cols[:, 7], alive_c,
                                            eps, out=outs))
            emit(dict(shape, form="out= columns", host_us=host_us(run_out),
                      queued_ms=queued_time(run_out)))
        fill = torch.empty((B, n), **f)
        timed(lambda: fill.fill_(1.0), host=False,
              name="fill_ (K13's output bytes)", dtype=dts, shape=[B, n])
        del d, v, vp, w, ws, vps, fill
    # the weather model's fft group: K8 (fft)'s backward on its table
    wm = _weather_model(dev, {})
    gd = wm.grid_data[0]
    kinds, prm = wm.spec.table_rows(wm.params, gd.plan.kidxs)
    prm = prm.detach()
    E = k8f.kern_rows_fft(kinds, prm, gd.dists, gd.plan.sizes)
    gk = torch.Generator(device=dev).manual_seed(SEED + 8)
    G = torch.randn(E.shape, generator=gk, dtype=E.dtype, device=dev)
    run = (lambda: k8f.kern_rows_fft_bwd(kinds, prm, gd.dists,
                                         gd.plan.sizes, G))
    shape = dict(name="kern_rows_fft_bwd", dtype=str(E.dtype)[6:],
                 shape=list(E.shape), Q=len(kinds), m=gd.dists.numel())
    if hasattr(k8f, "bwd_cluster"):
        shape["cluster"] = k8f.bwd_cluster(len(kinds), gd.dists.numel(),
                                           E.dtype)
    timed(run, **shape)
    if hasattr(k8f, "bwd_cluster"):
        saved = k8f.bwd_cluster
        try:
            k8f.bwd_cluster = lambda *args, **kwargs: 0
            emit(dict(shape, cluster=0, kernel="one CTA a q",
                      sha256=sha(run), queued_ms=queued_time(run)))
        finally:
            k8f.bwd_cluster = saved
    fill = torch.empty((len(kinds), 3), dtype=E.dtype, device=dev)
    timed(lambda: fill.fill_(1.0), host=False,
          name="fill_ (K8 bwd's output bytes)", shape=[len(kinds), 3])
    one = torch.empty(1, device=dev)
    for _ in range(2):
        timed(lambda: one.fill_(1.0), name="fill_ (one element)")
    walls = []
    for _ in range(SKI_LOG_DET_RUNS):
        wm._cache.pop("slq_logdet", None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logdet = wm.ski_log_det()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    emit(dict(name="ski_log_det (weather, SLQ: 40 steps, %d probes)"
              % max(wm.n_probes, 15), wall_s=walls, value=logdet))
    print(json.dumps({"k13_k8_times": rows, "root": os.path.abspath(root),
                      "card": card_line()}))
    return 0


# K12 at the MINRES rung's (16, 15768) in float64 and in float32 (the
# mixed-precision inner cycles' dtype), and at one long row (synth's n)
K12_SHAPES = ((16, 15768, "float64"), (16, 15768, "float32"),
              (1, 47480, "float64"))
RUNG_RUNS = 3


def k12_state(B, n, dts, dev):
    """K12's seeded mid-run state at (B, n) in ``dts``, every row active
    and tol 0, so that no row stops through the timed calls: w = d v for
    a diagonal d, unit rows v, a unit v_prev orthogonal to v, d, d_prev
    and x normal, the Givens scalars on the unit circle."""
    import torch

    g = torch.Generator().manual_seed(SEED + B * n)
    f = dict(generator=g, dtype=torch.float64)
    diag = torch.rand(n, **f) + 0.5
    v = torch.randn(B, n, **f)
    v /= v.norm(dim=1, keepdim=True)
    vp = torch.randn(B, n, **f)
    vp -= (vp * v).sum(1, keepdim=True) * v
    vp /= vp.norm(dim=1, keepdim=True)
    d, dp, x = (torch.randn(B, n, **f) for _ in range(3))
    th = 2 * torch.pi * torch.rand(2, B, **f)
    scal = (0.1 + 0.4 * torch.rand(B, **f), th[0].cos(), th[0].sin(),
            th[1].cos(), th[1].sin(), 0.5 + 1.5 * torch.rand(B, **f))
    dtype = getattr(torch, dts)
    st = [t.to(dev, dtype) for t in (v * diag, x, v, vp, d, dp) + scal]
    return st + [torch.ones(B, dtype=torch.int32, device=dev),
                 torch.zeros(B, dtype=torch.int32, device=dev),
                 torch.zeros(1, dtype=dtype, device=dev)]


def _weather_model(dev, ctx):
    """The weather model at its initial parameters, built once for all
    the names of one ``--times`` run."""
    if "wm" not in ctx:
        import runlmc_tpu_torch as T
        from runlmc_tpu_torch.datasets import weather_synthetic

        wx, wy, _, _, _ = weather_synthetic(SEED)
        ctx["wm"] = T.InterpolatedLLGP(
            wx, wy, functional_kernel=weather_spec(T, len(wx)), m=WEATHER_M,
            objective="stochastic", seed=SEED, device=dev)
    return ctx["wm"]


def k12_rows(dev, helpers, ctx):
    """``--times K12``: K12 at ``K12_SHAPES`` (:func:`k12_state`; the
    sha256 of the state after the first call), ``fill_`` of the five
    arrays it writes and of all eleven it moves; K13's sha256 at
    ``K13_SHAPES`` (its reduction is K12's); then the plain MINRES rung
    on the weather model at its initial parameters (16 right-hand sides,
    the certified solve's ``RUNG_MAXITER`` and ``KRYLOV_CYCLE``): after
    a warm-up run, ``RUNG_RUNS`` walls, iterations, residual, and its
    first cycle's device ms by layer (:func:`rung_cycle_layers`)."""
    import torch

    from runlmc_tpu_torch import hopper
    from runlmc_tpu_torch.hopper import lanczos, minres
    from runlmc_tpu_torch.models.interpolated_llgp import (
        KRYLOV_CYCLE,
        RUNG_MAXITER,
    )
    from runlmc_tpu_torch.ops.solvers import batched_minres

    sha, host_us, emit, timed = helpers
    for B, n, dts in K12_SHAPES:
        st = k12_state(B, n, dts, dev)
        shape = dict(name="minres_update", dtype=dts, shape=[B, n])
        if hasattr(minres, "lanczos_cluster"):
            shape["cluster"] = minres.lanczos_cluster(B, n, st[2].dtype)
        timed(lambda st=st: (minres.minres_update(*st), st[1:14])[1],
              **shape)
        for k in (5, 11):
            fill = torch.empty((k, B, n), dtype=st[2].dtype, device=dev)
            timed(lambda fill=fill: fill.fill_(1.0), host=False,
                  name="fill_ (%d (B, n) arrays)" % k, dtype=dts,
                  shape=[k, B, n])
        del st, fill
    for B, n, dts in K13_SHAPES:
        d, v, vp, w, beta, alive, eps = k13_state(lanczos, B, n, dts, dev)
        emit(dict(name="lanczos_step", dtype=dts, shape=[B, n],
                  sha256=sha(lambda: lanczos.lanczos_step(
                      w, vp, v, beta, alive, eps))))
    wm = _weather_model(dev, ctx)
    wrhs = torch.cat([wm.y[None], wm._probes(SEED, 0)], 0)
    wK = wm._kski()
    walls = []
    for _ in range(RUNG_RUNS + 1):  # the first warms up, untimed
        torch.cuda.synchronize()
        hopper.reset_launches()
        t0 = time.perf_counter()
        res = batched_minres(wK.matvec, wrhs, tol=wm.tolerance,
                             maxiter=RUNG_MAXITER, cycle=KRYLOV_CYCLE,
                             stall_ratio=0.999)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    emit(dict(name="MINRES rung (weather, initial parameters, %d rhs)"
              % wrhs.shape[0], wall_s=walls[1:],
              iterations=int(torch.max(res.iterations)),
              residual=float(torch.max(res.error)), tolerance=wm.tolerance,
              k12_launches=hopper.launch_counts()["minres_update/f64"],
              first_cycle_layers=rung_cycle_layers(wK.matvec, wrhs,
                                                   wm.tolerance)))


def k8f_rows(dev, helpers, ctx):
    """``--times K8F``: K8 (fft) forward on the weather model's fft group
    (its table rows and distances, Q = 6, m = 2504 embedded in 8192), in
    float64 and float32, with ``fill_`` of its output's bytes."""
    import torch

    from runlmc_tpu_torch.hopper import kern_rows_fft as k8f

    sha, host_us, emit, timed = helpers
    wm = _weather_model(dev, ctx)
    gd = wm.grid_data[0]
    kinds, prm = wm.spec.table_rows(wm.params, gd.plan.kidxs)
    for dtype in (torch.float64, torch.float32):
        p, dists = prm.detach().to(dtype), gd.dists.to(dtype)
        E = k8f.kern_rows_fft(kinds, p, dists, gd.plan.sizes)
        timed(lambda p=p, dists=dists: k8f.kern_rows_fft(
                  kinds, p, dists, gd.plan.sizes),
              name="kern_rows_fft", dtype=str(dtype)[6:],
              shape=list(E.shape), Q=len(kinds), m=dists.numel())
        fill = torch.empty_like(E)
        timed(lambda fill=fill: fill.fill_(1.0), host=False,
              name="fill_ (K8 (fft) forward's output bytes)",
              dtype=str(dtype)[6:], shape=list(E.shape))


def k10r_rows(dev, helpers, ctx):
    """``--times K10R``: K10 forward and its backward (float64, float32)
    on the weather model's 'slfm' symbols over 16 seeded operand spectra
    and cotangents, at the full range and at each rank's Fourier range
    of two (phase 17's grid layout), with ``fill_`` of each output's
    bytes and each output's sha256 (compare two archives' in one call).
    Where the package has the backward's selector (``bwd_tile``), the
    backward at each of ``K10_BWD_SWEEP_TILES`` and
    ``K10_BWD_SWEEP_ROWS`` is timed as well (queued, with its sha256).
    A package without the range (a parent's archive) times the full
    range only, and the float32 backward only where it has the
    range."""
    import inspect

    import torch

    from runlmc_tpu_torch.hopper import fourier

    sha, host_us, emit, timed = helpers
    wm = _weather_model(dev, ctx)
    ranged = "f0" in inspect.signature(fourier.fourier_contract).parameters
    tiles = hasattr(fourier, "bwd_tile")
    gen = torch.Generator(device="cpu").manual_seed(MESH_VEC_SEED)
    for dtype, gs in ((torch.float64, wm._kski().groups[0]),
                      (torch.float32, wm._kski32().groups[0])):
        D, F = gs.diag_That.shape
        ct = torch.complex128 if dtype == torch.float64 else torch.complex64
        vf = torch.randn(MESH_VECS, D, F, generator=gen, dtype=ct).to(dev)
        G = torch.randn(MESH_VECS, D, F, generator=gen, dtype=ct).to(dev)
        ranges = [(0, F)] + ([(0, (F + 1) // 2), ((F + 1) // 2, F)]
                             if ranged else [])
        for f0, f1 in ranges:
            sym = gs.That_rep[:, f0:f1].contiguous()
            diag = gs.diag_That[:, f0:f1].contiguous()
            kw = {"f0": f0} if ranged else {}
            args = ("slfm", vf, gs.A, sym, diag)
            shape = dict(dtype=str(dtype)[6:], range=[f0, f1 - f0], F=F)
            timed(lambda args=args, kw=kw: fourier.fourier_contract(
                *args, **kw), name="fourier_contract", **shape)
            out = torch.empty((MESH_VECS, D, f1 - f0), dtype=ct, device=dev)
            timed(lambda out=out: out.fill_(1.0), host=False,
                  name="fill_ (K10's output bytes)", **shape)
            if dtype == torch.float32 and not ranged:
                continue
            Gr = G[..., f0:f1].contiguous()

            def bwd(Gr=Gr, kw=kw):
                return fourier.fourier_contract_bwd(Gr, vf, **kw)

            row = dict(shape)
            if tiles:
                row["tile_chunk"] = list(fourier.bwd_tile(
                    MESH_VECS, D, f1 - f0, ct,
                    sms=torch.cuda.get_device_properties(
                        dev).multi_processor_count))
            timed(bwd, name="fourier_contract_bwd", **row)
            Hout = torch.empty((D, D, f1 - f0), dtype=ct, device=dev)
            timed(lambda Hout=Hout: Hout.fill_(1.0), host=False,
                  name="fill_ (K10 backward's output bytes)", **shape)
            for t in (K10_BWD_SWEEP_TILES if tiles else ()):
                for rows in K10_BWD_SWEEP_ROWS:
                    with k10_bwd_tile(t, rows):
                        emit(dict(name="fourier_contract_bwd (tile %d, %d "
                                  "rows)" % (t, rows), sha256=sha(bwd),
                                  queued_ms=queued_time(bwd), **shape))


@contextlib.contextmanager
def k10_bwd_tile(tile, rows):
    """K10's backward selector held at ``tile`` frequencies a CTA and
    ``rows`` batch rows a chunk (at most the batch)."""
    from runlmc_tpu_torch.hopper import fourier

    saved = fourier.bwd_tile
    fourier.bwd_tile = (lambda nb, D, F, dtype, sms=None:
                        (tile, max(1, min(rows, nb))))
    try:
        yield
    finally:
        fourier.bwd_tile = saved


def k10b_rows(dev, helpers, ctx):
    """``--times K10B``: the device µs of FourierContract.backward per
    weather stochastic step (``K10B_STEPS`` steps' gradients at the
    initial parameters, profiled) and per grid-layout step (each rank of
    phase 17's 'grid' configuration, spawned from this checkout), in all
    and by part (:func:`k10_bwd_split`): the H kernel, symbol_grads'
    einsums, the adjoint forward, the range's zero-filled operand
    cotangent."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sha, host_us, emit, timed = helpers
    wm = _weather_model(dev, ctx)
    x0 = torch.as_tensor(wm.param_array, dtype=wm.dtype, device=dev)
    probes = wm._probes(SEED, 0)
    wm._stochastic_grad(x0, probes)
    torch.cuda.synchronize()
    with k10_bwd_ranges(), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        for _ in range(K10B_STEPS):
            wm._stochastic_grad(x0, probes)
        torch.cuda.synchronize()
    emit(dict(name="K10 backward per weather stochastic step",
              steps=K10B_STEPS, **k10_bwd_split(prof, K10B_STEPS)))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_k10b_")
    procs = mesh_spawn(["grid"], tmp)
    try:
        mesh_wait(procs, time.time(), tmp)
    finally:
        mesh_kill(procs)
    for r in range(MESH_CONFIGS["grid"][0]):
        with open(os.path.join(tmp, "grid.rank%d.json" % r)) as f:
            res = json.load(f)
        emit(dict(name="K10 backward per grid-layout step", rank=r,
                  fourier_range=res["fourier_range"], **res["k10_bwd"]))
    shutil.rmtree(tmp, ignore_errors=True)


TIMES = {"K12": k12_rows, "K8F": k8f_rows, "K10R": k10r_rows,
         "K10B": k10b_rows}
# weather stochastic steps profiled by ``--times K10B``; the tile widths
# and batch rows a chunk at which ``--times K10R`` also times K10's
# backward
K10B_STEPS = 3
K10_BWD_SWEEP_TILES = (16, 8, 4)
K10_BWD_SWEEP_ROWS = (16, 8, 4)


def times(names, root):
    """``--times NAME[,NAME] [ROOT]``: the timing rows of each named set
    (``TIMES``: ``K12`` :func:`k12_rows`, ``K8F`` :func:`k8f_rows`,
    ``K10R`` :func:`k10r_rows`, ``K10B`` :func:`k10b_rows`) of
    the package at ROOT (this checkout by default), through
    :func:`timing_rows` (profiler device ms, CUDA events, queued ms,
    sha256, host µs per call), then ``fill_`` of one element, the
    card's launch floor. One JSON line at the end; to compare two
    checkouts on one card, run it for each in one call, in turns."""
    import torch

    unknown = [n for n in names if n not in TIMES]
    if unknown or not names:
        print("chip_smoke: --times takes names from %s, got %s"
              % (",".join(TIMES), ",".join(names)), file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    dev = torch.device("cuda")
    rows = []
    helpers = timing_rows(rows)
    ctx = {}
    for name in names:
        TIMES[name](dev, helpers, ctx)
    one = torch.empty(1, device=dev)
    for _ in range(2):
        helpers[3](lambda: one.fill_(1.0), name="fill_ (one element)")
    print(json.dumps({"times": rows, "names": names,
                      "root": os.path.abspath(root), "card": card_line()}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(*sys.argv[2:7]))
    if sys.argv[1:2] == ["--times"]:
        sys.exit(times(sys.argv[2].split(",") if len(sys.argv) > 2 else [],
                       sys.argv[3] if len(sys.argv) > 3 else HERE))
    if sys.argv[1:2] == ["--k3-bwd-times"]:
        sys.exit(k3_bwd_times(sys.argv[2] if len(sys.argv) > 2 else HERE))
    if sys.argv[1:2] == ["--bwd-times"]:
        sys.exit(bwd_times(sys.argv[2] if len(sys.argv) > 2 else HERE))
    if sys.argv[1:2] == ["--fwd-times"]:
        sys.exit(fwd_times(sys.argv[2] if len(sys.argv) > 2 else HERE))
    if sys.argv[1:2] == ["--k10-k9-times"]:
        sys.exit(k10_k9_times(sys.argv[2] if len(sys.argv) > 2 else HERE))
    if sys.argv[1:2] == ["--k13-k8-times"]:
        sys.exit(k13_k8_times(sys.argv[2] if len(sys.argv) > 2 else HERE))
    sys.exit(main())

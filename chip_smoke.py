#!/usr/bin/env python3
"""Smoke run of the PyTorch port (runlmc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases:

1. print the card's name and power limit (``nvidia-smi``); require a
   CUDA device and TF32 off;
2. build every CUDA kernel from ``runlmc_tpu_torch/hopper/csrc`` (one
   ``nvcc`` per source, all at once);
3. build the model of the slice — ``InterpolatedLLGP`` on an
   fx2007-shaped synthetic problem (D=13 outputs, n=3113 training and
   150 held-out points, Q=1 RBF of rank 2, m=[234] -> 238 grid points,
   Dm=3094) in float64 on the card — and hold each hand kernel against
   its plain PyTorch version on the card at the shapes of that path,
   with times (CUDA events), the library call's time where one PyTorch
   call computes the same function, and the least time the card could
   take (bytes over 3.35 TB/s, operations over the peak rate);
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
6. print the kernel table as one JSON line (each row's ``launches``
   counted on its own path, named in ``path``), the card line again,
   and as the last line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero without the last line. Detailed
results also go to ``chiprun_out/chip_smoke.json``.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM figures (NVIDIA data sheet): HBM rate and the peak
# rates outside the tensor cores
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

SEED = 0
TOLERANCE = 1e-8
# CPU vs card agreement of the predictions, relative to the largest
# magnitude: both solves are certified to an absolute residual of
# TOLERANCE, and the f32 inner cycles round differently on each device
PREDICT_RTOL = 1e-6


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


def _self_device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def device_profile(fn, reps=1):
    """(device ms per call, [(kernel, calls, device ms)] by time, wall ms
    per call) of ``fn`` under torch.profiler, counting device-side
    events only; device ms is None when the profiler records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / reps
    rows = [(e.key, e.count, _self_device_us(e) / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _self_device_us(e) > 0]
    rows.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    return (total / reps if total > 0 else None), rows, wall_ms


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")] * 1e3
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import runlmc_tpu_torch as T
    from runlmc_tpu_torch import config, hopper
    from runlmc_tpu_torch.datasets import fx2007_synthetic
    from runlmc_tpu_torch.hopper import build, cg, cross, interp, kuu
    from runlmc_tpu_torch.lmc.woodbury import woodbury_pcg
    from runlmc_tpu_torch.models.interpolated_llgp import RUNG_MAXITER
    from runlmc_tpu_torch.utils.carry import cast_params, from_reference_params

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
               plain_fn, moved, flops, library_fn=None):
        torch.cuda.synchronize()
        abs_err, rel_err = errors(got, want)
        ms = cuda_time(fn)
        plain_ms = cuda_time(plain_fn)
        device_ms = device_profile(fn, reps=10)[0]
        plain_device_ms = device_profile(plain_fn, reps=10)[0]
        library_ms = cuda_time(library_fn) if library_fn else None
        bms, by = bound_ms(moved, flops, dtype)
        row = {
            "name": name, "dtype": str(dtype).replace("torch.", ""),
            "route": route, "source": source, "replaces": replaces,
            "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms,
            "bound_ms": bms, "bound_by": by,
        }
        print("kernel %-15s %-7s rel err %.3e (tol %.0e)  %.4f ms (device "
              "%s)  plain %.4f ms (device %s)  library %s  bound %.4f ms (%s)"
              % (name, row["dtype"], rel_err, tol, ms, _ms(device_ms),
                 plain_ms, _ms(plain_device_ms), _ms(library_ms), bms, by),
              flush=True)
        require(rel_err <= tol, "%s %s disagrees with its plain version"
                % (name, row["dtype"]))
        rows.append(row)

    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=gen, dtype=dtype).to(dev)

    # K1: K_UU at the model dtype and for the f32 preconditioner
    for dtype in (torch.float64, torch.float32):
        p = cast_params(model.params, dtype)
        gd = model.grid_data[0] if dtype == torch.float64 else \
            model.grid_data32[0]
        tops = spec.eval_kernels_stacked(p, gd.dists, gd.plan.kidxs)
        B = spec.coreg_mats(p, gd.plan.kidxs)
        sizes = gd.plan.sizes
        out = kuu.kuu_dense(tops, B, sizes)
        want = kuu.kuu_dense_plain(tops, B, sizes)
        record("kuu_dense", dtype, "cuda",
               "runlmc_tpu_torch/hopper/csrc/kuu_dense.cu",
               "runlmc_tpu/lmc/grid.py:537", out, want,
               1e-12 if dtype == torch.float64 else 1e-6,
               lambda: kuu.kuu_dense(tops, B, sizes),
               lambda: kuu.kuu_dense_plain(tops, B, sizes),
               nbytes(out, tops, B), 2.0 * out.numel() * tops.shape[0])

    # K7: K_*X of the prediction path (f64), then a mixed table of all
    # five kernel kinds on a 2-D input
    from runlmc_tpu_torch.lmc import likelihood as lk

    td = lk.flatten_data(txs, [np.zeros(len(x)) for x in txs])
    xa = torch.as_tensor(td.X, dtype=torch.float64, device=dev)
    oa = torch.as_tensor(td.output_idx, device=dev)
    Bq = spec.coreg_mats(model.params)
    table = spec.kernel_table(model.params)
    args = (xa, oa, model.X, model.oidx, Bq) + table
    out = cross.cross_kernel(*args)
    flops = 12.0 * out.numel() * Bq.shape[0]
    record("cross_kernel", torch.float64, "cuda",
           "runlmc_tpu_torch/hopper/csrc/cross_kernel.cu",
           "runlmc_tpu/lmc/likelihood.py:85", out,
           cross.cross_kernel_plain(*args), 1e-12,
           lambda: cross.cross_kernel(*args),
           lambda: cross.cross_kernel_plain(*args),
           nbytes(out, *args), flops)

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
    smse = [float(np.mean((a - b) ** 2) / np.var(b))
            for a, b in zip(mu, tys) if len(b)]
    print("card vs CPU (CPU run %.1f s): mean rel err %.3e, variance rel "
          "err %.3e (tol %g); SMSE per held-out output %s"
          % (cpu_s, mean_err, var_err, PREDICT_RTOL, smse), flush=True)
    require(mean_err <= PREDICT_RTOL and var_err <= PREDICT_RTOL,
            "card and CPU predictions disagree")

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

    # ------------------------------------------------------------ phase 6
    for row in rows:
        key = "%s/%s" % (row["name"], row["dtype"].replace("float", "f"))
        if key in hopper.PREDICT_PATH:
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
        "launches": launches, "report": res,
        "escalation": {"s": esc_s, "iterations": esc_iters,
                       "residual": esc_worst, "launches": esc_launches},
        "card_vs_cpu": {"mean_rel_err": mean_err, "var_rel_err": var_err},
        "smse": smse,
    }
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

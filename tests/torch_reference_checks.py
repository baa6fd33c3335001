"""Checks of the port against the JAX package that take minutes on the
CPU, so they are a script and not tests: the float32 fits and jitter
rungs behind ROADMAP.md's queue 3. Both packages run on the CPU in
float64 models with float32 factorizations, from the same numpy data.

    python tests/torch_reference_checks.py fx2007 [--package jax|port]
    python tests/torch_reference_checks.py synth

fx2007: the fx2007 twin (``datasets.fx2007_synthetic``, seed 0; bench.py's
shape: Q=1 RBF of rank 2, m=[234], tolerance 1e-8, the exact objective,
AdaDelta(min_grad_ratio=0.2)) trained to its stopping rule by each
package: the stopping iteration, SMSE and NLPD on the held-out windows,
and the exact log-likelihood at the trained parameters; then, at each
package's trained parameters, the float32 K_UU of each package factored
by each package's ``chol_jittered``: the rung of the (1e-6, 1e-4, 1e-2)
ladder it lands on, and the lowest eigenvalue of the equilibrated
float32 K_UU in float64. Both packages are imported from the checkout
that holds this script.

synth: bench.py's reduced synth copy (every 30th point, m=[8, 8],
tolerance 1e-3, the exact objective, AdaDelta's defaults) trained 50
float32 steps from the same start by each package, chunk by chunk: each
step's factorization residual and the first step above the escalation
threshold; and at every other step's parameters the port's float32
residual and the condition number and lowest eigenvalue of the
equilibrated float32 C and K_UU, in float64.

Each prints one JSON object per package.
"""

import argparse
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KUU_LADDER = (1e-6, 1e-4, 1e-2)


def _fx2007_spec(pkg):
    return pkg.LMCKernelSpec.create(D=13, lmc_kernels=[pkg.RBF(name="rbf0")],
                                    lmc_ranks=[2])


def _eig_equilibrated(A):
    A = np.asarray(A, dtype=np.float64)
    s = 1.0 / np.sqrt(np.abs(np.diag(A)))
    return np.linalg.eigvalsh(A * s[:, None] * s[None, :])


def fx2007(which):
    import torch

    import runlmc_tpu as R
    import runlmc_tpu_torch as T
    from runlmc_tpu.lmc import grid as jgrid
    from runlmc_tpu.lmc import woodbury as jwb
    from runlmc_tpu.utils.evaluation import nlpd, smse
    from runlmc_tpu_torch.datasets import fx2007_synthetic
    from runlmc_tpu_torch.lmc import grid as tgrid
    from runlmc_tpu_torch.lmc import woodbury as twb
    from runlmc_tpu_torch.utils.carry import cast_params

    xss, yss, txs, tys = fx2007_synthetic(0)
    kw = dict(m=[234], tolerance=1e-8, objective="exact")
    if which == "jax":
        m = R.InterpolatedLLGP(xss, yss, functional_kernel=_fx2007_spec(R),
                               **kw)
        info = m.optimize(R.AdaDelta(min_grad_ratio=0.2))
    else:
        m = T.InterpolatedLLGP(xss, yss, functional_kernel=_fx2007_spec(T),
                               device="cpu", **kw)
        info = m.optimize(T.AdaDelta(min_grad_ratio=0.2))
    mu, var = m.predict(txs)
    x = np.asarray(m.param_array)
    out = {"package": which, "n_iter": int(info["n_iter"]),
           "exact_precision": m.exact_precision,
           "smse": float(smse(tys, mu, yss)),
           "nlpd": float(nlpd(tys, mu, var)),
           "exact_mll": float(m.log_likelihood())}
    # each package's float32 K_UU at these parameters
    jm = R.InterpolatedLLGP(xss, yss, functional_kernel=_fx2007_spec(R),
                            **kw)
    jm.param_array = x
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jm.params)
    K = {"jax_kuu": np.asarray(jgrid.build_kski(
        jm.spec, p32, jm.grid_data32, jm.data.lens).groups[0].KUU_dense)}
    tm = T.InterpolatedLLGP(xss, yss, functional_kernel=_fx2007_spec(T),
                            device="cpu", **kw)
    tm.param_array = x
    K["port_kuu"] = tgrid.build_kski(
        tm.spec, cast_params(tm.params, torch.float32), tm.grid_data32,
        tm.data.lens).groups[0].KUU_dense.detach().numpy()
    out["kuu_rel_diff"] = float(np.abs(K["jax_kuu"] - K["port_kuu"]).max()
                                / np.abs(K["jax_kuu"]).max())
    for name, A in K.items():
        # the JAX package: the first scale whose factor is finite
        out["jax_rung_on_" + name] = next(
            (i for i, c in enumerate(KUU_LADDER) if np.all(np.isfinite(
                np.asarray(jwb.chol_jittered(jnp.asarray(A), scales=(c,)))))),
            len(KUU_LADDER) - 1)
        # the port: the first scale whose flag is read as set
        seen, real = [], twb._accepted
        twb._accepted = lambda f: seen.append(real(f)) or seen[-1]
        try:
            twb.chol_jittered(torch.as_tensor(A), scales=KUU_LADDER)
        finally:
            twb._accepted = real
        out["port_rung_on_" + name] = (seen.index(True) if True in seen
                                       else len(KUU_LADDER) - 1)
        out["eigmin_equilibrated_" + name] = float(
            _eig_equilibrated(A)[0])
    return out


def synth():
    import torch

    import runlmc_tpu as R
    import runlmc_tpu_torch as T
    from runlmc_tpu.models.interpolated_llgp import EXACT_RESIDUAL_THRESHOLD
    from runlmc_tpu_torch.datasets import synth_synthetic
    from runlmc_tpu_torch.lmc import woodbury as twb
    from runlmc_tpu_torch.utils.carry import unravel_params

    xss, yss, _, _ = synth_synthetic(0)
    rx, ry = [x[::30] for x in xss], [y[::30] for y in yss]

    def spec(pkg):
        return pkg.LMCKernelSpec.create(
            D=5, slfm_kernels=[pkg.RBF(name="slfm0"), pkg.RBF(name="slfm1")],
            indep_gp=[pkg.RBF(name="rbf%d" % i) for i in range(5)])

    kw = dict(m=[8, 8], tolerance=1e-3, objective="exact")
    jm = R.InterpolatedLLGP(rx, ry, functional_kernel=spec(R), **kw)
    tm = T.InterpolatedLLGP(rx, ry, functional_kernel=spec(T), device="cpu",
                            **kw)
    x0 = np.asarray(jm.param_array)
    assert np.array_equal(x0, tm.param_array)
    opt = R.AdaDelta()
    hp = jnp.asarray([opt.step_rate, opt.decay, opt.momentum, opt.offset],
                     dtype=jnp.float64)

    def at(x):
        """The port's float32 residual at x, and the conditioning of the
        float32 K_UU and C its factorization takes."""
        mats, real = [], twb.chol_jittered

        def spy(A, scales=KUU_LADDER, equilibrate=None):
            mats.append(("C" if scales[0] == 0.0 else "K_UU",
                         A.detach().numpy().copy()))
            return real(A, scales=scales, equilibrate=equilibrate)

        twb.chol_jittered = spy
        try:
            r = float(tm._probe_residual(unravel_params(
                torch.as_tensor(np.array(x)), tm.params), tm._equilibrate))
        finally:
            twb.chol_jittered = real
        row = {"residual": r}
        for kind, A in mats:
            e = _eig_equilibrated(A)
            row["eigmin_" + kind] = float(e[0])
            row["cond_" + kind] = (float(e[-1] / e[0]) if e[0] > 0
                                   else float("inf"))
        return row

    outs = []
    for which in ("jax", "port"):
        z = np.zeros_like(x0)
        st, errs, xs = (x0, z, z, z), [], []
        for c in range(5):
            if which == "jax":
                o = jm._jit_chunk(*[jnp.asarray(a) for a in st],
                                  jax.random.PRNGKey(0),
                                  jnp.asarray(10 * c, jnp.int32), hp,
                                  jm.grid_data, jm.precond_data32,
                                  jm.inner_data32, jm.y)
                o = [np.asarray(a) for a in o]
            else:
                o = tm._chunk(*st, T.AdaDelta(), start=10 * c)
            errs.extend(float(e) for e in o[6])
            xs.extend(np.asarray(o[0]))
            st = tuple(a[-1] for a in o[:4])
        first = next((i for i, e in enumerate(errs)
                      if e > EXACT_RESIDUAL_THRESHOLD), None)
        outs.append({"package": which, "residuals": errs,
                     "first_step_above_threshold": first,
                     "threshold": EXACT_RESIDUAL_THRESHOLD,
                     "every_other_step": [at(x) for x in xs[::2]]})
    return outs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("check", choices=("fx2007", "synth"))
    ap.add_argument("--package", choices=("both", "jax", "port"),
                    default="both", help="fx2007: whose fit to run")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    if args.check == "fx2007":
        outs = [fx2007(p) for p in ("jax", "port")
                if args.package in ("both", p)]
    else:
        outs = synth()
    for out in outs:
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

"""One rank of the port's mesh tests (tests/test_torch_parallel.py,
tests/test_torch_distributed.py), on the CPU over Gloo:

    python tests/torch_mesh_worker.py CASE RANK WORLD RENDEZVOUS IN OUT

starts the process group through ``parallel.initialize`` with the
``FileStore`` at RENDEZVOUS, reads the seeded inputs the test wrote to
IN (numpy), runs CASE in float64 with ``device="cpu"`` and writes its
results to ``OUT.rank<RANK>.npz``. It imports no JAX: the tests hold the
results against the single-process run and the JAX package."""

import os
import sys

os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import runlmc_tpu_torch as T  # noqa: E402
import runlmc_tpu_torch.parallel as par  # noqa: E402
from runlmc_tpu_torch.lmc import grid as tgrid  # noqa: E402
from runlmc_tpu_torch.lmc import likelihood as tlk  # noqa: E402
from runlmc_tpu_torch.ops.solvers import batched_cg  # noqa: E402
from runlmc_tpu_torch.parallel.collectives import mesh_mean  # noqa: E402
from runlmc_tpu_torch.utils.carry import (  # noqa: E402
    from_reference_params,
    ravel_params,
    unravel_params,
)

DT = torch.float64


def sincos_spec(pkg):
    """The two-output model of tests/test_parallel.py."""
    return pkg.LMCKernelSpec.create(D=2, lmc_kernels=[pkg.RBF(name="k")],
                                    lmc_ranks=[1])


def slfm_spec(pkg, D=3):
    """The weather configuration's kernel at D outputs: SLFM rank 2 plus
    a frozen-scale RBF per output."""
    return pkg.LMCKernelSpec.create(
        D=D, slfm_kernels=[pkg.RBF(name="slfm0"), pkg.RBF(name="slfm1")],
        indep_gp=[pkg.Scaled(inner=pkg.RBF(name="rbf%d" % i),
                             trainable_scale=False) for i in range(D)])


def ski_spec(pkg):
    """tests/test_torch_likelihood.py's exact-objective problem."""
    return pkg.LMCKernelSpec.create(
        D=2, lmc_kernels=[pkg.RBF()], lmc_ranks=[2],
        indep_gp=[pkg.Matern32(name="i")])


def split(inp, name):
    """The per-output arrays ``name0``, ``name1``, ... of the inputs."""
    out, d = [], 0
    while "%s%d" % (name, d) in inp:
        out.append(inp["%s%d" % (name, d)])
        d += 1
    return out


def flat_grad(fn, params):
    x = ravel_params(params).detach().clone().requires_grad_(True)
    out = fn(unravel_params(x, params))
    (g,) = torch.autograd.grad(out, x)
    return out.detach(), g


def grid_states(inp, mesh, mode, rep):
    """The slfm spec's group state on the unit inputs, in ``mode``
    ('fft' or 'dense') with representation ``rep``, sharded over the
    mesh's 'grid' axis (none without a mesh)."""
    spec = slfm_spec(T).with_input_dim(1)
    gds, _ = tgrid.make_grids(spec, split(inp, "gx"), m=[13], rep=rep,
                              mode=mode)
    gd = gds[0]
    if mesh is not None:
        import dataclasses

        gd = gd.replace(plan=dataclasses.replace(gd.plan,
                                                 grid_shard=(mesh, "grid")))
    params = unravel_params(torch.as_tensor(inp["gp"]),
                            from_reference_params(spec.init_raw_params(),
                                                  DT, "cpu"))
    return spec, gd.to(DT, "cpu"), params


def grid_case(inp, mesh, mode, rep):
    """grid_matvec on the seeded vectors, and the gradient of a seeded
    linear functional of it in the raw parameters (averaged over the
    mesh)."""
    spec, gd, params = grid_states(inp, mesh, mode, rep)
    u = torch.as_tensor(inp["gu"])
    w = torch.as_tensor(inp["gw"])
    state = tgrid.build_group_state(spec, params, gd)
    out = state.grid_matvec(u)

    def loss(p):
        return torch.sum(w * tgrid.build_group_state(spec, p, gd)
                         .grid_matvec(u))

    _, g = flat_grad(loss, params)
    return out.numpy(), mesh_mean(g, mesh).numpy()


def case_units(inp, rank, world):
    """tests/test_torch_parallel.py: the sharded solve, grid_matvec on a
    'grid' mesh (fft in every representation, and a dense group), the
    data-sharded exact objective and the probe-sharded surrogate."""
    res = {}
    probe = par.default_mesh(world)
    grid = par.default_mesh(world, axis_name="grid")
    if world > 1:
        gm = par.global_mesh(grid_axis=world)
        res["global_shape"] = np.asarray(gm.devices.shape)
        res["global_index"] = np.asarray([gm.index("probe"),
                                          gm.index("grid")])
        res["global_1d"] = np.asarray(par.global_mesh().devices.shape)
    # the sharded solve: an uneven batch of an SPD system
    A = torch.as_tensor(inp["A"])
    got = tlk.sharded_solve(
        lambda b: batched_cg(lambda v: v @ A.T, b, tol=1e-12),
        torch.as_tensor(inp["rhs"]), (probe, "probe"))
    for k, v in got._asdict().items():
        res["solve_" + k] = v.numpy()
    for mode, rep in (("fft", "slfm"), ("fft", "sum"), ("fft", "bt"),
                      ("dense", "slfm")):
        res["mv_%s_%s" % (mode, rep)], res["mvg_%s_%s" % (mode, rep)] = \
            grid_case(inp, grid, mode, rep)
    # the data-sharded exact objective
    spec = ski_spec(T).with_input_dim(1)
    Xs = split(inp, "sx")
    gds, _ = tgrid.make_grids(spec, Xs, m=[10])
    gds = tuple(gd.to(DT, "cpu") for gd in gds)
    lens = [len(X) for X in Xs]
    y = torch.as_tensor(inp["sy"])
    params = unravel_params(torch.as_tensor(inp["sp"]),
                            from_reference_params(spec.init_raw_params(),
                                                  DT, "cpu"))
    auxes = []

    def mll(p):
        v, aux = tlk.exact_ski_mll(spec, p, gds, lens, y,
                                   data_shard=(probe, "probe"))
        auxes.append(aux)
        return v

    v, g = flat_grad(mll, params)
    res.update(exact_value=v.numpy(), exact_grad=mesh_mean(g, probe).numpy(),
               exact_grad_local=g.numpy(),
               exact_alpha=auxes[0].alpha.numpy(),
               exact_error=auxes[0].solve_error.numpy(),
               exact_quad=auxes[0].quad.numpy())
    # the probe-sharded surrogate, preconditioned and plain
    model = T.InterpolatedLLGP(split(inp, "kx"), split(inp, "ky"),
                               functional_kernel=slfm_spec(T), m=[24],
                               grid_mode="fft", objective="stochastic",
                               seed=3, device="cpu")
    model.param_array = inp["kp"]
    probes = torch.as_tensor(inp["kprobes"])
    for name, kw in (("precond", dict(grid_data32=model.precond_data32,
                                      inner_data32=model.inner_data32)),
                     ("plain", {})):
        def surrogate(p, kw=kw):
            s, aux = tlk.stochastic_mll_surrogate(
                model.spec, p, model.grid_data, model.data.lens, model.y,
                probes, tol=1e-10, rhs_sharding=(probe, "probe"), **kw)
            return -s

        _, g = flat_grad(surrogate, model.params)
        res["surrogate_" + name] = mesh_mean(g, probe).numpy()
    return res


def sincos(inp, mesh, **kw):
    """tests/test_parallel.py's two-output model on the fed inputs; a
    stochastic model reads its probes from ``probes<it>``."""
    kw = dict(dict(m=[16], seed=1, trace_iterations=16), **kw)
    m = T.InterpolatedLLGP(split(inp, "x"), split(inp, "y"),
                           functional_kernel=sincos_spec(T), mesh=mesh,
                           device="cpu", **kw)
    m.param_array = inp["p0"]
    m.probe_stream = lambda run_seed, it: inp["probes%d" % it]
    return m


def train(res, name, m, max_it, predict=False):
    info = m.optimize(T.AdaDelta(max_it=max_it))
    res[name + "_params"] = m.param_array
    res[name + "_n_iter"] = np.asarray(info["n_iter"])
    res[name + "_grad_norms"] = np.asarray(info["grad_norms"])
    res[name + "_objective"] = np.asarray(m.objective)
    if predict:
        mus, vs = m.predict([inp_test(m)] * 2)
        res[name + "_mu"] = np.concatenate(mus)
        res[name + "_var"] = np.concatenate(vs)


def inp_test(m):
    return np.linspace(1, 5, 7)[:, None]


def case_train2(inp, rank, world):
    """tests/test_torch_distributed.py on two ranks: probe-mesh training,
    the data-sharded exact objective with a predict, its reports and a
    checkpoint restored into a meshless model, and a 'grid'-only mesh (no
    RHS sharding) on an fft model with a predict and its SLQ report."""
    import tempfile

    res = {}
    train(res, "probe", sincos(inp, par.default_mesh(world),
                               tolerance=1e-11, objective="stochastic"), 12)
    m = sincos(inp, par.default_mesh(world), objective="exact")
    train(res, "exact", m, 8, predict=True)
    res["exact_ll"] = np.asarray([m.log_likelihood(),
                                  m.log_likelihood(exact=False)])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        m.save(path)
        fresh = sincos(inp, None, objective="exact")
        fresh.restore(path)
    res["exact_restored"] = fresh.param_array
    g = sincos(inp, par.default_mesh(world, axis_name="grid"),
               tolerance=1e-11, objective="stochastic", grid_mode="fft")
    res["gridonly_rhs_sharding"] = np.asarray(g._rhs_sharding is None)
    train(res, "gridonly", g, 4, predict=True)
    res["gridonly_ll"] = np.asarray(g.log_likelihood(exact=False))
    return res


def case_train4(inp, rank, world):
    """tests/test_torch_distributed.py on four ranks: fft training on
    probe_grid_mesh(2, 2), then a predict."""
    res = {}
    train(res, "pg", sincos(inp, par.probe_grid_mesh(2, 2), tolerance=1e-11,
                            objective="stochastic", grid_mode="fft"),
          8, predict=True)
    return res


CASES = {"units": case_units, "train2": case_train2, "train4": case_train4}


def spawn(case, world, inp, tmp, timeout=100):
    """Run ``case`` on ``world`` ranks (this file, one process each, one
    thread each) with the inputs ``inp`` and a ``FileStore`` under
    ``tmp``; each rank's results as a dict. Every rank is killed, and
    the test fails with their output, when one fails or the ranks run
    past ``timeout`` seconds together."""
    import subprocess
    import time

    tmp = str(tmp)
    inputs = os.path.join(tmp, "%s_in.npz" % case)
    np.savez(inputs, **inp)
    out = os.path.join(tmp, case)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r), str(world),
         os.path.join(tmp, "%s_rendezvous" % case), inputs, out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.time())))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate() for p in procs]
        raise AssertionError("%s: ranks timed out after %d s\n%s"
                             % (case, timeout, "\n".join(
                                 e[-3000:] for _, e in logs)))
    bad = [(r, p.returncode, e) for r, (p, (_, e)) in
           enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise AssertionError("%s: ranks failed\n%s" % (case, "\n".join(
            "rank %d exit %d:\n%s" % (r, c, e[-3000:]) for r, c, e in bad)))
    return [dict(np.load("%s.rank%d.npz" % (out, r))) for r in range(world)]


def main(case, rank, world, rendezvous, inputs, out):
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    started = par.initialize("file://" + rendezvous, world, rank,
                             backend="gloo", timeout=60)
    assert started and par.is_distributed()
    inp = dict(np.load(inputs))
    res = CASES[case](inp, rank, world)
    res["world"] = np.asarray(torch.distributed.get_world_size())
    np.savez("%s.rank%d.npz" % (out, rank), **res)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))

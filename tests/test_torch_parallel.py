"""The port's mesh layer (runlmc_tpu_torch/parallel) on the CPU: the mesh
helpers and the launcher, then two ranks over Gloo
(tests/torch_mesh_worker.py) against the single-rank run and the JAX
package: the probe-sharded solve, grid_matvec on a 'grid' mesh (K10 on
each rank's Fourier range, and a dense group's rows), the data-sharded
exact objective and the probe-sharded surrogate. K10's range on its
plain version and, with the card stubbed, what its wrappers pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import runlmc_tpu as R
import runlmc_tpu_torch as T
import runlmc_tpu_torch.parallel as par
import torch_mesh_worker as W
from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu.lmc import likelihood as jlk
from runlmc_tpu_torch.hopper import build, fourier
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.parallel import collectives, launcher, mesh as pmesh

WORLD = 2


def _perturbed(raw, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)), raw)


def _flat(tree):
    return np.array(ravel_pytree(tree)[0])


def _jax_probes(key, n_probes, n):
    return np.array(jlk.rademacher_probes(key, n_probes, n, jnp.float64))


def _inputs():
    """The seeded inputs of every case of ``torch_mesh_worker.case_units``
    (numpy), and the JAX objects the tests compare with."""
    rng = np.random.RandomState(11)
    inp = {}
    M = rng.standard_normal((30, 30))
    inp["A"] = M @ M.T + 30 * np.eye(30)
    inp["rhs"] = rng.standard_normal((5, 30))
    for d, n in enumerate((23, 19, 21)):
        inp["gx%d" % d] = np.sort(rng.uniform(0, 3, n)).reshape(-1, 1)
    spec = W.slfm_spec(T).with_input_dim(1)
    inp["gp"] = _flat(_perturbed(spec.init_raw_params(seed=2), 2))
    gds, _ = tgrid.make_grids(spec, W.split(inp, "gx"), m=[13])
    cols = gds[0].interp.ncols
    inp["gu"] = rng.standard_normal((16, cols))
    inp["gw"] = rng.standard_normal((16, cols))
    # tests/test_torch_likelihood.py's exact problem: 57 rows, split 29/28
    for d, n in enumerate((26, 31)):
        inp["sx%d" % d] = rng.uniform(0, 4, n).reshape(-1, 1)
    inp["sy"] = np.concatenate([np.sin(X[:, 0]) + 0.1 * rng.standard_normal(
        len(X)) for X in W.split(inp, "sx")])
    sj = W.ski_spec(R).with_input_dim(1)
    raw_s = _perturbed(sj.init_raw_params(seed=1), 2)
    inp["sp"] = _flat(raw_s)
    # tests/test_torch_stochastic.py's 1-D fft problem, 4 JAX probes
    rs = np.random.RandomState(31)
    for d, n in enumerate((40, 34, 37)):
        X = np.sort(rs.uniform(0, 6, n))
        inp["kx%d" % d] = X
        inp["ky%d" % d] = np.sin(X + d) + 0.3 * d + 0.05 * rs.randn(n)
    mj = R.InterpolatedLLGP(W.split(inp, "kx"), W.split(inp, "ky"),
                            functional_kernel=W.slfm_spec(R), m=[24],
                            grid_mode="fft", objective="stochastic", seed=3)
    inp["kp"] = mj.param_array + 0.1 * np.cos(np.arange(mj.n_params))
    mj.param_array = inp["kp"]
    inp["kprobes"] = _jax_probes(jax.random.PRNGKey(5), 4, len(mj.data.y))
    return inp, dict(sj=sj, raw_s=raw_s, mj=mj)


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """(inputs, JAX objects, each rank's results, the single-rank
    results)."""
    inp, jx = _inputs()
    tmp = tmp_path_factory.mktemp("mesh_units")
    ranks = W.spawn("units", WORLD, inp, tmp)
    single = W.case_units(inp, 0, 1)
    return inp, jx, ranks, single


# ---- the helpers and the launcher, in this process


def test_pad_batch():
    b = np.arange(35, dtype=float).reshape(5, 7)
    padded, orig = par.pad_batch(b, 8)
    assert padded.shape == (8, 7) and orig == 5
    np.testing.assert_array_equal(padded[:5], b)
    assert not padded[5:].any()
    same, n = par.pad_batch(b, 5)
    assert same is b and n == 5


def test_shard_sizes_split_as_numpy():
    for n, parts in ((3113, 2), (4097, 2), (7, 3), (2, 4), (16, 2)):
        sizes = pmesh.shard_sizes(n, parts)
        want = [len(a) for a in np.array_split(np.arange(n), parts)]
        assert list(sizes) == want
        los = [pmesh.shard_range(n, parts, i) for i in range(parts)]
        assert los[0][0] == 0 and los[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(los, los[1:]))


def test_initialize_is_a_noop_without_a_coordinator(monkeypatch):
    for k in ("COORD", "NPROC", "PROC_ID", "MASTER_ADDR", "WORLD_SIZE",
              "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert par.initialize() is False
    assert not par.is_distributed()
    assert not torch.distributed.is_initialized()


def test_initialize_without_a_process_id_raises(monkeypatch):
    monkeypatch.delenv("PROC_ID", raising=False)
    with pytest.raises(ValueError, match="PROC_ID"):
        par.initialize(coordinator_address="localhost:1", num_processes=2)
    monkeypatch.setenv("COORD", "localhost:1")
    monkeypatch.setenv("NPROC", "2")
    with pytest.raises(ValueError, match="COORD/NPROC set but no process id"):
        par.initialize()


def test_group_timeout_is_bounded():
    assert launcher.DEFAULT_TIMEOUT_S <= 120
    assert launcher.group_timeout().total_seconds() <= 120
    assert launcher.group_timeout(30).total_seconds() == 30


def test_meshes_without_a_process_group_hold_this_process():
    """As JAX's single-host mode: one rank, no groups, every collective
    the identity."""
    m = par.default_mesh(8)
    assert m.size == 1 and m.shape == {"probe": 1} and m.index("probe") == 0
    assert m.group("probe") is None and m.group() is None
    assert m.device == torch.device("cpu")
    g = par.global_mesh(grid_axis=1)
    assert g.axis_names == ("probe",) and g.shape == {"probe": 1}
    pg = par.probe_grid_mesh(1, 1)
    assert pg.shape == {"probe": 1, "grid": 1}
    with pytest.raises(ValueError, match="not divisible"):
        par.global_mesh(grid_axis=2)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        par.probe_grid_mesh(2, 2)
    x = torch.arange(6.0).reshape(3, 2)
    assert collectives.group_sum(x, None) is x
    assert collectives.gather_rows(x, None, (3,)) is x
    assert collectives.gather_last(x, None, (2,)) is x
    assert collectives.mesh_mean(x, m) is x
    assert torch.equal(par.shard_batch(x.numpy(), m), x)
    assert torch.equal(par.replicated(x, m), x)


def test_a_mesh_of_another_type_is_refused():
    Xs, Ys = [np.linspace(0, 1, 9)] * 2, [np.sin(np.linspace(0, 1, 9))] * 2
    with pytest.raises(ValueError, match="Mesh"):
        T.InterpolatedLLGP(Xs, Ys, functional_kernel=W.sincos_spec(T),
                           m=[8], mesh=("probe",), device="cpu")


# ---- K10 on a Fourier range


def _k10_args(rep, nb=5, D=3, K=2, F=41, seed=0):
    rng = np.random.RandomState(seed)

    def c(*shape):
        return torch.as_tensor(rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape))

    vf = c(nb, D, F)
    if rep == "sum":
        return vf, torch.as_tensor(rng.standard_normal((K, D, D))), \
            c(K, F), None
    if rep == "bt":
        return vf, None, c(D, D, F), None
    return vf, torch.as_tensor(rng.standard_normal((D, K))), c(K, F), c(D, F)


@pytest.mark.parametrize("rep", ["sum", "bt", "slfm"])
@pytest.mark.parametrize("f0, nf", [(0, 41), (0, 21), (21, 20), (7, 1)])
def test_fourier_plain_range_is_the_slice_of_the_full_output(rep, f0, nf):
    """The contraction is pointwise in f: a range's output (and its
    backward's H) is that slice of the full range's, to the bit."""
    vf, mat, sym, diag = _k10_args(rep)

    def cut(t):
        return None if t is None else t[..., f0:f0 + nf].contiguous()

    full = fourier.fourier_contract(rep, vf, mat, sym, diag)
    got = fourier.fourier_contract(rep, vf, mat, cut(sym), cut(diag), f0=f0)
    assert got.shape == (5, 3, nf)
    assert torch.equal(got, full[..., f0:f0 + nf])
    G = _k10_args("bt", seed=1)[0][..., :nf].contiguous()
    Gfull = torch.zeros((5, 3, 41), dtype=G.dtype)
    Gfull[..., f0:f0 + nf] = G
    Hfull = fourier.fourier_contract_bwd(Gfull, vf)
    H = fourier.fourier_contract_bwd(G, vf, f0=f0)
    assert torch.equal(H, Hfull[..., f0:f0 + nf])


@pytest.mark.parametrize("rep", ["sum", "bt", "slfm"])
def test_fourier_range_gradients_match_autograd_of_the_slice(rep):
    """contract(f0=...) against autograd through the plain contraction
    of the operand's slice: the operand's cotangent is zero outside the
    range."""
    vf, mat, sym, diag = _k10_args(rep, seed=3)
    f0, nf = 12, 17
    sym, diag = (None if t is None else t[..., f0:f0 + nf].contiguous()
                 for t in (sym, diag))
    G = _k10_args("bt", seed=4)[0][..., :nf].contiguous()
    ins = [t for t in (vf, mat, sym, diag) if t is not None]

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        it = iter(leaves)
        args = [next(it) if t is not None else None
                for t in (vf, mat, sym, diag)]
        return torch.autograd.grad(fn(*args), leaves, G)

    got = grads(lambda v, a, s, d: fourier.contract(rep, v, a, s, d, f0=f0))
    want = grads(lambda v, a, s, d: fourier.fourier_contract_plain(
        rep, v[..., f0:f0 + nf], a, s, d))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)
    assert not got[0][..., :f0].any() and not got[0][..., f0 + nf:].any()


def test_fourier_range_outside_the_operand_raises():
    vf, mat, sym, diag = _k10_args("slfm")
    with pytest.raises(ValueError, match="outside"):
        fourier.fourier_contract("slfm", vf, mat, sym[..., :5],
                                 diag[..., :5], f0=37)


def test_fourier_wrappers_pass_the_range_and_the_operand_stride(monkeypatch):
    """With the card stubbed: the forward and the backward launch on the
    operand's own memory with (f0, its row stride) and an nf-wide
    output."""
    seen = []

    def fake_function(name, symbol, argtypes):
        def fn(*args):
            seen.append((symbol, args))
            return 0
        return fn

    monkeypatch.setattr(build, "use_plain", lambda what, t: False)
    monkeypatch.setattr(build, "require_cuda", lambda what, *ts: None)
    monkeypatch.setattr(build, "function", fake_function)
    monkeypatch.setattr(build, "stream_ptr", lambda device=None: None)
    monkeypatch.setattr(build, "sm_count", lambda index: build.H100_SMS)
    vf, mat, sym, diag = _k10_args("slfm", nb=4, D=4, K=2, F=57)
    g = fourier.fourier_contract("slfm", vf, mat, sym[..., 29:].contiguous(),
                                 diag[..., 29:].contiguous(), f0=29)
    G = torch.zeros((4, 4, 28), dtype=vf.dtype)
    H = fourier.fourier_contract_bwd(G, vf, f0=29)
    (sf, af), (sb, ab) = seen
    assert sf == "fourier_fwd_f64" and af[2] == vf.data_ptr()
    assert af[7:13] == (4, 4, 2, 28, 29, 57)
    assert g.shape == (4, 4, 28) and af[3] == g.data_ptr()
    assert sb == "fourier_bwd_f64" and ab[1].value == vf.data_ptr()
    assert ab[3:8] == (4, 4, 28, 29, 57) and H.shape == (4, 4, 28)
    assert ab[8:10] == fourier.bwd_tile(4, 4, 28, vf.dtype)


# ---- two ranks over Gloo


def test_two_ranks_ran_and_agree_to_the_bit(units):
    """Each rank returns the same bits for every result."""
    _, _, ranks, _ = units
    assert [int(r["world"]) for r in ranks] == [WORLD] * WORLD
    for k in ranks[0]:
        if k == "global_index":
            continue
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_global_mesh_shapes_with_a_grid_axis(units):
    _, _, ranks, _ = units
    for r, res in enumerate(ranks):
        assert res["global_shape"].tolist() == [1, 2]
        assert res["global_index"].tolist() == [0, r]
        assert res["global_1d"].tolist() == [2]


def test_sharded_solve_matches_the_unsharded_solve(units):
    """5 right-hand sides over 2 ranks (padded to 6): each rank's CG
    loop on its rows, gathered and sliced back."""
    inp, _, ranks, single = units
    res = ranks[0]
    assert res["solve_x"].shape == (5, 30)
    np.testing.assert_allclose(res["solve_x"], single["solve_x"],
                               rtol=1e-12, atol=1e-12)
    want = np.linalg.solve(inp["A"], inp["rhs"].T).T
    np.testing.assert_allclose(res["solve_x"], want, rtol=1e-9, atol=1e-11)
    assert res["solve_converged"].dtype == bool and res["solve_converged"].all()
    assert (res["solve_iterations"] > 0).all()
    assert (res["solve_error"] < 1e-12).all()


@pytest.mark.parametrize("rep", ["slfm", "sum", "bt"])
def test_grid_matvec_on_a_grid_mesh_is_the_single_rank_one(units, rep):
    """An fft group on a 2-rank 'grid' mesh: each rank contracts its
    Fourier range, the gather rebuilds the spectrum: the same bits as one
    rank; the gradient of a functional of it (the gather's sum-style
    backward, K10's range backward, averaged over the mesh) agrees."""
    _, _, ranks, single = units
    got, want = ranks[0]["mv_fft_" + rep], single["mv_fft_" + rep]
    np.testing.assert_array_equal(got, want)
    g, gw = ranks[0]["mvg_fft_" + rep], single["mvg_fft_" + rep]
    np.testing.assert_allclose(g, gw, rtol=1e-12,
                               atol=1e-12 * np.abs(gw).max())


def test_dense_group_shards_its_rows(units):
    """A dense group with ``grid_shard``: each rank holds its rows of
    K_UU (``_shard_rows``) and the product's rows are gathered."""
    _, _, ranks, single = units
    np.testing.assert_allclose(ranks[0]["mv_dense_slfm"],
                               single["mv_dense_slfm"], rtol=1e-13,
                               atol=1e-13)
    gw = single["mvg_dense_slfm"]
    np.testing.assert_allclose(ranks[0]["mvg_dense_slfm"], gw, rtol=1e-12,
                               atol=1e-12 * np.abs(gw).max())


def test_shard_rows_and_last_are_this_ranks_range():
    class FakeMesh:
        shape = {"grid": 2}

        def __init__(self, i):
            self.i = i

        def index(self, axis):
            return self.i

        def group(self, axis):
            return None

    x = torch.arange(35.0).reshape(5, 7)
    assert torch.equal(tgrid._shard_rows(x, (FakeMesh(0), "grid")), x[:3])
    assert torch.equal(tgrid._shard_rows(x, (FakeMesh(1), "grid")), x[3:])
    assert torch.equal(tgrid._shard_last(x, (FakeMesh(1), "grid")),
                       x[:, 4:])
    assert tgrid._shard_last(x, None) is x


def test_exact_ski_mll_data_sharded_matches_one_rank_and_jax(units):
    """57 data rows split 29/28: the value, alpha (gathered) and the
    gradient averaged over the mesh against one rank (1e-12: a gradient
    off by the world size fails) and against JAX's meshless
    exact_ski_mll. Each rank's gradient is already the whole gradient
    before the mean: its replicated backward sees the whole cotangent
    (``collectives.shared``)."""
    inp, jx, ranks, single = units
    res = ranks[0]
    np.testing.assert_allclose(res["exact_value"], single["exact_value"],
                               rtol=1e-12)
    np.testing.assert_allclose(res["exact_grad"], single["exact_grad"],
                               rtol=1e-12,
                               atol=1e-12 * np.abs(single["exact_grad"]).max())
    np.testing.assert_allclose(res["exact_alpha"], single["exact_alpha"],
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(res["exact_quad"], single["exact_quad"],
                               rtol=1e-12)
    assert float(res["exact_error"]) < 1e-8
    g = res["exact_grad"]
    for r in ranks:
        np.testing.assert_array_equal(r["exact_grad_local"], g)
    sj, raw = jx["sj"], jx["raw_s"]
    Xs = W.split(inp, "sx")
    gj, _ = jgrid.make_grids(sj, Xs, m=[10])
    lens = [len(X) for X in Xs]

    def obj(p):
        return jlk.exact_ski_mll(sj, p, gj, lens, jnp.asarray(inp["sy"]))[0]

    p = jax.tree.map(jnp.asarray, raw)
    want_v, want_g = jax.jit(jax.value_and_grad(obj))(p)
    np.testing.assert_allclose(res["exact_value"], float(want_v), rtol=1e-10)
    want_g = _flat(want_g)
    np.testing.assert_allclose(g, want_g, rtol=1e-6,
                               atol=1e-6 * np.abs(want_g).max())


@pytest.mark.parametrize("kind", ["precond", "plain"])
def test_probe_sharded_surrogate_matches_jax(units, kind):
    """The surrogate with 5 solve rows over 2 ranks (the JAX package's
    probes, tolerance 1e-10): the gradient against one rank and against
    JAX's meshless gradient, at tests/test_torch_stochastic.py's
    tolerance."""
    inp, jx, ranks, single = units
    mj = jx["mj"]
    got = ranks[0]["surrogate_" + kind]
    np.testing.assert_allclose(got, single["surrogate_" + kind], rtol=1e-6,
                               atol=1e-6 * np.abs(got).max())
    kw = dict(grid_data32=mj.precond_data32,
              inner_data32=mj.inner_data32) if kind == "precond" else {}

    def fj(p):
        return -jlk.stochastic_mll_surrogate(
            mj.spec, p, mj.grid_data, mj.data.lens, mj.y,
            jnp.asarray(inp["kprobes"]), tol=1e-10, **kw)[0]

    want = _flat(jax.jit(jax.grad(fj))(mj.params))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_port_signatures_take_the_jax_sharding_arguments():
    import inspect

    from runlmc_tpu_torch.lmc import likelihood as tlk

    def names(fn):
        return list(inspect.signature(fn).parameters)

    assert names(tlk.exact_ski_mll) == names(jlk.exact_ski_mll)
    jax_s = [n for n in names(jlk.stochastic_mll_surrogate)
             if n != "diff_data"]
    assert names(tlk.stochastic_mll_surrogate) == jax_s
    assert names(tlk.sharded_solve) == names(jlk.sharded_solve)

"""The port's hand kernels against their plain PyTorch versions on the
card, at small shapes. Without a card every test skips. On a machine
with one, run without the JAX-configuring conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import runlmc_tpu_torch as T
from runlmc_tpu_torch import hopper
from runlmc_tpu_torch.hopper import (
    capacitance,
    cg,
    chol_jitter,
    chol_vjp,
    cross,
    fourier,
    interp,
    kern_rows_fft,
    kuu,
    lanczos,
    minres,
    trsm,
)
from runlmc_tpu_torch.lmc import likelihood as lk
from runlmc_tpu_torch.lmc import woodbury as wbm
from runlmc_tpu_torch.ops.interpolation import multi_interpolant
from runlmc_tpu_torch.utils.carry import from_reference_params

DTYPES = [torch.float32, torch.float64]
# float64 kernels sum the same few terms as their plain versions in
# another order; float32 passes reduce rows of ~1000 terms
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.cuda.synchronize()
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= RTOL[dtype] * scale


def _kuu_table(Q, m, dtype, dev, seed):
    """K1's inputs: kind codes cycling through every kind (RBF,
    Matern32, StdPeriodic, Identity), positive table rows and first-row
    distances (0 first) on the card."""
    g = torch.Generator().manual_seed(seed)
    kinds = tuple(q % 4 for q in range(Q))
    prm = (0.5 + torch.rand(Q, 3, generator=g, dtype=dtype)).to(dev)
    dists = torch.cat([torch.zeros(1, dtype=dtype), torch.sort(
        2.0 * torch.rand(m - 1, generator=g, dtype=dtype))[0]]).to(dev)
    return kinds, prm, dists


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes", [(37,), (6, 7), (3, 4, 5)])
def test_kuu_dense(dev, dtype, sizes):
    m = int(np.prod(sizes))
    kinds, prm, dists = _kuu_table(4, m, dtype, dev, 0)
    g = torch.Generator().manual_seed(0)
    B = torch.randn(4, 3, 3, generator=g, dtype=dtype).to(dev)
    args = (kinds, prm, dists, B, sizes)
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = dict(kuu.kuu_dense.launches)
    out = kuu.kuu_dense(*args)
    _close(out, kuu.kuu_dense_plain(*args), dtype)
    before[sfx] += 1
    assert kuu.kuu_dense.launches == before
    assert torch.equal(out, kuu.kuu_dense(*args))


def test_kuu_dense_tables_past_the_shared_memory_budget(dev):
    """Four float64 rows of m=4096 exceed one launch's table budget: the
    q's run as two launches, the second adding into the output."""
    kinds, prm, dists = _kuu_table(4, 4096, torch.float64, dev, 1)
    B = torch.randn(4, 1, 1, dtype=torch.float64, device=dev)
    args = (kinds, prm, dists, B, (64, 64))
    _close(kuu.kuu_dense(*args), kuu.kuu_dense_plain(*args), torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_kernel_all_kinds(dev, dtype):
    spec = T.LMCKernelSpec.create(
        D=3, lmc_kernels=[T.RBF(active_dims=(0,)), T.Matern32()],
        lmc_ranks=[1, 2], slfm_kernels=[T.StdPeriodic(period=1.3)],
        indep_gp=[T.IdentityKern(), T.Scaled(inner=T.RBF(), scale=2.0)],
    ).with_input_dim(2)
    p = from_reference_params(spec.init_raw_params(seed=3), dtype, dev)
    g = torch.Generator().manual_seed(1)
    xa = torch.rand(33, 2, generator=g, dtype=dtype).to(dev)
    xb = torch.cat([xa[:5], torch.rand(60, 2, generator=g,
                                       dtype=dtype).to(dev)])
    oa = torch.randint(0, 3, (33,), generator=g, dtype=torch.int32).to(dev)
    ob = torch.randint(0, 3, (65,), generator=g, dtype=torch.int32).to(dev)
    args = (xa, oa, xb, ob, spec.coreg_mats(p)) + spec.kernel_table(p)
    _close(cross.cross_kernel(*args), cross.cross_kernel_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", [1, 2])
def test_interp_gather_scatter(dev, dtype, dim):
    rng = np.random.RandomState(dim)
    axes = [np.linspace(0, 1, 9) for _ in range(dim)]
    Xs = [rng.uniform(-0.1, 1.1, (50, dim)), rng.uniform(0, 1, (20, dim))]
    W = multi_interpolant(Xs, axes).to(dtype, dev)
    g = torch.Generator().manual_seed(2)
    v = torch.randn(5, W.ncols, generator=g, dtype=dtype).to(dev)
    x = torch.randn(5, W.shape[0], generator=g, dtype=dtype).to(dev)
    _close(W.matvec(v), interp.interp_gather_plain(W.indices, W.weights, v),
           dtype)
    _close(W.rmatvec(x),
           interp.interp_scatter_plain(W.t_ptr, W.t_rows, W.t_weights, x),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cg_passes(dev, dtype):
    g = torch.Generator().manual_seed(3)

    def rnd(*s):
        return torch.randn(*s, generator=g, dtype=dtype).to(dev)

    B, n = 7, 1500
    p, x, r, z = rnd(B, n), rnd(B, n), rnd(B, n), rnd(B, n)
    Ap = 2.0 * p + 0.1 * rnd(B, n)
    rz = rnd(B).abs() + 0.5
    act = torch.tensor([1, 1, 0, 1, 0, 1, 1], dtype=torch.int32, device=dev)
    tol = torch.full((1,), 1e-3, dtype=dtype, device=dev)
    k = [t.clone() for t in (x, r, rz, p)] + [act.clone(),
                                              torch.zeros_like(act)]
    q = [t.clone() for t in (x, r, rz, p)] + [act.clone(),
                                              torch.zeros_like(act)]
    pk, rk = cg.cg_update_xr(p, Ap, k[0], k[1], k[2], k[4])
    pq, rq = cg.cg_update_xr_plain(p, Ap, q[0], q[1], q[2], q[4])
    for a, b in zip((k[0], k[1], pk, rk), (q[0], q[1], pq, rq)):
        _close(a, b, dtype)
    cg.cg_update_p(k[1], z, k[3], k[2], k[4], k[5], pk, rk, tol)
    cg.cg_update_p_plain(q[1], z, q[3], q[2], q[4], q[5], pk, rk, tol)
    for a, b in zip((k[3], k[2]), (q[3], q[2])):
        _close(a, b, dtype)
    assert torch.equal(k[4], q[4]) and torch.equal(k[5], q[5])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes", [(37,), (6, 7), (3, 4, 5)])
def test_kuu_dense_bwd(dev, dtype, sizes):
    m = int(np.prod(sizes))
    kinds, prm, dists = _kuu_table(4, m, dtype, dev, 4)
    g = torch.Generator().manual_seed(4)
    B = torch.randn(4, 3, 3, generator=g, dtype=dtype).to(dev)
    G = torch.randn(3 * m, 3 * m, generator=g, dtype=dtype).to(dev)
    args = (kinds, prm, dists, B, sizes, G)
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = dict(kuu.kuu_dense_bwd.launches)
    got = kuu.kuu_dense_bwd(*args)
    before[sfx] += 1
    assert kuu.kuu_dense_bwd.launches == before
    for a, b in zip(got, kuu.kuu_dense_bwd_plain(*args)):
        _close(a, b, dtype)
    for a, b in zip(got, kuu.kuu_dense_bwd(*args)):
        assert torch.equal(a, b)


def test_training_chunk_matches_cpu(dev):
    """Two exact-objective steps at the model dtype on the card and on
    the CPU from the same parameters; the float64 forward and backward
    K1 kernels launch."""
    rng = np.random.RandomState(1)
    Xs = [np.sort(rng.uniform(0, 5, 40)) for _ in range(2)]
    Ys = [np.sin(X) + 0.1 * rng.randn(40) for X in Xs]
    spec = T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()], lmc_ranks=[1])
    kw = dict(functional_kernel=spec, m=[20], objective="exact",
              exact_precision="model")
    mg = T.InterpolatedLLGP(Xs, Ys, device=dev, **kw)
    mc = T.InterpolatedLLGP(Xs, Ys, device="cpu", **kw)
    x0 = mc.param_array + 0.1 * np.cos(np.arange(mc.n_params))
    z = np.zeros_like(x0)
    opt = T.AdaDelta()
    hopper.reset_launches()
    out_g = mg._chunk(x0, z, z, z, opt, n_steps=2)
    counts = hopper.launch_counts()
    for name in hopper.MODEL_PRECISION_PATH:
        assert counts[name] > 0, name
    out_c = mc._chunk(x0, z, z, z, opt, n_steps=2)
    for a, b in zip(out_g, out_c):
        np.testing.assert_allclose(a, b, rtol=1e-8,
                                   atol=1e-10 * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("objective", ["exact", "stochastic"])
def test_checkpoint_resumes_on_the_card(dev, tmp_path, objective):
    """A file saved by a CPU model restores onto the card (parameters on
    the card, equal), and on the card 10 steps, a checkpoint and 10
    resumed steps in a fresh model equal 20 uninterrupted steps bit for
    bit, the fused K1 launching in the resumed run."""
    rng = np.random.RandomState(2)
    Xs = [np.sort(rng.uniform(0, 5, 40)) for _ in range(2)]
    Ys = [np.sin(X) + 0.1 * rng.randn(40) for X in Xs]
    spec = T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()], lmc_ranks=[1])
    kw = dict(functional_kernel=spec, m=[20], objective=objective)
    mc = T.InterpolatedLLGP(Xs, Ys, device="cpu", **kw)
    mc.param_array = mc.param_array + 0.1
    mc.save(str(tmp_path / "cpu.npz"))
    mg = T.InterpolatedLLGP(Xs, Ys, device=dev, **kw)
    mg.restore(str(tmp_path / "cpu.npz"))
    assert mg.params["noise"].device.type == "cuda"
    np.testing.assert_array_equal(mg.param_array, mc.param_array)

    full = T.InterpolatedLLGP(Xs, Ys, device=dev, **kw)
    info_full = full.optimize(T.AdaDelta(max_it=20))
    half = T.InterpolatedLLGP(Xs, Ys, device=dev, **kw)
    info_half = half.optimize(T.AdaDelta(max_it=10))
    half.save(str(tmp_path / "half.npz"), opt_state=info_half["state"])
    res = T.InterpolatedLLGP(Xs, Ys, device=dev, **kw)
    ckpt = res.restore(str(tmp_path / "half.npz"))
    hopper.reset_launches()
    info_res = res.optimize(T.AdaDelta(max_it=20), state=ckpt["opt_state"])
    assert hopper.launch_counts()["kuu_dense/f32"] > 0
    assert info_res["n_iter"] == info_full["n_iter"]
    np.testing.assert_array_equal(res.param_array, full.param_array)


def test_model_predict_launches_every_kernel(dev):
    rng = np.random.RandomState(0)
    Xs = [np.sort(rng.uniform(0, 5, 40)) for _ in range(2)]
    Ys = [np.sin(X) + 0.1 * rng.randn(40) for X in Xs]
    spec = T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()], lmc_ranks=[1])
    tX = [np.linspace(1, 4, 5)] * 2
    mg = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[20],
                            tolerance=1e-8, device=dev)
    mc = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[20],
                            tolerance=1e-8, device="cpu")
    hopper.reset_launches()
    mu_g, var_g = mg.predict(tX)
    counts = hopper.launch_counts()
    # float64 K6 runs only on the escalation rung, which this solve
    # does not reach
    assert not mg.prediction_report["explained-variance"]["escalated"]
    for name in hopper.PREDICT_PATH:
        assert counts[name] > 0, name
    mu_c, var_c = mc.predict(tX)
    for a, b in zip(mu_g + var_g, mu_c + var_c):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-10)


def _fourier_args(rep, dtype, dev, nb=5, D=3, K=2, F=257, seed=5):
    g = torch.Generator().manual_seed(seed)
    ct = COMPLEX[dtype]

    def cplx(*shape):
        return torch.randn(*shape, generator=g, dtype=ct).to(dev)

    vf = cplx(nb, D, F)
    if rep == "sum":
        return vf, torch.randn(K, D, D, generator=g, dtype=dtype).to(dev), \
            cplx(K, F), None
    if rep == "bt":
        return vf, None, cplx(D, D, F), None
    return vf, torch.randn(D, K, generator=g, dtype=dtype).to(dev), \
        cplx(K, F), cplx(D, F)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rep", ["sum", "bt", "slfm"])
def test_fourier_contract(dev, dtype, rep):
    vf, mat, sym, diag = _fourier_args(rep, dtype, dev)
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = dict(fourier.fourier_contract.launches)
    got = fourier.fourier_contract(rep, vf, mat, sym, diag)
    before[sfx] += 1
    assert fourier.fourier_contract.launches == before
    want = fourier.fourier_contract_plain(rep, vf, mat, sym, diag)
    _close(torch.view_as_real(got), torch.view_as_real(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rep", ["sum", "bt", "slfm"])
def test_fourier_contract_backward(dev, dtype, rep):
    """The autograd function's gradients against autograd through the
    plain version, every input at once."""
    vf, mat, sym, diag = _fourier_args(rep, dtype, dev, seed=6)
    G = _fourier_args("bt", dtype, dev, seed=7)[0]
    ins = [t for t in (vf, mat, sym, diag) if t is not None]

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        it = iter(leaves)
        args = [next(it) if t is not None else None
                for t in (vf, mat, sym, diag)]
        out = fn(rep, *args)
        return torch.autograd.grad(out, leaves, G)

    sfx = "f32" if dtype == torch.float32 else "f64"
    before = fourier.fourier_contract_bwd.launches[sfx]
    got = grads(fourier.contract)
    assert fourier.fourier_contract_bwd.launches[sfx] == before + 1
    want = grads(fourier.fourier_contract_plain)
    for a, b in zip(got, want):
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_minres_update(dev, dtype):
    g = torch.Generator().manual_seed(8)

    def rnd(*s):
        return torch.randn(*s, generator=g, dtype=dtype).to(dev)

    B, n = 6, 2500
    vecs = [rnd(B, n) for _ in range(6)]  # w, x, v, v_prev, d, d_prev
    scal = [rnd(B) for _ in range(6)]  # beta, c, s, c_prev, s_prev, phi
    scal[0] = scal[0].abs()
    act = torch.tensor([1, 1, 0, 1, 0, 1], dtype=torch.int32, device=dev)
    tol = torch.full((1,), 1e-1, dtype=dtype, device=dev)

    def state():
        return ([t.clone() for t in vecs + scal]
                + [act.clone(), torch.zeros_like(act)])

    k, q = state(), state()
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = minres.minres_update.launches[sfx]
    minres.minres_update(*k, tol)
    assert minres.minres_update.launches[sfx] == before + 1
    minres.minres_update_plain(*q, tol)
    for a, b in zip(k[1:12], q[1:12]):  # w is scratch
        _close(a, b, dtype)
    assert torch.equal(k[12], q[12]) and torch.equal(k[13], q[13])


def test_fft_stochastic_step_matches_cpu(dev):
    """One stochastic-objective step of a small fft-mode model on the
    card and on the CPU from the same parameters and the same fed
    probes; the float64 and float32 Fourier contractions and the
    float64 backward launch."""
    rng = np.random.RandomState(2)
    Xs = [np.sort(rng.uniform(0, 5, 60)) for _ in range(3)]
    Ys = [np.sin(X + d) + 0.1 * rng.randn(60) for d, X in enumerate(Xs)]
    spec = T.LMCKernelSpec.create(
        D=3, slfm_kernels=[T.RBF(name="s0"), T.RBF(name="s1")],
        indep_gp=[T.Scaled(inner=T.RBF(name="r%d" % d),
                           trainable_scale=False) for d in range(3)])
    kw = dict(functional_kernel=spec, m=[40], grid_mode="fft",
              objective="stochastic", tolerance=1e-10)
    mg = T.InterpolatedLLGP(Xs, Ys, device=dev, **kw)
    mc = T.InterpolatedLLGP(Xs, Ys, device="cpu", **kw)
    probes = np.sign(np.random.RandomState(3).randn(mc.n_probes, 180))
    for mdl in (mg, mc):
        mdl.probe_stream = lambda seed, it: probes
    x0 = mc.param_array + 0.1 * np.cos(np.arange(mc.n_params))
    z = np.zeros_like(x0)
    hopper.reset_launches()
    out_g = mg._chunk(x0, z, z, z, T.AdaDelta(), n_steps=1)
    counts = hopper.launch_counts()
    for name in hopper.STOCHASTIC_PATH:
        assert counts[name] > 0, name
    out_c = mc._chunk(x0, z, z, z, T.AdaDelta(), n_steps=1)
    for a, b in zip(out_g[:5], out_c[:5]):
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-6 * max(np.abs(b).max(), 1e-12))
    assert out_g[6][0] <= 1e-10 and out_c[6][0] <= 1e-10


def _mixed_table(dtype, dev, seed=4, na=70, nb=90):
    spec = T.LMCKernelSpec.create(
        D=3, lmc_kernels=[T.RBF(active_dims=(0,)), T.Matern32()],
        lmc_ranks=[1, 2], slfm_kernels=[T.StdPeriodic(period=1.3)],
        indep_gp=[T.IdentityKern(), T.Scaled(inner=T.RBF(), scale=2.0),
                  T.Scaled(inner=T.Matern32(), trainable_scale=False)],
        indep_gp_index=[0, 1, 2],
    ).with_input_dim(2)
    p = from_reference_params(spec.init_raw_params(seed=seed), dtype, dev)
    g = torch.Generator().manual_seed(seed)
    xa = torch.rand(na, 2, generator=g, dtype=dtype)
    xb = torch.cat([xa[:20], torch.rand(nb - 20, 2, generator=g,
                                        dtype=dtype)])
    oa = torch.randint(0, 3, (na,), generator=g, dtype=torch.int32)
    ob = torch.cat([oa[:20], torch.randint(0, 3, (nb - 20,), generator=g,
                                           dtype=torch.int32)])
    G = torch.randn(na, nb, generator=g, dtype=dtype)
    return tuple(t.to(dev) for t in (xa, oa, xb, ob)) + (
        spec.coreg_mats(p).detach(),) + spec.kernel_table(p) + (G.to(dev),)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_kernel_bwd(dev, dtype):
    """K7's backward on a six-kernel table (Q > 1, every kind, unsorted
    column outputs, r = 0 pairs) against autograd of the plain forward;
    twice, to the bit (deterministic)."""
    args = _mixed_table(dtype, dev)
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = cross.cross_kernel_bwd.launches[sfx]
    got = cross.cross_kernel_bwd(*args)
    assert cross.cross_kernel_bwd.launches[sfx] == before + 1
    again = cross.cross_kernel_bwd(*args)
    want = cross.cross_kernel_bwd_plain(*args)
    for a, b, c in zip(got, want, again):
        _close(a, b, dtype)
        assert torch.equal(a, c)


def test_cross_kernel_bwd_many_kernels(dev):
    """More kernels than one launch takes: two launches over q."""
    spec = T.LMCKernelSpec.create(
        D=2, lmc_kernels=[T.RBF(name="k%d" % i, inv_lengthscale=0.5 + i)
                          for i in range(10)], lmc_ranks=[1] * 10)
    spec = spec.with_input_dim(1)
    p = from_reference_params(spec.init_raw_params(seed=1), torch.float64,
                              dev)
    x = torch.linspace(0, 3, 50, dtype=torch.float64, device=dev)[:, None]
    o = (torch.arange(50, device=dev) % 2).to(torch.int32)
    G = torch.randn(50, 50, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0)).to(dev)
    args = (x, o, x, o, spec.coreg_mats(p).detach()) + \
        spec.kernel_table(p) + (G,)
    before = cross.cross_kernel_bwd.launches["f64"]
    got = cross.cross_kernel_bwd(*args)
    assert cross.cross_kernel_bwd.launches["f64"] == before + 2
    for a, b in zip(got, cross.cross_kernel_bwd_plain(*args)):
        _close(a, b, torch.float64)


def test_exact_log_likelihood_and_grad_matches_cpu(dev):
    """The exact oracle of a small model on the card (K7 forward and
    backward, cuSOLVER) and on the CPU at the same parameters."""
    rng = np.random.RandomState(5)
    Xs = [np.sort(rng.uniform(0, 4, 40)) for _ in range(3)]
    Ys = [np.sin(X + d) + 0.1 * rng.randn(40) for d, X in enumerate(Xs)]
    spec = T.LMCKernelSpec.create(D=3, lmc_kernels=[T.RBF()],
                                  lmc_ranks=[2])
    mg = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[16],
                            device=dev)
    mc = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[16],
                            device="cpu")
    mc.param_array = mg.param_array
    hopper.reset_launches()
    vg, gg = mg.exact_log_likelihood_and_grad()
    counts = hopper.launch_counts()
    for name in hopper.REPORT_PATH:
        assert counts[name] > 0, name
    vc, gc = mc.exact_log_likelihood_and_grad()
    np.testing.assert_allclose(vg, vc, rtol=1e-10)
    np.testing.assert_allclose(gg, gc, rtol=1e-8,
                               atol=1e-8 * np.abs(gc).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_lanczos_step(dev, dtype):
    """K13 against its plain version step by step on a diagonal
    operator, with a row started on an eigenvector (it breaks down at
    the first step) and a dead row."""
    g = torch.Generator().manual_seed(6)
    B, n = 5, 3000
    d = (torch.rand(n, generator=g, dtype=dtype) + 0.5).to(dev)
    v = torch.sign(torch.randn(B, n, generator=g, dtype=dtype)).to(dev)
    v = v / float(np.sqrt(n))
    v[0] = 0.0
    v[0, 17] = 1.0
    eps = torch.full((1,), lanczos.breakdown_eps(dtype), dtype=dtype,
                     device=dev)
    v_prev = torch.zeros_like(v)
    beta = torch.zeros(B, dtype=dtype, device=dev)
    alive = torch.tensor([1, 1, 1, 1, 0], dtype=torch.int32, device=dev)
    sfx = "f32" if dtype == torch.float32 else "f64"
    for step in range(6):
        w = v * d
        want = lanczos.lanczos_step_plain(w, v_prev, v, beta, alive, eps)
        before = lanczos.lanczos_step.launches[sfx]
        got = lanczos.lanczos_step(w.clone(), v_prev.clone(), v.clone(),
                                   beta, alive, eps)
        assert lanczos.lanczos_step.launches[sfx] == before + 1
        for a, b in zip(got[:4], want[:4]):
            _close(a, b, dtype)
        assert torch.equal(got[4], want[4])
        v_prev, v, _, beta, alive = want
    assert int(alive[0]) == 0 and int(alive[4]) == 0 and int(alive[1]) == 1


def test_slq_log_det_matches_cpu(dev):
    """The SLQ log-det of a small fft model on the card and on the CPU
    with the same fed probes; the Lanczos steps and the float64 Fourier
    contraction launch."""
    rng = np.random.RandomState(2)
    Xs = [np.sort(rng.uniform(0, 5, 60)) for _ in range(3)]
    Ys = [np.sin(X + d) + 0.1 * rng.randn(60) for d, X in enumerate(Xs)]
    spec = T.LMCKernelSpec.create(D=3, lmc_kernels=[T.RBF()],
                                  lmc_ranks=[2])
    kw = dict(functional_kernel=spec, m=[40], grid_mode="fft")
    mg = T.InterpolatedLLGP(Xs, Ys, device=dev, **kw)
    mc = T.InterpolatedLLGP(Xs, Ys, device="cpu", **kw)
    probes = np.sign(np.random.RandomState(3).randn(15, 180))
    for mdl in (mg, mc):
        mdl.slq_probes = lambda N, n: probes
    hopper.reset_launches()
    got = mg.ski_log_det()
    counts = hopper.launch_counts()
    for name in hopper.SLQ_PATH:
        assert counts[name] > 0, name
    np.testing.assert_allclose(got, mc.ski_log_det(), rtol=1e-8)


def _spd_factor(k, dtype, dev, seed=0):
    """Lower Cholesky factor of a seeded SPD matrix, condition number
    about 3, in column-major storage (as cuSOLVER leaves it)."""
    g = torch.Generator().manual_seed(seed)
    G = torch.randn(k, k, generator=g, dtype=torch.float64)
    A = torch.eye(k, dtype=torch.float64) + (G + G.T) / (4 * (2 * k) ** 0.5)
    return torch.linalg.cholesky(A).to(dev, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k, c", [(64, 1), (333, 16), (200, 70)])
def test_trsm_lower(dev, dtype, trans, k, c):
    g = torch.Generator().manual_seed(1)
    L = _spd_factor(k, dtype, dev)
    B = torch.randn(c, k, generator=g, dtype=dtype).to(dev)
    sfx = "f32" if dtype == torch.float32 else "f64"
    want = trsm.trsm_lower_plain(L, B, trans)
    for Ls in (L, L.contiguous()):  # column-major, then row-major
        before = trsm.trsm_lower.launches[sfx]
        got = trsm.trsm_lower(Ls, B, trans=trans)
        assert trsm.trsm_lower.launches[sfx] == before + 1
        _close(got, want, dtype)
        assert torch.equal(got, trsm.trsm_lower(Ls, B, trans=trans))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k, c", [(1, 1), (65, 3), (300, 1), (333, 16),
                                  (520, 7)])
def test_trsm_chains_match_the_per_block_kernel(dev, dtype, trans, k, c):
    """c <= 16 runs the chains with helpers; they sum in the per-block
    kernel's order, so the two agree to the bit, and with the plain
    version and the kernel's block order in plain PyTorch."""
    g = torch.Generator().manual_seed(3)
    L = _spd_factor(k, dtype, dev)
    B = torch.randn(c, k, generator=g, dtype=dtype).to(dev)
    for Ls in (L, L.contiguous()):
        got = trsm.trsm_lower(Ls, B, trans=trans)
        assert torch.equal(got, trsm._launch(Ls, B, trans, 1))
        _close(got, trsm.trsm_lower_plain(Ls, B, trans), dtype)
        _close(got, trsm.trsm_lower_schedule(Ls, B, trans), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nbatch", [1, 16, 1400])
def test_interp_scatter_variants_on_a_skewed_csr(dev, dtype, nbatch):
    """An empty column and one far longer than the rest, in the variant
    the shape selects (a warp per column for 1 and 16 batch rows, a
    thread per column for 1400): relaunches are bit-identical."""
    g = torch.Generator().manual_seed(4)
    deg = torch.full((200,), 20, dtype=torch.int64)
    deg[0], deg[1] = 0, 5000
    ptr = torch.zeros(201, dtype=torch.int64)
    ptr[1:] = torch.cumsum(deg, 0)
    nnz = int(ptr[-1])
    rows = torch.randint(0, 3000, (nnz,), generator=g, dtype=torch.int32)
    wt = torch.randn(nnz, generator=g, dtype=dtype)
    x = torch.randn(nbatch, 3000, generator=g, dtype=dtype)
    csr = (ptr.to(torch.int32).to(dev), rows.to(dev), wt.to(dev))
    got = interp.interp_scatter(*csr, x.to(dev))
    assert torch.equal(got, interp.interp_scatter(*csr, x.to(dev)))
    want = interp.interp_scatter_plain(*(t.cpu() for t in csr), x[:16])
    _close(got[:16].cpu(), want, dtype)
    assert bool((got[:, 0] == 0).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_cho_solve_nan_factor(dev, dtype):
    L = torch.full((130, 130), float("nan"), dtype=dtype, device=dev)
    X = trsm.cho_solve(L, torch.ones(5, 130, dtype=dtype, device=dev))
    torch.cuda.synchronize()
    assert bool(torch.isnan(X).all())


def test_cho_solve_backward_matches_cholesky_solve(dev):
    L0 = _spd_factor(257, torch.float64, dev)
    g = torch.Generator().manual_seed(2)
    S0, G = (torch.randn(3, 257, generator=g, dtype=torch.float64).to(dev)
             for _ in range(2))
    grads = []
    for fn in (trsm.cho_solve,
               lambda L_, S_: torch.cholesky_solve(S_.mT, L_).mT):
        L = L0.clone().requires_grad_(True)
        S = S0.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(L, S), (L, S), G))
    for a, b in zip(*grads):
        _close(a, b, torch.float64)


def _k2_problem(dtype, dev, groups):
    """Grams and tile plans of real interpolants (a 2-D grid, with a
    1-D second group for cross blocks), seeded lower factors, noise."""
    from runlmc_tpu_torch.lmc import grid as tgrid

    rng = np.random.RandomState(4)
    Xs = [rng.uniform(0, 1, (n, 3)) for n in (150, 130)]
    kw = dict(lmc_kernels=[T.RBF(name="a", active_dims=(0, 1))],
              lmc_ranks=[1])
    if groups == 2:
        kw["indep_gp"] = [T.RBF(name="b", active_dims=(2,))]
    spec = T.LMCKernelSpec.create(D=2, **kw).with_input_dim(3)
    gds, _ = tgrid.make_grids(spec, Xs, m=[9, 11, 70])
    gds = tuple(gd.to(dtype, dev) for gd in gds)
    g = torch.Generator().manual_seed(5)
    inv_eps = (torch.rand(2, generator=g, dtype=dtype) + 0.5).to(dev)
    Fs = [torch.tril(torch.randn(gd.interp.ncols, gd.interp.ncols,
                                 generator=g, dtype=dtype)).to(dev)
          for gd in gds]
    return tgrid.gram_nest(gds), inv_eps, Fs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("groups", [1, 2])
def test_capacitance(dev, dtype, groups):
    nest, inv_eps, Fs = _k2_problem(dtype, dev, groups)
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = capacitance.capacitance.launches[sfx]
    C, Ts = capacitance.capacitance(nest, inv_eps, Fs)
    assert capacitance.capacitance.launches[sfx] == before + 1
    Cp, Tp = capacitance.capacitance_plain(nest, inv_eps, Fs)
    _close(C, Cp, dtype)
    assert torch.equal(C, C.T)
    # column-major factors, as cuSOLVER leaves them: the same bits
    Cc, _ = capacitance.capacitance(nest, inv_eps,
                                    [F.mT.contiguous().mT for F in Fs])
    assert torch.equal(C, Cc)
    g = torch.Generator().manual_seed(6)
    Cbar = torch.randn(C.shape, generator=g, dtype=dtype).to(dev)
    got = capacitance.capacitance_bwd(nest, inv_eps, Fs, Ts, Cbar)
    want = capacitance.capacitance_bwd_plain(nest, inv_eps, Fs, Tp, Cbar)
    again = capacitance.capacitance_bwd(nest, inv_eps, Fs, Ts, Cbar)
    # the backward sums Dm products of a cotangent of both signs
    tol = {torch.float32: 1e-4, torch.float64: 1e-12}[dtype]
    for a, b, c in zip((got[0], *got[1]), (want[0], *want[1]),
                       (again[0], *again[1])):
        torch.cuda.synchronize()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("colmajor", [False, True])
@pytest.mark.parametrize("D, m", [(13, 238), (2, 2560)])
def test_capacitance_site_shapes(dev, dtype, colmajor, D, m):
    """Seeded banded grams at fx2007's width (D=13, m=238: 49 tile rows
    of C, 4 tile rows of each F_{a,d}, ragged at both) and a wide one
    (D=2, m=2560: the work lists' deep tiles run past a wave), F row- or
    column-major:
    forward and backward against the plain versions, relaunches
    bit-identical."""
    g = torch.Generator().manual_seed(8)
    i = torch.arange(m)
    band = ((i[:, None] - i[None, :]).abs() <= 3).to(dtype)
    G = torch.randn(D, m, m, generator=g, dtype=dtype) * band
    G = G + G.mT
    ptr, rblk = capacitance.tile_plan(G.numpy())
    nest = [[(G.to(dev), torch.as_tensor(ptr, device=dev),
              torch.as_tensor(rblk, device=dev))]]
    inv_eps = (torch.rand(D, generator=g, dtype=dtype) + 0.5).to(dev)
    F = torch.tril(torch.randn(D * m, D * m, generator=g, dtype=dtype))
    F = (F.mT.contiguous().mT if colmajor else F).to(dev)
    C, Ts = capacitance.capacitance(nest, inv_eps, [F])
    Cp, Tp = capacitance.capacitance_plain(nest, inv_eps, [F])
    _close(C, Cp, dtype)
    assert torch.equal(C, capacitance.capacitance(nest, inv_eps, [F])[0])
    Cbar = torch.randn(C.shape, generator=g, dtype=dtype).to(dev)
    got = capacitance.capacitance_bwd(nest, inv_eps, [F], Ts, Cbar)
    want = capacitance.capacitance_bwd_plain(nest, inv_eps, [F], Tp, Cbar)
    again = capacitance.capacitance_bwd(nest, inv_eps, [F], Ts, Cbar)
    tol = {torch.float32: 1e-4, torch.float64: 1e-12}[dtype]
    for a, b, c in zip((got[0], *got[1]), (want[0], *want[1]),
                       (again[0], *again[1])):
        torch.cuda.synchronize()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
        assert torch.equal(a, c)


def test_capacitance_bwd_raises_past_max_groups(dev):
    """The backward takes at most MAX_GROUPS groups (the kernel's
    Groups::kMax): one more raises before any launch."""
    D, m, n = 2, 3, capacitance.MAX_GROUPS + 1
    G = torch.eye(m, dtype=torch.float64).expand(D, m, m).contiguous()
    ptr, rblk = capacitance.tile_plan(G.numpy())
    entry = (G.to(dev), torch.as_tensor(ptr, device=dev),
             torch.as_tensor(rblk, device=dev))
    nest = [[entry] * n for _ in range(n)]
    inv_eps = torch.ones(D, dtype=torch.float64, device=dev)
    Fs = [torch.eye(D * m, dtype=torch.float64, device=dev)] * n
    C, Ts = capacitance.capacitance(nest, inv_eps, Fs)
    with pytest.raises(ValueError, match="at most 8 groups"):
        capacitance.capacitance_bwd(nest, inv_eps, Fs, Ts, torch.ones_like(C))


def test_capacitance_autograd_matches_cpu(dev):
    """Capacitance's backward through a Cholesky, card vs CPU, float64."""
    nest, inv_eps, Fs = _k2_problem(torch.float64, dev, 2)
    grads = []
    for d in (dev, "cpu"):
        ie = inv_eps.to(d).requires_grad_(True)
        Fr = [F.to(d).requires_grad_(True) for F in Fs]
        nd = [[tuple(t.to(d) for t in e) for e in row] for row in nest]
        C = capacitance.capacitance_matrix(nd, ie, Fr)
        out = torch.linalg.cholesky(C).diagonal().log().sum()
        grads.append(torch.autograd.grad(out, [ie] + Fr))
    for a, b in zip(*grads):
        _close(a.cpu(), b, torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_interp_apply_autograd(dev, dtype):
    rng = np.random.RandomState(7)
    Xs = [rng.uniform(0, 1, (n, 2)) for n in (80, 60)]
    W = multi_interpolant(Xs, [np.linspace(-0.1, 1.1, 9),
                               np.linspace(-0.1, 1.1, 10)])
    grads = []
    for d in (dev, "cpu"):
        Wd = W.to(dtype, d)
        v = torch.as_tensor(rng.standard_normal((4, W.ncols)) if d == dev
                            else v0, dtype=dtype, device=d)
        v0 = v.detach().cpu().numpy()
        v.requires_grad_(True)
        out = Wd.rmatvec(Wd.matvec(v) ** 2)
        grads.append(torch.autograd.grad(out.sum(), v)[0].cpu())
    _close(grads[0], grads[1], dtype)


def _k3_matrix(n, dtype, dev, eig0=0.5, seed=11):
    """Graded D A D with A's lowest eigenvalue ``eig0``, the rest in
    [1, 2]."""
    rng = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.concatenate([[eig0], np.linspace(1.0, 2.0, n - 1)])
    d = np.exp(rng.uniform(-1, 1, n))
    return torch.as_tensor(d[:, None] * ((U * eig) @ U.T) * d[None, :],
                           dtype=dtype).to(dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("equilibrate", [True, False])
@pytest.mark.parametrize("n", [45, 300])
def test_chol_jitter_kernels(dev, dtype, equilibrate, n):
    """K3a, K3b and their backward against their plain versions on a
    non-symmetric A and cotangents in both storage orders; one launch
    counted per call; relaunches bit-identical."""
    A = _k3_matrix(n, dtype, dev)
    A[3, 7] += 0.01
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = dict(chol_jitter.chol_prologue.launches)
    M, s, sd = chol_jitter.chol_prologue(A, 1e-3, equilibrate)
    before[sfx] += 1
    assert chol_jitter.chol_prologue.launches == before
    sd_p = chol_jitter.chol_scale_plain(A, equilibrate)
    Mp, sp = chol_jitter.chol_prologue_plain(A, 1e-3, equilibrate, sd_p)
    _close(sd, sd_p, dtype)
    _close(M, Mp, dtype)
    assert M.mT.is_contiguous()
    assert torch.equal(M, chol_jitter.chol_prologue(A, 1e-3, equilibrate,
                                                    sd)[0])
    L, info = torch.linalg.cholesky_ex(M)
    O, flag = chol_jitter.chol_descale(L, info.clone(), s)
    Op, flag_p = chol_jitter.chol_descale_plain(L, info, sp)
    _close(O, Op, dtype)
    assert int(flag) == int(flag_p) == 0
    g = torch.Generator().manual_seed(n)
    for col in (False, True):
        Ob = torch.randn(n, n, generator=g, dtype=dtype).to(dev)
        Mb = torch.randn(n, n, generator=g, dtype=dtype).to(dev)
        if col:
            Ob, Mb = Ob.mT.contiguous().mT, Mb.mT.contiguous().mT
        sb = None
        if equilibrate:
            got = chol_jitter.chol_descale_bwd(L, s, Ob)
            want = chol_jitter.chol_descale_bwd_plain(L, s, Ob)
            for a, b in zip(got, want):
                _close(a, b, dtype)
            assert all(torch.equal(a, b) for a, b in zip(
                got, chol_jitter.chol_descale_bwd(L, s, Ob)))
            sb = got[1]
        Ab = chol_jitter.chol_prologue_bwd(A, sd, Mb, sb, 1e-3, equilibrate)
        _close(Ab, chol_jitter.chol_prologue_bwd_plain(
            A, sd, Mb, sb, 1e-3, equilibrate), dtype)
        assert torch.equal(Ab, chol_jitter.chol_prologue_bwd(
            A, sd, Mb, sb, 1e-3, equilibrate))


@pytest.mark.parametrize("equilibrate", [True, False])
def test_chol_jittered_flag_on_an_indefinite_matrix(dev, equilibrate,
                                                    monkeypatch):
    """The first rung's flag is set on an indefinite matrix, and the
    ladder lands on the same rung as on the CPU with one host read per
    attempt; the factor and its float64 gradient equal the CPU's."""
    A = _k3_matrix(60, torch.float64, dev, eig0=-5e-5)
    M, _, _ = chol_jitter.chol_prologue(A, 1e-6, equilibrate)
    L, info = torch.linalg.cholesky_ex(M)
    assert int(chol_jitter.chol_descale(L, info, None)[1]) != 0
    w = torch.randn(60, 60, dtype=torch.float64)
    out = {}
    real = wbm._accepted
    for where in ("cpu", "cuda"):
        seen = []
        monkeypatch.setattr(wbm, "_accepted",
                            lambda f: seen.append(real(f)) or seen[-1])
        X = A.to(where).requires_grad_(True)
        F = wbm.chol_jittered(X, equilibrate=equilibrate)
        (gX,) = torch.autograd.grad(torch.sum(torch.tril(w.to(where)) * F),
                                    X)
        out[where] = (seen, F.detach().cpu(), gX.cpu())
    assert out["cuda"][0] == out["cpu"][0] == [False, True]
    # cuSOLVER against LAPACK at a condition of about 4e4 (times the
    # grading): the factor to about eps cond, the gradient (two more
    # solves with it) to about eps cond^2
    for (a, b), tol in zip(zip(out["cuda"][1:], out["cpu"][1:]),
                           (1e-8, 1e-5)):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def _other_storage(X):
    return X.mT.contiguous().mT if X.is_contiguous() else X.contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 45, 130, 300])
def test_chol_vjp_kernels(dev, dtype, n):
    """The Cholesky VJP's two kernels against their plain versions, L and
    L-bar in every pair of storage orders; one launch counted per call;
    relaunches bit-identical; the tri kernel's float32 sums equal to the
    bit to route 1's (the earlier kernel's order); the whole backward
    exactly symmetric and equal to torch's Cholesky backward,
    symmetrized."""
    A = _k3_matrix(n, torch.float64, dev)
    Lc = torch.linalg.cholesky_ex(A)[0].to(dtype)  # column-major
    g = torch.Generator().manual_seed(n)
    Lb = torch.randn(n, n, generator=g, dtype=dtype).to(dev)
    sfx = "f32" if dtype == torch.float32 else "f64"
    want = chol_vjp.chol_vjp_plain(Lc, Lb)
    for L in (Lc, _other_storage(Lc)):
        for G in (Lb, _other_storage(Lb)):
            before = chol_vjp.chol_vjp.launches[sfx]
            S = chol_vjp.chol_vjp(L, G)
            assert chol_vjp.chol_vjp.launches[sfx] == before + 1
            _close(S, want, dtype)
            assert torch.equal(S, chol_vjp.chol_vjp(L, G))
            assert torch.equal(S, S.mT)
            if dtype == torch.float32:
                assert torch.equal(S, chol_vjp.chol_vjp(L, G, route=1))
    S = chol_vjp.chol_vjp(Lc, Lb)
    want = chol_vjp.chol_vjp_solve_plain(Lc, S)
    for L in (Lc, _other_storage(Lc)):
        before = chol_vjp.chol_vjp_solve.launches[sfx]
        got = chol_vjp.chol_vjp_solve(L, S)
        assert chol_vjp.chol_vjp_solve.launches[sfx] == before + 1
        assert torch.equal(got, got.mT) and got.is_contiguous()
        _close(got, want, dtype)
        assert torch.equal(got, chol_vjp.chol_vjp_solve(L, S))
    # the whole VJP against torch's, in float64 on the same factor (the
    # float32 one's product refactored in float64)
    L64 = Lc.double()
    Lb64 = Lb.double()
    a = (L64 @ L64.mT).requires_grad_(True)
    (ref,) = torch.autograd.grad(torch.linalg.cholesky(a), a, Lb64)
    ref = 0.5 * (ref + ref.mT)
    got = chol_vjp.cholesky_backward(L64, Lb64)
    assert torch.equal(got, got.mT) and got.is_contiguous()
    assert float((got - ref).abs().max()) <= 1e-9 * float(ref.abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_vjp_solve_nan_comes_back(dev, dtype):
    """A NaN in L comes back as NaN in A-bar, and the launch ends."""
    n = 200
    L = torch.linalg.cholesky_ex(_k3_matrix(n, torch.float64, dev))[0]
    L = L.to(dtype)
    S = chol_vjp.chol_vjp(L, torch.tril(torch.ones_like(L)))
    L[150, 20] = float("nan")
    got = chol_vjp.chol_vjp_solve(L, S)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got).any())
    assert torch.isnan(chol_vjp.chol_vjp_solve_plain(L, S)).any()


def test_chol_vjp_raises_on_what_it_cannot_take(dev):
    """No fallback: a CUDA tensor the kernels do not take raises."""
    L = torch.eye(8, device=dev)
    with pytest.raises(ValueError):
        chol_vjp.chol_vjp(L, L.double())
    with pytest.raises(ValueError):
        chol_vjp.chol_vjp(L.half(), L.half())
    with pytest.raises(ValueError):
        chol_vjp.chol_vjp(L[:, :4], L[:, :4])
    with pytest.raises(ValueError):
        chol_vjp.chol_vjp_solve(L[:4, :4].half(), L[:4, :4].half())
    with pytest.raises(ValueError):
        chol_vjp.chol_vjp_solve(L, L.double())
    with pytest.raises(ValueError):
        chol_vjp.chol_vjp_solve(L, L.cpu())


def test_cholesky_ex_counts_on_the_training_path(dev):
    """chol_jittered's gradient on the card launches the VJP's kernels
    once per factorization and equals the CPU's."""
    A = _k3_matrix(60, torch.float64, dev)
    w = torch.randn(60, 60, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    out = {}
    for where in ("cpu", "cuda"):
        hopper.reset_launches()
        X = A.to(where).requires_grad_(True)
        F = wbm.chol_jittered(X)
        (gX,) = torch.autograd.grad(torch.sum(torch.tril(w.to(where)) * F),
                                    X)
        out[where] = (gX.cpu(), hopper.launch_counts())
    assert out["cuda"][1]["chol_vjp/f64"] == 1
    assert out["cuda"][1]["chol_vjp_solve/f64"] == 1
    assert out["cpu"][1]["chol_vjp/f64"] == 0
    a, b = out["cuda"][0], out["cpu"][0]
    assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes", [(37,), (9, 7), (2, 3, 5)])
def test_kern_rows_fft(dev, dtype, sizes):
    """K8 on the first rows: the embedding and the table's cotangent
    against their plain versions (every kind); one launch each;
    relaunches bit-identical."""
    m = int(np.prod(sizes))
    kinds, prm, dists = _kuu_table(5, m, dtype, dev, seed=m)
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = dict(kern_rows_fft.kern_rows_fft.launches)
    E = kern_rows_fft.kern_rows_fft(kinds, prm, dists, sizes)
    before[sfx] += 1
    assert kern_rows_fft.kern_rows_fft.launches == before
    _close(E, kern_rows_fft.kern_rows_fft_plain(kinds, prm, dists, sizes),
           dtype)
    assert torch.equal(E, kern_rows_fft.kern_rows_fft(kinds, prm, dists,
                                                      sizes))
    G = torch.randn(E.shape, generator=torch.Generator().manual_seed(1),
                    dtype=dtype).to(dev)
    got = kern_rows_fft.kern_rows_fft_bwd(kinds, prm, dists, sizes, G)
    _close(got, kern_rows_fft.kern_rows_fft_bwd_plain(kinds, prm, dists,
                                                      sizes, G), dtype)
    assert torch.equal(got, kern_rows_fft.kern_rows_fft_bwd(
        kinds, prm, dists, sizes, G))


def test_kern_rows_fft_raises_on_what_it_cannot_take(dev):
    kinds, prm, dists = _kuu_table(3, 12, torch.float64, dev, seed=0)
    with pytest.raises(ValueError):
        kern_rows_fft.kern_rows_fft(kinds, prm, dists.float(), (12,))
    with pytest.raises(ValueError):
        kern_rows_fft.kern_rows_fft(kinds, prm, dists, (5,))
    with pytest.raises(ValueError):
        kern_rows_fft.kern_rows_fft((0,) * 65, torch.ones(65, 3, device=dev,
                                                          dtype=prm.dtype),
                                    dists, (12,))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_kernel_bwd_rank_one(dev, dtype):
    """K7's backward with the rank-1 term formed in its loads against the
    plain version on G - alpha alpha^T."""
    args = _mixed_table(dtype, dev, na=80, nb=80)
    args = args[:2] + args[:2] + args[4:]
    alpha = torch.randn(80, generator=torch.Generator().manual_seed(2),
                        dtype=dtype).to(dev)
    got = cross.cross_kernel_bwd(*args, alpha=alpha)
    want = cross.cross_kernel_bwd_plain(*args, alpha=alpha)
    for a, b in zip(got, want):
        _close(a, b, dtype)


def test_exact_mll_closed_form_matches_autograd(dev):
    """The oracle's closed-form gradient on the card against autograd
    through torch's Cholesky backward (the route it replaces)."""
    rng = np.random.RandomState(5)
    Xs = [np.sort(rng.uniform(0, 4, 40)) for _ in range(3)]
    Ys = [np.sin(X + d) + 0.1 * rng.randn(40) for d, X in enumerate(Xs)]
    spec = T.LMCKernelSpec.create(D=3, lmc_kernels=[T.RBF()],
                                  lmc_ranks=[2])
    mg = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[16],
                            device=dev)
    grads = []
    for closed in (True, False):
        x = torch.as_tensor(mg.param_array, device=dev).requires_grad_(True)
        from runlmc_tpu_torch.utils.carry import unravel_params
        p = unravel_params(x, mg.params)
        if closed:
            v = lk.exact_mll(mg.spec, p, mg.X, mg.oidx, mg.y)
        else:
            L = torch.linalg.cholesky(lk.exact_dense_K(mg.spec, p, mg.X,
                                                       mg.oidx))
            alpha = torch.cholesky_solve(mg.y[:, None], L)[:, 0]
            v = -0.5 * (torch.dot(mg.y, alpha) + 2 * torch.sum(torch.log(
                torch.diagonal(L))) + len(mg.y) * np.log(2 * np.pi))
        grads.append(torch.autograd.grad(v, x)[0].cpu())
    a, b = grads
    assert float((a - b).abs().max()) <= 1e-8 * float(b.abs().max())

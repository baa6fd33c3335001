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
    cross,
    fourier,
    interp,
    kuu,
    lanczos,
    minres,
    trsm,
)
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes", [(37,), (6, 7), (3, 4, 5)])
def test_kuu_dense(dev, dtype, sizes):
    g = torch.Generator().manual_seed(0)
    m = int(np.prod(sizes))
    tops = torch.rand(2, m, generator=g, dtype=dtype).to(dev)
    B = torch.randn(2, 3, 3, generator=g, dtype=dtype).to(dev)
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = dict(kuu.kuu_dense.launches)
    _close(kuu.kuu_dense(tops, B, sizes), kuu.kuu_dense_plain(tops, B, sizes),
           dtype)
    before[sfx] += 1
    assert kuu.kuu_dense.launches == before


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
    g = torch.Generator().manual_seed(4)
    m = int(np.prod(sizes))
    tops = torch.rand(2, m, generator=g, dtype=dtype).to(dev)
    B = torch.randn(2, 3, 3, generator=g, dtype=dtype).to(dev)
    G = torch.randn(3 * m, 3 * m, generator=g, dtype=dtype).to(dev)
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = dict(kuu.kuu_dense_bwd.launches)
    got = kuu.kuu_dense_bwd(tops, B, sizes, G)
    before[sfx] += 1
    assert kuu.kuu_dense_bwd.launches == before
    for a, b in zip(got, kuu.kuu_dense_bwd_plain(tops, B, sizes, G)):
        _close(a, b, dtype)


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

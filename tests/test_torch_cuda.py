"""The port's hand kernels against their plain PyTorch versions on the
card, at small shapes. Without a card every test skips. On a machine
with one, run without the JAX-configuring conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import hashlib

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
    potrf,
    trsm,
)
from runlmc_tpu_torch.lmc import likelihood as lk
from runlmc_tpu_torch.lmc import woodbury as wbm
from runlmc_tpu_torch.ops import slq
from runlmc_tpu_torch.ops.interpolation import multi_interpolant
from runlmc_tpu_torch.utils.carry import from_reference_params
from torch_minres_states import minres_state

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
    """Four float64 kernels on a 64 x 64 grid (m=4096), a table of 128 KB
    that the kernel before this one had to split over two launches: the
    folded row alone (32 KB) is in shared memory."""
    kinds, prm, dists = _kuu_table(4, 4096, torch.float64, dev, 1)
    B = torch.randn(4, 1, 1, dtype=torch.float64, device=dev)
    args = (kinds, prm, dists, B, (64, 64))
    _close(kuu.kuu_dense(*args), kuu.kuu_dense_plain(*args), torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes,D", [((1,), 1), ((5,), 3), ((19,), 2),
                                     ((238,), 13), ((7, 5), 3),
                                     ((29, 29), 5), ((2, 3, 7), 3),
                                     ((3, 1), 2), ((2000,), 1)])
def test_kuu_dense_rows_and_folds(dev, dtype, sizes, D, monkeypatch):
    """K1 where D*m is odd or 2 mod 4 (rows that start off a 16-byte
    boundary: peeled heads and tails), a single point, a trailing axis of
    size 1, a row longer than a CTA's threads' vectors; the fold
    in each CTA's prologue and as its own launch (the default picks one
    by Q * m) give the same bits, one count per call."""
    m = int(np.prod(sizes))
    kinds, prm, dists = _kuu_table(5, m, dtype, dev, 2)
    B = torch.randn(5, D, D, generator=torch.Generator().manual_seed(2),
                    dtype=dtype).to(dev)
    args = (kinds, prm, dists, B, sizes)
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = kuu.kuu_dense.launches[sfx]
    out = kuu.kuu_dense(*args)
    _close(out, kuu.kuu_dense_plain(*args), dtype)
    for fold_launch_min in (1 << 62, 0):  # the prologue, then the launch
        monkeypatch.setattr(kuu, "FOLD_LAUNCH_MIN", fold_launch_min)
        assert torch.equal(out, kuu.kuu_dense(*args))
    assert kuu.kuu_dense.launches[sfx] == before + 3


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes,D", [((1,), 1), ((1,), 3), ((33,), 1),
                                     ((65,), 2), ((2, 1, 3), 2),
                                     ((5, 33), 1), ((3, 2, 40), 2),
                                     ((40, 1), 2)])
def test_kuu_dense_bwd_tile_edges(dev, dtype, sizes, D):
    """K1's backward where the grid's innermost axis is not a multiple of
    the 32-point tile (ragged last tiles), a single point, one output,
    and a middle or trailing axis of size 1; relaunched to the bit."""
    m = int(np.prod(sizes))
    kinds, prm, dists = _kuu_table(5, m, dtype, dev, 6)
    g = torch.Generator().manual_seed(6)
    B = torch.randn(5, D, D, generator=g, dtype=dtype).to(dev)
    G = torch.randn(D * m, D * m, generator=g, dtype=dtype).to(dev)
    args = (kinds, prm, dists, B, sizes, G)
    got = kuu.kuu_dense_bwd(*args)
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


def _generic(monkeypatch, module, name, value):
    monkeypatch.setattr(module, name, lambda *args, **kwargs: value)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [1, 3, 4, 9])
@pytest.mark.parametrize("rep, K", [("sum", 2), ("sum", 4), ("sum", 5),
                                    ("slfm", 1), ("slfm", 2), ("slfm", 4),
                                    ("slfm", 5), ("bt", 0)])
def test_fourier_instances_match_the_generic_kernel(dev, dtype, D, rep, K,
                                                    monkeypatch):
    """K10's small instance (D <= 4, K <= 2) and the generic kernel (D =
    9 or K > 2) at an odd F against the plain version; the instance's
    outputs equal the generic kernel's to the bit, and relaunches are
    bit-identical."""
    vf, mat, sym, diag = _fourier_args(rep, dtype, dev, nb=6, D=D,
                                       K=max(K, 1), F=129, seed=D + K)
    inst = fourier.fourier_instance(rep, D, K)
    assert (inst == fourier.GENERIC) == (D == 9 or K > 2)
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = fourier.fourier_contract.launches[sfx]
    got = fourier.fourier_contract(rep, vf, mat, sym, diag)
    assert fourier.fourier_contract.launches[sfx] == before + 1
    assert torch.equal(got, fourier.fourier_contract(rep, vf, mat, sym, diag))
    want = fourier.fourier_contract_plain(rep, vf, mat, sym, diag)
    _close(torch.view_as_real(got), torch.view_as_real(want), dtype)
    _generic(monkeypatch, fourier, "fourier_instance", fourier.GENERIC)
    assert torch.equal(got, fourier.fourier_contract(rep, vf, mat, sym, diag))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb", [6, 17, 128])
@pytest.mark.parametrize("D", [3, 9])
@pytest.mark.parametrize("rep, K", [("sum", 2), ("sum", 5), ("slfm", 2),
                                    ("slfm", 5), ("bt", 0)])
def test_fourier_range_is_the_slice_of_the_full_range(dev, dtype, nb, D, rep,
                                                      K, monkeypatch):
    """K10 and its backward on Fourier ranges of an odd F (a grid mesh
    rank's contraction), the small instance and the generic kernel, at
    one and at several of the backward's chunks of batch rows: the
    operand read in place from f0, each range's output the full range's
    slice to the bit, and its plain version's values."""
    vf, mat, sym, diag = _fourier_args(rep, dtype, dev, nb=nb, D=D,
                                       K=max(K, 1), F=129, seed=D + K + 40)
    G = _fourier_args("bt", dtype, dev, nb=nb, D=D, F=129, seed=D + K)[0]
    full = fourier.fourier_contract(rep, vf, mat, sym, diag)
    Hfull = fourier.fourier_contract_bwd(G, vf)
    for f0, f1 in ((0, 65), (65, 129), (17, 18), (0, 129)):
        def cut(t):
            return None if t is None else t[..., f0:f1].contiguous()

        args = (rep, vf, mat, cut(sym), cut(diag))
        got = fourier.fourier_contract(*args, f0=f0)
        assert got.shape == (nb, D, f1 - f0)
        assert torch.equal(got, full[..., f0:f1])
        _close(torch.view_as_real(got), torch.view_as_real(
            fourier.fourier_contract_plain(*args, f0=f0)), dtype)
        Gr = G[..., f0:f1].contiguous()
        H = fourier.fourier_contract_bwd(Gr, vf, f0=f0)
        assert torch.equal(H, Hfull[..., f0:f1])
        _close(torch.view_as_real(H), torch.view_as_real(
            fourier.fourier_contract_bwd_plain(Gr, vf, f0)), dtype)
        with monkeypatch.context() as mp:
            _generic(mp, fourier, "fourier_instance", fourier.GENERIC)
            assert torch.equal(fourier.fourier_contract(*args, f0=f0), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb", [1, 2, 3, 5, 16, 17])
def test_fourier_weather_widths_every_batch_count(dev, dtype, nb,
                                                  monkeypatch):
    """The small instance at the weather group's widths (D = 4, R = 2)
    and an odd F, on the forward's call and the adjoint's (conjugated
    symbol): the generic kernel's bits and the plain version's values."""
    vf, mat, sym, diag = _fourier_args("slfm", dtype, dev, nb=nb, D=4, K=2,
                                       F=4097, seed=nb)
    args = ("slfm", vf, mat, sym, diag)
    adj = ("slfm", vf) + fourier.adjoint_symbol("slfm", mat, sym, diag)
    assert fourier.fourier_instance("slfm", 4, 2) == fourier.SMALL
    got, got_adj = (fourier.fourier_contract(*a) for a in (args, adj))
    _close(torch.view_as_real(got), torch.view_as_real(
        fourier.fourier_contract_plain(*args)), dtype)
    _close(torch.view_as_real(got_adj), torch.view_as_real(
        fourier.fourier_contract_plain(*adj)), dtype)
    _generic(monkeypatch, fourier, "fourier_instance", fourier.GENERIC)
    assert torch.equal(fourier.fourier_contract(*args), got)
    assert torch.equal(fourier.fourier_contract(*adj), got_adj)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb", [1, 3, 16, 17, 128])
@pytest.mark.parametrize("D", [1, 4, 9])
def test_fourier_bwd_every_batch_count_and_range(dev, dtype, nb, D):
    """K10's backward at the weather width (F = 4097) on the full range,
    both ranges of two and odd-offset ranges, at every batch count the
    selector stages differently (one stage, chunks in two buffers):
    the plain version's values (1e-12 / 1e-5 of the largest magnitude),
    a range the full range's slice to the bit, relaunches bit-identical,
    one launch a call."""
    F = 4097
    vf = _fourier_args("bt", dtype, dev, nb=nb, D=D, F=F, seed=nb + D)[0]
    G = _fourier_args("bt", dtype, dev, nb=nb, D=D, F=F, seed=nb + D + 1)[0]
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = fourier.fourier_contract_bwd.launches[sfx]
    Hfull = fourier.fourier_contract_bwd(G, vf)
    assert fourier.fourier_contract_bwd.launches[sfx] == before + 1
    assert torch.equal(Hfull, fourier.fourier_contract_bwd(G, vf))
    for f0, f1 in ((0, F), (0, 2049), (2049, F), (1, 2050), (17, 18),
                   (4001, F)):
        Gr = G[..., f0:f1].contiguous()
        H = fourier.fourier_contract_bwd(Gr, vf, f0=f0)
        assert H.shape == (D, D, f1 - f0)
        assert torch.equal(H, Hfull[..., f0:f1])
        assert torch.equal(H, fourier.fourier_contract_bwd(Gr, vf, f0=f0))
        _close(torch.view_as_real(H), torch.view_as_real(
            fourier.fourier_contract_bwd_plain(Gr, vf, f0)), dtype)


def _gather_problem(dtype, dev, dims, seed):
    rng = np.random.RandomState(seed)
    axes = [np.linspace(0, 1, 9) for _ in range(dims)]
    Xs = [rng.uniform(-0.1, 1.1, (300, dims)), rng.uniform(0, 1, (77, dims))]
    return multi_interpolant(Xs, axes).to(dtype, dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", [1, 2])
@pytest.mark.parametrize("nb", [1, 15, 16, 17, 31, 32, 33, 65])
def test_interp_gather_chunks_and_strides(dev, dtype, dims, nb,
                                          monkeypatch):
    """K9's gather at every chunk and chunk or tile boundary, its tap
    instance (4 or 16 taps) and the generic one, on a row-major and a
    transposed operand in both layouts (a thread a row; column tiles):
    all the same bits, relaunches too, and the plain version's
    values."""
    W = _gather_problem(dtype, dev, dims, seed=nb)
    g = torch.Generator().manual_seed(nb)
    vt = torch.randn(W.ncols, nb, generator=g, dtype=dtype).to(dev).T
    vr = vt.contiguous()
    assert vt.is_contiguous() == (nb == 1)
    got = interp.interp_gather(W.indices, W.weights, vr)
    assert torch.equal(got, interp.interp_gather(W.indices, W.weights, vr))
    _close(got, interp.interp_gather_plain(W.indices, W.weights, vr), dtype)
    assert torch.equal(interp.interp_gather(W.indices, W.weights, vt), got)
    for layout, v in ((interp.GATHER_ROWS, vr), (interp.GATHER_ROWS, vt),
                      (interp.GATHER_COLS, vt)):
        _generic(monkeypatch, interp, "gather_layout", layout)
        for chunk in interp.GATHER_CHUNKS[layout]:
            _generic(monkeypatch, interp, "gather_chunk", chunk)
            for taps in (interp.gather_taps(W.indices.shape[1]), 0):
                _generic(monkeypatch, interp, "gather_taps", taps)
                assert torch.equal(
                    interp.interp_gather(W.indices, W.weights, v), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_interp_gather_unaligned_taps_take_the_generic_instance(dev, dtype):
    """Taps that do not start on 16 bytes (a view at an offset) are read
    one by one: the same bits as the aligned ones."""
    W = _gather_problem(dtype, dev, 1, seed=3)
    n, taps = W.indices.shape
    ibuf = torch.zeros(n * taps + 1, dtype=torch.int32, device=dev)
    wbuf = torch.zeros(n * taps + 1, dtype=dtype, device=dev)
    idx = ibuf[1:].view(n, taps)
    w = wbuf[1:].view(n, taps)
    idx.copy_(W.indices)
    w.copy_(W.weights)
    v = torch.randn(7, W.ncols, dtype=dtype, device=dev)
    assert torch.equal(interp.interp_gather(idx, w, v),
                       interp.interp_gather(W.indices, W.weights, v))


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


def _minres_state(B, n, dtype, dev, seed, offset=False):
    """``minres_state`` (its inactive, beta' = 0 and gamma = 0 rows) on
    the card; with ``offset`` the vectors start one element past a
    16-byte boundary."""
    st, diag = minres_state(B, n, dtype, seed)
    return ([_placed(t, dev, offset) for t in st[:6]]
            + [t.to(dev) for t in st[6:]]), diag.to(dev)


def _placed(t, dev, offset):
    """``t`` copied to the card, one element past a 16-byte boundary with
    ``offset``."""
    if not offset:
        return t.to(dev, copy=True)
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _copy_state(st, offset):
    return [_placed(t, t.device, offset) if t.dim() == 2 else t.clone()
            for t in st]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B, n, offset", [
    (3, 300, False),     # one CTA a row
    (16, 15768, False),  # the rung's shape: clusters of 8, held slices
    (1, 47480, False),   # one long row: slices re-read from memory
    (5, 40001, False),   # n odd: scalar loads, long slices
    (4, 1000, True),     # an offset pointer: scalar loads, clusters of 2
])
def test_minres_update_clusters_and_long_rows(dev, dtype, B, n, offset):
    """K12 against its plain version from the same state, three
    iterations: one launch each, w only read, the inactive row left
    bit-identical, masks and iteration counts the plain version's (with
    the beta' = 0 and gamma = 0 rows), and a relaunch bit-identical."""
    st, diag = _minres_state(B, n, dtype, dev, seed=B + n, offset=offset)
    sfx = "f32" if dtype == torch.float32 else "f64"
    for _ in range(3):
        got, again = _copy_state(st, offset), _copy_state(st, offset)
        want = [t.clone() for t in st]
        before = minres.minres_update.launches[sfx]
        minres.minres_update(*got)
        assert minres.minres_update.launches[sfx] == before + 1
        minres.minres_update(*again)
        minres.minres_update_plain(*want)
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        assert torch.equal(got[0], st[0])
        for a, b in zip(got[1:12], want[1:12]):
            _close(a, b, dtype)
        assert torch.equal(got[12], want[12])
        assert torch.equal(got[13], want[13])
        if B > 1:
            for a, b in zip(got[:12], st[:12]):
                assert torch.equal(a[0], b[0])
        for t, u in zip(st, want):
            t.copy_(u)
        st[0].copy_(st[2] * diag)
    assert int(st[13][-1]) == 3 and (B == 1 or int(st[13][0]) == 0)
    if B > 3:
        assert st[13][1:3].tolist() == [2, 1]


# K13's outputs over four steps on _k13_digest's state, recorded from the
# kernel before its reduction moved into csrc/lanczos_core.cuh
K13_SHA256 = {
    torch.float64:
        "1bd85d4f11d05f44d027b9e68a1518bd805c5e69a2fe6d70b144ba2dddfa0e1a",
    torch.float32:
        "d6a6373ac452ba646f1cbca2146a198e8f8d843496dc820b8e15f663fa51f44f",
}


def _k13_digest(dtype, dev):
    """sha256 of K13's outputs over four steps from a fixed seeded state:
    the rung's SLQ shape (15, 15768) in float64, the float32 report
    path's (15, 790) in float32; row 0 breaks down at the first step."""
    B, n = (15, 15768) if dtype == torch.float64 else (15, 790)
    g = torch.Generator().manual_seed(21)
    d = (torch.rand(n, generator=g, dtype=dtype) + 0.5).to(dev)
    v = torch.sign(torch.randn(B, n, generator=g, dtype=dtype)).to(dev)
    v = v / float(np.sqrt(n))
    v[0] = 0.0
    v[0, n // 3] = 1.0
    eps = torch.full((1,), lanczos.breakdown_eps(dtype), dtype=dtype,
                     device=dev)
    v_prev = torch.zeros_like(v)
    beta = torch.zeros(B, dtype=dtype, device=dev)
    alive = torch.ones(B, dtype=torch.int32, device=dev)
    h = hashlib.sha256()
    for _ in range(4):
        out = lanczos.lanczos_step(v * d, v_prev, v, beta, alive, eps)
        for t in out:
            h.update(t.cpu().numpy().tobytes())
        v_prev, v, _, beta, alive = out
    return h.hexdigest()


@pytest.mark.parametrize("dtype", DTYPES)
def test_lanczos_step_keeps_its_recorded_bits(dev, dtype):
    """K13 rebuilt on the shared row reduction gives the bits it gave
    before the move (the code moved, the order of operations did not)."""
    assert _k13_digest(dtype, dev) == K13_SHA256[dtype]


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
@pytest.mark.parametrize("counts", [(3, 70, 0, 77), (64, 1, 65, 20),
                                    (150, 0, 0, 1)])
def test_cross_kernel_pair_path_matches_general_path(dev, dtype, counts):
    """K7 on one point set sorted by output (the pair path: tile pairs
    I >= J, K[b, a] through the transposed tile) against the same inputs
    as two point sets (the general path) to the bit, an asymmetric B,
    outputs whose runs span tile edges, one empty; the plain version
    within tolerance; relaunched to the bit."""
    x, o, B, table, _, _ = _sorted_table(dtype, dev, counts)
    assert cross._pair_plan(x, o, x, o, len(counts)) is not None
    pair = cross.cross_kernel(x, o, x, o, B, *table)
    general = cross.cross_kernel(x, o, x.clone(), o.clone(), B, *table)
    assert torch.equal(pair, general)
    assert torch.equal(pair, cross.cross_kernel(x, o, x, o, B, *table))
    _close(pair, cross.cross_kernel_plain(x, o, x, o, B, *table), dtype)


@pytest.mark.parametrize("Q", [6, 11])
def test_cross_kernel_rbf_tables_and_passes(dev, Q):
    """K7 on RBF tables on one mask (the branch-free path: six is the
    weather oracle's table) and on eleven kernels over two masks (two
    passes of eight), pair and general path alike, unsorted outputs on
    one point set (the general path)."""
    kerns = [T.RBF(name="k%d" % i, inv_lengthscale=0.3 + 0.2 * i,
                   active_dims=(0,) if Q > 6 and i % 2 else None)
             for i in range(Q)]
    spec = T.LMCKernelSpec.create(D=4, lmc_kernels=kerns,
                                  lmc_ranks=[1] * Q).with_input_dim(2)
    p = from_reference_params(spec.init_raw_params(seed=4), torch.float64,
                              dev)
    g = torch.Generator().manual_seed(4)
    x = torch.rand(300, 2, generator=g, dtype=torch.float64).to(dev)
    o = torch.as_tensor(np.repeat(np.arange(4), [90, 70, 100, 40]),
                        dtype=torch.int32, device=dev)
    B = torch.randn(Q, 4, 4, generator=g, dtype=torch.float64).to(dev)
    table = spec.kernel_table(p)
    pair = cross.cross_kernel(x, o, x, o, B, *table)
    assert torch.equal(pair, cross.cross_kernel(x, o, x.clone(), o, B,
                                                *table))
    _close(pair, cross.cross_kernel_plain(x, o, x, o, B, *table),
           torch.float64)
    perm = torch.randperm(300, generator=g).to(dev)
    xu, ou = x[perm].contiguous(), o[perm].contiguous()
    _close(cross.cross_kernel(xu, ou, xu, ou, B, *table),
           cross.cross_kernel_plain(xu, ou, xu, ou, B, *table),
           torch.float64)


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


def _sorted_table(dtype, dev, counts, seed=8):
    """The mixed six-kernel table of :func:`_mixed_table` on one point set
    sorted by output, ``counts`` points per output (runs that start and
    end inside the 64-point tiles, an empty output), a seeded asymmetric
    cotangent and alpha."""
    args = _mixed_table(dtype, dev, seed=seed, na=sum(counts),
                        nb=sum(counts))
    n = sum(counts)
    o = torch.as_tensor(np.repeat(np.arange(len(counts)), counts),
                        dtype=torch.int32, device=dev)
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, 2, generator=g, dtype=dtype).to(dev)
    x[5] = x[70]  # a pair at r = 0 off the diagonal
    G = torch.randn(n, n, generator=g, dtype=dtype).to(dev)
    alpha = torch.randn(n, generator=g, dtype=dtype).to(dev)
    B = torch.randn(args[4].shape[0], len(counts), len(counts),
                    generator=g, dtype=dtype).to(dev)
    return x, o, B, args[5:8], G, alpha


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_alpha", [False, True])
def test_cross_kernel_bwd_pair_path_matches_general_path(dev, dtype,
                                                         with_alpha):
    """K7's backward on one point set (the pair path: each unordered pair
    once) against the same inputs as two point sets (the general path)
    and the plain version; outputs whose runs span tile edges; alpha
    formed in the loads (pair) or by torch.addr first (general)."""
    x, o, B, table, G, alpha = _sorted_table(dtype, dev, (3, 70, 0, 77))
    kw = {"alpha": alpha} if with_alpha else {}
    pair = cross.cross_kernel_bwd(x, o, x, o, B, *table, G, **kw)
    general = cross.cross_kernel_bwd(x, o, x.clone(), o.clone(), B, *table,
                                     G, **kw)
    want = cross.cross_kernel_bwd_plain(x, o, x, o, B, *table, G, **kw)
    again = cross.cross_kernel_bwd(x, o, x, o, B, *table, G, **kw)
    for a, b, c, w in zip(pair, general, again, want):
        _close(a, w, dtype)
        _close(b, w, dtype)
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_kernel_bwd_unsorted_outputs_pair_path(dev, dtype):
    """One point set whose outputs are not sorted (the wrapper sorts it
    first, a gather of G) and whose runs span tile edges, with alpha."""
    x, o, B, table, G, alpha = _sorted_table(dtype, dev, (30, 90, 40, 1))
    p = torch.randperm(len(o), generator=torch.Generator().manual_seed(3))
    o, x = o[p.to(dev)].contiguous(), x[p.to(dev)].contiguous()
    got = cross.cross_kernel_bwd(x, o, x, o, B, *table, G, alpha=alpha)
    want = cross.cross_kernel_bwd_plain(x, o, x, o, B, *table, G,
                                        alpha=alpha)
    for a, b in zip(got, want):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_kernel_bwd_column_major_cotangent(dev, dtype):
    """A column-major cotangent on the pair path (the oracle hands over
    K^-1 from cholesky_inverse so) is read in place as G^T, G[a, b] and
    G[b, a] swapped: bit-identical to its row-major copy, with and
    without alpha, and to the plain version within tolerance."""
    x, o, B, table, G, alpha = _sorted_table(dtype, dev, (3, 70, 0, 77))
    Gc = G.t().contiguous().t()
    assert not Gc.is_contiguous() and torch.equal(Gc, G)
    for kw in ({}, {"alpha": alpha}):
        got = cross.cross_kernel_bwd(x, o, x, o, B, *table, Gc, **kw)
        row = cross.cross_kernel_bwd(x, o, x, o, B, *table, G, **kw)
        want = cross.cross_kernel_bwd_plain(x, o, x, o, B, *table, G, **kw)
        for a, b, w in zip(got, row, want):
            assert torch.equal(a, b)
            _close(a, w, dtype)


@pytest.mark.parametrize("Q", [9, 17])
def test_cross_kernel_bwd_many_kernels_pair_path_alpha(dev, Q):
    """More kernels than one launch takes, on the pair path with alpha
    and two input dims (one kernel in three on the first dim only):
    ceil(Q / 8) tile launches."""
    kerns = [T.RBF(name="k%d" % i, inv_lengthscale=0.5 + 0.1 * i,
                   active_dims=(0,) if i % 3 == 0 else None)
             for i in range(Q)]
    spec = T.LMCKernelSpec.create(D=3, lmc_kernels=kerns,
                                  lmc_ranks=[1] * Q).with_input_dim(2)
    p = from_reference_params(spec.init_raw_params(seed=2), torch.float64,
                              dev)
    g = torch.Generator().manual_seed(2)
    x = torch.rand(130, 2, generator=g, dtype=torch.float64).to(dev)
    o = torch.as_tensor(np.repeat(np.arange(3), [50, 65, 15]),
                        dtype=torch.int32, device=dev)
    G = torch.randn(130, 130, generator=g, dtype=torch.float64).to(dev)
    alpha = torch.randn(130, generator=g, dtype=torch.float64).to(dev)
    args = (x, o, x, o, spec.coreg_mats(p).detach()) + \
        spec.kernel_table(p) + (G,)
    before = cross.cross_kernel_bwd.launches["f64"]
    got = cross.cross_kernel_bwd(*args, alpha=alpha)
    assert cross.cross_kernel_bwd.launches["f64"] == before + -(-Q // 8)
    for a, b in zip(got, cross.cross_kernel_bwd_plain(*args, alpha=alpha)):
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B, n", [(1, 5), (15, 790), (15, 15768),
                                  (2, 40000), (3, 40001)])
def test_lanczos_step_clusters_and_long_rows(dev, dtype, B, n):
    """K13 with one CTA a row, full clusters of 8, and slices too long for
    registers (re-read from global memory), with 16-byte and scalar
    loads: each step against the plain version from the same state (row
    0 breaks down at the first step), relaunches bit-identical, and the
    form lanczos_tridiag calls (strided columns of (B, k) outputs, alive
    in place) with the same bits."""
    g = torch.Generator().manual_seed(n + B)
    d = (torch.rand(n, generator=g, dtype=dtype) + 0.5).to(dev)
    v = torch.sign(torch.randn(B, n, generator=g, dtype=dtype)).to(dev)
    v = v / float(np.sqrt(n))
    v[0] = 0.0
    v[0, n // 2] = 1.0
    eps = torch.full((1,), lanczos.breakdown_eps(dtype), dtype=dtype,
                     device=dev)
    v_prev = torch.zeros_like(v)
    beta = torch.zeros(B, dtype=dtype, device=dev)
    alive = torch.ones(B, dtype=torch.int32, device=dev)
    alphas = torch.empty((B, 4), dtype=dtype, device=dev)
    betas = torch.zeros((B, 5), dtype=dtype, device=dev)
    alive_c = alive.clone()
    for step in range(4):
        w = v * d
        want = lanczos.lanczos_step_plain(w, v_prev, v, beta, alive, eps)
        got = lanczos.lanczos_step(w, v_prev.clone(), v, beta, alive, eps)
        again = lanczos.lanczos_step(w, v_prev.clone(), v, beta, alive, eps)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        for a, b in zip(got[:4], want[:4]):
            _close(a, b, dtype)
        assert torch.equal(got[4], want[4])
        res = lanczos.lanczos_step(
            w, v_prev.clone(), v, betas[:, step], alive_c, eps,
            out=(alphas[:, step], betas[:, step + 1], alive_c))
        assert torch.equal(res[1], got[1])
        assert torch.equal(alphas[:, step], got[2])
        assert torch.equal(betas[:, step + 1], got[3])
        assert torch.equal(alive_c, got[4])
        v_prev, v, _, beta, alive = got
    assert int(alive[0]) == 0 and int(alive.sum()) == B - 1


def test_lanczos_tridiag_matches_cpu(dev):
    """Twelve steps on the card and on the CPU from the same rows of a
    diagonal operator, one of them an eigenvector (it breaks down)."""
    g = torch.Generator().manual_seed(12)
    n = 3000
    d = torch.rand(n, generator=g, dtype=torch.float64) + 0.5
    v0 = torch.sign(torch.randn(4, n, generator=g, dtype=torch.float64))
    v0 = v0 / float(np.sqrt(n))
    v0[0] = 0.0
    v0[0, 3] = 1.0
    dd = d.to(dev)
    hopper.reset_launches()
    ga, gb = slq.lanczos_tridiag(lambda v: v * dd, v0.to(dev), 12)
    assert hopper.launch_counts()["lanczos_step/f64"] == 12
    ca, cb = slq.lanczos_tridiag(lambda v: v * d, v0, 12)
    np.testing.assert_allclose(ga.cpu().numpy(), ca.numpy(), rtol=1e-10)
    np.testing.assert_allclose(gb.cpu().numpy(), cb.numpy(), rtol=1e-10,
                               atol=1e-300)
    assert torch.all(ga[0, 1:] == 1.0) and torch.all(gb[0] == 0.0)


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
    # only M's lower triangle is written
    _close(torch.tril(M), torch.tril(Mp), dtype)
    assert M.mT.is_contiguous()
    assert torch.equal(torch.tril(M), torch.tril(chol_jitter.chol_prologue(
        A, 1e-3, equilibrate, sd)[0]))
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


def _stored(X, col):
    """X stored column-major (col) or row-major."""
    return X.mT.contiguous().mT if col else X.contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 31, 33, 64, 3094, 4205])
def test_chol_jitter_backward_every_order(dev, dtype, n):
    """K3a's and K3b's backward against their plain versions in every
    storage order of their operands (the line pass where they are stored
    alike, the tile pass otherwise), with and without the epilogue's
    s-bar, also from a cotangent that starts off a 16-byte boundary; one
    launch counted per call; relaunches bit-identical."""
    A = _k3_matrix(n, dtype, dev, seed=n + 3)
    L = torch.linalg.cholesky(A)
    A[0, n - 1] += 0.01  # not symmetric
    sd = chol_jitter.chol_scale_plain(A, True)
    g = torch.Generator().manual_seed(n)
    G = torch.randn(n, n, generator=g, dtype=dtype).to(dev)
    buf = torch.empty(n * n + 1, dtype=dtype, device=dev)
    G_off = buf[1:].view(n, n)
    G_off.copy_(G)
    sb_in = torch.randn(n, generator=g, dtype=dtype).to(dev)
    sfx = "f32" if dtype == torch.float32 else "f64"
    for gcol in (False, True):
        for fcol in (False, True):
            Ob, Lf = _stored(G, gcol), _stored(L, fcol)
            before = dict(chol_jitter.chol_descale_bwd.launches)
            got = chol_jitter.chol_descale_bwd(Lf, sd, Ob)
            before[sfx] += 1
            assert chol_jitter.chol_descale_bwd.launches == before
            assert got[0].mT.is_contiguous() == gcol or n == 1
            for a, b in zip(got, chol_jitter.chol_descale_bwd_plain(
                    Lf, sd, Ob)):
                _close(a, b, dtype)
            assert all(torch.equal(a, b) for a, b in zip(
                got, chol_jitter.chol_descale_bwd(Lf, sd, Ob)))
        Mb = _stored(G, gcol)
        for sb in (None, sb_in):
            before = dict(chol_jitter.chol_prologue_bwd.launches)
            Ab = chol_jitter.chol_prologue_bwd(A, sd, Mb, sb, 1e-4, True)
            before[sfx] += 1
            assert chol_jitter.chol_prologue_bwd.launches == before
            assert Ab.is_contiguous()
            _close(Ab, chol_jitter.chol_prologue_bwd_plain(
                A, sd, Mb, sb, 1e-4, True), dtype)
            assert torch.equal(Ab, chol_jitter.chol_prologue_bwd(
                A, sd, Mb, sb, 1e-4, True))
    # off a 16-byte boundary: the wrappers copy the operand
    got = chol_jitter.chol_descale_bwd(L, sd, G_off)
    for a, b in zip(got, chol_jitter.chol_descale_bwd_plain(L, sd, G)):
        _close(a, b, dtype)
    Ab = chol_jitter.chol_prologue_bwd(A, sd, G_off, sb_in, 1e-4, True)
    assert torch.equal(Ab, chol_jitter.chol_prologue_bwd(A, sd, G, sb_in,
                                                         1e-4, True))


def _lower_equal(a, b):
    """a is b's lower triangle with zeros above it."""
    return torch.equal(a, torch.tril(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("equilibrate", [True, False])
@pytest.mark.parametrize("n", [3094, 4205, 1024, 1001])
def test_chol_jitter_forward_at_site_shapes(dev, dtype, equilibrate, n):
    """K3a and K3b at the sites' n (fx2007's and synth's C, rows off a
    16-byte boundary) and a ragged n: M the plain version's lower
    triangle bit for bit with zeros above, and s the plain version's
    (without equilibration from the same d: the kernel sums the diagonal
    in another order), also from an A that starts off a 16-byte
    boundary; the in-place chain (K3a, cuSOLVER's potrf in place, K3b)
    equal to the bit to the earlier route (cholesky_ex into a new
    factor), L's strict upper triangle 0 (K3a's zeros: no tril_ runs), O
    bit for bit the plain version's with zeros above; relaunches
    bit-identical."""
    A = _k3_matrix(n, dtype, dev, seed=n)
    sd_p = chol_jitter.chol_scale_plain(A, equilibrate)
    Mp, sp = chol_jitter.chol_prologue_plain(A, 1e-4, equilibrate, sd_p)
    buf = torch.empty(n * n + 1, dtype=dtype, device=dev)
    A_off = buf[1:].view(n, n)
    A_off.copy_(A)
    for src in (A, A_off):
        M, s, sd = chol_jitter.chol_prologue(src, 1e-4, equilibrate)
        assert M.mT.is_contiguous()
        if equilibrate:  # s is elementwise: the plain version's bits
            assert _lower_equal(M, Mp) and torch.equal(sd, sd_p)
            assert torch.equal(s, sp)
        else:  # d is a sum, taken in another order than torch.mean's
            _close(sd, sd_p, dtype)
            Mq = chol_jitter.chol_prologue(src, 1e-4, equilibrate, sd_p)[0]
            assert _lower_equal(Mq, Mp)
        M2, s2, _ = chol_jitter.chol_prologue(src, 1e-4, equilibrate, sd)
        assert torch.equal(M, M2) and (s is None or torch.equal(s, s2))
    # the earlier route: a new factor from the same M (then tril_)
    L_old, info_old = torch.linalg.cholesky_ex(M)
    O_old, flag_old = chol_jitter.chol_descale(L_old, info_old.clone(), s)
    ptr = M.data_ptr()
    L, info = potrf.potrf_(M)
    assert L is M and L.data_ptr() == ptr and L.mT.is_contiguous()
    assert torch.equal(L, L_old) and torch.equal(info, info_old)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    O, flag = chol_jitter.chol_descale(L, info.clone(), s)
    assert torch.equal(O, O_old) and int(flag) == int(flag_old) == 0
    Op, flag_p = chol_jitter.chol_descale_plain(L, info, sp)
    assert torch.equal(O, Op) and int(flag_p) == 0
    assert torch.equal(O, chol_jitter.chol_descale(L, info.clone(), s)[0])
    # a NaN above the diagonal is never read; one below sets the flag
    L[1, n - 1] = float("nan")
    assert int(chol_jitter.chol_descale(L, info.clone(), s)[1]) == 0
    L[n - 1, 1] = float("nan")
    assert int(chol_jitter.chol_descale(L, info.clone(), s)[1]) == -1
    assert int(chol_jitter.chol_descale(L, info.clone(), None)[1]) == -1


def test_chol_jittered_in_place_matches_the_earlier_route(dev):
    """One chol_jittered call factors in place and equals, bit for bit,
    the earlier route's factor (K3a, cholesky_ex into a new factor, K3b)
    with its float32 gradient; it holds two (n, n) matrices and potrf's
    workspace."""
    n = 1001
    A = _k3_matrix(n, torch.float32, dev, eig0=-5e-5, seed=3)
    w = torch.randn(n, n, generator=torch.Generator().manual_seed(4)).to(dev)
    out = []
    for route in ("in place", "earlier"):
        real = wbm.cholesky_ex
        if route == "earlier":
            wbm.cholesky_ex = lambda M: chol_vjp.CholeskyEx.apply(M.clone())
        try:
            X = A.clone().requires_grad_(True)
            F = wbm.chol_jittered(X)
            (g,) = torch.autograd.grad(torch.sum(torch.tril(w) * F), X)
        finally:
            wbm.cholesky_ex = real
        out.append((F.detach(), g))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        F = wbm.chol_jittered(A)
    torch.cuda.synchronize()
    # M (then the factor) and the de-scaled copy, plus cuSOLVER's
    # workspace, a larger share of a matrix at this n than at the sites'
    # (the earlier route held a third matrix, the factor)
    mats = (torch.cuda.max_memory_allocated() - base) / (4 * n * n)
    assert mats <= 2.5, mats


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


@pytest.mark.parametrize("dtype, sizes", [
    (dt, sz) for dt in DTYPES for sz in ((2504,), (50, 40), (12, 10, 9))
] + [(torch.float64, (94, 128)), (torch.float64, (95, 128))])
def test_kern_rows_fft_bwd_cluster_has_the_one_cta_bits(dev, dtype, sizes,
                                                        monkeypatch):
    """K8 (fft)'s backward at the weather group's shape (Q = 6, m =
    2504), 2-D and 3-D grids, the largest float64 grid whose terms fit in
    8 CTAs and a larger one that does not: against the plain version,
    relaunched bit-identical, and the cluster kernel at every cluster
    size that fits with the one-CTA kernel's bits."""
    m = int(np.prod(sizes))
    Q = 6
    kinds, prm, dists = _kuu_table(Q, m, dtype, dev, seed=m)
    E = kern_rows_fft.kern_rows_fft(kinds, prm, dists, sizes)
    G = torch.randn(E.shape, generator=torch.Generator().manual_seed(2),
                    dtype=dtype).to(dev)
    C = kern_rows_fft.bwd_cluster(Q, m, dtype)
    want_c = min(8, -(-m // 256))
    assert C == (0 if (dtype, sizes) == (torch.float64, (95, 128)) else
                 1 << (want_c.bit_length() - 1))
    got = kern_rows_fft.kern_rows_fft_bwd(kinds, prm, dists, sizes, G)
    _close(got, kern_rows_fft.kern_rows_fft_bwd_plain(kinds, prm, dists,
                                                      sizes, G), dtype)
    assert torch.equal(got, kern_rows_fft.kern_rows_fft_bwd(
        kinds, prm, dists, sizes, G))
    for c in (0, 1, 2, 4, 8):
        if c and 4 * G.element_size() * -(-m // 256) * (256 // c) > \
                kern_rows_fft.SMEM_LIMIT:
            continue
        monkeypatch.setattr(kern_rows_fft, "bwd_cluster",
                            lambda Q, m, dtype, sms=None, c=c: c)
        assert torch.equal(kern_rows_fft.kern_rows_fft_bwd(
            kinds, prm, dists, sizes, G), got), c


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

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
from runlmc_tpu_torch.hopper import cg, cross, interp, kuu
from runlmc_tpu_torch.ops.interpolation import multi_interpolant
from runlmc_tpu_torch.utils.carry import from_reference_params

DTYPES = [torch.float32, torch.float64]
# float64 kernels sum the same few terms as their plain versions in
# another order; float32 passes reduce rows of ~1000 terms
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


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

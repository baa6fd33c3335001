"""The synth configuration (bench.py:114-130): the file loader against
the JAX package's on tiny files, the layout of the in-repo synthetic
twin, and a 3-step training chunk on a reduced copy (bench.py's
VALIDATE["synth"]: every 30th point, m=[8, 8]) against the JAX
package."""

import numpy as np

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu import datasets as jdata
from runlmc_tpu_torch import datasets as tdata


def _spec(pkg, D=5):
    return pkg.LMCKernelSpec.create(
        D=D, slfm_kernels=[pkg.RBF(name="slfm0"), pkg.RBF(name="slfm1")],
        indep_gp=[pkg.RBF(name="rbf%d" % i) for i in range(D)],
    )


def test_synth_loader_matches_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    (tmp_path / "synth").mkdir()
    np.save(tmp_path / "synth" / "xss.npy", rng.uniform(0, 1, (5, 40, 2)))
    np.save(tmp_path / "synth" / "yss.npy", rng.standard_normal((5, 40, 1)))
    want = jdata.synth(datadir=str(tmp_path))
    got = tdata.synth(datadir=str(tmp_path))
    monkeypatch.setenv("RUNLMC_DATA", str(tmp_path))
    from_env = tdata.synth()
    for w, g, e in zip(want, got, from_env):
        assert len(w) == len(g) == len(e) == 5
        for a, b, c in zip(w, g, e):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    assert len(got[2][-1]) > 0  # a held-out quadrant


def test_synth_synthetic_layout():
    xss, yss, txs, tys = tdata.synth_synthetic(0)
    assert len(xss) == len(yss) == len(txs) == len(tys) == 5
    assert all(x.shape == (10_000, 2) for x in xss[:4])
    assert all(len(t) == 0 and t.shape == (0, 2) for t in txs[:4])
    n = sum(len(y) for y in yss)
    assert 47_000 < n < 48_000 and n + len(tys[-1]) == 50_000
    assert all(len(x) == len(y) for x, y in zip(xss + txs, yss + tys))
    assert np.all(txs[-1] >= 0.5)
    assert not np.any(np.all(xss[-1] >= 0.5, axis=1))
    assert all(np.all((x >= 0) & (x <= 1)) for x in xss)
    # the same split as the JAX package's loader applies to full arrays
    again = tdata.synth_synthetic(0)
    for a, b in zip(xss + yss, again[0] + again[1]):
        np.testing.assert_array_equal(a, b)
    assert all(np.all(np.isfinite(y)) and np.std(y) > 0.1 for y in yss)


def test_reduced_synth_chunk_matches_jax():
    """Three exact-objective AdaDelta steps at exact_precision='model' on
    the reduced synthetic synth copy: P=2 inputs, 12 x 12 grids (Dm=720),
    the 2-D BTTB K_UU, block-banded grams through K2's plain versions and
    16-tap rows through K9's; float64 factorizations in both packages."""
    xss, yss, _, _ = tdata.synth_synthetic(0)
    xs = [x[::30] for x in xss]
    ys = [y[::30] for y in yss]
    kw = dict(m=[8, 8], tolerance=1e-3, objective="exact",
              exact_precision="model")
    mj = R.InterpolatedLLGP(xs, ys, functional_kernel=_spec(R), **kw)
    mt = T.InterpolatedLLGP(xs, ys, functional_kernel=_spec(T), device="cpu",
                            **kw)
    assert mt.grid_data[0].plan.sizes == (12, 12)
    assert mt.grid_data[0].interp.ncols == 720
    mt.param_array = mj.param_array
    ij = mj.optimize(optimizer=R.AdaDelta(max_it=3))
    it = mt.optimize(optimizer=T.AdaDelta(max_it=3))
    assert it["n_iter"] == ij["n_iter"] == 3
    # float64 Woodbury factorizations in both packages round apart by
    # about 1e-12, the exact gradient by about 1e-9 relative (two Cholesky
    # VJPs); three steps carry that: the bounds of test_torch_train's
    # optimize parity
    np.testing.assert_allclose(mt.param_array, mj.param_array, rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(it["grad_norms"], ij["grad_norms"],
                               rtol=1e-6)

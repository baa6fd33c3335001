"""The operator algebra (ops/operators.py) against dense oracles, as
tests/test_operators.py holds the JAX package's, and against the JAX
operators on the same inputs; the mean functions against the JAX
package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as la
import torch

from runlmc_tpu.mean import functions as jmean
from runlmc_tpu.ops import operators as jops
from runlmc_tpu_torch import mean as tmean
from runlmc_tpu_torch.ops import operators as ops
from tests.utils import bttb_dense_oracle, rand_pd, random_toep


def _t(a):
    return torch.as_tensor(np.array(a, dtype=float))


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=float))


def _symm_blocks(rng, pkg, d=3, m=4):
    blocks = [[None] * d for _ in range(d)]
    dense = np.zeros((d * m, d * m))
    for i in range(d):
        for j in range(i, d):
            top = random_toep(rng, m)
            blocks[i][j] = blocks[j][i] = top
            blk = bttb_dense_oracle(top, (m,))
            dense[i * m:(i + 1) * m, j * m:(j + 1) * m] = blk
            dense[j * m:(j + 1) * m, i * m:(i + 1) * m] = blk
    mk = (lambda top: ops.Toeplitz(_t(top))) if pkg == "t" else \
        (lambda top: jops.Toeplitz(_j(top)))
    mod = ops if pkg == "t" else jops
    return mod.SymmSquareBlock([[mk(b) for b in row] for row in blocks]), dense


def _case(name, rng):
    """(port operator, JAX operator, dense oracle) of each case of
    tests/test_operators.py."""
    if name == "dense":
        a = rng.standard_normal((4, 6))
        return ops.Dense(_t(a)), jops.Dense(_j(a)), a
    if name == "identity":
        return ops.Identity(5), jops.Identity(5), np.eye(5)
    if name == "diag":
        d = rng.standard_normal(6)
        return ops.Diag(_t(d)), jops.Diag(_j(d)), np.diag(d)
    if name == "toeplitz":
        top = random_toep(rng, 7)
        return (ops.Toeplitz(_t(top)), jops.Toeplitz(_j(top)),
                bttb_dense_oracle(top, (7,)))
    if name == "bttb":
        top = rng.standard_normal(12)
        return (ops.BTTB.build(_t(top), (3, 4)),
                jops.BTTB.build(_j(top), (3, 4)),
                bttb_dense_oracle(top, (3, 4)))
    if name == "kronecker":
        a, top = rand_pd(rng, 3), random_toep(rng, 4)
        return (ops.Kronecker(ops.Dense(_t(a)), ops.Toeplitz(_t(top))),
                jops.Kronecker(jops.Dense(_j(a)), jops.Toeplitz(_j(top))),
                np.kron(a, bttb_dense_oracle(top, (4,))))
    if name == "kronecker_nested":
        a, b, c = (rng.standard_normal((k, k)) for k in (2, 3, 2))
        return (ops.Kronecker(ops.Dense(_t(a)),
                              ops.Kronecker(ops.Dense(_t(b)),
                                            ops.Dense(_t(c)))),
                jops.Kronecker(jops.Dense(_j(a)),
                               jops.Kronecker(jops.Dense(_j(b)),
                                              jops.Dense(_j(c)))),
                np.kron(a, np.kron(b, c)))
    if name == "block_diag":
        a, b = rng.standard_normal((2, 3)), rng.standard_normal((4, 4))
        return (ops.BlockDiag([ops.Dense(_t(a)), ops.Dense(_t(b))]),
                jops.BlockDiag([jops.Dense(_j(a)), jops.Dense(_j(b))]),
                la.block_diag(a, b))
    if name == "symm_square_block":
        state = rng.bit_generator.state
        top, dense = _symm_blocks(rng, "t")
        rng.bit_generator.state = state
        jop, _ = _symm_blocks(rng, "j")
        return top, jop, dense
    if name == "sum":
        a, d = rand_pd(rng, 5), rng.standard_normal(5)
        return (ops.Sum([ops.Dense(_t(a)), ops.Diag(_t(d))]),
                jops.Sum([jops.Dense(_j(a)), jops.Diag(_j(d))]),
                a + np.diag(d))
    if name == "composition":
        a, b = rng.standard_normal((3, 4)), rng.standard_normal((4, 5))
        return (ops.Composition([ops.Dense(_t(a)), ops.Dense(_t(b))]),
                jops.Composition([jops.Dense(_j(a)), jops.Dense(_j(b))]),
                a @ b)
    raise KeyError(name)


CASES = ["dense", "identity", "diag", "toeplitz", "bttb", "kronecker",
         "kronecker_nested", "block_diag", "symm_square_block", "sum",
         "composition"]


@pytest.mark.parametrize("name", CASES)
def test_operator_against_dense_oracle_and_jax(rng, name):
    op, jop, dense = _case(name, rng)
    assert tuple(op.shape) == dense.shape == tuple(jop.shape)
    n = dense.shape[1]
    v = rng.standard_normal(n)
    V = rng.standard_normal((3, n))
    M = rng.standard_normal((n, 2))
    np.testing.assert_allclose(op.matvec(_t(v)).numpy(), dense @ v,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(op.matvec(_t(V)).numpy(), V @ dense.T,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(op.matmat(_t(M)).numpy(), dense @ M,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(op.as_dense()), dense, rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(op.matvec(_t(V)).numpy(),
                               np.asarray(jop.matvec(_j(V))), rtol=1e-12,
                               atol=1e-12)


def test_wrap(rng):
    a = rng.standard_normal((4, 4))
    at = _t(a)
    op = ops.LinearOperator.wrap((4, 4), lambda v: v @ at.T)
    v = rng.standard_normal(4)
    assert op.shape == (4, 4)
    np.testing.assert_allclose(op.matvec(_t(v)).numpy(), a @ v, rtol=1e-12)


def test_eig_bounds(rng):
    top = random_toep(rng, 6)
    dense = bttb_dense_oracle(top, (6,))
    diag = ops.Diag(_t(np.abs(rng.standard_normal(6))))
    for op, d in [
        (ops.Toeplitz(_t(top)), dense),
        (diag, np.asarray(diag.as_dense())),
        (ops.Sum([ops.Toeplitz(_t(top)), ops.Identity(6)]),
         dense + np.eye(6)),
    ]:
        assert np.linalg.eigvalsh(d).max() <= float(op.upper_eig_bound()) \
            + 1e-9
    sj = jops.Sum([jops.Toeplitz(_j(top)), jops.Identity(6)])
    assert float(ops.Sum([ops.Toeplitz(_t(top)), ops.Identity(6)])
                 .upper_eig_bound()) == pytest.approx(
        float(sj.upper_eig_bound()), rel=1e-12)


def test_operators_are_differentiable(rng):
    """Autograd reaches an operator's tensor fields (the JAX operators
    are pytrees that jax.grad differentiates)."""
    a = _t(rand_pd(rng, 4)).requires_grad_(True)
    d = _t(rng.uniform(1, 2, 4)).requires_grad_(True)
    v = _t(rng.standard_normal(4))
    out = ops.Sum([ops.Dense(a), ops.Diag(d)]).matvec(v).sum()
    ga, gd = torch.autograd.grad(out, (a, d))
    np.testing.assert_allclose(ga.numpy(), np.outer(np.ones(4), v.numpy()))
    np.testing.assert_allclose(gd.numpy(), v.numpy())


@pytest.mark.parametrize("cls", ["Zero", "Constant"])
def test_mean_functions_match_jax(cls):
    Xs = [np.linspace(0, 1, 5), np.linspace(0, 1, 3), np.zeros(0)]
    jm = getattr(jmean, cls)(output_dim=3)
    tm = getattr(tmean, cls)(output_dim=3)
    raw = jm.init_raw_params()
    if raw:
        raw = {"offsets": np.array([0.5, -1.0, 2.0])}
    assert tm.init_raw_params().keys() == jm.init_raw_params().keys()
    for got, want in zip(tm.mean(raw, Xs), jm.mean(raw, Xs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="1-D"):
        getattr(tmean, cls)(input_dim=2)

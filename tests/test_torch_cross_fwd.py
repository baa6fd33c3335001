"""Kernel K7's forward (csrc/cross_kernel.cu, which runs only on the card):
numpy mirrors of its pair path (the tile pairs I >= J of one point set
sorted by output, each unordered pair's k(r) once for K[a, b] and, through
the transposed tile, K[b, a]) and of its general path
(tests/torch_fwd_mirrors.py) against the plain version, on the table of
every kernel kind of tests/test_torch_cross_bwd.py; the two paths' bits
against each other; and the wrapper's choice of path."""

import numpy as np
import pytest
import torch

import runlmc_tpu_torch as T
from runlmc_tpu_torch.hopper import cross
from runlmc_tpu_torch.utils.carry import from_reference_params
from tests import torch_fwd_mirrors as mirrors
from tests.test_torch_cross_bwd import COUNTS, _spec

# the same products and sums in another order: float64 rounding
RTOL = 1e-12


def _problem(counts, seed, spec=None):
    """Sorted points on a 2-D input with the outputs' ``counts`` (a pair
    at r = 0 off the diagonal), an asymmetric B and the table of
    ``spec`` (every kind by default)."""
    spec = spec or _spec()
    p = from_reference_params(spec.init_raw_params(seed=seed), torch.float64,
                              "cpu")
    rng = np.random.RandomState(seed)
    n = sum(counts)
    x = rng.uniform(0, 2, (n, 2))
    if n > 5:
        x[5] = x[min(70, n - 1)]
    o = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    kinds, masks, prm = (t.numpy() for t in spec.kernel_table(p))
    B = rng.standard_normal((len(kinds), len(counts), len(counts)))
    return x, o, B, kinds, masks, prm


def _plain(xa, oa, xb, ob, B, kinds, masks, prm):
    t = torch.as_tensor
    return cross.cross_kernel_plain(t(xa), t(oa), t(xb), t(ob), t(B),
                                    t(kinds), t(masks), t(prm)).numpy()


def _many_kernels_spec():
    """Eleven kernels (two passes of the kernel's eight), on three masks,
    every kind."""
    kerns = [T.RBF(name="r%d" % i, inv_lengthscale=0.5 + 0.2 * i,
                   active_dims=(0,) if i % 3 == 0 else None)
             for i in range(7)]
    kerns += [T.Matern32(name="m", active_dims=(1,)),
              T.StdPeriodic(name="p", period=1.3),
              T.IdentityKern(active_dims=(0,)),
              T.Scaled(inner=T.RBF(name="s", active_dims=(1,)), scale=0.8)]
    return T.LMCKernelSpec.create(D=4, lmc_kernels=kerns,
                                  lmc_ranks=[1] * len(kerns)
                                  ).with_input_dim(2)


@pytest.mark.parametrize(
    "counts,many", [(c, False) for c in COUNTS + [(1,), (0, 5)]]
    + [(c, True) for c in COUNTS if len(c) == 4])
def test_pair_walk_mirror_matches_plain(counts, many):
    """The pair path, mirrored: tile pairs I >= J whose outputs start and
    end mid-tile (one output empty), a diagonal tile's pairs a > b
    written both ways and a = b once, every element of K written exactly
    once, and the plain version's K; with eleven kernels, two passes."""
    spec = _many_kernels_spec() if many else None
    x, o, B, kinds, masks, prm = _problem(counts, len(counts), spec)
    K, visits = mirrors.k7_pair(x, o, B, kinds, masks, prm)
    assert np.all(visits == 1)
    want = _plain(x, o, x, o, B, kinds, masks, prm)
    np.testing.assert_allclose(K, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("counts", COUNTS)
def test_pair_path_equals_general_path_bit_for_bit(counts):
    """With an asymmetric B, the pair path's K[b, a] (the tile pair's
    transposed write, with B[q, out J, out I]) is the general path's
    K[b, a] to the bit, and so is every K[a, b]; both within rounding of
    the plain version."""
    x, o, B, kinds, masks, prm = _problem(counts, 7 + len(counts))
    assert not np.allclose(B, B.transpose(0, 2, 1))
    pair, _ = mirrors.k7_pair(x, o, B, kinds, masks, prm)
    general = mirrors.k7_general(x, o, x.copy(), o.copy(), B, kinds, masks,
                                 prm)
    assert np.array_equal(pair, general)
    want = _plain(x, o, x, o, B, kinds, masks, prm)
    np.testing.assert_allclose(general, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_general_path_on_two_point_sets_and_unsorted_outputs():
    """The general path on distinct point sets (K_*X) and on one point set
    whose outputs are not sorted gives the plain version's K."""
    x, o, B, kinds, masks, prm = _problem((30, 90, 40, 1), 3)
    rng = np.random.RandomState(3)
    perm = rng.permutation(len(o))
    xu, ou = x[perm], o[perm]
    xt = rng.uniform(0, 2, (37, 2))
    ot = rng.randint(0, 4, 37).astype(np.int32)
    for args in ((xu, ou, xu, ou), (xt, ot, x, o)):
        got = mirrors.k7_general(*args, B, kinds, masks, prm)
        want = _plain(*args, B, kinds, masks, prm)
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


def test_wrapper_takes_the_pair_path_only_on_one_sorted_point_set():
    """The wrapper's choice: the pair plan (the backward's plan, cached)
    for the same sorted tensors on both sides; the general path for
    equal copies, for unsorted outputs and for two point sets."""
    x = torch.rand(150, 2, dtype=torch.float64)
    o = torch.as_tensor(np.repeat(np.arange(3), [64, 1, 85]),
                        dtype=torch.int32)
    plan = cross._pair_plan(x, o, x, o, 3)
    assert plan is not None
    ta, _, pairs, _, _ = cross.bwd_plan((64, 1, 85), (64, 1, 85), True)
    assert plan[1:] == (len(ta), len(ta), len(pairs))
    assert cross._pair_plan(x, o, x, o, 3)[0] is plan[0]
    assert cross._pair_plan(x, o, x.clone(), o.clone(), 3) is None
    assert cross._pair_plan(x, o, x[:100], o[:100], 3) is None
    u = o.flip(0).contiguous()
    xu = x.flip(0).contiguous()
    assert cross._pair_plan(xu, u, xu, u, 3) is None

"""Kernel K7's backward (csrc/cross_kernel_bwd.cu, which runs only on the
card): a numpy mirror of its tile-pair walk over the host plan
(tests/torch_bwd_mirrors.py) against the plain version, with and without
the rank-1 term, on the pair path (one point set: each unordered pair
once) and the general path; the plan's coverage of G; and the caching of
the plan and of each index tensor's order."""

import numpy as np
import pytest
import torch

import runlmc_tpu_torch as T
from runlmc_tpu_torch.hopper import cross
from runlmc_tpu_torch.utils.carry import from_reference_params
from tests import torch_bwd_mirrors as mirrors

# the same products and sums in another order: float64 rounding
RTOL = 1e-12


def _spec():
    """Every kernel kind, over split active dims of a 2-D input, on four
    outputs."""
    return T.LMCKernelSpec.create(
        D=4,
        lmc_kernels=[T.RBF(name="r", active_dims=(0,)),
                     T.Matern32(name="m", active_dims=(1,))],
        lmc_ranks=[1, 2],
        slfm_kernels=[T.StdPeriodic(name="p", period=1.7)],
        indep_gp=[T.IdentityKern(),
                  T.Scaled(inner=T.RBF(name="s", active_dims=(1,)),
                           scale=1.5),
                  T.Scaled(inner=T.Matern32(name="f"),
                           trainable_scale=False, scale=0.7)],
        indep_gp_index=[0, 1, 3],
    ).with_input_dim(2)


# outputs whose runs start and end inside 64-point tiles, one empty
COUNTS = [(3, 70, 0, 77), (64, 1, 65, 20), (150, 0, 0, 1)]


def _problem(counts, seed):
    spec = _spec()
    p = from_reference_params(spec.init_raw_params(seed=seed), torch.float64,
                              "cpu")
    rng = np.random.RandomState(seed)
    n = sum(counts)
    x = rng.uniform(0, 2, (n, 2))
    x[5] = x[min(70, n - 1)]  # a pair at r = 0 off the diagonal
    o = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    kinds, masks, prm = (t.numpy() for t in spec.kernel_table(p))
    B = rng.standard_normal((len(kinds), len(counts), len(counts)))
    G = rng.standard_normal((n, n))
    alpha = rng.standard_normal(n)
    return x, o, B, kinds, masks, prm, G, alpha


def _plain(x, o, B, kinds, masks, prm, G, alpha):
    t = torch.as_tensor
    xt, ot = t(x), t(o)
    return cross.cross_kernel_bwd_plain(
        xt, ot, xt, ot, t(B), t(kinds), t(masks), t(prm), t(G),
        None if alpha is None else t(alpha))


@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("with_alpha", [False, True])
@pytest.mark.parametrize("pair", [True, False])
def test_pair_walk_mirror_matches_plain(counts, with_alpha, pair):
    """The kernel's walk, mirrored: on the pair path each unordered pair
    of points is evaluated once for G[a, b] (to (oa, ob)) and G[b, a] (to
    (ob, oa)), each diagonal element once; the general path takes every
    element once. Both give the plain backward's (d B, d prm)."""
    x, o, B, kinds, masks, prm, G, alpha = _problem(counts, len(counts))
    a = alpha if with_alpha else None
    dB, dprm, visits = mirrors.k7_pair_walk(x, o, B, kinds, masks, prm, G,
                                            a, pair)
    assert np.all(visits == 1)
    want = _plain(x, o, B, kinds, masks, prm, G, a)
    for got, w in zip((dB, dprm), want):
        w = w.numpy()
        np.testing.assert_allclose(got, w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())


@pytest.mark.parametrize("counts", COUNTS + [(1,), (0, 5)])
@pytest.mark.parametrize("pair", [True, False])
def test_bwd_plan_covers_every_element_once(counts, pair):
    """Tiles never straddle two outputs and cover each output's run; the
    plan's slots cover each element of G exactly once (on the pair path
    through slot 2p for G[I, J], I >= J, and 2p + 1 for G[J, I]); each
    (d, e) lists exactly the slots of its outputs, ascending."""
    D, n = len(counts), sum(counts)
    ta, tb, pairs, ptr, idx = cross.bwd_plan(tuple(counts), tuple(counts),
                                             pair)
    o = np.repeat(np.arange(D), counts)
    for start, length, d in ta:
        assert 1 <= length <= cross.TILE
        assert np.all(o[start:start + length] == d)
    assert sum(r[1] for r in ta) == n
    seen = np.zeros((n, n), dtype=int)
    slot_de = {}
    for p, (I, J) in enumerate(pairs):
        (r0, rl, ro), (c0, cl, co) = ta[I], tb[J]
        w = np.ones((rl, cl), dtype=int)
        if pair and I == J:
            w = np.tril(w)
        seen[r0:r0 + rl, c0:c0 + cl] += w
        slot_de[2 * p] = ro * D + co
        if pair:
            assert I >= J
            seen[c0:c0 + cl, r0:r0 + rl] += np.tril(w, -1).T \
                if I == J else w.T
            slot_de[2 * p + 1] = co * D + ro
    assert np.all(seen == 1)
    assert ptr[-1] == len(idx) == len(slot_de)
    for de in range(D * D):
        lst = idx[ptr[de]:ptr[de + 1]].tolist()
        assert lst == sorted(lst)
        assert all(slot_de[j] == de for j in lst)


def test_bwd_plan_and_output_order_are_cached():
    """The plan is made once per (counts, path) and placed once per
    device; an index tensor's order is read once per tensor and version
    (the model keeps one index tensor), and again after it changes."""
    assert cross.bwd_plan((3, 4), (3, 4), True) is \
        cross.bwd_plan((3, 4), (3, 4), True)
    dev = torch.device("cpu")
    assert cross._device_plan((3, 4), (3, 4), True, dev)[0] is \
        cross._device_plan((3, 4), (3, 4), True, dev)[0]
    o = torch.as_tensor([0, 0, 1, 1, 1], dtype=torch.int32)
    first = cross.output_order(o, 2)
    assert first == (None, (2, 3))
    assert cross.output_order(o, 2) is first
    o[1] = 1  # a new version: read again
    again = cross.output_order(o, 2)
    assert again is not first and again == (None, (1, 4))
    u = torch.as_tensor([1, 0, 1, 0], dtype=torch.int32)
    perm, counts = cross.output_order(u, 2)
    assert counts == (2, 2) and perm.tolist() == [1, 3, 0, 2]
    with pytest.raises(ValueError):
        cross.output_order(torch.as_tensor([0, 2], dtype=torch.int32), 2)

"""K13 (the Lanczos step, ``hopper/lanczos.py``) and K8 (fft)'s backward
(``hopper/kern_rows_fft.py``) as their CUDA kernels split the work over
thread-block clusters: the cluster choices and each CTA's part, numpy
mirrors of the kernels' summation orders against the plain versions,
the cluster backward's two-phase order against the one-CTA kernel's
chains to the bit, and ``lanczos_tridiag`` (which writes each step into
columns of its (B, k) outputs) against the JAX package's, from numpy
seeds in float64."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runlmc_tpu.ops import slq as jslq
from runlmc_tpu_torch.hopper import kern_rows_fft as k8
from runlmc_tpu_torch.hopper import lanczos
from runlmc_tpu_torch.ops import bttb as tbttb
from runlmc_tpu_torch.ops import slq

DTYPES = [torch.float32, torch.float64]
SHAPES = [1, 5, 790, 2504, 15768, 40000, 40001]


def _covers(ranges, n):
    """The ranges, in order, tile [0, n) exactly once."""
    at = 0
    for lo, hi in ranges:
        assert lo == min(at, n) and lo <= hi
        at = hi
    assert at == n


@pytest.mark.parametrize("dtype", DTYPES)
def test_lanczos_cluster_is_pure_and_slices_cover_each_row(dtype):
    for B in (1, 2, 15, 16, 132, 300):
        for n in SHAPES:
            C = lanczos.lanczos_cluster(B, n, dtype)
            assert C == lanczos.lanczos_cluster(B, n, dtype)
            assert 1 <= C <= lanczos.MAX_CLUSTER
            assert B * C <= lanczos.SMS or C == 1
            for vec in {1, lanczos.vector_width(dtype)}:
                if n % vec == 0:
                    _covers([lanczos.lanczos_slice(n, vec, C, r)
                             for r in range(C)], n)
    # the SLQ paths' shapes: the weather rows fill 120 SMs, the reduced
    # copy's float32 rows take one CTA each
    assert lanczos.lanczos_cluster(15, 15768, torch.float64) == 8
    assert lanczos.lanczos_cluster(15, 790, torch.float32) == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_bwd_cluster_is_pure_and_its_ctas_cover_each_q(dtype):
    item = 8 if dtype == torch.float64 else 4
    for Q in (1, 4, 6, 17, 33, 64):
        for m in (1, 30, 256, 257, 1080, 2000, 2504, 12032, 12160):
            C = k8.bwd_cluster(Q, m, dtype)
            assert C == k8.bwd_cluster(Q, m, dtype)
            assert C in (0, 1, 2, 4, 8)
            if C:
                assert Q * C <= k8.SMS or C == 1
                points = [o for r in range(C)
                          for o in k8.bwd_points(m, C, r) if o >= 0]
                assert sorted(points) == list(range(m))
                assert 4 * item * len(k8.bwd_points(m, C, 0)) \
                    <= k8.SMEM_LIMIT
    assert k8.bwd_cluster(6, 2504, torch.float64) == 8
    # the largest float64 grid whose terms fit in 8 CTAs' shared memory,
    # and a larger one that takes the one-CTA kernel
    assert k8.bwd_cluster(6, 94 * 128, torch.float64) == 8
    assert k8.bwd_cluster(6, 95 * 128, torch.float64) == 0
    assert k8.bwd_cluster(6, 95 * 128, torch.float32) == 8


# ---------------------------------------------------------------- K13


def _cta_sum(x):
    """csrc/kern_rows_fft.cu finish_dprm over 256 per-thread values: the
    xor-shuffle tree in each warp, then the warps' sums in warp order."""
    s = 0.0
    for warp in _warp_sums(x):
        s = s + warp
    return s


def _warp_sums(x):
    """The xor-shuffle tree of each warp of the per-thread values."""
    x = x.reshape(-1, 32).copy()
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = x + x[:, lanes ^ off]
    return x[:, 0]


def _cluster_sum(partials):
    """csrc/lanczos.cu cluster_sum over the C * 8 warp partials in (rank,
    warp) order: lane l adds partials l and l + 32, then the xor tree."""
    lanes = np.zeros(32)
    for i, p in enumerate(partials):
        lanes[i % 32] = lanes[i % 32] + p if i >= 32 else p
    return _warp_sums(lanes)[0]


def _mirror_step(w, vp, v, beta, alive, eps):
    """The kernel's step, one row at a time, in its summation order: a
    cluster of ``lanczos_cluster`` CTAs, each a slice of the row's
    vectors, thread t taking vectors t, t + 256, ...; each warp's sum by
    the xor tree, and the cluster's warp sums by ``_cluster_sum``."""
    B, n = v.shape
    dtype = torch.float64
    C = lanczos.lanczos_cluster(B, n, dtype)
    vec = lanczos.vector_width(dtype)
    vec = vec if n % vec == 0 else 1
    T = lanczos.THREADS
    out = [np.zeros_like(v), np.zeros(B), np.zeros(B), np.zeros(B, np.int32)]
    for b in range(B):
        w1 = w[b] - beta[b] * vp[b]

        def partial(x, y, lo, hi):
            nv = (hi - lo) // vec
            K = -(-nv // T)
            pad = np.zeros((K * T - nv) * vec)
            xs = np.concatenate([x[lo:hi], pad]).reshape(K, T, vec)
            ys = np.concatenate([y[lo:hi], pad]).reshape(K, T, vec)
            acc = np.zeros(T)
            for k in range(K):
                for e in range(vec):
                    acc = acc + xs[k, :, e] * ys[k, :, e]
            return _warp_sums(acc)

        def cluster_sum(x, y):
            return _cluster_sum(np.concatenate([
                partial(x, y, *lanczos.lanczos_slice(n, vec, C, r))
                for r in range(C)]))

        alpha = cluster_sum(w1, v[b])
        w2 = w1 - alpha * v[b]
        bn = math.sqrt(cluster_sum(w2, w2))
        live = bool(alive[b])
        live_n = live and bn > eps
        out[0][b] = w2 / (bn if bn > 0 else 1.0) if live_n else 0.0
        out[1][b] = alpha if live else 1.0
        out[2][b] = bn if live_n else 0.0
        out[3][b] = int(live_n)
    return out


@pytest.mark.parametrize("B, n", [(3, 5), (15, 790), (4, 15768),
                                  (2, 40000), (2, 40001)])
def test_k13_mirror_agrees_with_the_plain_step(B, n):
    """Three steps of the kernel's order against lanczos_step_plain at
    1e-12, with a row that breaks down at the first step and a dead
    row: one CTA a row, full clusters, slices past the registers, and an
    odd n (scalar loads)."""
    rng = np.random.RandomState(n + B)
    d = rng.uniform(0.5, 1.5, n)
    v = np.sign(rng.standard_normal((B, n))) / np.sqrt(n)
    v[0] = 0.0
    v[0, n // 2] = 1.0
    vp = np.zeros_like(v)
    beta = np.zeros(B)
    alive = np.ones(B, np.int32)
    alive[-1] = 0 if B > 2 else 1
    eps = lanczos.breakdown_eps(torch.float64)
    for _ in range(3):
        w = v * d
        got = _mirror_step(w, vp, v, beta, alive, eps)
        want = lanczos.lanczos_step_plain(
            *(torch.as_tensor(a) for a in (w, vp, v, beta, alive)),
            torch.full((1,), eps, dtype=torch.float64))
        for g, wt in zip(got[:3], want[1:4]):
            wt = wt.numpy()
            np.testing.assert_allclose(g, wt, rtol=0, atol=1e-12 * max(
                1.0, float(np.abs(wt).max())))
        np.testing.assert_array_equal(got[3], want[4].numpy())
        vp, v, beta, alive = v, got[0], got[2], got[3]
    assert alive[0] == 0 and np.all(got[1][0] == 1.0)


def test_lanczos_step_out_form_matches_new_outputs():
    """On the CPU, ``out=`` (strided columns, alive in place) returns
    the values of the allocating form."""
    rng = np.random.RandomState(5)
    w, vp, v = (torch.as_tensor(rng.standard_normal((3, 11)))
                for _ in range(3))
    beta = torch.as_tensor(rng.uniform(0.1, 1.0, 3))
    alive = torch.tensor([1, 0, 1], dtype=torch.int32)
    eps = torch.full((1,), 1e-14, dtype=torch.float64)
    want = lanczos.lanczos_step(w, vp, v, beta, alive, eps)
    cols = torch.zeros((3, 4), dtype=torch.float64)
    acols = torch.zeros((3, 4), dtype=torch.float64)
    alive_c = alive.clone()
    got = lanczos.lanczos_step(w, vp, v, beta, alive_c, eps,
                               out=(acols[:, 1], cols[:, 2], alive_c))
    assert got[2].data_ptr() == acols[:, 1].data_ptr()
    assert got[4] is alive_c
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)


def test_lanczos_tridiag_matches_jax_with_a_breakdown_row():
    """The restructured recurrence and the SLQ estimate from the same
    numpy-seeded probes against the JAX package (float64, the
    tolerances of tests/test_torch_slq.py): a mild dense operator plus
    a diagonal block on which row 0's probe is an eigenvector."""
    n, k = 70, 12
    rng = np.random.RandomState(11)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.linspace(1.0, 30.0, n)) @ Q.T
    A[:, 0] = A[0, :] = 0.0
    A[0, 0] = 2.5  # e_0 is an eigenvector
    z = np.where(rng.uniform(size=(5, n)) < 0.5, -1.0, 1.0)
    v0 = z / np.sqrt(n)
    v0[0] = 0.0
    v0[0, 0] = 1.0
    wa, wb = jslq.lanczos_tridiag(lambda v: v @ jnp.asarray(A),
                                  jnp.asarray(v0), k)
    At = torch.as_tensor(A)
    ga, gb = slq.lanczos_tridiag(lambda v: v @ At, torch.as_tensor(v0), k)
    assert ga.shape == (5, k) and gb.shape == (5, k - 1)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-10)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-10,
                               atol=1e-300)
    assert ga[0, 0] == 2.5 and torch.all(ga[0, 1:] == 1.0)
    assert torch.all(gb[0] == 0.0) and torch.all(gb[1:] > 0)
    # the quadrature of runlmc_tpu/ops/slq.py:_slq_impl on JAX's
    # tridiagonals, against the port's estimate from the same probes
    z[0] = 0.0
    z[0, 0] = np.sqrt(n)
    wa, wb = jslq.lanczos_tridiag(lambda v: v @ jnp.asarray(A),
                                  jnp.asarray(z / np.sqrt(n)), k)
    T = (np.stack([np.diag(a) for a in np.asarray(wa)])
         + np.stack([np.diag(b, 1) + np.diag(b, -1)
                     for b in np.asarray(wb)]))
    lam, U = jnp.linalg.eigh(jnp.asarray(T))
    want = n * float(jnp.mean(jnp.sum(
        U[:, 0, :] ** 2 * jnp.log(jnp.maximum(lam, 1e-300)), axis=-1)))
    got = float(slq.slq_logdet_from_probes(lambda v: v @ At,
                                           torch.as_tensor(z), k))
    np.testing.assert_allclose(got, want, rtol=1e-10)


# ---------------------------------------------------------------- K8 bwd


def _kern_grads(kind, r, gamma, period):
    """common.cuh kern_grads in its operation order: k~, dk~/dgamma,
    dk~/dperiod."""
    if kind == 0:
        r2 = r * r
        k = math.exp(-0.5 * r2 * gamma)
        return k, -0.5 * r2 * k, 0.0
    if kind == 1:
        s = r * (1.7320508075688772 * gamma)
        e = math.exp(-s)
        return (1.0 + s) * e, -(1.7320508075688772 * r) * s * e, 0.0
    if kind == 2:
        arg = (3.141592653589793 / period) * r
        s = math.sin(arg)
        k = math.exp(-0.5 * (s * s) * gamma)
        return (k, -0.5 * (s * s) * k,
                gamma * s * math.cos(arg)
                * (3.141592653589793 * r / (period * period)) * k)
    return (1.0 if r == 0.0 else 0.0), 0.0, 0.0


def _point_terms(Gq, sizes, ext, o):
    """The images' sum of first-row point o in the (a, b, c) order."""
    idx = np.unravel_index(o, sizes)
    ims = [[s] + ([E - s] if s > 0 else []) for s, E in zip(idx, ext)]
    w = 0.0
    for pos in np.ndindex(*[len(i) for i in ims]):
        w = w + Gq[tuple(ims[a][b] for a, b in enumerate(pos))]
    return w


def _finish(acc, scale):
    """The shuffle tree and the pass over the warps of the three sums,
    then the table row's cotangent."""
    s = [_cta_sum(a) for a in acc]
    return np.array([scale * s[1], scale * s[2], s[0]])


def _one_cta_chains(kinds, prm, dists, sizes, G):
    """The one-CTA kernel: thread t sums the points t, t + 256, ..."""
    ext = tbttb.extension_sizes(sizes)
    m = len(dists)
    T = k8.THREADS
    out = np.zeros((len(kinds), 3))
    for q, kind in enumerate(kinds):
        acc = np.zeros((3, T))
        for t in range(T):
            for o in range(t, m, T):
                w = _point_terms(G[q], sizes, ext, o)
                k, dg, dp = _kern_grads(kind, dists[o], prm[q, 0],
                                        prm[q, 1])
                acc[:, t] = acc[:, t] + np.array([w * k, w * dg, w * dp])
        out[q] = _finish(acc, prm[q, 2])
    return out


def _cluster_two_phase(kinds, prm, dists, sizes, G):
    """The cluster kernel: CTA r computes the terms of its chains' points
    into its own slots (``bwd_points``), runs those chains and its warps'
    shuffle trees; the first CTA adds the 8 warps' sums in order."""
    ext = tbttb.extension_sizes(sizes)
    m = len(dists)
    T = k8.THREADS
    out = np.zeros((len(kinds), 3))
    for q, kind in enumerate(kinds):
        C = k8.bwd_cluster(len(kinds), m, torch.float64)
        chains = T // C
        warps = np.zeros((T // 32, 3))
        for r in range(C):
            slots = k8.bwd_points(m, C, r)
            terms = np.full((4, len(slots)), np.nan)
            for p, o in enumerate(slots):
                if o >= 0:
                    terms[:, p] = (_point_terms(G[q], sizes, ext, o),) \
                        + _kern_grads(kind, dists[o], prm[q, 0], prm[q, 1])
            acc = np.zeros((3, chains))
            for tl in range(chains):
                for p in range(tl, len(slots), chains):
                    if slots[p] < 0:
                        break
                    w, k, dg, dp = terms[:, p]
                    acc[:, tl] = acc[:, tl] + np.array([w * k, w * dg,
                                                        w * dp])
            for i in range(3):
                warps[r * chains // 32:(r + 1) * chains // 32, i] = \
                    _warp_sums(acc[i])
        s = np.zeros(3)
        for wsum in warps:
            s = s + wsum
        out[q] = [prm[q, 2] * s[1], prm[q, 2] * s[2], s[0]]
    return out


@pytest.mark.parametrize("sizes", [(1,), (37,), (600,), (2504,), (9, 7),
                                   (2, 3, 5), (12, 10, 9)])
def test_k8_bwd_two_phase_order_has_the_one_cta_bits(sizes):
    """The cluster kernel's CTAs, each running its share of the chains
    on its own points' terms, give the one-CTA kernel's sums to the bit,
    and both agree with the plain backward at 1e-12."""
    m = int(np.prod(sizes))
    rng = np.random.RandomState(m + len(sizes))
    kinds = (0, 1, 2, 3)
    prm = 0.5 + rng.uniform(size=(4, 3))
    dists = np.concatenate([[0.0], np.sort(rng.uniform(0, 2, m - 1))])
    G = rng.standard_normal((4,) + tbttb.extension_sizes(sizes))
    one = _one_cta_chains(kinds, prm, dists, sizes, G)
    two = _cluster_two_phase(kinds, prm, dists, sizes, G)
    np.testing.assert_array_equal(two, one)
    want = k8.kern_rows_fft_bwd_plain(kinds, torch.as_tensor(prm),
                                      torch.as_tensor(dists), sizes,
                                      torch.as_tensor(G)).numpy()
    np.testing.assert_allclose(one, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())

"""K12 (the MINRES update, ``hopper/minres.py``) as its CUDA kernel
splits a row over a thread-block cluster: a numpy mirror of the
kernel's order of operations (each CTA's slice by ``lanczos_slice``,
each thread's partial over its vectors, each warp's xor tree, the
cluster's (rank, warp) tree, one reciprocal a thread) against
``minres_update_plain``; ``_minres_cycle`` and ``batched_minres`` with
the mirror in place of the update against the JAX package's; the
wrapper's launch arguments with the card stubbed; and the selectors'
use of the card's multiprocessor count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runlmc_tpu.ops import solvers as jsol
from runlmc_tpu_torch.hopper import build, interp, lanczos, minres
from runlmc_tpu_torch.hopper import kern_rows_fft as k8
from runlmc_tpu_torch.ops import solvers as tsol
from tests.test_torch_minres import _mv, _system
from torch_minres_states import minres_state

TORCH = {np.dtype(np.float32): torch.float32,
         np.dtype(np.float64): torch.float64}


def _tree(x):
    """The xor-shuffle tree over the last axis's 32 lanes: lane 0's sum."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ off]
    return x[..., 0]


def _row_sum(x, y, vec, C):
    """<x, y> over a row in the kernel's order (csrc/lanczos_core.cuh):
    CTA r takes ``lanczos_slice(n, vec, C, r)``, thread t its vectors t,
    t + 256, ..., one element after another; then each warp's tree, and
    the C * 8 warp sums by lanes l and l + 32 and the tree again."""
    T = lanczos.THREADS
    parts = []
    for r in range(C):
        lo, hi = lanczos.lanczos_slice(x.shape[0], vec, C, r)
        nv = (hi - lo) // vec
        K = -(-nv // T)
        pad = np.zeros((K * T - nv) * vec, x.dtype)
        xs = np.concatenate([x[lo:hi], pad]).reshape(K, T, vec)
        ys = np.concatenate([y[lo:hi], pad]).reshape(K, T, vec)
        acc = np.zeros(T, x.dtype)
        for k in range(K):
            for e in range(vec):
                acc = acc + xs[k, :, e] * ys[k, :, e]
        parts.append(_tree(acc.reshape(-1, 32)))
    p = np.concatenate(parts)
    lanes = np.zeros(32, x.dtype)
    lanes[:min(32, p.size)] = p[:32]
    lanes[:max(0, p.size - 32)] += p[32:]
    return _tree(lanes)


def _layout(B, n, dtype):
    """(C, vec) of the wrapper's launch for aligned (B, n) rows."""
    vec = lanczos.vector_width(dtype)
    return lanczos.lanczos_cluster(B, n, dtype), (vec if n % vec == 0
                                                  else 1)


def mirror_update(w, x, v, vp, d, dp, beta, c, s, cp, sp, phi, active,
                  iters, tol):
    """csrc/minres.cu on numpy arrays, in place, row by row."""
    B, n = v.shape
    C, vec = _layout(B, n, TORCH[v.dtype])
    one = v.dtype.type(1)
    for b in range(B):
        if not active[b]:
            continue  # an inactive row's cluster exits at once
        w1 = w[b] - beta[b] * vp[b]
        alpha = _row_sum(v[b], w1, vec, C)
        w2 = w1 - alpha * v[b]
        bn = np.sqrt(_row_sum(w2, w2, vec, C))
        eps = sp[b] * beta[b]
        delta = cp[b] * beta[b]
        delta2 = c[b] * delta + s[b] * alpha
        gamma_t = -s[b] * delta + c[b] * alpha
        gamma = np.sqrt(gamma_t * gamma_t + bn * bn)
        pos = bool(gamma > 0)
        safe_gamma = gamma if pos else one
        c_new = gamma_t / safe_gamma if pos else one
        s_new = bn / safe_gamma if pos else 0 * one
        tau = c_new * phi[b]
        phi_new = -s_new * phi[b]
        inv_bn = one / (bn if bn > 0 else one)
        inv_g = one / safe_gamma
        dn = (v[b] - delta2 * d[b] - eps * dp[b]) * inv_g
        x[b] = x[b] + tau * dn
        vp[b] = v[b]
        v[b] = w2 * inv_bn
        dp[b] = d[b]
        d[b] = dn
        cp[b], sp[b] = c[b], s[b]
        beta[b], c[b], s[b], phi[b] = bn, c_new, s_new, phi_new
        iters[b] += 1
        active[b] = int(abs(phi_new) >= tol[0] and pos)


def mirror_update_torch(*state):
    """:func:`mirror_update` on CPU tensors, in place (numpy views)."""
    mirror_update(*(t.numpy() for t in state))


CASES = [
    # (B, n, dtype): C, loads, held or long slices
    (3, 5, torch.float64),         # C = 1, scalar loads (n odd)
    (16, 300, torch.float64),      # C = 1, 16-byte vectors
    (4, 1000, torch.float64),      # C = 2
    (5, 1001, torch.float32),      # C = 1, scalar loads
    (16, 15768, torch.float64),    # the rung's shape: C = 8, held
    (16, 15768, torch.float32),    # the inner cycles' dtype: C = 8, held
    (4, 9000, torch.float32),      # C = 3
    (1, 47480, torch.float64),     # one long row: C = 8, re-read slices
    (5, 40001, torch.float64),     # C = 8, scalar loads, long slices
]


@pytest.mark.parametrize("B, n, dtype", CASES)
def test_k12_mirror_agrees_with_the_plain_update(B, n, dtype):
    """Three iterations of the kernel's order against
    minres_update_plain from the same state each time (1e-14 relative in
    float64, 1e-5 in float32): the inactive row is left bit-identical,
    and the masks and iteration counts are the plain version's."""
    st, diag = minres_state(B, n, dtype, seed=B * n)
    rtol = 1e-14 if dtype == torch.float64 else 1e-5
    for _ in range(3):
        got = [t.clone() for t in st]
        want = [t.clone() for t in st]
        mirror_update_torch(*got)
        minres.minres_update_plain(*want)
        for g, wt in zip(got[1:12], want[1:12]):
            scale = max(1.0, float(wt.abs().max()))
            assert float((g - wt).abs().max()) <= rtol * scale
        assert torch.equal(got[12], want[12])
        assert torch.equal(got[13], want[13])
        for g, t in zip(got[:12], st[:12]):
            assert B == 1 or torch.equal(g[0], t[0])  # row 0 inactive
        st = want
        st[0] = st[2] * diag
    assert int(st[13][-1]) == 3 and (B == 1 or int(st[13][0]) == 0)


def test_k12_mirror_rows_with_zero_beta_and_gamma():
    """The eigenvector row: beta' = 0 exactly, v' = w2 (no division by
    zero), s' = 0 and the row stops (|phi_bar'| = 0 < tol); with c = s =
    0 too, gamma = 0: c' = 1, s' = 0, the row's vectors still update
    once and it stops."""
    st, _ = minres_state(5, 64, torch.float64, seed=3)
    st[14].fill_(1e-12)
    want = [t.clone() for t in st]
    got = [t.clone() for t in st]
    minres.minres_update_plain(*want)
    mirror_update_torch(*got)
    for r in (1, 2):
        assert float(want[6][r]) == 0.0  # beta' = 0
    assert float(want[7][2]) == 1.0 and float(want[8][2]) == 0.0
    assert want[12].tolist() == [0, 0, 0, 1, 1]
    assert want[13].tolist() == [0, 1, 1, 1, 1]
    for g, wt in zip(got[1:12], want[1:12]):
        assert float((g - wt).abs().max()) <= 1e-14 * max(
            1.0, float(wt.abs().max()))
    assert torch.equal(got[12], want[12]) and torch.equal(got[13], want[13])


@pytest.mark.parametrize("B, n, dtype, held", [
    (16, 15768, torch.float64, True), (16, 15768, torch.float32, True),
    (1, 47480, torch.float64, False), (5, 40001, torch.float64, False),
    (3, 5, torch.float64, True), (4, 1000, torch.float64, True)])
def test_k12_cases_cover_held_and_long_slices(B, n, dtype, held):
    """Which of the kernel's paths each shape takes: a slice of at most
    kHeld = 8 elements a thread stays in registers."""
    C, vec = _layout(B, n, dtype)
    longest = max(hi - lo for lo, hi in (lanczos.lanczos_slice(n, vec, C, r)
                                         for r in range(C)))
    assert (longest <= 8 * lanczos.THREADS) == held
    assert C == {(16, 15768): 8, (1, 47480): 8, (5, 40001): 8, (3, 5): 1,
                 (4, 1000): 2}[(B, n)]


@pytest.mark.parametrize("k", [1, 2, 7, 25])
def test_minres_cycle_with_the_mirror_matches_jax(k, monkeypatch):
    """k iterations of one cycle with the kernel's order in place of the
    update, against the JAX while-loop body (tests/test_torch_minres.py's
    tolerances)."""
    monkeypatch.setattr(tsol, "minres_update", mirror_update_torch)
    A, b = _system(seed=k)
    tol = 1e-8
    xj, ij = jsol._minres_cycle(_mv(A, "jax"), jnp.asarray(b), tol, k)
    xt, it = tsol._minres_cycle(_mv(A, "torch"), torch.as_tensor(b),
                                torch.full((1,), tol, dtype=torch.float64), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(xj)).max())


@pytest.mark.parametrize("cycle,cond", [(100, 4.0), (8, 4.0), (8, 10.0),
                                        (30, 10.0)])
def test_batched_minres_with_the_mirror_matches_jax(cycle, cond,
                                                    monkeypatch):
    monkeypatch.setattr(tsol, "minres_update", mirror_update_torch)
    A, b = _system(seed=3, cond=cond)
    tol = 1e-8
    rj = jsol.batched_minres(_mv(A, "jax"), jnp.asarray(b), tol=tol,
                             cycle=cycle)
    rt = tsol.batched_minres(_mv(A, "torch"), torch.as_tensor(b), tol=tol,
                             cycle=cycle)
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-10,
                               atol=1e-10 * np.abs(xj).max())
    np.testing.assert_allclose(rt.error.numpy(), np.asarray(rj.error),
                               rtol=1e-6, atol=1e-14)
    assert rt.iterations[1] == 0 and rt.iterations[3] == 0
    assert bool(rt.converged.all())


def test_batched_minres_mixed_precision_with_the_mirror_matches_jax(
        monkeypatch):
    """float32 inner cycles (the mirror in float32) with float64
    true-residual refinement."""
    monkeypatch.setattr(tsol, "minres_update", mirror_update_torch)
    A, b = _system(seed=5, cond=10.0)
    tol = 1e-7
    Aj32 = jnp.asarray(A, jnp.float32)
    At32 = torch.as_tensor(A, dtype=torch.float32)
    rj = jsol.batched_minres(_mv(A, "jax"), jnp.asarray(b), tol=tol,
                             cycle=20, inner_matvec=lambda v: v @ Aj32.T,
                             inner_dtype=jnp.float32)
    rt = tsol.batched_minres(_mv(A, "torch"), torch.as_tensor(b), tol=tol,
                             cycle=20, inner_matvec=lambda v: v @ At32.T,
                             inner_dtype=torch.float32)
    assert bool(rt.converged.all()) and bool(np.all(rj.converged))
    x = np.linalg.solve(A, b.T).T
    np.testing.assert_allclose(rt.x.numpy(), x, rtol=1e-6,
                               atol=1e-6 * np.abs(x).max())
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))


def _stub_card(monkeypatch, seen):
    """The wrapper's host path with the card's calls stubbed: each launch
    records its symbol and arguments."""
    def function(name, symbol, argtypes):
        assert name == "minres" and len(argtypes) == 20

        def fn(*args):
            seen.append((symbol, args))
            return 0
        return fn

    monkeypatch.setattr(build, "use_plain", lambda what, t: False)
    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "stream_ptr", lambda device=None: None)
    monkeypatch.setattr(build, "sm_count", lambda index: build.H100_SMS)


def test_minres_update_takes_k13s_cluster_rule(monkeypatch):
    """minres.py takes lanczos_cluster and vector_width from lanczos.py
    itself, and passes the cluster of the shape, 16-byte vectors where n
    and every row pointer allow them, and scalar loads otherwise."""
    assert minres.lanczos_cluster is lanczos.lanczos_cluster
    assert minres.vector_width is lanczos.vector_width
    seen = []
    _stub_card(monkeypatch, seen)
    before = dict(minres.minres_update.launches)
    for B, n, dtype in ((16, 15768, torch.float64), (5, 1001, torch.float32),
                        (4, 1000, torch.float64)):
        st, _ = minres_state(B, n, dtype, seed=1)
        minres.minres_update(*st)
        C, vec = _layout(B, n, dtype)
        sym, args = seen[-1]
        assert sym == "minres_update_" + build.suffix("", dtype)
        assert args[15:19] == (B, n, C, vec)
        assert args[:6] == tuple(t.data_ptr() for t in st[:6])
    # a row pointer off the 16-byte grid: scalar loads
    st, _ = minres_state(4, 1000, torch.float64, seed=2)
    buf = torch.zeros(4 * 1000 + 1, dtype=torch.float64)
    st[3] = buf[1:].view(4, 1000)
    minres.minres_update(*st)
    assert seen[-1][1][15:19] == (4, 1000, 2, 1)
    assert minres.minres_update.launches["f64"] == before["f64"] + 3
    assert minres.minres_update.launches["f32"] == before["f32"] + 1


def test_minres_update_raises_on_what_the_kernel_cannot_take(monkeypatch):
    _stub_card(monkeypatch, [])
    st, _ = minres_state(3, 40, torch.float64, seed=4)
    bad = list(st)
    bad[7] = bad[7].float()
    with pytest.raises(ValueError, match="mixed float"):
        minres.minres_update(*bad)
    bad = list(st)
    bad[12] = bad[12].long()
    with pytest.raises(ValueError, match="int32"):
        minres.minres_update(*bad)
    bad = list(st)
    bad[4] = torch.zeros(40, 3, dtype=torch.float64).T
    with pytest.raises(ValueError, match="contiguous"):
        minres.minres_update(*bad)
    bad = list(st)
    bad[8] = bad[8][:2]
    with pytest.raises(ValueError, match=r"\(B,\)"):
        minres.minres_update(*bad)


def test_selectors_follow_the_cards_multiprocessor_count():
    """The cluster and tier choices take the card's SM count (the
    wrappers pass build.sm_count of their tensors' device): at an H100's
    132 the defaults, and another count changes the choice."""
    f64 = torch.float64
    assert build.H100_SMS == 132
    assert lanczos.lanczos_cluster(16, 15768, f64) == 8
    assert lanczos.lanczos_cluster(16, 15768, f64, sms=132) == 8
    assert lanczos.lanczos_cluster(16, 15768, f64, sms=64) == 4
    assert lanczos.lanczos_cluster(15, 15768, f64, sms=16) == 1
    assert k8.bwd_cluster(6, 2504, f64) == 8
    assert k8.bwd_cluster(6, 2504, f64, sms=24) == 4
    assert k8.bwd_cluster(6, 2504, f64, sms=12) == 2
    assert interp.scatter_variant(4205, 759680, 1) == interp.SCATTER_WARP
    assert interp.scatter_variant(4205, 759680, 1, sms=2) \
        == interp.SCATTER_THREAD
    rows = interp.GATHER_ROWS
    assert interp.gather_chunk(3113, 3094, rows) == 4
    assert interp.gather_chunk(3113, 3094, rows, sms=132) == 4
    assert interp.gather_chunk(3113, 16, rows) == 1
    assert interp.gather_chunk(3113, 16, rows, sms=8) == 4
